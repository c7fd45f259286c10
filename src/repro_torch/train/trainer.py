"""Trainer: the fault-tolerant training loop on one device.

Ports ``repro/train/trainer.py``:
  * checkpoints every ``ckpt_every`` steps, async + atomic (checkpoint.py);
  * the data pipeline is a pure function of (seed, step), so a resume is
    exact;
  * ``run`` wraps each step in a retry loop: a ``SimulatedPreemption`` (or
    any error a failure hook raises as one) restores the latest checkpoint
    and replays from there, as a preempted pod would.

The device is ``cuda`` unless the caller passes ``device="cpu"``; without a
card the trainer raises instead of training on the CPU. Each batch goes to
the device through ``ops.upload`` (pinned, non-blocking on a card), and a
step reads the loss through the counted ``ops.device_get`` — the step's
backpressure, as in the reference — and the gradient norm only on log steps.
The reference's jit and buffer donation have no counterpart: the step runs
eagerly and builds new parameter and state tensors.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step


class SimulatedPreemption(RuntimeError):
    """Raised by failure-injection hooks to exercise the recovery path."""


@dataclasses.dataclass
class TrainerConfig:
    num_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    max_retries: int = 3


class Trainer:
    def __init__(self, model, pipeline, opt_cfg: OptConfig,
                 ckpt_dir: str, tcfg: TrainerConfig = TrainerConfig(),
                 failure_hook: Optional[Callable[[int], None]] = None,
                 grad_accum: int = 1, device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, trainer on "
                             f"{self.device}")
        self.model = model
        self.pipeline = pipeline
        self.tcfg = tcfg
        self.failure_hook = failure_hook
        self.ckpt = CheckpointManager(ckpt_dir)
        self.train_step = make_train_step(model, opt_cfg, grad_accum)
        self.params = None
        self.opt_state = None
        self.step = 0
        self.metrics_log: list[dict] = []

    # -- state management ----------------------------------------------------
    def init_state(self, seed: int = 0) -> None:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = self.model.init(gen)
        self.opt_state = init_opt_state(self.params)
        self.step = 0

    def state(self) -> dict:
        return {"params": self.params, "opt": self.opt_state,
                "step": np.asarray(self.step)}

    def save(self) -> None:
        self.ckpt.save_async(self.step, self.state())

    def try_resume(self) -> bool:
        """Restore the latest checkpoint, if any. A trainer with no state
        yet takes its structure from ``init_state()`` first (the
        reference's restores into an empty tree and cannot run after)."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        if self.params is None:   # the structure to restore into
            self.init_state()
        restored = self.ckpt.restore(latest, self.state(),
                                     device=self.device)
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        self.step = int(restored["step"])
        return True

    # -- loop -----------------------------------------------------------------
    def run(self) -> list[dict]:
        if self.params is None:
            raise RuntimeError("call init_state() or try_resume() first")
        retries = 0
        while self.step < self.tcfg.num_steps:
            try:
                self._one_step()
                retries = 0
            except SimulatedPreemption:
                # production path: pod died -> restore latest ckpt, replay
                retries += 1
                if retries > self.tcfg.max_retries:
                    raise
                self.ckpt.wait()
                if not self.try_resume():
                    self.init_state()
        self.ckpt.wait()
        return self.metrics_log

    def _one_step(self) -> None:
        if self.failure_hook is not None:
            self.failure_hook(self.step)  # may raise SimulatedPreemption
        batch = {k: ops.upload(v, self.device)
                 for k, v in self.pipeline.batch(self.step).items()}
        t0 = time.perf_counter()
        self.params, self.opt_state, metrics = self.train_step(
            self.params, self.opt_state, batch)
        # counted host sync: blocking on the loss is the step's backpressure
        loss = float(ops.device_get(metrics["loss"]))
        dt = time.perf_counter() - t0
        self.step += 1
        if self.step % self.tcfg.log_every == 0 or self.step == 1:
            rec = {"step": self.step, "loss": loss, "sec": dt,
                   "grad_norm": float(ops.device_get(metrics["grad_norm"]))}
            self.metrics_log.append(rec)
        if self.step % self.tcfg.ckpt_every == 0:
            self.save()
