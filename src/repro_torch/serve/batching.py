"""Continuous batching with MDRQ-based admission control.

Ports ``repro/serve/batching.py``. Each request carries a feature vector
(priority, prompt length, SLO deadline, estimated cost) and the admission
filter is a partial-match MDRQ over the pending queue, through the port's
``MDRQEngine`` (the columnar scan's vertical path). The batcher keeps B
decode slots hot: finished or empty slots are refilled from the admitted
queue each step, and prompts are fed token by token through the same decode
step. One counted ``ops.device_get`` per step brings the sampled tokens to
the host.

A quirk of the reference, kept because it changes results: refilling a slot
resets neither its cache nor its zone maps. Positions restart at 0, so stale
keys past ``pos`` are masked, but the stale ``kmin``/``kmax`` of a refilled
slot still widen its blocks' bounds and so change which blocks the prune
reads.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import Dataset, MDRQEngine, RangeQuery
from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops
from repro_torch.serve.serve_step import greedy_sample, make_serve_step

REQUEST_FEATURES = ["priority", "prompt_len", "deadline_ms", "est_cost"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new: int
    features: np.ndarray          # (4,) float32
    output: Optional[np.ndarray] = None


def admission_query(max_cost: float = 0.8,
                    min_priority: float = 0.2) -> RangeQuery:
    return RangeQuery.partial(len(REQUEST_FEATURES),
                              {0: (min_priority, 1.0), 3: (0.0, max_cost)})


class BatchServer:
    """Fixed-slot continuous batcher over a decode model.

    ``device`` (None means ``cuda``) holds the cache and the admission
    engine; the model and its parameters must be on it.
    """

    def __init__(self, model, params, slots: int = 4, max_len: int = 256,
                 device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, server on "
                             f"{self.device}")
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.cfg = model.cfg
        self.cache = model.init_cache(slots, max_len, model.dtype)
        self.step_fn = make_serve_step(model)
        self.pos = np.zeros((slots,), np.int32)
        self.active: list[Optional[Request]] = [None] * slots
        self.remaining = np.zeros((slots,), np.int32)
        self.gen: list[list[int]] = [[] for _ in range(slots)]
        self.to_feed: list[list[int]] = [[] for _ in range(slots)]
        self.done: list[Request] = []

    # -- admission ------------------------------------------------------------
    @staticmethod
    def admit(requests: list[Request], query: RangeQuery, device=None,
              backend: str = "auto") -> list[Request]:
        """MDRQ admission filter over the pending queue (on ``device``; None
        means ``cuda``)."""
        if not requests:
            return []
        feats = Dataset(np.stack([r.features for r in requests]).T)
        eng = MDRQEngine(feats, structures=("scan",), device=device,
                         backend=backend)
        ids = eng.query(query, method="scan_vertical")
        return [requests[i] for i in ids]

    # -- slot management --------------------------------------------------------
    def _fill_slot(self, s: int, req: Request) -> None:
        self.active[s] = req
        self.remaining[s] = req.max_new
        self.gen[s] = []
        self.to_feed[s] = list(req.prompt.tolist())
        self.pos[s] = 0
        # The slot's cache region is not reset: positions restart, and the
        # full cache is masked by pos, so stale keys beyond pos are never
        # attended to (stale zone maps still widen the block bounds).

    def serve(self, requests: list[Request],
              query: Optional[RangeQuery] = None) -> list[Request]:
        """Run until all admitted requests complete; returns finished list."""
        queue = self.admit(requests, query or admission_query(), self.device,
                           self.model.backend)
        queue = queue[::-1]  # pop from the end
        while queue or any(a is not None for a in self.active):
            for s in range(self.slots):
                if self.active[s] is None and queue:
                    self._fill_slot(s, queue.pop())
            toks = np.zeros((self.slots, 1), np.int32)
            for s in range(self.slots):
                if self.active[s] is None:
                    continue
                if self.to_feed[s]:
                    toks[s, 0] = self.to_feed[s].pop(0)
                else:
                    toks[s, 0] = self.gen[s][-1]
            logits, self.cache = self.step_fn(
                self.params, self.cache,
                torch.as_tensor(toks, device=self.device),
                torch.as_tensor(self.pos, device=self.device))
            # counted host sync: the decode loop's per-step device->host read
            nxt = ops.device_get(greedy_sample(logits, self.cfg.vocab_size))[:, 0]
            for s in range(self.slots):
                if self.active[s] is None:
                    continue
                self.pos[s] += 1
                if not self.to_feed[s]:  # prompt consumed -> generating
                    self.gen[s].append(int(nxt[s]))
                    self.remaining[s] -= 1
                    if self.remaining[s] <= 0 or self.pos[s] >= self.max_len - 1:
                        req = self.active[s]
                        req.output = np.asarray(self.gen[s], np.int32)
                        self.done.append(req)
                        self.active[s] = None
        return self.done
