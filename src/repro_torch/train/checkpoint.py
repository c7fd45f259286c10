"""Checkpointing: atomic commits, async writes, CRC-checked restore.

Ports ``repro/train/checkpoint.py``. Layout: ``<dir>/step_<N>/`` holding one
``arrays.npz`` (the flattened tree, key = the tree path: dict keys and list
indices joined by ``/``) and ``manifest.json`` (step, each key's shape and
dtype, the CRC-32 of the npz). Commit protocol: write into
``step_<N>.tmp``, then ``os.rename`` — readers only ever see complete
checkpoints, so a preemption mid-write can never corrupt the restore path.
bfloat16 arrays are stored as their raw uint16 bits, the manifest keeping
the logical dtype, as the reference stores them.

Device tensors reach the host through one counted ``ops.device_get`` per
save, taken before ``save_async`` hands the host arrays to its writer
thread: training goes on while the file is written, and ``wait()`` joins
before the next save or at shutdown.

``restore(step, like, device=...)`` rebuilds the port's tree (dicts, lists,
tensors, numpy arrays, Python numbers) in the structure of ``like``, each
tensor on ``device`` (default: the device of ``like``'s leaf). The
reference's ``shardings`` argument re-shards onto a TPU mesh; one device
has nothing to re-shard. A ``like`` that is a sub-tree of what was saved
(``{"params": ...}``) restores that part alone. The port's trees list the
layers, so a key reads ``params/layers/3/attn/wq`` where the reference's
stacked tree has one ``params/layers/attn/wq`` array: the two packages'
checkpoints do not load into each other.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import ops


def _items(tree):
    if isinstance(tree, dict):
        return tree.items()
    if isinstance(tree, (list, tuple)):
        return enumerate(tree)
    return None


def _flatten_with_paths(tree, prefix: str = "") -> dict[str, Any]:
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    flat: dict[str, Any] = {}
    for k, v in items:
        flat.update(_flatten_with_paths(v, f"{prefix}/{k}" if prefix
                                        else str(k)))
    return flat


def _map_with_paths(tree, fn: Callable[[str, Any], Any], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_paths(v, fn, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_paths(v, fn, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _host_flat(state) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """The flattened state as host arrays (bfloat16 as raw uint16 bits) and
    each key's logical dtype. Every tensor crosses in one counted
    ``ops.device_get``."""
    flat = _flatten_with_paths(state)
    keys = [k for k, v in flat.items() if isinstance(v, torch.Tensor)]
    tensors = [flat[k].detach() for k in keys]
    dtypes = {k: str(t.dtype).removeprefix("torch.")
              for k, t in zip(keys, tensors)}
    host = dict(zip(keys, ops.device_get(
        [t.view(torch.int16) if t.dtype == torch.bfloat16 else t
         for t in tensors]))) if keys else {}
    raw = {}
    for k, v in flat.items():
        if k in host:
            raw[k] = host[k].view(np.uint16) \
                if dtypes[k] == "bfloat16" else host[k]
        else:
            raw[k] = np.asarray(v)
            dtypes[k] = str(raw[k].dtype)
    return raw, dtypes


def _crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            crc = zlib.crc32(chunk, crc)
    return crc


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step: int, state: Any) -> str:
        """Synchronous atomic save of a tree of tensors, arrays and
        numbers."""
        return self._write(step, *_host_flat(state))

    def _write(self, step: int, raw: dict, dtypes: dict) -> str:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        npz_path = os.path.join(tmp, "arrays.npz")
        np.savez(npz_path, **raw)
        manifest = {
            "step": step,
            "keys": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                     for k, v in raw.items()},
            "crc32": _crc(npz_path),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()
        return final

    def save_async(self, step: int, state: Any) -> None:
        """Fetch to host (one counted sync), then write on a background
        thread."""
        self.wait()
        raw, dtypes = _host_flat(state)

        def work():
            try:
                self._write(step, raw, dtypes)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, device=None,
                verify: bool = True) -> Any:
        """Restore into the structure of ``like`` (values replaced): a
        tensor leaf becomes a tensor of its dtype on ``device`` (None: the
        leaf's own device), a numpy leaf an array of its dtype, a Python
        number a number of its type."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        npz_path = os.path.join(d, "arrays.npz")
        if verify and manifest["crc32"] != _crc(npz_path):
            raise IOError(f"checkpoint {d} failed crc verification")
        with np.load(npz_path) as data:
            def leaf(key: str, lk):
                arr = data[key]
                shape = tuple(getattr(lk, "shape", ()))
                if arr.shape != shape:
                    raise ValueError(f"{key}: checkpoint shape {arr.shape} "
                                     f"!= {shape}")
                if isinstance(lk, torch.Tensor):
                    dev = lk.device if device is None else device
                    if manifest["keys"][key]["dtype"] == "bfloat16":
                        t = torch.as_tensor(arr.view(np.int16), device=dev
                                            ).view(torch.bfloat16)
                    else:
                        t = torch.as_tensor(arr, device=dev)
                    return t.to(lk.dtype)
                if isinstance(lk, (np.ndarray, np.generic)):
                    return arr.astype(lk.dtype)
                return type(lk)(arr)
            return _map_with_paths(like, leaf)
