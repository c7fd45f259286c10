"""Roofline terms of a dry-run cell, for one NVIDIA H100 per rank.

Three terms per (arch x shape x mesh) cell, as the reference's dry run
reports them (``benchmarks/roofline.py`` there, with TPU constants; the
port keeps its own):

  compute    = FLOPs per device / PEAK_FLOPS
  memory     = bytes per device / HBM_BW
  collective = collective bytes per device / LINK_BW
               (an all-reduce counted twice: reduce and broadcast halves
               of a ring)

The FLOPs, bytes and collective bytes are what ``launch.dryrun`` counts on
rank 0's local shard ops.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense bf16 without sparsity, at the full 700 W
# power limit (the figure PERF.md's kernel table uses).
PEAK_FLOPS = 989.4e12
# NVIDIA H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s.
HBM_BW = 3.35e12
# Assumed layout: 8 cards per node joined by NVLink, nodes joined by one
# NDR InfiniBand port (400 Gb/s = 50 GB/s) per card. A 16-wide mesh axis
# spans two nodes, so its collectives are bound by the InfiniBand link.
LINK_BW = 50e9

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "broadcast")


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collectives: dict[str, int]  # result bytes per collective kind

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.collectives.values()))

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        ar2 = self.collectives.get("all-reduce", 0)
        return (self.collective_bytes + ar2) / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def summary(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes,
            "collectives_by_op": dict(self.collectives),
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def model_flops(cfg, tokens: float, train: bool) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); forward-only = 2*N*D."""
    mult = 6.0 if train else 2.0
    return mult * cfg.param_counts()["active"] * tokens
