"""mdrqlint for the PyTorch/CUDA port — AST-based static checks of the
port's runtime invariants, and its launch/host-sync budget certificate.

Ports ``repro/analysis/``. The engine's claim holds only because every hot
path keeps hand-maintained invariants: one counted op + one *counted* host
sync per bucket, dtype-correct padding sentinels, lock-disciplined version
swaps, frozen (hashable) registry entries, device values crossing serving
threads only through the backlog queue. The runtime counter asserts of the
port's tests fire only on the paths a test exercises; this package checks
the same invariants syntactically over the whole package, and
``analysis.budget`` derives the launch/sync budget statically into
``BUDGET_torch.json``, whose leaves equal the reference's ``BUDGET.json``.

Usage (from the repository root)::

    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch
    PYTHONPATH=src python -m repro_torch.analysis --budget BUDGET_torch.json
    PYTHONPATH=src python -m repro_torch.analysis --budget-check BUDGET_torch.json

Per-line suppression: append ``# mdrqlint: disable=<rule>[,<rule>...] —
<reason>`` (or ``disable=all``) to the offending line. Accepted legacy debt
lives in ``baseline.json`` next to this package (empty); a run fails only on
unsuppressed, unbaselined findings. The rules are tabulated in ``rules.py``.

Nothing here imports torch: the lint and the certifier are stdlib ``ast``.
"""
from repro_torch.analysis.budget import certify
from repro_torch.analysis.engine import (Finding, Report, Rule, load_baseline,
                                         run, write_baseline)
from repro_torch.analysis.rules import ALL_RULES

__all__ = ["ALL_RULES", "Finding", "Report", "Rule", "certify",
           "load_baseline", "run", "write_baseline"]
