#!/usr/bin/env python3
"""Time the pipelined MDRQ server's stream schemes against each other on
one card, and run ``chip_smoke.py``'s serving phases alone.

    python3 tools/pipeline_ab.py [--n N] [--turns 4] [--out FILE.json]

Builds GMRQB (``chip_smoke.N`` records x 19, seed 0) into the engine under
test and the plain-backend engine, runs ``chip_smoke``'s ``server``,
``calibrate`` and ``pipeline`` phases (every check of theirs applies), then
serves the pipeline phase's two streams — ``PIPE_COUNT_QUERIES`` Count
queries and the first ``PIPE_IDS_QUERIES`` of them under Ids, windows of
``PIPE_BATCH``, backlog ``PIPE_BACKLOG`` — in turns through:

  * ``sync``: ``MDRQServer`` (one thread, the default stream);
  * ``streams``: ``PipelinedMDRQServer`` as shipped (launch and copy on
    streams of their own, the copy after the window's event);
  * ``default``: the same server with both stages on the default stream
    (window k's copy queues behind window k+1's kernels).

Turn order ``streams, default, default, streams`` (each turn runs ``sync``
first). Every result of every run must equal ``query_batch``'s over the same
windows. Per run: wall seconds from the first submit to the last result,
qps, ``finalize_seconds`` and its share of the wall. Also the host
seconds of ``MDRQEngine.launch_batch`` for one window on an idle card and
right behind another window's launch (the device stage of window k+1 meets
window k's kernels still queued). Prints one JSON line and writes it to
``--out``. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))
sys.path.insert(0, str(HERE))


def serve(srv, qs, timeout):
    t0 = time.perf_counter()
    tickets = [srv.submit(q) for q in qs]
    if hasattr(srv, "drain"):
        srv.drain(timeout)
        got = [t.result(timeout=timeout) for t in tickets]
    else:
        srv.flush()
        got = [t.result() for t in tickets]
    return got, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("pipeline_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import Count, Ids, MDRQEngine
    from repro_torch.data import gmrqb
    from repro_torch.kernels import _build
    from repro_torch.serve import MDRQServer, PipelinedMDRQServer

    class DefaultStreamServer(PipelinedMDRQServer):
        """Both stages on the default stream."""

        @staticmethod
        def _stage_streams(device):
            return None

    smi = cs.nvidia_smi_line()
    print(f"  {smi}; torch {torch.__version__}", flush=True)
    n = args.n or cs.N
    _build.build()   # before any phase, so no phase times nvcc
    t0 = time.perf_counter()
    ds = gmrqb.build(n, seed=cs.SEED)
    eng = MDRQEngine(ds, tile_n=cs.TILE_N)
    eng_plain = MDRQEngine(ds, tile_n=cs.TILE_N, backend="torch")
    queries = [q for _, q in gmrqb.mixed_workload(ds, 128, seed=cs.SEED)]
    oracle = cs.Oracle(eng, ds.cols, queries)
    print(f"  data: n={n}, {time.perf_counter() - t0:.1f} s", flush=True)
    with cs.phase("server"):
        cs.server_phase(eng, ds)
    with cs.phase("calibrate"):
        cs.calibrate_phase(eng, eng_plain, oracle, queries)
    with cs.phase("pipeline"):
        cs.pipeline_phase(eng, ds)
    del eng_plain

    stream = [q for _, q in gmrqb.mixed_workload(ds, cs.PIPE_COUNT_QUERIES,
                                                 seed=cs.SEED)]
    cases = {"count": (Count(), stream),
             "ids": (Ids(), stream[:cs.PIPE_IDS_QUERIES])}
    want = {}
    for kind, (spec, qs) in cases.items():
        want[kind] = []
        for i in range(0, len(qs), cs.PIPE_BATCH):
            want[kind] += eng.query_batch(qs[i:i + cs.PIPE_BATCH],
                                          method="auto", spec=spec)
    # One window's device stage on an idle card, and right behind another's.
    window = stream[:cs.PIPE_BATCH]
    behind = {"idle": [], "behind": []}
    for _ in range(cs.TIMED_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = eng.launch_batch(window, spec=Count())
        behind["idle"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        second = eng.launch_batch(window, spec=Count())
        behind["behind"].append(time.perf_counter() - t0)
        cs.check(first.finalize() == second.finalize() == want["count"][
            :cs.PIPE_BATCH], "launch_batch windows != query_batch")
    behind = {k: float(sorted(v)[len(v) // 2]) for k, v in behind.items()}
    print(f"  launch_batch host seconds, one Count window: idle card "
          f"{behind['idle']:.5f}, right behind another window "
          f"{behind['behind']:.5f}", flush=True)

    order = (["streams", "default", "default", "streams"] * args.turns)[
        :args.turns]
    runs = []
    for turn, scheme in enumerate(order):
        for kind, (spec, qs) in cases.items():
            kw = dict(max_batch=cs.PIPE_BATCH, max_wait_s=float("inf"),
                      spec=spec)
            sync = MDRQServer(eng, **kw)
            got, sync_s = serve(sync, qs, cs.PIPE_TIMEOUT_S)
            cs.check(all(cs.same_result(spec, x, y)
                         for x, y in zip(got, want[kind])),
                     f"{kind} sync != query_batch")
            cls = PipelinedMDRQServer if scheme == "streams" \
                else DefaultStreamServer
            srv = cls(eng, backlog=cs.PIPE_BACKLOG,
                      latency_budget_s=cs.PIPE_TIMEOUT_S,
                      warmup=kind == "count", **kw)
            try:
                got, pipe_s = serve(srv, qs, cs.PIPE_TIMEOUT_S)
            finally:
                srv.close(cs.PIPE_TIMEOUT_S)
            cs.check(all(cs.same_result(spec, x, y)
                         for x, y in zip(got, want[kind])),
                     f"{kind} {scheme} != query_batch")
            st = srv.stats
            run = {"turn": turn, "scheme": scheme, "spec": kind,
                   "queries": len(qs), "sync_s": sync_s, "pipe_s": pipe_s,
                   "sync_qps": len(qs) / sync_s, "pipe_qps": len(qs) / pipe_s,
                   "ratio": sync_s / pipe_s,
                   "finalize_s": st.finalize_seconds,
                   "wall_s": st.wall_seconds,
                   "finalize_share": st.finalize_seconds / st.wall_seconds,
                   "stream_scheme": srv.stream_scheme}
            runs.append(run)
            print(f"  turn {turn} {scheme:<8} {kind:<5} sync "
                  f"{run['sync_qps']:10.1f} qps, pipelined "
                  f"{run['pipe_qps']:10.1f} qps (x{run['ratio']:.3f}), "
                  f"finalize share {run['finalize_share']:.3f}", flush=True)
    out = {"device": smi, "n": n, "launch_s": behind, "runs": runs}
    line = json.dumps(out)
    print(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
