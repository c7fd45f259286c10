#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check every result.

    python3 chip_smoke.py        # from the root of a checkout, on a CUDA machine

Phases, one status line each; any failed check raises and the script exits
non-zero without printing a result:

  1. device  — require CUDA (no fallback); print the card's name and power
               limit as nvidia-smi reports them.
  2. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``.
  3. data    — GMRQB, 10 M records x 19 attributes (seed 0); the engine under
               test and a second engine running the plain PyTorch versions
               (``backend="torch"``) on the same card, each with the
               reference's four structures — the columnar scan, the kd-tree,
               the STR R*-tree and the VA-file, each padded to
               (24, 10,000,384) float32 on the card (the trees permuted), plus
               the VA-file's packed codes — and the row-major scan
               (``rowscan=True``: (10,000,384, 24) float32). The two engines
               build side by side on two host threads; each build's time is
               printed.
  4. kernels — each hand kernel against its plain version at the main paths'
               shapes (Q = 1 and Q = 128, with the ``m`` and ``rows``
               arguments ``ColumnarScan`` passes, each scan also timed
               without them; the columnar scans also at the scan bucket
               ``auto`` makes of the B = 128 batch and at Q = 8, printed
               but not listed in the kernels line, whose launch counts are
               per kernel; the visit kernel at the visit lists the kd-tree
               and the VA-file prune the 128-query workload to, each row's
               real and padded visits printed; the row-major scan at Q = 1):
               masks exactly equal, aggregates within float32 summation
               tolerance, repeated sums bit-identical; CUDA-event times of
               the kernel, its plain version and, where one exists, the
               one-call PyTorch equivalent. The bound of a compare kernel
               counts two compares per object per (query or visit, real dim
               its query constrains) — the full scan and the visits also one
               finiteness test per object per real row read — at the compare
               issue rate (``COMPARES_PER_CLOCK_PER_SM``; printed with its
               source), the others' operations at ``PEAK_F32_OPS_PER_S``.
  5. slice   — the main path: ``MDRQEngine.query_batch(method="auto")`` on the
               GMRQB mixed workload at B in {1, 8, 32, 128} under Ids, Count,
               Mask, two TopK and three Agg specs, plus ``engine.query`` singles.
               Every result equals the plain-backend engine's; a sample equals
               the numpy oracle; each bucket costs its path's budget (a scan
               bucket 1 fused launch + 1 host sync, a two-phase bucket 1 prune
               or filter + 1 fused visit launch + 2 host syncs); every kernel
               of the scan path was launched.
  6. index   — the two-phase paths: ``query_batch(method=m)`` for m in kdtree,
               rstar, vafile at B in {8, 128} under the same eight specs (Ids
               and Mask at B in {8, 32}: they are host-bound, and B=128 would
               take minutes), and ``engine.query`` singles (ids and Count) on
               each. The same checks, and every visit and VA-filter kernel was
               launched (each path's launches printed; the VA-file list's
               visit row counts the vafile path's alone).
  7. server  — ``MDRQServer(max_batch=64).serve_all`` on 256 queries under
               Count, against ``query_batch``; the host cost of the op
               layer's warm-key record per counted call.
  8. calibrate — trace -> audit -> calibrate: the 128 mixed queries under
               Count on each plannable path by name and under ``auto`` at
               B in {1, 8, 32, 128} (each shape warmed, then traced); the
               drift audit of both trace sets; ``auto`` B = 128's plan and
               execute-span seconds, its per-bucket breakdown (host launch,
               device, wait, copy, finalize) and the device ops of one
               B = 128 batch by ``auto``, ``scan`` and ``scan_vertical``
               (``torch.profiler``); ``Planner.calibrate`` on every trace's
               sample and its report; ``auto`` at B in {8, 128} under the
               placeholder and the fitted constants (warm qps and
               ``method_counts``, every result equal to the plain engine's,
               each bucket at its budget) beside each path by name; the
               constants restored and ``auto`` planning as before. The scan,
               visit and VA-filter kernels were launched.
  9. pipeline — 2,048 Count queries of the mixed workload (seed 0), then the
               first 256 under Ids, in windows of 128 through
               ``MDRQServer`` and ``serve_pipelined(backlog=4)``: every
               result equal to the synchronous server's and to
               ``query_batch`` over the same windows, the same op counts,
               no new warm key after ``warmup()`` (Count), shedding at a
               1 us latency budget and serving again, correctly, once it
               is raised; qps of both, finalize share, flush reasons, the
               warmup report and the stream scheme. The scan kernels were
               launched.
 10. dist    — horizontal partitioning: ``MDRQEngine(structures=("scan",),
               mesh=...)`` over the data phase's GMRQB at D = 1 (cuda:0) and
               D = 8 (cuda:0 listed eight times: 8 shards of 1,250,304
               objects), and a D = 8 engine on the plain backend.
               ``query_batch`` by ``scan`` and ``auto`` at B in {1, 8, 128}
               under Count, two TopK and three Agg, Ids and Mask at B in
               {8, 32}, and ``engine.query`` singles (ids and Count): every
               result equal to the unmeshed engine's scan and the plain
               meshed engine's, a sample to numpy, repeated sums
               bit-identical; one ``distributed_multi_reduce`` (or one
               ``distributed_mask`` / ``distributed_count``) + one host sync
               per bucket and single, and D launches of the scan kernel.
               ``MDRQServer`` (256 Count queries) and ``serve_pipelined`` on
               the D = 8 engine equal to ``query_batch``. Then 10,000 rows
               appended and 10,000 ids deleted (tombstones in every shard)
               on the D = 8 engine and its plain twin: B = 128 (Ids and
               Mask 32, as in the delta phase) under the eight specs
               against each other and numpy over the live rows,
               then ``compact()`` (the mesh kept) and the same checks.
               Printed: each mesh's layout, warm qps of Count, Agg sum and
               TopK d3 at B = 128 beside the unmeshed ``scan``, the merge's
               device ms, peak memory.
 11. rowscan — the row-major scan path: ``query_batch(method="rowscan")`` at
               B = 8 under the eight specs (one ``range_scan_rows`` launch and
               one host sync per query) and singles; the same checks, and
               ``range_scan_rows`` was launched.
 12. budget:frozen — the launch/host-sync budget of ``BUDGET_torch.json``
               on the card. First the detector: under
               ``torch.cuda.set_sync_debug_mode("warn")`` a planted pageable
               upload and an ``.item()`` must be seen, a pinned non-blocking
               upload and ``ops.device_get`` (whose transfer runs with the
               mode lifted) must not. Then each certified path by name
               (``scan``, ``scan_vertical``, ``kdtree``, ``rstar``,
               ``vafile``) under Count, Agg sum and TopK d3 at B = 128 and
               Ids at B = 32 (host-bound), each warmed: ``launch_batch``'s
               host ms on an idle card and behind one launched batch of the
               same path, beside the device ms of its work (CUDA events);
               then ``launch_batch`` and ``finalize`` with the counters reset
               and the detector on. Gates: the counted launches and syncs of
               each stage equal the certificate's, no synchronizing CUDA
               call outside ``ops.device_get`` in either stage (each one
               printed with its call site), every result equal to the plain
               engine's. Tracing stays off. Readings beside the gates, for
               the host waits the detector cannot see: what PyTorch's
               caching allocators made during the call behind a batch (new
               pinned host blocks, new device segments, allocation retries)
               and the interpreter's gc ms; on ``scan`` and
               ``scan_vertical`` (not Ids) ``BEHIND_CALLS`` more calls, each
               launched while every batch before it is still in flight,
               twice (first and second meeting of each queue depth): each
               call's host ms, first and median, the same allocator and gc
               readings, and the device events of a batch
               (``torch.profiler`` over 3 batches).
 13. delta   — the mutable plane. Through ``MDRQServer.append``/``delete``
               on the engine under test (a query submitted before and after
               each call must see exactly the writes before it) and directly
               on the plain engine: 100,000 fresh GMRQB rows appended (seed 1,
               1% of the base), then 100,000 base ids and 10,000 of the new
               ids deleted (numpy seed 1). Every method at B = 128 (Ids and
               Mask at 32: host-bound, ~2.5 s a call at 128) and the row
               scan at B = 8, under the eight specs, against the plain
               engine, 16 queries against numpy over the live rows, each
               bucket at its frozen budget; warm qps of Count, Agg sum and
               TopK d3 per path, frozen and under the delta; the tombstone
               fold's time.
 14. budget:delta — the budget phase again, under the live delta.
 15. compact — ``compact()`` on both engines, side by side on two host
               threads (id map, version 1, seconds, peak device memory),
               then the delta phase's checks again.
 16. examples — ``ColumnarScan.mask_batch``, ``mask_batch_partial`` and
               ``count_batch`` (also ``partial=True``) at B = 128 of the
               workload on the compacted engine: equal to the plain
               engine's, 16 queries equal to ``numpy_scan_ids``, one
               counted op and one host sync per call, no synchronizing CUDA
               call outside ``ops.device_get``. Then both engines are freed
               and each port example (``examples/quickstart_torch.py``,
               ``gmrqb_demo_torch.py``, ``batched_queries_torch.py``) runs
               its ``main`` on cuda:0 at its default size: its own asserts
               hold (every path, batch form and spec agree), and it launched
               a scan, a visit and a VA-filter kernel; its wall seconds and
               kernel launches are printed. Then the two LM examples:
               ``train_lm_torch.py`` (demo preset, 20 steps: finite logged
               losses) and ``serve_lm_torch.py`` (120 warm-up steps, 12
               requests: the served ids are those whose features satisfy
               its admission query in numpy, 8 tokens each), each launching
               an admission kernel (row 5, 6 or 8).
 17. lm      — the LM decode-serving path, after both engines are freed.
               Qwen3-8B at full width, 4 of its 36 layers (d_model 4096,
               random bf16 weights from a torch.Generator, seed 0):
               ``BatchServer(slots=4, max_len=1024)`` serves 8 requests
               (seed 0; prompts of 4-15 tokens, 16 new tokens) through the
               MDRQ admission filter with ``kv_block_prune=4``,
               ``kv_block_size=32`` (``launch.serve --kv-prune 4``); every
               admitted request completes at its length, with the logits
               (within ``LOGIT_ATOL``) and token ids of the same server on
               the plain backend, up to the first step whose plain top-2
               logit margin is under twice that step's logit difference.
               Then 8 more requests (seed 1; prompts of 40-120 tokens, 24
               new, all admitted): positions cross blocks 0-4, refilled
               slots decode on stale zone maps (both must be reached).
               Both sets are replayed teacher-forced on the plain backend:
               logits within ``LOGIT_ATOL`` at every generated token, greedy
               tokens equal where the plain top-2 margin is at least 2 *
               ``TOKEN_TIE``, and a planted fault (the last listed block
               dropped in every call; its replay's launches are not
               counted) must be rejected. Then long-context
               decode: B = 4 at 32,768 slots, blocks of 512 keys,
               16 of 64 kept, K/V caches from a generator (seed 1), positions
               32,759 - 64 b (the last block partial), 8 teacher-forced steps
               on each backend on its own cache copy: every kernel call
               (here and in the server) within ``KV_RTOL`` of its plain
               version on the same inputs, every visit list the top 16 by a
               numpy stable sort of its bounds, logits within
               ``LOGIT_ATOL``, layer-0 visit lists of the two backends
               equal; warm ms per step and tokens/s with the kernel and
               with ``kv_block_prune=0`` on the same state; a profile of
               three steps (device busy over device events, the idle share
               against the warm step without the profiler, top ops,
               ``kv_visit_attention``'s device ms per step);
               ``kv_visit_attention`` on the inputs of one more step's
               layer-0 call: against its plain version, int32 against int64
               ids and positions, two planted faults (which the ``KV_RTOL``
               check must reject), one device kernel per call, eager,
               device and host time, and ``scaled_dot_product_attention``
               over the whole cache; and the same times at the server shape
               (the multi-block set's call with the most valid keys).
 18. lm_families — every family's decode-serving path, one model at a
               time (random bf16 weights from a torch.Generator, seed 0),
               each freed before the next, all at full width and cut in
               depth: deepseek-moe-16b at 4 of 28 layers (int8 cache,
               prune 4 of 32 blocks of 32 keys), arctic-480b at 1 of 35,
               llava-next-34b at 4 of 60, h2o-danube-1.8b at 3 of 24 (int8,
               its 4,096-slot window), recurrentgemma-2b at 5 of 26 (one
               group and the tail), mamba2-780m at 4 of 48 and
               seamless-m4t-large-v2 at 3 of 24 decoder layers (its 24
               encoder layers; its cross cache filled from seeded stub
               frame embeddings, max_len // 4 of them). Each serves the lm
               phase's multi-block set (8 requests, prompts 40-120, 24
               new) through ``BatchServer(slots=4, max_len=1024)``, every
               kernel call held against its plain version, and is replayed
               teacher-forced on the plain backend (``teacher_forced_check``;
               an MoE replay takes the served run's expert ids, and prints
               per MoE layer how many its own top-k would have changed);
               printed: parameter GB, peak memory, ms per step, the tokens
               that agree. h2o-danube then decodes positions 4,090-4,100
               across its ring's wrap (each step writes slot pos % 4096
               alone). deepseek-moe-16b then decodes the long context: B = 4
               at 32,768 slots, 16 of 64 blocks of 512, int8, 8 steps on
               both backends, warm step times pruned and on the full int8
               cache, and the int8 instance's row on the last step's
               layer-0 call: against its plain version and the bf16
               instance on the dequantized cache, a planted fault,
               its time beside the bf16 instance's and the
               gather-and-dequantize route's; then its error and time at
               the server shape (the served call with the most valid keys).
 19. train   — the training path. (a) ``launch.train`` for smollm-360m at
               full width on cuda:0: 10 steps of batch 8 x seq 512, one
               checkpoint at step 10 under ``build/chip_train`` (removed
               after): every logged loss finite, step 10's below step 1's,
               the admission filter launched row 5, 6 or 8 and admitted the
               ids of a plain-backend engine on the same features; printed:
               ms/step (median of steps 2-10), tokens/s, peak allocated GB,
               the model-FLOP share (``train_flops`` over the step time x
               989.4 TFLOP/s dense bf16) beside the nvidia-smi line. (b)
               ``launch.serve --ckpt-dir`` (``--kv-prune 4``) loads step 10
               and serves 8 requests with the tokens of a ``BatchServer`` on
               the trainer's final parameters, ``kv_visit_attention``
               launched. (c) ``prefill``'s last-token logits against
               ``decode_step`` over the same 64-token prompts (B = 2) within
               ``LOGIT_ATOL``. (d) At the reduced config, a
               ``SimulatedPreemption`` at step 25 with checkpoints every 10
               ends at step 35 with the loss and parameters of an
               uninterrupted run bit for bit, under
               ``torch.use_deterministic_algorithms(True)``. (e)
               deepseek-moe-16b at its published widths (d 2048, 64 experts
               top-6 + 2 shared, vocab 102,400), 2 of its 28 layers, and
               (f) seamless-m4t-large-v2 at its published widths and depth
               (24 + 24 layers, d 1024, vocab 256,206 tied, 128 stub frames
               a row), (g) mamba2-780m (48 layers, d 1536, two SSD chunks of
               256) and (h) recurrentgemma-2b (d 2560, vocab 256,000
               tied; 23 = 7 x 3 + 2 of its 26 layers, for the card's
               memory), each ``TRAIN_FAMILY_STEPS`` (6) Trainer steps of 8
               x 512 on the MDRQ-filtered pipeline, all at published widths
               and at published depth but (e) and (h); no checkpoint: finite
               losses, the last step's below step 1's, the MoE's aux loss
               positive and finite at every step (zero for the others), an
               admission kernel launched; printed as (a) (the model FLOPs
               of the active parameters, the encoder's tokens, the SSD's
               chunked products and the local-attention layers,
               ``train_flops``). (e) then serves 8 requests from the
               trained parameters with an int8 cache pruned to 4 of 32-key
               blocks, every ``kv_visit_attention[int8]`` call within
               ``KV_RTOL`` of its plain version; (f) - (h) hold prefill
               against decode as (c) (the encoder-decoder after
               ``fill_cross_cache``); (g) and (h) also on a float32 copy of
               the trained parameters: the float32 forms within
               ``PREFILL_F32_ATOL`` of each other, each bf16 path within
               ``LOGIT_ATOL`` of its float32 counterpart (mamba2's bf16
               arms, the pair included, within ``PREFILL_SSM_BF16_ATOL``).
               The training path's launches are added to the kernel rows
               they name.

The last three lines are the kernel table (JSON), the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

N = 10_000_000
SEED = 0
TILE_N = 1024
BATCH_SIZES = (1, 8, 32, 128)
INDEX_METHODS = ("kdtree", "rstar", "vafile")
INDEX_BATCH_SIZES = (8, 128)
HOST_BOUND_BATCH_SIZES = (8, 32)   # Ids and Mask on the two-phase paths
HOST_CHECK_BATCH = 32     # Ids and Mask under a delta, after a compaction
DELTA_METHODS = ("scan", "scan_vertical", "kdtree", "rstar", "vafile", "auto")
ROWSCAN_BATCH = 8
DELTA_ROWS = 100_000      # appended: 1% of the base
DELTA_BASE_DEAD = 100_000
DELTA_NEW_DEAD = 10_000
# warm query_batch calls per qps cell, median kept: one (three before), for
# the script's time (the cell's checks run on a call of their own)
TIMED_CALLS = 1
ORACLE_SAMPLE = 16        # queries per (B, spec) checked against numpy
N_SINGLES = 8             # engine.query singles on the main path
SERVER_QUERIES = 256
TIMING_REPS = 10
# The calibrate phase: the plannable paths traced by name (and "auto"), at
# BATCH_SIZES; "auto" rerun under the fitted constants at these sizes.
CAL_METHODS = ("scan", "scan_vertical", "kdtree", "rstar", "vafile")
REFIT_BATCH_SIZES = (8, 128)
# The pipeline phase: one stream served synchronously and pipelined.
PIPE_BATCH = 128
PIPE_BACKLOG = 4
PIPE_COUNT_QUERIES = 2048
PIPE_IDS_QUERIES = 256
PIPE_TIMEOUT_S = 300.0    # any wait on the finalizer; also the main budget
# The dist phase: meshes of D shards on the card (a mesh listing cuda:0 D
# times); reduced specs at DIST_BATCH_SIZES, Ids and Mask at the host-bound
# sizes; writes that put tombstones in every shard.
DIST_SHARDS = (1, 8)
DIST_BATCH_SIZES = (1, 8, 128)
DIST_SERVER_QUERIES = 256
DIST_DELTA_ROWS = 10_000
DIST_DELTA_DEAD = 10_000  # 9,000 base ids and 1,000 of the new rows
# float32 sums taken in different orders (kernel tree vs torch vs numpy
# pairwise) over non-negative values: relative difference bound.
AGG_SUM_RTOL = 1e-5
# The budget phase: each certified path by name, frozen and under the delta.
BUDGET_METHODS = ("scan", "scan_vertical", "kdtree", "rstar", "vafile")
BUDGET_BATCH = 128
BUDGET_IDS_BATCH = 32     # Ids is host-bound (the (Q, n) mask crosses)
# launch_batch calls timed behind in-flight batches on the scan paths (gap
# 1): each call while every batch before it is still on the card.
BEHIND_METHODS = ("scan", "scan_vertical")
BEHIND_CALLS = 4
# The port's MDRQ examples, each run at its default size, and the kernels
# each must launch (the scans, the visits, the VA filter).
EXAMPLES = ("quickstart_torch", "gmrqb_demo_torch", "batched_queries_torch")
# the LM examples: train_lm_torch for a short run of its demo preset, then
# serve_lm_torch as it is; each runs the admission filter (ADMISSION_KERNELS)
LM_EXAMPLE_STEPS = 20
EXAMPLE_KERNELS = (("range_scan_tiles", "multi_scan_tiles"),
                   ("range_scan_visit", "multi_scan_visit"),
                   ("va_filter_packed", "multi_va_filter_packed"))
COLUMNAR_BATCH = 128
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 rate outside
# the tensor cores, for the bound column. The VA filter's 32-bit logical
# operations are counted against the float32 rate too (the data sheet states
# no int32 rate outside the tensor cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# The compare rows' operations term (the scan, visit and row-scan kernels):
# two float32 compares per (object, query, compared dim), which issue at 64
# results per clock per SM on compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput table, row "compare, minimum,
# maximum"; the 67e12 above counts an FFMA, at 128 per clock, as two
# operations). The rate is that times the card's SMs and its
# ``clocks.max.sm`` as nvidia-smi reports it.
COMPARES_PER_CLOCK_PER_SM = 64
COMPARE_RATE_SOURCE = ("CUDA C++ Programming Guide, arithmetic instruction "
                       "throughput, compute capability 9.0: compare, "
                       "minimum, maximum = 64 per clock per SM")

# -- the LM phase --
LM_ARCH = "qwen3_8b"
# Qwen3-8B at full width, cut to 4 of its 36 layers: the lm_families
# phase needed the time, and the kernel's shapes per layer, the server's and
# the long context's, are the same at any depth
LM_LAYERS = 4
LM_SEED = 0
LM_REQUESTS, LM_SLOTS, LM_MAX_LEN, LM_MAX_NEW = 8, 4, 1024, 16
LM_PRUNE, LM_BLOCK = 4, 32          # what launch.serve --kv-prune 4 sets
# The multi-block request set: prompts of 40-120 tokens and 24 new tokens, so
# positions cross blocks 0-4 of 32 keys; every request admitted, 8 on 4 slots,
# so refilled slots decode on their predecessors' zone maps.
LM_MB_REQUESTS, LM_MB_PROMPT, LM_MB_NEW = 8, (40, 121), 24
LONG_B, LONG_SLOTS, LONG_BLOCK, LONG_PRUNE = 4, 32_768, 512, 16
LONG_STEPS = 8
LONG_TIMED_STEPS = 10
# -- the lm_families phase: (arch, config changes), full width; the cuts in
# depth are arctic-480b's (1 of 35 layers: 128 experts of 3 x 7168 x 4864
# bf16 weights each, 28 GB) and, to keep the script inside its time with the
# train phase after it, every other model's: the host-bound decode's time
# grows with depth, while each layer's shapes, kernel calls and checks are
# the same at any depth (recurrentgemma-2b keeps one (rec, rec, attn) group
# and its two-layer tail; seamless-m4t-large-v2 its 24 encoder layers);
# deepseek, llava, h2o, mamba2 and seamless run at half their earlier
# depths, for the script's time --
FAMILY_SEED = 0
FAMILIES = (
    ("deepseek_moe_16b", dict(n_layers=4, kv_cache_int8=True,
                              kv_block_prune=LM_PRUNE,
                              kv_block_size=LM_BLOCK)),
    ("arctic_480b", dict(n_layers=1, kv_cache_int8=True,
                         kv_block_prune=LM_PRUNE, kv_block_size=LM_BLOCK)),
    ("llava_next_34b", dict(n_layers=4, kv_block_prune=LM_PRUNE,
                            kv_block_size=LM_BLOCK)),
    ("h2o_danube_1_8b", dict(n_layers=3, kv_cache_int8=True)),
    ("recurrentgemma_2b", dict(n_layers=5)),
    ("mamba2_780m", dict(n_layers=4)),
    ("seamless_m4t_large_v2", dict(n_layers=3)),
)
# h2o-danube's 4,096-slot ring: positions 4,090-4,100 cross its wrap
RING_POS0, RING_STEPS = 4090, 11
# The kernel against its plain version on the same bf16 inputs: both sides
# accumulate in float32 and round the output once to bf16, so they may differ
# by one bf16 ulp of a value, at most 2**-7 of the largest |output|. The limit
# is two such ulps of the largest |plain output| of the call. kv_visit_row
# plants two faults at the long-context shape (the last listed block dropped;
# the keys of the partial 128-key tile masked) and requires the check to
# reject each (readings in PERF.md).
KV_RTOL = 2.0 ** -6
# End to end, both backends compute in bf16 and differ only where the
# attention output rounds, but a one-ulp difference in one layer grows
# through the layers of a random-init network (and through the caches the
# steps write): on an H100 the two backends' logits come out 0.08 (server) to
# 0.18 (long context) apart at |logit| < 5 (PERF.md). The kernel's own
# faults are caught per call (KV_RTOL); this limit bounds the drift of the
# whole path.
LOGIT_ATOL = 0.5
# The teacher-forced token check: with both backends fed one token stream,
# the kernel's greedy token must equal the plain backend's wherever the plain
# top-2 margin is at least 2 * TOKEN_TIE. A backend whose logits are within
# TOKEN_TIE of the plain ones cannot pick another token there; the two
# backends' logits drift 0.08-0.18 apart on an H100 (PERF.md), so a sound
# kernel stays clear of it, while a fault that moves logits by more than
# TOKEN_TIE (even within LOGIT_ATOL) is seen at every decisive step it flips.
# (The margin test against each step's own logit difference can never fail:
# margin >= 2 d forces the same argmax.)
TOKEN_TIE = 0.25


# -- the train phase: launch.train at smollm-360m's full width --
TRAIN_ARCH = "smollm_360m"
# 10 steps (20 before), for the script's time
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 10, 8, 512
TRAIN_DIR = ROOT / "build" / "chip_train"     # git-ignored; removed after
TRAIN_DEVICE = "cuda:0"
# the admission filter's kernels (kernel table rows 5, 6 and 8): the planner
# picks one of them for the pipeline's partial-match query
ADMISSION_KERNELS = ("range_scan_tiles", "range_scan_vertical",
                     "range_scan_visit")
TRAIN_SERVE_REQUESTS, TRAIN_SERVE_NEW = 8, 16
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), for the step's
# model-FLOP share
PEAK_BF16_FLOPS = 989.4e12
# Prefill's last-token logits against a decode of the same prompt, bf16 at
# full width: the two compute the same function, but the full-sequence
# attention and the one-token decode round to bf16 in other places, and the
# difference grows through 32 layers; the bound is LOGIT_ATOL's, for the
# same drift of a whole path (the reading is printed)
PREFILL_B, PREFILL_LEN = 2, 64
# The scan families' float32 arm of that check: the same trained parameters
# in float32 through both forms, which compute one function; on an H100 the
# two came out 4.9e-5 (mamba2-780m, 48 layers) and 9.5e-6
# (recurrentgemma-2b, 23 layers) apart at |logit| <= 10 (PERF.md)
PREFILL_F32_ATOL = 1e-3
# mamba2-780m's bf16 arms of that check (bf16 prefill against bf16 decode,
# each bf16 path against float32) in place of LOGIT_ATOL: each bf16 path
# drifts from the float32 function with depth, both forms alike (the float32
# forms agree to 4.9e-5), prefill 0.063 / 0.10 / 0.27 / 0.48 at 1 / 8 / 23 /
# 48 layers, the pair 0.51 at 48; a fault planted in the chunked SSD's
# intra-chunk decay (one step too long, or its diagonal dropped) reads
# 3.55-3.67 on each arm at 48 layers. On an H100 (tools/prefill_probe.py,
# PERF.md), so the limit has 2.5x room above the sound reading and 2.8x
# below the faulted one
PREFILL_SSM_BF16_ATOL = 1.25
# Preemption and resume at the reduced config: the CPU test's schedule
RESUME_STEPS, RESUME_EVERY, RESUME_AT, RESUME_SEQ = 35, 10, 25, 48
# The train phase's parts for the other families: published widths, bf16,
# random weights (seed 0), TRAIN_BATCH x TRAIN_SEQ through the Trainer on the
# MDRQ-filtered pipeline, no checkpoint (a full-width save would be 12-42
# GB; the round trip of these trees is held on the CPU): (arch, config
# changes). deepseek-moe-16b is cut to 2 of its 28 layers (1.60 B
# parameters, ~25.5 GB of weights and AdamW state); seamless-m4t-large-v2
# keeps all 24 + 24 (1.77 B, ~28 GB; its stub frames are the reference's
# max(8, seq // 4)); mamba2-780m all 48 layers (two SSD chunks of 256);
# recurrentgemma-2b 23 of its 26 layers, 7 (rec, rec, attn) groups of 8 and
# the two-layer tail (2.43 B; its 2,048-key local window covers the 512
# positions): at all 26 (2.66 B) the step peaked at 80.38 GB allocated of
# the H100's 85.02 GB (the old and the new weights and AdamW state are
# alive together in the functional update), too little room after twenty
# earlier phases; at 23, 73.39 GB (PERF.md section 4)
TRAIN_FAMILIES = (("deepseek_moe_16b", dict(n_layers=2)),
                  ("seamless_m4t_large_v2", {}),
                  ("mamba2_780m", {}),
                  ("recurrentgemma_2b", dict(n_layers=23)))
# Trainer steps of each of those parts: a median of 5 timed steps; 6 (10
# before), for the script's time
TRAIN_FAMILY_STEPS = 6


class CheckFailed(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    yield
    print(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def side_by_side(fn, other):
    """``fn()`` here while ``other()`` runs on a second thread -> (both
    results). For the two engines' host-bound builds and compactions, whose
    numpy sorts and copies release the GIL; nothing is timed across them."""
    out: dict = {}

    def run():
        try:
            out["value"] = other()
        except BaseException as e:  # re-raised on this thread
            out["error"] = e
    thread = threading.Thread(target=run)
    thread.start()
    try:
        value = fn()
    finally:
        thread.join()
    if "error" in out:
        raise out["error"]
    return value, out["value"]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


@functools.cache
def compare_rate() -> float:
    """Float32 compares per second the card can issue (see
    ``COMPARES_PER_CLOCK_PER_SM``); read once, printed with its source."""
    mhz = max_sm_clock_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = COMPARES_PER_CLOCK_PER_SM * sms * mhz * 1e6
    print(f"  compare rate: {COMPARES_PER_CLOCK_PER_SM} x {sms} SMs x "
          f"{mhz:.0f} MHz (clocks.max.sm) = {rate:.4e}/s "
          f"({COMPARE_RATE_SOURCE})", flush=True)
    return rate


def time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float,
             rate: float = PEAK_F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def same_result(spec, a, b) -> bool:
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.shape == b.shape \
            and np.array_equal(a, b)
    if spec.kind == "agg":
        if np.isnan(a) or np.isnan(b):
            return bool(np.isnan(a) and np.isnan(b))
        if spec.op == "sum":
            return abs(a - b) <= AGG_SUM_RTOL * abs(b)
    return a == b


def expected_counts(eng, buckets, spec, delta: bool) -> dict[str, int]:
    """The budget of one ``query_batch`` over these buckets ({path: size}),
    as ``ops.counters()`` reports it — the same with or without a live delta
    (the delta scan rides each bucket's fused op): a scan bucket is 1 fused
    launch + 1 host sync; a two-phase bucket is 1 prune (filter) + its
    survivors' sync, then 1 fused visit launch + its payload's sync — unless
    nothing survived, when the visit launch and its sync are skipped (under
    a delta they become one delta-only scan and its sync); the row scan is
    one ``range_scan_rows`` + 1 host sync per query (+ 1 ``mask_counts``
    per query for a frozen Count)."""
    scan_ops = {"scan": "multi_scan_reduce",
                "scan_vertical": "multi_scan_vertical_reduce"}
    want: dict[str, int] = {}

    def add(name, k=1):
        want[name] = want.get(name, 0) + k
    for meth, size in buckets.items():
        if meth == "rowscan":
            add("range_scan_rows", size)
            add("host_sync", size)
            if spec.kind == "count" and not delta:
                add("mask_counts", size)
            continue
        add("host_sync")
        if meth in scan_ops:
            add(scan_ops[meth])
            continue
        add("multi_va_filter" if meth == "vafile" else "prune_hierarchy_batch")
        if getattr(eng, meth).last_visited_blocks:
            add("multi_visit_reduce")
            add("host_sync")
        elif delta:
            add("multi_scan_reduce")
            add("host_sync")
    return want


class Oracle:
    """Numpy ground truth: matching ids per query (cached), and each spec's
    result from them. On the trees, TopK orders equal values by leaf-order
    position (``inv_perm[id]``), as the reference does; elsewhere by id.

    Under a delta, ``cols`` holds the base columns with the delta rows
    appended, ``alive`` marks the rows not tombstoned and ``n_base`` where
    the delta starts: a tree's TopK is then the reference's merge — its base
    top k (leaf-order ties) and the delta's top k (id ties), re-ranked with
    ties by id."""

    def __init__(self, eng, cols, queries, alive=None, n_base=None):
        self.cols, self.queries = cols, queries
        self.alive, self.n_base = alive, n_base
        self._ids: dict[int, np.ndarray] = {}
        self._inv = {}
        for name in ("kdtree", "rstar"):
            perm = getattr(eng, name).perm
            inv = np.empty_like(perm)
            inv[perm] = np.arange(perm.size)
            self._inv[name] = inv

    def ids(self, i: int) -> np.ndarray:
        from repro_torch.core import match_mask_np
        if i not in self._ids:
            mask = match_mask_np(self.cols, self.queries[i])
            if self.alive is not None:
                mask &= self.alive
            self._ids[i] = np.nonzero(mask)[0].astype(np.int64)
        return self._ids[i]

    def _topk(self, spec, ids, ties):
        vals = self.cols[spec.dim, ids]
        order = np.lexsort((ties, -vals if spec.largest else vals))
        return ids[order[: spec.k]].astype(np.int64)

    def result(self, spec, i: int, method: str):
        ids = self.ids(i)
        if spec.kind != "topk" or method not in self._inv:
            return spec.from_ids(ids, self.cols)
        inv = self._inv[method]
        if self.n_base is None:
            return self._topk(spec, ids, inv[ids])
        base, new = ids[ids < self.n_base], ids[ids >= self.n_base]
        cand = np.concatenate([self._topk(spec, base, inv[base]),
                               self._topk(spec, new, new)])
        return self._topk(spec, cand, cand)


def kernel_phase(eng, queries):
    """Hold each kernel against its plain version; measure all three times."""
    from repro_torch.core import QueryBatch
    from repro_torch.kernels import range_scan

    data = eng.columnar.data_dev
    m_pad = data.shape[0]
    dev = data.device
    rows = []

    def row(name, source, replaces, err, ms, plain_ms, nbytes, ops, lib_ms,
            rate=PEAK_F32_OPS_PER_S, shape=False):
        # shape: another shape of a listed kernel, printed but not listed
        # (the launch counts are per kernel, not per shape)
        b, by = bound_ms(nbytes, ops, rate)
        if not shape:
            rows.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "launches": 0,
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b, "bound_by": by, "library_ms": lib_ms})
        print(f"  {name}: err={err} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b:.4f} ({by}) library_ms={lib_ms}"
              + (" (a shape of a listed kernel)" if shape else ""), flush=True)

    full = QueryBatch.from_queries(queries[:128])
    lo, up = (torch.as_tensor(a, device=dev)
              for a in full.bounds_columnar(m_pad, dtype=np.float32))
    reducer_rows(eng, scan_rows(eng, queries, row), row)

    lo1, up1 = lo[:, :1].contiguous(), up[:, :1].contiguous()
    rows_row(eng, queries, row, got_columnar=range_scan.range_scan_tiles(
        data, lo1, up1, tile_n=TILE_N, **scan_rows_kw(eng, queries[:1])))
    visit_rows(eng, full, queries, row)
    return rows


def reducer_rows(eng, masks, row) -> None:
    """Kernels 3 and 4 on the Q = 128 scan masks (``scan_rows``' return):
    against their plain versions (fills exactly, sums within AGG_SUM_RTOL
    and bit-identical when repeated, min / max exactly), then timed."""
    from repro_torch.kernels import ref, reducers
    data = eng.columnar.data_dev
    n_pad = data.shape[1]
    dev = data.device
    # -- masked_fill_tiles (TopK's front half) on the Q = 128 scan masks --
    values = data[3]
    for q_n in (1, 128):
        got = reducers.masked_fill_tiles(masks[:q_n], values, float("-inf"),
                                         tile_n=TILE_N)
        check(torch.equal(got, ref.masked_fill_ref(masks[:q_n], values,
                                                   float("-inf"))),
              f"masked_fill_tiles Q={q_n} != plain")
        del got
    mask_bool = masks.view(torch.bool)  # the 0/1 int8 masks, reinterpreted
    ninf = torch.tensor(float("-inf"), device=dev)
    q_n = masks.shape[0]
    row("masked_fill_tiles", "src/repro_torch/kernels/csrc/reducers.cu",
        "src/repro/kernels/reducers.py:77", 0.0,
        time_ms(lambda: reducers.masked_fill_tiles(masks, values, float("-inf"),
                                                   tile_n=TILE_N)),
        time_ms(lambda: ref.masked_fill_ref(masks, values, float("-inf"))),
        q_n * n_pad + n_pad * 4 + q_n * n_pad * 4, float(q_n * n_pad),
        time_ms(lambda: torch.where(mask_bool, values, ninf)))

    # -- masked_agg_tiles: sum / min / max, Q = 1 and 128; sums repeatable --
    err = 0.0
    for op in ("sum", "min", "max"):
        for q_n in (1, 128):
            got = reducers.masked_agg_tiles(masks[:q_n], values, op, tile_n=TILE_N)
            want = ref.masked_agg_ref(masks[:q_n], values, op)
            diff = (got - want).abs()
            diff = torch.where(torch.isfinite(want), diff, torch.zeros_like(diff))
            if op == "sum":
                ok = bool((diff <= AGG_SUM_RTOL * want.abs()).all())
                err = max(err, float(diff.max()))
            else:
                ok = torch.equal(got, want)
            check(ok, f"masked_agg_tiles {op} Q={q_n} != plain")
    again = reducers.masked_agg_tiles(masks, values, "sum", tile_n=TILE_N)
    check(torch.equal(again, reducers.masked_agg_tiles(masks, values, "sum",
                                                       tile_n=TILE_N)),
          "masked_agg_tiles sums differ between identical runs")
    q_n = masks.shape[0]
    row("masked_agg_tiles", "src/repro_torch/kernels/csrc/reducers.cu",
        "src/repro/kernels/reducers.py:132", err,
        time_ms(lambda: reducers.masked_agg_tiles(masks, values, "sum",
                                                  tile_n=TILE_N)),
        time_ms(lambda: ref.masked_agg_ref(masks, values, "sum")),
        q_n * n_pad + n_pad * 4 + q_n * (n_pad // 1024) * 4, float(q_n * n_pad),
        None)


def scan_rows_kw(eng, qs, ids_np=None) -> dict:
    """What ``ColumnarScan`` passes the scan wrappers beyond the reference's
    arguments for the queries ``qs``: ``m=`` and ``rows=`` (the dims any
    query constrains) to the full scan, ``rows=`` (the distinct dims of
    ``ids_np``) to the vertical one."""
    from repro_torch.core import QueryBatch
    if ids_np is None:
        return {"m": eng.columnar.m,
                "rows": int(QueryBatch.from_queries(qs).dims_mask.any(axis=0).sum())}
    return {"rows": int(np.unique(ids_np).size)}


def compared_dims(lo, up, m: int) -> np.ndarray:
    """Per query, the real dims its full-scan bounds constrain: a dim whose
    bounds are the float32 extrema is open (its compare holds exactly for
    the finite values, which one test per object settles)."""
    fmax = float(np.finfo(np.float32).max)
    lo, up = lo[:m].cpu().numpy(), up[:m].cpu().numpy()
    return (~((lo == -fmax) & (up == fmax))).sum(axis=0)


def scan_compares(lo, up, m: int) -> tuple[int, int]:
    """(constrained, all) (query, real dim) pairs of full-scan bounds."""
    return int(compared_dims(lo, up, m).sum()), m * lo.shape[1]


def scan_rows(eng, queries, row):
    """Kernels 1, 2, 5 and 6, the columnar scans: ``multi_scan_tiles`` at the
    first 128 queries (all their bounds), at the scan bucket ``auto`` makes
    of the B = 128 mixed batch and at Q = 8; ``multi_scan_vertical`` at the
    partial-match queries among the first 128 (pow2-padded: the B = 128
    vertical bucket) and among the first 8 partial ones; both at Q = 1.
    Each against its plain version (masks exactly equal), then timed; the
    bucket shapes are printed, not listed (``shape=True``). Operations: two
    compares per object per (query, distinct compared real dim), plus one
    finiteness test per object per real row for the full scan, at
    ``compare_rate()``. Each full or vertical scan is also timed without
    the ``m`` / ``rows`` hints (the reference's call). Returns the Q = 128
    full-scan masks."""
    from repro_torch.core import Count, QueryBatch
    from repro_torch.core.scan import bucketed_batch_bounds
    from repro_torch.core.types import next_pow2
    from repro_torch.kernels import multi_scan, range_scan, ref

    data = eng.columnar.data_dev
    m = eng.columnar.m
    m_pad, n_pad = data.shape
    dev = data.device
    rate = compare_rate()
    scan_src = "src/repro_torch/kernels/csrc/scan.cu"

    eng.query_batch(queries[:128], method="auto", spec=Count())
    plan = eng.last_batch_stats.methods
    scan_b = [q for q, meth in zip(queries[:128], plan) if meth == "scan"]
    partial = [q for q in queries[:128] if not q.is_complete_match]
    vert_b = [q for q, meth in zip(queries[:128], plan)
              if meth == "scan_vertical"]
    print(f"  auto at B=128: {len(scan_b)} scan, {len(vert_b)} scan_vertical "
          f"(the vertical bucket is the 128-query row's batch: "
          f"{vert_b == partial})", flush=True)

    def tiles_row(name, qs, bucket, shape=False):
        if bucket:
            _, lo, up = bucketed_batch_bounds(QueryBatch.from_queries(qs),
                                              m_pad, data.dtype, dev)
        else:
            lo, up = (torch.as_tensor(a, device=dev) for a in
                      QueryBatch.from_queries(qs).bounds_columnar(m_pad))
        q_n = lo.shape[1]
        kw = scan_rows_kw(eng, qs)
        got = multi_scan.multi_scan_tiles(data, lo, up, tile_n=TILE_N, **kw)
        check(torch.equal(got, ref.multi_scan_ref(data, lo, up)),
              f"{name} Q={q_n} != plain")
        pairs, every = scan_compares(lo, up, m)
        print(f"  {name}: Q={q_n}, {pairs} of {every} (query, real dim) "
              f"pairs constrained; every real dim compared would bound it at "
              f"{2.0 * every * n_pad / rate * 1e3:.4f} ms", flush=True)
        row(name, scan_src, "src/repro/kernels/multi_scan.py:73", 0.0,
            time_ms(lambda: multi_scan.multi_scan_tiles(data, lo, up,
                                                        tile_n=TILE_N, **kw)),
            time_ms(lambda: ref.multi_scan_ref(data, lo, up)),
            m * n_pad * 4 + q_n * n_pad + 2 * m_pad * q_n * 4,
            (2.0 * pairs + m) * n_pad, None, rate, shape)
        no_hint(name, kw, lambda: multi_scan.multi_scan_tiles(
            data, lo, up, tile_n=TILE_N))
        return got

    def no_hint(name, kw, fn):
        hints = ", ".join(f"{k}={v}" for k, v in kw.items())
        print(f"  {name} without {hints}: ms={time_ms(fn):.4f}", flush=True)

    def vertical_row(name, qs, shape=False):
        batch = QueryBatch.from_queries(qs)
        q_pad, lo, up = bucketed_batch_bounds(batch, m_pad, data.dtype, dev)
        ids_np = batch.padded_dim_ids(q_pad)
        ids = torch.as_tensor(ids_np, device=dev)
        vkw = scan_rows_kw(eng, qs, ids_np)
        got = multi_scan.multi_scan_vertical(data, ids, lo, up, tile_n=TILE_N,
                                             **vkw)
        check(torch.equal(got, ref.multi_scan_vertical_ref(data, ids, lo, up)),
              f"{name} Q={q_pad} != plain")
        del got
        union = np.unique(ids_np).size
        listed = sum(np.unique(r).size for r in ids_np)
        print(f"  {name}: Q={q_pad}, D_max={ids_np.shape[1]}, {listed} "
              f"distinct (query, dim) pairs, {union} rows", flush=True)
        row(name, scan_src, "src/repro/kernels/multi_scan.py:144", 0.0,
            time_ms(lambda: multi_scan.multi_scan_vertical(data, ids, lo, up,
                                                           tile_n=TILE_N,
                                                           **vkw)),
            time_ms(lambda: ref.multi_scan_vertical_ref(data, ids, lo, up)),
            union * n_pad * 4 + q_pad * n_pad + ids.numel() * 4
            + 2 * m_pad * q_pad * 4,
            2.0 * listed * n_pad, None, rate, shape)
        no_hint(name, vkw, lambda: multi_scan.multi_scan_vertical(
            data, ids, lo, up, tile_n=TILE_N))

    # -- multi_scan_tiles: the first 128 queries; Q = 1 checked here too --
    one = QueryBatch.from_queries(queries[:1])
    lo1, up1 = (torch.as_tensor(a, device=dev)
                for a in one.bounds_columnar(m_pad))
    kw = scan_rows_kw(eng, queries[:1])
    check(torch.equal(multi_scan.multi_scan_tiles(data, lo1, up1,
                                                  tile_n=TILE_N, **kw),
                      ref.multi_scan_ref(data, lo1, up1)),
          "multi_scan_tiles Q=1 != plain")
    masks = tiles_row("multi_scan_tiles", queries[:128], bucket=False)
    if scan_b:
        tiles_row("multi_scan_tiles[B=128 scan bucket]", scan_b, bucket=True,
                  shape=True)
    tiles_row("multi_scan_tiles[Q=8]", queries[:8], bucket=False, shape=True)

    # -- multi_scan_vertical: Q = 1 checked, the B = 128 bucket, Q = 8 --
    pq = partial[0]
    b1 = QueryBatch.from_queries([pq])
    ids1 = torch.as_tensor(b1.padded_dim_ids(), device=dev)
    vlo, vup = (torch.as_tensor(a, device=dev)
                for a in b1.bounds_columnar(m_pad))
    check(torch.equal(multi_scan.multi_scan_vertical(data, ids1, vlo, vup,
                                                     tile_n=TILE_N),
                      ref.multi_scan_vertical_ref(data, ids1, vlo, vup)),
          "multi_scan_vertical Q=1 != plain")
    vertical_row("multi_scan_vertical", partial)
    vertical_row("multi_scan_vertical[Q=8]", partial[:8], shape=True)

    # -- range_scan_tiles / range_scan_vertical: Q = 1 --
    got = range_scan.range_scan_tiles(data, lo1, up1, tile_n=TILE_N, **kw)
    check(torch.equal(got, ref.range_scan_ref(data, lo1, up1)),
          "range_scan_tiles != plain")
    pairs, _ = scan_compares(lo1, up1, m)
    row("range_scan_tiles", scan_src, "src/repro/kernels/range_scan.py:71",
        0.0,
        time_ms(lambda: range_scan.range_scan_tiles(data, lo1, up1,
                                                    tile_n=TILE_N, **kw)),
        time_ms(lambda: ref.range_scan_ref(data, lo1, up1)),
        m * n_pad * 4 + n_pad + 2 * m_pad * 4, (2.0 * pairs + m) * n_pad,
        None, rate)
    no_hint("range_scan_tiles", kw, lambda: range_scan.range_scan_tiles(
        data, lo1, up1, tile_n=TILE_N))
    dims = torch.as_tensor(np.nonzero(pq.dims_mask)[0].astype(np.int32),
                           device=dev)
    d = dims.long()
    got = range_scan.range_scan_vertical(data, dims, vlo, vup, tile_n=TILE_N)
    check(torch.equal(got, ref.range_scan_ref(data[d], vlo[d, 0], vup[d, 0])),
          "range_scan_vertical != plain")
    row("range_scan_vertical", scan_src, "src/repro/kernels/range_scan.py:142",
        0.0,
        time_ms(lambda: range_scan.range_scan_vertical(data, dims, vlo, vup,
                                                       tile_n=TILE_N)),
        time_ms(lambda: ref.range_scan_ref(data[d], vlo[d, 0], vup[d, 0])),
        dims.numel() * n_pad * 4 + n_pad + dims.numel() * 12,
        2.0 * dims.numel() * n_pad, None, rate)
    return masks


def rows_row(eng, queries, row, got_columnar=None):
    """Kernel 11: the row-major scan at Q = 1 on the row scan's (10,000,384,
    24) copy, against its plain version — and against the columnar scan's
    mask of the same query (same data, other layout), where given."""
    from repro_torch.kernels import ops, range_scan, ref

    rs = eng.rowscan
    data = rs.data_dev
    n_pad, m_pad = data.shape
    lo, up = ops.query_bounds_device(queries[0], m_pad, data.dtype, data.device)
    lo, up = lo.T.contiguous(), up.T.contiguous()
    got = range_scan.range_scan_rows(data, lo, up, tile_rows=rs.tile_rows)
    check(torch.equal(got, ref.range_scan_rows_ref(data, lo, up)),
          "range_scan_rows != plain")
    check(got_columnar is None or torch.equal(got, got_columnar),
          "range_scan_rows != the columnar scan's mask")
    print(f"  row scan: data {tuple(data.shape)}, query 0 matches "
          f"{int(got.sum())} rows", flush=True)
    row("range_scan_rows", "src/repro_torch/kernels/csrc/rows.cu",
        "src/repro/kernels/range_scan.py:190", 0.0,
        time_ms(lambda: range_scan.range_scan_rows(data, lo, up,
                                                   tile_rows=rs.tile_rows)),
        time_ms(lambda: ref.range_scan_rows_ref(data, lo, up)),
        n_pad * m_pad * 4 + n_pad + 2 * m_pad * 4,
        (2.0 * int(compared_dims(lo.reshape(-1, 1), up.reshape(-1, 1),
                                 rs.m)[0]) + rs.m) * n_pad, None,
        compare_rate())


def visit_rows(eng, full, queries, row):
    """Kernels 7-10: the visit kernel at the kd-tree's and the VA-file's
    visit lists for the 128-query workload (and the kd-tree's for one
    query), the VA filter at Q = 128 and 1.

    The visit rows are bounded as the full scan is: bytes, each distinct
    visited block's real rows read once and the whole padded output written
    once; operations, two compares per object of each real visit per real
    dim its query constrains, plus one finiteness test per object per real
    row of each distinct visited block (what rejects +inf and NaN where the
    query leaves a dim open), at ``compare_rate()``."""
    from repro_torch.core import blockindex
    from repro_torch.core.types import next_pow2
    from repro_torch.kernels import multi_scan, range_scan, ref, va_filter

    kd = eng.kdtree
    data = kd.data_dev
    m_pad, n_pad = data.shape
    dev = data.device
    blocks = range_scan.blocks_view(data, TILE_N)
    q_n = len(full)
    qlo, qhi = (torch.as_tensor(a, device=dev)
                for a in full.bounds_columnar(kd.m, q_n))
    leaf = blockindex.prune_hierarchy_batch(kd.levels_lo, kd.levels_hi, qlo,
                                            qhi, fanout=kd.fanout)
    qids_np, bids_np = np.nonzero(leaf.cpu().numpy())
    real_v = int(qids_np.size)
    qids_p, bids_p = blockindex._pad_visit_list(qids_np.astype(np.int32),
                                                bids_np.astype(np.int32))
    qids = torch.as_tensor(qids_p, device=dev)
    bids = torch.as_tensor(bids_p, device=dev)
    lo, up = (torch.as_tensor(a, device=dev)
              for a in full.bounds_columnar(m_pad, q_n, np.float32))
    n_vis = qids.numel()
    distinct = int(np.unique(bids_np).size)
    m = kd.m
    cdims = compared_dims(lo, up, m)
    pairs = int(cdims[qids_np].sum())
    print(f"  kdtree visits for Q={q_n}: {real_v} (padded {n_vis}), "
          f"{distinct} distinct of {n_pad // TILE_N} blocks; {pairs} "
          f"(visit, constrained real dim) pairs of {real_v * m}", flush=True)
    got = multi_scan.multi_scan_visit(data, qids, bids, lo, up, tile_n=TILE_N)
    check(torch.equal(got, ref.multi_scan_blocks_ref(blocks, qids, bids, lo, up)),
          f"multi_scan_visit V={n_vis} != plain")
    del got
    row("multi_scan_visit", "src/repro_torch/kernels/csrc/visit.cu",
        "src/repro/kernels/multi_scan.py:206", 0.0,
        time_ms(lambda: multi_scan.multi_scan_visit(data, qids, bids, lo, up,
                                                    tile_n=TILE_N)),
        time_ms(lambda: ref.multi_scan_blocks_ref(blocks, qids, bids, lo, up)),
        distinct * m * TILE_N * 4 + n_vis * TILE_N + n_vis * 8
        + 2 * m_pad * q_n * 4,
        (2.0 * pairs + m * distinct) * TILE_N, None, compare_rate())

    # -- multi_scan_visit at the VA-file's list for the same 128 queries --
    va = eng.vafile
    vq, vb = va._candidate_blocks_batch(full)
    vqids_p, vbids_p = blockindex._pad_visit_list(vq, vb)
    vqids = torch.as_tensor(vqids_p, device=dev)
    vbids = torch.as_tensor(vbids_p, device=dev)
    vdata = va.data_dev
    vblocks = range_scan.blocks_view(vdata, TILE_N)
    v_real, v_pad = int(vq.size), vqids.numel()
    v_distinct = int(np.unique(vb).size)
    v_pairs = int(cdims[vq].sum())
    print(f"  vafile visits for Q={q_n}: {v_real} (padded {v_pad}), "
          f"{v_distinct} distinct of {n_pad // TILE_N} blocks; {v_pairs} "
          f"(visit, constrained real dim) pairs of {v_real * m}", flush=True)
    got = multi_scan.multi_scan_visit(vdata, vqids, vbids, lo, up, tile_n=TILE_N)
    check(torch.equal(got, ref.multi_scan_blocks_ref(vblocks, vqids, vbids, lo,
                                                     up)),
          f"multi_scan_visit V={v_pad} (VA-file list) != plain")
    del got
    row("multi_scan_visit[vafile]", "src/repro_torch/kernels/csrc/visit.cu",
        "src/repro/kernels/multi_scan.py:206", 0.0,
        time_ms(lambda: multi_scan.multi_scan_visit(vdata, vqids, vbids, lo, up,
                                                    tile_n=TILE_N)),
        time_ms(lambda: ref.multi_scan_blocks_ref(vblocks, vqids, vbids, lo,
                                                  up)),
        v_distinct * m * TILE_N * 4 + v_pad * TILE_N + v_pad * 8
        + 2 * m_pad * q_n * 4,
        (2.0 * v_pairs + m * v_distinct) * TILE_N, None, compare_rate())

    # -- range_scan_visit: Q = 1, the kd-tree's survivors of one query --
    q0 = queries[0]
    b1 = np.nonzero(leaf[0].cpu().numpy())[0].astype(np.int32)
    ids1 = np.full((next_pow2(b1.size),), -1, np.int32)
    ids1[: b1.size] = b1
    ids1 = torch.as_tensor(ids1, device=dev)
    lo1, up1 = lo[:, :1].contiguous(), up[:, :1].contiguous()
    zeros = torch.zeros_like(ids1)
    got = range_scan.range_scan_visit(data, ids1, lo1, up1, tile_n=TILE_N)
    check(torch.equal(got, ref.multi_scan_blocks_ref(blocks, zeros, ids1, lo1,
                                                     up1)),
          "range_scan_visit != plain")
    print(f"  kdtree visits for query 0 ({q0.n_queried_dims} dims, "
          f"{int(cdims[0])} constrained): {b1.size} (padded {ids1.numel()})",
          flush=True)
    row("range_scan_visit", "src/repro_torch/kernels/csrc/visit.cu",
        "src/repro/kernels/range_scan.py:248", 0.0,
        time_ms(lambda: range_scan.range_scan_visit(data, ids1, lo1, up1,
                                                    tile_n=TILE_N)),
        time_ms(lambda: ref.multi_scan_blocks_ref(blocks, zeros, ids1, lo1,
                                                  up1)),
        b1.size * m * TILE_N * 4 + ids1.numel() * (TILE_N + 4)
        + 2 * m_pad * 4,
        (2.0 * int(cdims[0]) + m) * TILE_N * b1.size, None, compare_rate())

    # -- multi_va_filter_packed: Q = 128; va_filter_packed: Q = 1 --
    # Operations: four 32-bit logical operations per (query, object, packed
    # word) — the word-parallel test of 16 fields at once.
    packed = va.packed_dev
    w = packed.shape[0]
    clo, chi = (torch.as_tensor(a, device=dev)
                for a in va.query_cells_batch(full, q_n))
    got = va_filter.multi_va_filter_packed(packed, clo, chi, va.m)
    check(torch.equal(got, ref.multi_va_filter_packed_ref(packed, clo, chi, va.m)),
          f"multi_va_filter_packed Q={q_n} != plain")
    print(f"  VA candidates at Q={q_n}: {float(got.float().mean()):.4f} of "
          f"objects; {w} packed words", flush=True)
    del got
    row("multi_va_filter_packed", "src/repro_torch/kernels/csrc/va_filter.cu",
        "src/repro/kernels/va_filter.py:144", 0.0,
        time_ms(lambda: va_filter.multi_va_filter_packed(packed, clo, chi, va.m)),
        time_ms(lambda: ref.multi_va_filter_packed_ref(packed, clo, chi, va.m)),
        w * n_pad * 4 + q_n * n_pad + 2 * clo.numel() * 4,
        4.0 * q_n * n_pad * w, None)
    c1, h1 = clo[:, :1].contiguous(), chi[:, :1].contiguous()
    got = va_filter.va_filter_packed(packed, c1, h1, va.m)
    check(torch.equal(got, ref.va_filter_packed_ref(packed, c1[:, 0], h1[:, 0],
                                                    va.m)),
          "va_filter_packed != plain")
    row("va_filter_packed", "src/repro_torch/kernels/csrc/va_filter.cu",
        "src/repro/kernels/va_filter.py:97", 0.0,
        time_ms(lambda: va_filter.va_filter_packed(packed, c1, h1, va.m)),
        time_ms(lambda: ref.va_filter_packed_ref(packed, c1[:, 0], h1[:, 0],
                                                 va.m)),
        w * n_pad * 4 + n_pad + 2 * c1.numel() * 4, 4.0 * n_pad * w, None)


def result_specs() -> tuple:
    """The eight result specs every query phase runs under."""
    from repro_torch.core import Agg, Count, Ids, Mask, TopK
    return (Ids(), Count(), Mask(), TopK(k=10, dim=3),
            TopK(k=10, dim=4, largest=False), Agg("sum", 3), Agg("min", 2),
            Agg("max", 18))


def run_checked(eng, eng_plain, oracle, qs, method, spec, label,
                delta=False, same_plan=True):
    """One ``query_batch`` under the counters, held against its budget, the
    plain engine (and its plan, unless ``same_plan`` is False: the engine
    under test plans with other constants) and a numpy sample -> (results,
    method_counts)."""
    from repro_torch.kernels import ops
    ops.reset_counters()
    got = eng.query_batch(qs, method=method, spec=spec)
    counts = ops.counters()
    stats = eng.last_batch_stats
    want_counts = expected_counts(eng, stats.method_counts, spec, delta)
    check(counts == want_counts,
          f"{label}: counters {counts} != {want_counts}")
    plain = eng_plain.query_batch(qs, method=method, spec=spec)
    check(not same_plan or eng_plain.last_batch_stats.methods == stats.methods,
          f"{label}: plans differ from the plain engine's")
    for k, (x, y) in enumerate(zip(got, plain)):
        check(same_result(spec, x, y),
              f"{label} query {k}: kernel {x!r} != plain {y!r}")
    for k in range(min(len(qs), ORACLE_SAMPLE)):
        want = oracle.result(spec, k, stats.methods[k])
        check(same_result(spec, got[k], want),
              f"{label} query {k}: {got[k]!r} != oracle {want!r}")
    return got, dict(stats.method_counts)


def warm_qps(eng, qs, method, spec) -> float:
    """Queries per second of ``query_batch``: the median of ``TIMED_CALLS``
    warm calls, host clock (the call ends in its host sync)."""
    times = []
    for _ in range(TIMED_CALLS):
        t0 = time.perf_counter()
        eng.query_batch(qs, method=method, spec=spec)
        times.append(time.perf_counter() - t0)
    return len(qs) / float(np.median(times))


def slice_phase(eng, eng_plain, oracle, queries):
    """The main path, checked against the plain engine and numpy; warm qps
    as in ``warm_qps``."""
    from repro_torch.core import Count

    topk_peak = None
    for b in BATCH_SIZES:
        qs = queries[:b]
        for spec in result_specs():
            if b == 128 and spec.kind == "topk":
                torch.cuda.reset_peak_memory_stats()
            _, buckets = run_checked(eng, eng_plain, oracle, qs, "auto", spec,
                                     f"auto B={b} {spec}")
            if b == 128 and spec.kind == "topk":
                topk_peak = max(topk_peak or 0, torch.cuda.max_memory_allocated())
            qps = warm_qps(eng, qs, "auto", spec)
            print(f"  B={b:<3} {str(spec):<38} warm qps={qps:10.1f} "
                  f"method_counts={buckets}", flush=True)

    # Singles: planned, and on the scans by name (their single-query
    # kernels; "auto" may send a single to a two-phase path).
    k = next(k for k, q in enumerate(queries) if q.is_complete_match)
    for i in (*range(N_SINGLES), k):
        q = queries[i]
        want = oracle.ids(i)
        for method in ("auto", "scan") + (
                () if q.is_complete_match else ("scan_vertical",)):
            check(np.array_equal(eng.query(q, method=method), want),
                  f"single {i} {method}: ids != oracle")
            check(eng.query(q, method=method, spec=Count()) == want.size,
                  f"single {i} {method}: count != oracle")
    return topk_peak


def index_phase(eng, eng_plain, oracle, queries) -> dict:
    """The two-phase paths by name, checked like the main path; warm qps as
    in ``warm_qps``. Returns each path's kernel launches."""
    from repro_torch.core import Count
    from repro_torch.kernels import ops

    by_method = {}
    for method in INDEX_METHODS:
        before = ops.kernel_launches()
        for b in sorted(set(INDEX_BATCH_SIZES) | set(HOST_BOUND_BATCH_SIZES)):
            qs = queries[:b]
            for spec in result_specs():
                host_bound = spec.kind in ("ids", "mask")
                if b not in (HOST_BOUND_BATCH_SIZES if host_bound
                             else INDEX_BATCH_SIZES):
                    continue
                run_checked(eng, eng_plain, oracle, qs, method, spec,
                            f"{method} B={b} {spec}")
                visits = getattr(eng, method).last_visited_blocks
                qps = warm_qps(eng, qs, method, spec)
                print(f"  {method:<6} B={b:<3} {str(spec):<38} warm qps="
                      f"{qps:10.1f} visits={visits}", flush=True)
        for i in range(N_SINGLES):
            want = oracle.ids(i)
            check(np.array_equal(eng.query(queries[i], method=method), want),
                  f"{method} single {i}: ids != oracle")
            check(eng.query(queries[i], method=method, spec=Count())
                  == want.size, f"{method} single {i}: count != oracle")
        after = ops.kernel_launches()
        by_method[method] = {k: v - before.get(k, 0) for k, v in after.items()
                             if v > before.get(k, 0)}
        print(f"  kernel launches on the {method} path: {by_method[method]}",
              flush=True)
    return by_method


def server_phase(eng, ds):
    from repro_torch.core import Count
    from repro_torch.data import gmrqb
    from repro_torch.serve import MDRQServer

    queries = [q for _, q in gmrqb.mixed_workload(ds, SERVER_QUERIES, seed=SEED)]
    srv = MDRQServer(eng, max_batch=64, spec=Count())
    got = srv.serve_all(queries)
    want = eng.query_batch(queries, method="auto", spec=Count())
    check(got == want, "server results != query_batch")
    st = srv.stats
    print(f"  server: {st.n_queries} queries in {st.n_batches} batches, "
          f"qps={st.qps:.1f}, flushes={st.flush_reasons}, "
          f"methods={st.method_counts}", flush=True)
    print(f"  warm-key record: {warm_key_us(eng):.3f} us per counted op "
          f"call (host)", flush=True)


def warm_key_us(eng, calls: int = 20_000) -> float:
    """Host microseconds ``ops.counted`` spends per call on the warm-key
    record (the key of a B = 128 full-scan call, hashed and looked up in
    the warm set); the counter bump it shares a lock with predates it."""
    from repro_torch.core import Count
    from repro_torch.kernels import ops
    data = eng.columnar.data_dev
    bounds = torch.zeros((data.shape[0], 128), device=data.device)
    args = (data, bounds, bounds, None, None)
    kw = dict(spec=Count(), tile_n=TILE_N, m=eng.dataset.m, rows=19,
              backend="auto")
    warm = set(ops.warm_keys())
    t0 = time.perf_counter()
    for _ in range(calls):
        _ = ops.warm_key("multi_scan_reduce", args, kw) in warm
    return (time.perf_counter() - t0) / calls * 1e6


def indented(text: str) -> str:
    return "\n".join("    " + line for line in text.splitlines())


def bucket_breakdown(eng, qs, spec, reps: int = TIMED_CALLS) -> dict:
    """Where one ``auto`` batch's time goes -> {"plan": s, path: {part: s}}.
    Per bucket: the host's preparation and launches (``launch``), the
    card's time from the first to the last queued operation (``device``,
    CUDA events; it includes any gap the host leaves), the host's wait for
    it after launching (``wait``), the counted copy (``copy``) and the host
    finalizer (``finalize``). Medians of ``reps`` warm runs."""
    from repro_torch.core import QueryBatch
    from repro_torch.kernels import ops
    batch = QueryBatch.from_queries(qs)
    runs: dict = {}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        methods = eng.planner.plan_batch(batch, spec=spec).methods
        runs.setdefault("plan", []).append(time.perf_counter() - t0)
        buckets: dict = {}
        for k, meth in enumerate(methods):
            buckets.setdefault(meth, []).append(k)
        for meth, idxs in buckets.items():
            sub = QueryBatch(batch.lower[idxs], batch.upper[idxs])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            payload, fin = eng.paths[meth].launch_batch(sub, spec=spec)
            end.record()
            t1 = time.perf_counter()
            end.synchronize()
            t2 = time.perf_counter()
            host = ops.device_get(payload)
            t3 = time.perf_counter()
            fin(host)
            t4 = time.perf_counter()
            runs.setdefault((meth, len(idxs)), []).append(
                (t1 - t0, start.elapsed_time(end) / 1e3, t2 - t1, t3 - t2,
                 t4 - t3))
    out = {"plan": float(np.median(runs.pop("plan")))}
    for key, rows in runs.items():
        med = np.median(np.asarray(rows), axis=0)
        out[key] = dict(zip(("launch", "device", "wait", "copy", "finalize"),
                            map(float, med)))
    return out


def batch_device_ops(eng, qs, method, spec) -> tuple[float, list]:
    """torch.profiler over one warm ``query_batch`` -> (the summed device
    ms of its device events, [(name, calls, device ms)] by device ms).
    The profiler can drop a device event (``device_kernels``): a reading
    with fewer events than another of the same batch lost some."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng.query_batch(qs, method=method, spec=spec)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.query_batch(qs, method=method, spec=spec)
        torch.cuda.synchronize()
    ops_ms: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            calls, ms = ops_ms.get(e.name, (0, 0.0))
            ops_ms[e.name] = (calls + 1, ms + e.time_range.elapsed_us() / 1e3)
    rows = sorted(((k, c, ms) for k, (c, ms) in ops_ms.items()),
                  key=lambda r: -r[2])
    return sum(ms for _, _, ms in rows), rows


def calibrate_phase(eng, eng_plain, oracle, queries):
    """Trace -> audit -> calibrate on the card, then restore the constants.

    The 128 mixed queries under Count on each plannable path by name and
    under ``auto`` at B in ``BATCH_SIZES`` (each shape warmed, then traced);
    the drift audit of both trace sets; ``auto`` B = 128's plan and
    execute-span seconds, ``bucket_breakdown`` and the device ops of one
    B = 128 batch by ``auto``, ``scan`` and ``scan_vertical`` (profiler);
    the calibration samples
    of every trace fitted by ``Planner.calibrate``; ``auto`` at
    ``REFIT_BATCH_SIZES`` under the placeholder and the fitted constants
    (warm qps, ``method_counts``, every result equal to the plain engine's,
    each bucket at its budget) beside each path by name; then the saved
    constants back, and ``auto`` B = 128 planning as the plain engine does
    again."""
    from repro_torch import obs
    from repro_torch.core import Count

    spec = Count()
    model = eng.planner.model
    saved = dataclasses.asdict(model)
    traces = []
    for method in (*CAL_METHODS, "auto"):
        for b in BATCH_SIZES:
            qs = queries[:b]
            eng.query_batch(qs, method=method, spec=spec)   # warm the shape
            eng.query_batch(qs, method=method, spec=spec, trace=True)
            traces.append((method, eng.last_trace))
    named = [t for m, t in traces if m != "auto"]
    auto = [t for m, t in traces if m == "auto"]
    print("  audit, the paths by name (Count, B in 1, 8, 32, 128):")
    print(indented(obs.audit(named).summary()))
    print("  audit, auto:")
    print(indented(obs.audit(auto).summary()), flush=True)
    bt = auto[-1]
    spans = [s for root in bt.spans for s in root.find("execute")]
    print(f"  auto B=128 traced: plan {bt.plan_seconds * 1e3:.3f} ms of "
          f"{bt.seconds * 1e3:.3f} ms; execute spans " + ", ".join(
              f"{s.attrs['path']} ({s.attrs['bucket']} queries) "
              f"{s.seconds * 1e3:.3f} ms" for s in spans), flush=True)
    parts = bucket_breakdown(eng, queries[:128], spec)
    print(f"  auto B=128 breakdown (median of {TIMED_CALLS}, ms): plan "
          f"{parts.pop('plan') * 1e3:.3f}", flush=True)
    for (meth, size), p in parts.items():
        print(f"    {meth} ({size} queries): " + ", ".join(
            f"{k} {v * 1e3:.3f}" for k, v in p.items()), flush=True)
    for method in ("auto", "scan", "scan_vertical"):
        total, rows = batch_device_ops(eng, queries[:128], method, spec)
        print(f"  device ops of one {method} B=128 Count batch "
              f"(torch.profiler): {total:.3f} ms in "
              f"{sum(c for _, c, _ in rows)} events", flush=True)
        for name, calls, ms in rows[:8]:
            print(f"    {ms:8.3f} ms {calls:3d}x {name[:90]}", flush=True)

    def auto_runs(label, same_plan):
        out = {}
        for b in REFIT_BATCH_SIZES:
            qs = queries[:b]
            _, counts = run_checked(eng, eng_plain, oracle, qs, "auto", spec,
                                    f"calibrate {label} auto B={b}",
                                    same_plan=same_plan)
            out[b] = (warm_qps(eng, qs, "auto", spec), counts)
        return out

    placeholder = auto_runs("placeholder", True)
    by_name = {(m, b): warm_qps(eng, queries[:b], m, spec)
               for m in CAL_METHODS for b in REFIT_BATCH_SIZES}
    samples = obs.calibration_samples([t for _, t in traces], model)
    report = eng.planner.calibrate(samples)
    print(f"  calibrate: {report.n_samples} samples from {report.methods}, "
          f"rms_rel_err {report.rms_rel_err:.4g}", flush=True)
    for f in report.fits:
        print(f"    {f.constant}: fitted {f.fitted:.6g} "
              f"({'accepted' if f.accepted else 'rejected'}: {f.reason}); "
              f"placeholder {saved[f.constant]:.6g}", flush=True)
    try:
        fitted = auto_runs("fitted", False)
    finally:
        for name, value in saved.items():
            setattr(model, name, value)
    for b in REFIT_BATCH_SIZES:
        print(f"  auto B={b:<3} placeholder {placeholder[b][0]:10.1f} qps "
              f"{placeholder[b][1]}; fitted {fitted[b][0]:10.1f} qps "
              f"{fitted[b][1]}", flush=True)
        print("    by name: " + ", ".join(
            f"{m} {by_name[(m, b)]:.1f}" for m in CAL_METHODS), flush=True)
    check(dataclasses.asdict(model) == saved,
          "calibrate: the saved constants were not restored")
    run_checked(eng, eng_plain, oracle, queries, "auto", spec,
                "calibrate restored auto B=128")


def pipeline_phase(eng, ds):
    """The same stream through ``MDRQServer`` and ``serve_pipelined``.

    ``PIPE_COUNT_QUERIES`` Count queries of the mixed workload, then the
    first ``PIPE_IDS_QUERIES`` of them under Ids, in windows of
    ``PIPE_BATCH`` (no deadline flushes, so both servers cut the same
    windows). Gates: every pipelined result equals the synchronous server's
    and ``query_batch``'s over the same windows; the op counters of the
    stream equal the synchronous server's; after ``warmup()`` the Count
    stream adds no warm key; a latency budget far below one window's time
    sheds, and the raised budget serves again, correctly. The Ids server is
    not warmed: the warm batch matches every row, and at 10 M rows its Ids
    would be ~80 MB per query. Returns {spec kind: pipelined / synchronous
    wall qps}.
    """
    from repro_torch.core import Count, Ids
    from repro_torch.data import gmrqb
    from repro_torch.kernels import ops
    from repro_torch.serve import MDRQServer, Overloaded, serve_pipelined

    stream = [q for _, q in gmrqb.mixed_workload(ds, PIPE_COUNT_QUERIES,
                                                 seed=SEED)]
    ratios = {}
    for spec, qs in ((Count(), stream), (Ids(), stream[:PIPE_IDS_QUERIES])):
        label = f"pipeline {spec.kind}"
        want = []
        for i in range(0, len(qs), PIPE_BATCH):
            want += eng.query_batch(qs[i:i + PIPE_BATCH], method="auto",
                                    spec=spec)
        sync = MDRQServer(eng, max_batch=PIPE_BATCH,
                          max_wait_s=float("inf"), spec=spec)
        ops.reset_counters()
        t0 = time.perf_counter()
        got = sync.serve_all(qs)
        sync_wall = time.perf_counter() - t0
        sync_counts = ops.counters()
        check(all(same_result(spec, x, y) for x, y in zip(got, want)),
              f"{label}: synchronous server != query_batch")
        warm = spec.kind == "count"
        srv = serve_pipelined(eng, max_batch=PIPE_BATCH,
                              max_wait_s=float("inf"), spec=spec,
                              backlog=PIPE_BACKLOG,
                              latency_budget_s=PIPE_TIMEOUT_S, warmup=warm)
        try:
            ops.reset_counters()
            ops.reset_trace_log()
            t0 = time.perf_counter()
            tickets = [srv.submit(q) for q in qs]
            srv.drain(PIPE_TIMEOUT_S)
            got = [t.result(timeout=PIPE_TIMEOUT_S) for t in tickets]
            pipe_wall = time.perf_counter() - t0
            counts, new_keys = ops.counters(), ops.trace_log()
            check(len(got) == len(want) and all(
                same_result(spec, x, y) for x, y in zip(got, want)),
                f"{label}: pipelined results != the synchronous server's")
            check(counts == sync_counts,
                  f"{label}: counters {counts} != synchronous {sync_counts}")
            st, ss = srv.stats, sync.stats
            check(st.n_batches == ss.n_batches == -(-len(qs) // PIPE_BATCH),
                  f"{label}: windows {st.n_batches} / {ss.n_batches}")
            n = len(qs)
            print(f"  {label}: {n} queries, {st.n_batches} windows of "
                  f"{PIPE_BATCH}, backlog {PIPE_BACKLOG}, streams: "
                  f"{srv.stream_scheme}; methods {st.method_counts}",
                  flush=True)
            print(f"    sync      qps {ss.qps:10.1f} (busy), "
                  f"{n / sync_wall:10.1f} (wall {sync_wall:.4f} s); "
                  f"plan {ss.plan_seconds:.4f} s", flush=True)
            print(f"    pipelined qps {st.qps:10.1f} (wall_seconds "
                  f"{st.wall_seconds:.4f}), {n / pipe_wall:10.1f} (wall "
                  f"{pipe_wall:.4f} s); busy {st.busy_seconds:.4f} s, "
                  f"plan {st.plan_seconds:.4f} s, finalize "
                  f"{st.finalize_seconds:.4f} s (share of the wall "
                  f"{st.finalize_seconds / st.wall_seconds:.3f}); flushes "
                  f"{st.flush_reasons}; ratio pipelined / sync (wall) "
                  f"{sync_wall / pipe_wall:.3f}", flush=True)
            print(f"    counters per stream (both servers): {counts}",
                  flush=True)
            ratios[spec.kind] = sync_wall / pipe_wall
            if not warm:
                continue
            rep = srv.last_warmup
            print(f"    warmup: {rep.n_runs} runs over {rep.paths}, buckets "
                  f"{rep.bucket_sizes}, vertical dims {rep.dim_counts}, "
                  f"{len(rep.keys)} keys, {rep.seconds:.2f} s; new keys in "
                  f"the stream: {len(new_keys)}", flush=True)
            check(new_keys == (),
                  f"{label}: the warmed stream added keys {new_keys[:4]}")
            srv.latency_budget_s = 1e-6    # far below one window's time
            shed = [srv.submit(q) for q in qs[:PIPE_BATCH]]
            check(srv.stats.shed_counts.get("overloaded", 0) > 0
                  and all(t.shed for t in shed) and srv.n_pending == 0,
                  f"{label}: a 1 us budget shed {srv.stats.shed_counts}")
            with contextlib.suppress(Overloaded):
                shed[0].result(timeout=PIPE_TIMEOUT_S)
                check(False, f"{label}: a shed ticket returned a result")
            srv.latency_budget_s = PIPE_TIMEOUT_S
            tickets = [srv.submit(q) for q in qs[:PIPE_BATCH]]
            srv.drain(PIPE_TIMEOUT_S)
            check(all(same_result(spec, t.result(timeout=PIPE_TIMEOUT_S), y)
                      for t, y in zip(tickets, want)),
                  f"{label}: results after recovery != query_batch")
            print(f"    shed at a 1 us budget: {srv.stats.shed_counts}; "
                  f"recovered at {PIPE_TIMEOUT_S:.0f} s: {PIPE_BATCH} "
                  f"queries served, equal", flush=True)
        finally:
            srv.close(PIPE_TIMEOUT_S)
    return ratios


def dist_specs() -> tuple:
    """The reduced specs of the dist phase (the eight less Ids and Mask)."""
    return tuple(s for s in result_specs() if s.kind not in ("ids", "mask"))


def dist_checked(eng, d, qs, method, spec, label, want, plain, oracle,
                 extra_scans=0):
    """One ``query_batch`` of a meshed engine: one bucket on the sharded
    scan at 1 ``distributed_multi_reduce`` + 1 host sync, ``d`` launches of
    the scan kernel (one per shard; ``extra_scans`` for a delta block), and
    every result equal to ``want`` (the unmeshed scan's), to ``plain`` (the
    plain meshed engine's) and, on a sample, to ``oracle``."""
    from repro_torch.kernels import ops
    ops.reset_counters()
    ops.reset_kernel_launches()
    got = eng.query_batch(qs, method=method, spec=spec)
    counts, launches = ops.counters(), ops.kernel_launches()
    check(counts == {"distributed_multi_reduce": 1, "host_sync": 1},
          f"{label}: counters {counts}")
    check(eng.last_batch_stats.method_counts == {"scan": len(qs)},
          f"{label}: buckets {eng.last_batch_stats.method_counts}")
    check(launches.get("multi_scan_tiles", 0) == d + extra_scans,
          f"{label}: multi_scan_tiles launched "
          f"{launches.get('multi_scan_tiles', 0)} times, not {d}"
          + (f" + {extra_scans}" if extra_scans else ""))
    for k, (x, y, z) in enumerate(zip(got, want, plain)):
        check(same_result(spec, x, y),
              f"{label} query {k}: {x!r} != unmeshed {y!r}")
        check(same_result(spec, x, z),
              f"{label} query {k}: {x!r} != plain meshed {z!r}")
    for k in range(min(len(qs), ORACLE_SAMPLE)):
        w = oracle.result(spec, k, "scan")
        check(same_result(spec, got[k], w),
              f"{label} query {k}: {got[k]!r} != oracle {w!r}")
    return got


def dist_merge_ms(eng, qs) -> dict:
    """CUDA-event ms of the merges on the mesh's first device at this batch
    (Count's sum, Agg sum's sum, TopK d3's final top-k), from the shards'
    partials; the shards' own kernels are not in these times."""
    from repro_torch.core import QueryBatch
    from repro_torch.core import distributed as dist_mod
    from repro_torch.kernels import reducers

    dsc = eng.dist
    mesh = dsc.mesh
    _, lo, up, rows = dsc._batch_bounds(QueryBatch.from_queries(qs))
    masks = dist_mod._distributed_multi_mask(mesh, dsc.shards, lo, up,
                                             **dsc._op_kw(rows))
    counts = [x.ne(0).sum(dim=-1, dtype=torch.int32) for x in masks]
    aggs = [reducers.masked_agg(x, s[3], "sum", tile_n=TILE_N,
                                backend="auto")[0]
            for x, s in zip(masks, dsc.shards)]
    tops = [reducers.masked_topk(x, s[3], 10, True, tile_n=TILE_N,
                                 backend="auto")
            for x, s in zip(masks, dsc.shards)]
    return {
        "count": time_ms(lambda: torch.stack(mesh.gather(counts)).sum(
            dim=0, dtype=torch.int32)),
        "agg sum": time_ms(lambda: torch.stack(mesh.gather(aggs)).sum(dim=0)),
        "topk": time_ms(lambda: reducers.merge_shard_topk(
            [mesh.gather(p) for p in tops], dsc.n_local, 10, True)),
    }


def dist_phase(eng, ds, oracle, queries):
    """Horizontal partitioning: ``MDRQEngine(mesh=...)`` at D shards of the
    card against the unmeshed engine under test, the plain meshed engine
    and numpy; the servers on the eight-shard engine; writes and
    ``compact()``. Returns the launches of the path's kernels."""
    from repro_torch.core import Count, MDRQEngine, make_data_mesh
    from repro_torch.data import gmrqb
    from repro_torch.kernels import ops
    from repro_torch.serve import MDRQServer, serve_pipelined

    torch.cuda.reset_peak_memory_stats()
    dev = eng.device
    meshes = {d: make_data_mesh(device=[dev] * d) for d in DIST_SHARDS}
    t0 = time.perf_counter()
    engines = {d: MDRQEngine(ds, structures=("scan",), tile_n=TILE_N,
                             mesh=meshes[d]) for d in DIST_SHARDS}
    d_max = max(DIST_SHARDS)
    plain = MDRQEngine(ds, structures=("scan",), tile_n=TILE_N,
                       mesh=meshes[d_max], backend="torch")
    for d, e in engines.items():
        dsc = e.dist
        check(e._columnar is None and e.planner.model.n_devices == d
              and dsc.n_local * d == dsc.n_pad and dsc.n_local % TILE_N == 0,
              f"D={d}: engine layout")
        print(f"  D={d}: n padded to {dsc.n_pad:,}, {d} shard(s) of "
              f"{dsc.n_local:,} objects on {dsc.mesh.distinct}; per-shard "
              f"multi_scan_tiles data ({dsc.m_pad}, {dsc.n_local:,}) float32, "
              f"bounds ({dsc.m_pad}, q_pad), {d} launch(es) per bucket; "
              f"planner n_devices {e.planner.model.n_devices}", flush=True)
    print(f"  three meshed engines (D = 1, {d_max}, {d_max} plain) built in "
          f"{time.perf_counter() - t0:.1f} s; device memory allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    phase_launches: dict[str, int] = {}

    def tally():
        for k, v in ops.kernel_launches().items():
            phase_launches[k] = phase_launches.get(k, 0) + v

    # -- batches and singles, frozen --
    sizes = [(b, spec) for b in DIST_BATCH_SIZES for spec in dist_specs()]
    sizes += [(b, spec) for b in HOST_BOUND_BATCH_SIZES
              for spec in result_specs() if spec.kind in ("ids", "mask")]
    for b, spec in sizes:
        t0 = time.perf_counter()
        qs = queries[:b]
        want = eng.query_batch(qs, method="scan", spec=spec)
        want_plain = plain.query_batch(qs, method="scan", spec=spec)
        for d, e in engines.items():
            for method in ("scan", "auto"):
                got = dist_checked(e, d, qs, method, spec,
                                   f"D={d} {method} B={b} {spec}", want,
                                   want_plain, oracle)
                tally()
            if spec.kind == "agg" and spec.op == "sum":
                again = e.query_batch(qs, method="scan", spec=spec)
                check([np.float32(x).tobytes() for x in again]
                      == [np.float32(x).tobytes() for x in got],
                      f"D={d} B={b} {spec}: repeated sums differ in bits")
        print(f"  B={b:<3} {str(spec):<38} D={DIST_SHARDS} scan and auto: "
              f"equal to the unmeshed scan, the plain meshed engine and "
              f"numpy; 1 op + 1 sync, D scan launches per bucket "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    for d, e in engines.items():
        for i in range(N_SINGLES):
            w = oracle.ids(i)
            for method in ("scan", "auto"):
                for spec, op in ((None, "distributed_mask"),
                                 (Count(), "distributed_count")):
                    ops.reset_counters()
                    ops.reset_kernel_launches()
                    got = e.query(queries[i], method=method, spec=spec)
                    counts, launches = ops.counters(), ops.kernel_launches()
                    tally()
                    check(counts == {op: 1, "host_sync": 1},
                          f"D={d} single {i} {method}: counters {counts}")
                    check(launches.get("range_scan_tiles", 0) == d,
                          f"D={d} single {i}: range_scan_tiles launched "
                          f"{launches.get('range_scan_tiles', 0)} times")
                    check(np.array_equal(got, w) if spec is None
                          else got == w.size,
                          f"D={d} single {i} {method} {spec}: != oracle")
    print(f"  singles: {N_SINGLES} queries x (ids, Count) x (scan, auto) "
          f"on each mesh equal numpy, 1 op + 1 sync, D range_scan_tiles "
          f"launches each ({time.perf_counter() - t0:.1f} s)", flush=True)

    # -- warm qps at B = 128 --
    qs = queries[:128]
    for spec in qps_specs():
        row = {"unmeshed scan": warm_qps(eng, qs, "scan", spec)}
        for d, e in engines.items():
            row[f"D={d}"] = warm_qps(e, qs, "scan", spec)
        print(f"  warm qps B=128 {str(spec):<38} " + ", ".join(
            f"{k} {v:10.1f}" for k, v in row.items()), flush=True)

    # -- serving on the eight-shard engine --
    t0 = time.perf_counter()
    e8 = engines[d_max]
    stream = [q for _, q in gmrqb.mixed_workload(ds, DIST_SERVER_QUERIES,
                                                 seed=SEED)]
    want = eng.query_batch(stream, method="scan", spec=Count())
    check(e8.query_batch(stream, method="auto", spec=Count()) == want,
          f"D={d_max}: query_batch of the server stream != unmeshed")
    srv = MDRQServer(e8, max_batch=64, spec=Count())
    ops.reset_kernel_launches()
    check(srv.serve_all(stream) == want,
          f"D={d_max}: MDRQServer results != query_batch")
    tally()
    print(f"  MDRQServer on D={d_max}: {srv.stats.n_queries} Count queries "
          f"in {srv.stats.n_batches} batches, qps={srv.stats.qps:.1f}, "
          f"equal to query_batch", flush=True)
    pipe = serve_pipelined(e8, max_batch=PIPE_BATCH, max_wait_s=float("inf"),
                           spec=Count(), backlog=PIPE_BACKLOG,
                           latency_budget_s=PIPE_TIMEOUT_S, warmup=False)
    try:
        ops.reset_counters()
        ops.reset_kernel_launches()
        tickets = [pipe.submit(q) for q in stream]
        pipe.drain(PIPE_TIMEOUT_S)
        got = [t.result(timeout=PIPE_TIMEOUT_S) for t in tickets]
        counts = ops.counters()
        tally()
    finally:
        pipe.close(PIPE_TIMEOUT_S)
    windows = -(-len(stream) // PIPE_BATCH)
    check(got == want, f"D={d_max}: pipelined results != query_batch")
    check(counts == {"distributed_multi_reduce": windows,
                     "host_sync": windows},
          f"D={d_max}: pipelined counters {counts}")
    print(f"  serve_pipelined on D={d_max}: {len(stream)} Count queries in "
          f"{windows} windows of {PIPE_BATCH}, equal to query_batch, "
          f"counters {counts}, streams: {pipe.stream_scheme} (serving "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)

    merge = dist_merge_ms(e8, queries[:128])
    print(f"  merge on the first device, B=128, D={d_max} (CUDA events): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in merge.items()),
          flush=True)

    # -- writes, then compaction --
    extra = gmrqb.build(DIST_DELTA_ROWS, seed=2).rows()
    rng = np.random.default_rng(2)
    n_new_dead = DIST_DELTA_DEAD // 10
    dead = np.concatenate([
        rng.choice(N, DIST_DELTA_DEAD - n_new_dead, replace=False),
        N + rng.choice(DIST_DELTA_ROWS, n_new_dead, replace=False)])
    for e in (e8, plain):
        check(np.array_equal(e.append(extra), N + np.arange(DIST_DELTA_ROWS)),
              "dist: append ids")
        check(e.delete(dead) == dead.size, "dist: delete count")
    hit = np.unique(dead[dead < N] // e8.dist.n_local).size
    check(hit >= 3, f"dist: tombstones in {hit} shards")
    alive = np.ones(N + DIST_DELTA_ROWS, bool)
    alive[dead] = False
    cols = np.concatenate([ds.cols, np.ascontiguousarray(extra.T)], axis=1)
    for label, orc, extra_scans in (
            ("delta", Oracle(eng, cols, queries, alive=alive, n_base=N), 1),
            ("compacted", None, 0)):
        t0 = time.perf_counter()
        if orc is None:
            t0 = time.perf_counter()
            id_map = e8.compact()
            compact_s = time.perf_counter() - t0
            check(np.array_equal(plain.compact(), id_map),
                  "dist compact: id maps differ")
            check(e8.version == plain.version == 1 and e8.dist is not None
                  and e8.dist.mesh == meshes[d_max] and e8._columnar is None,
                  "dist compact: the mesh was not kept")
            check(np.array_equal(np.nonzero(id_map < 0)[0], np.sort(dead)),
                  "dist compact: -1 not exactly on the deleted ids")
            orc = Oracle(eng, e8.dataset.cols, queries)
            print(f"  compact on D={d_max}: {compact_s:.1f} s; "
                  f"{e8.dataset.n:,} live rows, shards of "
                  f"{e8.dist.n_local:,}", flush=True)
        for spec in result_specs():
            qs = check_batch(queries, "scan", spec)
            got_plain = plain.query_batch(qs, method="scan", spec=spec)
            dist_checked(e8, d_max, qs, "scan", spec,
                         f"{label} D={d_max} B={len(qs)} {spec}", got_plain,
                         got_plain, orc, extra_scans=extra_scans)
            tally()
        print(f"  {label}: D={d_max} B=128 (Ids and Mask "
              f"{HOST_CHECK_BATCH}) under 8 specs equal to the plain "
              f"meshed engine and numpy ({ORACLE_SAMPLE} queries); "
              f"{d_max}{' + 1' if extra_scans else ''} scan launches per "
              f"bucket ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"  dist peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return phase_launches


def rowscan_phase(eng, eng_plain, oracle, queries):
    """The row-major scan path by name, checked like the main path."""
    from repro_torch.core import Count

    qs = queries[:ROWSCAN_BATCH]
    for spec in result_specs():
        run_checked(eng, eng_plain, oracle, qs, "rowscan", spec,
                    f"rowscan B={ROWSCAN_BATCH} {spec}")
        qps = warm_qps(eng, qs, "rowscan", spec)
        print(f"  rowscan B={ROWSCAN_BATCH} {str(spec):<38} warm qps="
              f"{qps:10.1f}", flush=True)
    for i in range(N_SINGLES):
        want = oracle.ids(i)
        check(np.array_equal(eng.query(queries[i], method="rowscan"), want),
              f"rowscan single {i}: ids != oracle")
        check(eng.query(queries[i], method="rowscan", spec=Count())
              == want.size, f"rowscan single {i}: count != oracle")


def qps_specs() -> tuple:
    """The three specs whose warm qps the delta phase records per path."""
    from repro_torch.core import Agg, Count, TopK
    return Count(), Agg("sum", 3), TopK(k=10, dim=3)


def path_qps(eng, queries) -> dict:
    """{(path, spec): warm qps} for every method, B = 128 (rowscan B = 8)."""
    out = {}
    for method in (*DELTA_METHODS, "rowscan"):
        qs = queries[:ROWSCAN_BATCH if method == "rowscan" else 128]
        for spec in qps_specs():
            eng.query_batch(qs, method=method, spec=spec)   # warm
            out[(method, str(spec))] = warm_qps(eng, qs, method, spec)
    return out


def check_batch(queries, method: str, spec) -> list:
    """The queries a check under a delta or after a compaction runs: the
    row scan's first ``ROWSCAN_BATCH``; under Ids and Mask, host-bound at
    ~2.5 s a call at B = 128, the first ``HOST_CHECK_BATCH``, as on the
    two-phase paths; else the first 128."""
    if method == "rowscan":
        return queries[:ROWSCAN_BATCH]
    return queries[:HOST_CHECK_BATCH if spec.kind in ("ids", "mask")
                   else 128]


def delta_checks(eng, eng_plain, oracle, queries, delta, label):
    """Every method at B = 128 (Ids and Mask at ``HOST_CHECK_BATCH``) and
    the row scan at B = 8, under the eight specs, checked like the main
    path."""
    for method in (*DELTA_METHODS, "rowscan"):
        sizes = set()
        t0 = time.perf_counter()
        for spec in result_specs():
            qs = check_batch(queries, method, spec)
            sizes.add(len(qs))
            _, buckets = run_checked(eng, eng_plain, oracle, qs, method, spec,
                                     f"{label} {method} {spec}", delta=delta)
        print(f"  {label}: {method} B={'/'.join(map(str, sorted(sizes)))} ok "
              f"under 8 specs (last buckets {buckets}; "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)


def fold_time(eng, queries) -> float:
    """CUDA-event ms of the tombstone fold: the (128, n_pad) scan masks of
    the workload times the scan's base-tombstone vector. (A function, so
    no tensor of this version outlives it into the compaction check.)"""
    from repro_torch.core import QueryBatch
    from repro_torch.kernels import multi_scan, reducers

    data = eng.columnar.data_dev
    lo, up = (torch.as_tensor(a, device=data.device) for a in
              QueryBatch.from_queries(queries[:128]).bounds_columnar(
                  data.shape[0]))
    masks = multi_scan.multi_scan_tiles(data, lo, up, tile_n=TILE_N)
    tomb = eng.delta.snapshot().base_tomb_dev(data.shape[1], data.device)
    fold_ms = time_ms(lambda: reducers.fold_tombstones(masks, tomb))
    print(f"  tombstone fold, (128, {data.shape[1]}) int8 masks: "
          f"{fold_ms:.4f} ms", flush=True)
    return fold_ms


def delta_phase(eng, eng_plain, ds, queries):
    """Ingest through the server, serve under the delta -> (the server,
    the deleted ids, the live row count) for ``compact_phase``."""
    from repro_torch.core import Count, RangeQuery
    from repro_torch.data import gmrqb
    from repro_torch.kernels import ops
    from repro_torch.serve import MDRQServer

    frozen_qps = path_qps(eng, queries)
    extra = gmrqb.build(DELTA_ROWS, seed=1).rows()
    rng = np.random.default_rng(1)
    dead = np.concatenate([
        rng.choice(N, DELTA_BASE_DEAD, replace=False),
        N + rng.choice(DELTA_ROWS, DELTA_NEW_DEAD, replace=False)])

    # -- ingest: the server orders writes against the queries around them --
    srv = MDRQServer(eng, max_batch=64, spec=Count())
    everything = RangeQuery.partial(ds.m, {})
    t0 = time.perf_counter()
    before = srv.submit(everything)
    new_ids = srv.append(extra)
    after_append = srv.submit(everything)
    deleted = srv.delete(dead)
    after_delete = srv.submit(everything)
    ingest_s = time.perf_counter() - t0
    check(np.array_equal(new_ids, N + np.arange(DELTA_ROWS)),
          "append: unexpected ids")
    check(deleted == dead.size, f"delete: {deleted} != {dead.size}")
    live = N + DELTA_ROWS - dead.size
    counts = [t.result() for t in (before, after_append, after_delete)]
    check(counts == [N, N + DELTA_ROWS, live],
          f"server ingest ordering: counts {counts}")
    check(srv.stats.ingest_counts == {"append": 1, "delete": 1}
          and srv.stats.flush_reasons.get("ingest") == 2,
          f"server ingest stats {srv.stats.ingest_counts} "
          f"{srv.stats.flush_reasons}")
    check(np.array_equal(eng_plain.append(extra), new_ids),
          "plain engine: append ids differ")
    eng_plain.delete(dead)
    print(f"  ingest through the server: {DELTA_ROWS} rows appended, "
          f"{dead.size} deleted in {ingest_s:.2f} s; live rows {live}; "
          f"memory_report delta {eng.memory_report()['delta']} bytes",
          flush=True)

    alive = np.ones(N + DELTA_ROWS, bool)
    alive[dead] = False
    cols = np.concatenate([ds.cols, np.ascontiguousarray(extra.T)], axis=1)
    oracle = Oracle(eng, cols, queries, alive=alive, n_base=N)
    ops.reset_kernel_launches()
    delta_checks(eng, eng_plain, oracle, queries, True, "delta")
    launches = ops.kernel_launches()
    print(f"  kernel launches under the delta: {launches}")
    for name in ("multi_scan_tiles", "multi_scan_vertical", "masked_fill_tiles",
                 "masked_agg_tiles", "multi_scan_visit",
                 "multi_va_filter_packed", "range_scan_rows"):
        check(launches.get(name, 0) > 0,
              f"kernel {name} was not launched under the delta")
    delta_qps = path_qps(eng, queries)
    for key, q_frozen in frozen_qps.items():
        print(f"  qps {key[0]:<13} {key[1]:<38} frozen {q_frozen:10.1f} "
              f"delta {delta_qps[key]:10.1f}", flush=True)

    fold_time(eng, queries)
    return srv, dead, live


def compact_phase(eng, eng_plain, queries, srv, dead, live):
    """``compact()`` both engines (the engine under test through its
    server), then serve and check again."""
    from repro_torch.core import RangeQuery

    everything = RangeQuery.partial(eng.dataset.m, {})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_bytes = torch.cuda.memory_allocated()
    def timed(fn):
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0
    # the plain engine compacts on a second thread beside the engine
    (id_map, compact_s), (plain_map, plain_s) = side_by_side(
        lambda: timed(srv.compact), lambda: timed(eng_plain.compact))
    peak = torch.cuda.max_memory_allocated()
    check(np.array_equal(id_map, plain_map), "compact: id maps differ")
    check(eng.version == eng_plain.version == 1, "compact: version != 1")
    check(np.array_equal(np.nonzero(id_map < 0)[0], np.sort(dead)),
          "compact: -1 not exactly on the deleted ids")
    check(np.array_equal(id_map[id_map >= 0], np.arange(live)),
          "compact: live ids not renumbered in order")
    check(eng.dataset.n == live and eng.delta.d == 0, "compact: sizes")
    after_bytes = torch.cuda.memory_allocated()
    check(after_bytes <= before_bytes,
          f"compact: {after_bytes} bytes allocated after, {before_bytes} "
          f"before — a replaced version is still on the card")
    print(f"  compact: {compact_s:.1f} s (engine, through the server), "
          f"{plain_s:.1f} s (plain engine), side by side; build seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in eng.build_seconds.items())
          + f"; device memory {before_bytes / 1e9:.2f} GB before, peak "
          f"{peak / 1e9:.2f} GB during both, {after_bytes / 1e9:.2f} GB "
          f"after",
          flush=True)
    check(srv.submit(everything).result() == live,
          "count after compaction != live rows")
    oracle = Oracle(eng, eng.dataset.cols, queries)
    delta_checks(eng, eng_plain, oracle, queries, False, "compacted")


def lm_requests(cfg, seed: int, n: int, prompt: tuple[int, int], max_new: int,
                admit_all: bool = False) -> list:
    """``n`` requests (numpy seed ``seed``) with prompts of [lo, hi) tokens;
    random admission features, or ones the admission filter takes."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        toks = rng.integers(0, cfg.vocab_size, int(rng.integers(*prompt)))
        feats = [0.5, toks.size, 100.0, 0.5] if admit_all else \
            [rng.random(), 8, 100.0, rng.random()]
        reqs.append(Request(rid=i, prompt=toks.astype(np.int32),
                            max_new=max_new,
                            features=np.array(feats, np.float32)))
    return reqs


def lm_server(model, params, reqs, logits=None, steps=None, prepare=None):
    """Serve ``reqs`` through ``BatchServer(slots=LM_SLOTS,
    max_len=LM_MAX_LEN)``; with ``logits`` (a dict), record the logits row
    of every generated token per request id; with ``steps`` (a list), record
    each step's (tokens, positions, generating slots, their logits rows);
    ``prepare(cache)`` fills the server's fresh cache first (an
    encoder-decoder's cross cache) -> (done, steps, seconds)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import BatchServer, admission_query

    cfg = model.cfg
    srv = BatchServer(model, params, slots=LM_SLOTS, max_len=LM_MAX_LEN)
    if prepare is not None:
        prepare(srv.cache)
    if logits is not None or steps is not None:
        step = srv.step_fn

        def recording_step(params, cache, toks, pos):
            out, cache = step(params, cache, toks, pos)
            rows = out[:, 0, :cfg.vocab_size].float().cpu().numpy()
            gen = [s for s, req in enumerate(srv.active)
                   if req is not None and not srv.to_feed[s]]
            for s in gen:
                if logits is not None:
                    logits.setdefault(srv.active[s].rid, []).append(rows[s])
            if steps is not None:
                steps.append((toks.cpu().numpy().copy(),
                              pos.cpu().numpy().copy(), gen, rows[gen]))
            return out, cache
        srv.step_fn = recording_step
    ops.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = srv.serve(reqs, admission_query())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n_steps = ops.counter("host_sync") - 1   # one per step, plus the admission's
    feats = np.stack([r.features for r in reqs])
    admitted = {r.rid for r in reqs if 0.2 <= r.features[0] <= 1.0
                and 0.0 <= r.features[3] <= 0.8}
    check({r.rid for r in done} == admitted,
          f"served {sorted(r.rid for r in done)} != admitted {sorted(admitted)}"
          f" (features {feats.tolist()})")
    for r in done:
        check(r.output is not None and r.output.shape == (r.max_new,),
              f"request {r.rid}: output {r.output!r}")
    return done, n_steps, seconds


def replay(model, params, steps, fault=None, stop=None, prepare=None) -> list:
    """Teacher forcing: feed the recorded steps' tokens and positions through
    ``model``'s serve step on a fresh server cache (what ``BatchServer``
    starts from, ``prepare``d as the server's was) -> each step's logits
    rows of the generating slots. ``fault`` alters every call of
    ``ops.kv_visit_attention`` (a planted fault); ``stop(rows)`` True ends
    the replay early."""
    from repro_torch.kernels import ops
    from repro_torch.serve.serve_step import make_serve_step

    cache = model.init_cache(LM_SLOTS, LM_MAX_LEN, model.dtype)
    if prepare is not None:
        prepare(cache)
    step = make_serve_step(model)
    vocab = model.cfg.vocab_size
    op, rows = ops.kv_visit_attention, []
    if fault is not None:
        ops.kv_visit_attention = lambda *a, **kw: op(*fault(*a), **kw)
    try:
        with torch.inference_mode():   # as BatchServer.serve steps
            for toks, pos, gen, _ in steps:
                out, cache = step(params, cache,
                                  torch.as_tensor(toks, device="cuda"),
                                  torch.as_tensor(pos, device="cuda"))
                rows.append(out[gen, 0, :vocab].float().cpu().numpy())
                if stop is not None and stop(rows):
                    break
    finally:
        ops.kv_visit_attention = op
    return rows


def token_reading(rows_k, rows_p) -> dict:
    """The kernel side's logits rows against the plain side's, both fed one
    token stream: the largest difference, and at the decisive steps (plain
    top-2 margin >= 2 * TOKEN_TIE) how many greedy tokens differ."""
    worst, decisive, differ, own_rule, tokens = 0.0, 0, 0, 0, 0
    for lk_rows, lp_rows in zip(rows_k, rows_p):
        for lk, lp in zip(lk_rows, lp_rows):
            tokens += 1
            d = float(np.abs(lk - lp).max())
            worst = max(worst, d)
            top2 = np.sort(lp)[-2:]
            margin = float(top2[1] - top2[0])
            own_rule += margin >= 2 * d
            if margin >= 2 * TOKEN_TIE:
                decisive += 1
                differ += int(np.argmax(lk) != np.argmax(lp))
    return {"tokens": tokens, "worst": worst, "decisive": decisive,
            "differ": differ, "own_rule": own_rule}


def rejections(r: dict) -> list[str]:
    """What the teacher-forced check rejects in a ``token_reading``."""
    out = []
    if r["worst"] > LOGIT_ATOL:
        out.append(f"logits differ by {r['worst']:.4g} > {LOGIT_ATOL}")
    if r["differ"]:
        out.append(f"{r['differ']} of {r['decisive']} decisive greedy tokens "
                   f"differ from the plain backend's")
    return out


def teacher_forced_check(label, plain, params, steps,
                         prepare=None) -> tuple[dict, list]:
    """Replay the kernel server's token stream on the plain backend: logits
    within LOGIT_ATOL at every generated token, greedy tokens equal at every
    decisive step -> (the reading, the plain logits rows)."""
    rows_p = replay(plain, params, steps, prepare=prepare)
    r = token_reading([s[3] for s in steps], rows_p)
    faults = rejections(r)
    check(not faults, f"{label}: " + "; ".join(faults))
    check(r["decisive"] > 0, f"{label}: no decisive step to compare")
    print(f"  {label}, teacher-forced on the kernel's tokens: {r['tokens']} "
          f"generated tokens, max |logit kernel - plain| {r['worst']:.4g} "
          f"(limit {LOGIT_ATOL}); {r['decisive']} decisive (plain top-2 "
          f"margin >= {2 * TOKEN_TIE}), all equal; {r['own_rule']} with "
          f"margin >= 2 x their own logit difference", flush=True)
    return r, rows_p


def lm_server_part(model, plain, params) -> dict:
    """The server with the kernel against the same server on the plain
    backend, on two request sets -> (the inputs of the multi-block set's
    kernel call with the most valid keys, for the kernel row's server shape;
    the multi-block set's recorded steps, the plain side's logits rows of
    their replay and that reading, for ``served_fault``).

    Short prompts (seed LM_SEED, positions in block 0): token j of a request
    is compared while both sides have generated the same tokens before it:
    its logits must agree within LOGIT_ATOL, and its token must be equal
    unless the plain side's top-2 margin is under twice the step's largest
    logit difference (then the step is printed and the request compared no
    further). Both sets: every kernel call within KV_RTOL of its plain
    version, and the plain backend teacher-forced on the kernel server's
    tokens (``teacher_forced_check``). The multi-block set must reach block
    4, lists of more than one valid block and refilled slots."""
    cfg = model.cfg
    reqs = lm_requests(cfg, LM_SEED, LM_REQUESTS, (4, 16), LM_MAX_NEW)
    done, steps, seconds = lm_server(model, params, reqs)
    rec_k: dict[int, list] = {}
    rec_p: dict[int, list] = {}
    tf_steps: list = []
    shadow = {"calls": 0, "err": 0.0, "rel": 0.0}
    with plain_shadow(shadow):
        again, _, _ = lm_server(model, params, reqs, rec_k, tf_steps)
    check(shadow["calls"] == steps * cfg.n_layers,
          f"{shadow['calls']} server kernel calls held against the plain "
          f"version, not one per layer and step")
    check([r.output.tolist() for r in again] == [r.output.tolist() for r in done],
          "the kernel server gave other tokens on a second run")
    plain_done, _, plain_seconds = lm_server(plain, params, reqs, rec_p)
    check([r.rid for r in done] == [r.rid for r in plain_done],
          "completion order differs from the plain backend's")
    compared, worst = 0, 0.0
    for r, p in zip(done, plain_done):
        for j, (a, b) in enumerate(zip(r.output, p.output)):
            lk, lp = rec_k[r.rid][j], rec_p[r.rid][j]
            d = float(np.abs(lk - lp).max())
            worst = max(worst, d)
            check(d <= LOGIT_ATOL, f"request {r.rid} token {j}: logits differ "
                                   f"by {d} > {LOGIT_ATOL}")
            top2 = np.sort(lp)[-2:]
            margin = float(top2[1] - top2[0])
            if margin < 2 * d:
                print(f"  request {r.rid} token {j}: plain top-2 margin "
                      f"{margin:.4g} < 2 x logit difference {d:.4g}; compared "
                      f"no further", flush=True)
                break
            check(a == b, f"request {r.rid} token {j}: kernel {a} != plain {b}")
            compared += 1
    tokens = sum(r.output.size for r in done)
    print(f"  server: {len(done)} of {LM_REQUESTS} requests admitted and "
          f"completed, {tokens} tokens in {steps} steps, {seconds:.2f} s "
          f"({seconds / steps * 1e3:.1f} ms/step, {tokens / seconds:.1f} "
          f"generated tokens/s; plain backend, recording, "
          f"{plain_seconds:.2f} s); {compared} of {tokens} tokens compared "
          f"equal; max |logit kernel - plain| {worst:.4g}; each of "
          f"{shadow['calls']} kv_visit_attention calls within "
          f"{shadow['err']:.4g} ({shadow['rel']:.4g} of its max |plain|; "
          f"limit {KV_RTOL:.4g}) of its plain version", flush=True)
    for r in done:
        print(f"  request {r.rid}: prompt {r.prompt.size} tokens -> "
              f"{r.output[:8].tolist()}...", flush=True)
    teacher_forced_check("server, short prompts", plain, params, tf_steps)
    del rec_k, rec_p, tf_steps

    # The multi-block set: positions past block 0, refilled slots.
    reqs = lm_requests(cfg, LM_SEED + 1, LM_MB_REQUESTS, LM_MB_PROMPT,
                       LM_MB_NEW, admit_all=True)
    tf_steps = []
    shadow = {"calls": 0, "err": 0.0, "rel": 0.0}
    with plain_shadow(shadow):
        done, steps, seconds = lm_server(model, params, reqs, steps=tf_steps)
    refills = len(done) - LM_SLOTS
    print(f"  server, multi-block set: {len(done)} requests (prompts "
          f"{sorted(r.prompt.size for r in reqs)} tokens, {LM_MB_NEW} new) on "
          f"{LM_SLOTS} slots, {refills} refilled slots, {steps} steps in "
          f"{seconds:.2f} s; largest position {shadow['max_pos']} (block "
          f"{shadow['max_pos'] // LM_BLOCK}); {shadow['multi']} of "
          f"{shadow['calls']} kv_visit_attention calls list more than one "
          f"block with valid keys, each within {shadow['err']:.4g} "
          f"({shadow['rel']:.4g} of its max |plain|; limit {KV_RTOL:.4g}) of "
          f"its plain version", flush=True)
    check(len(done) == LM_MB_REQUESTS, "the multi-block set was not all served")
    check(shadow["calls"] == steps * cfg.n_layers,
          f"{shadow['calls']} multi-block kernel calls held against the plain "
          f"version, not one per layer and step")
    check(shadow["max_pos"] >= 4 * LM_BLOCK and shadow["multi"] > 0
          and refills > 0,
          "the multi-block set did not reach block 4, multi-block lists and "
          "refilled slots")
    sound, rows_p = teacher_forced_check("server, multi-block set", plain,
                                         params, tf_steps)
    return shadow["widest"], (tf_steps, rows_p, sound)


def served_fault(model, params, tf_steps, rows_p, sound) -> None:
    """A planted fault (the last listed block dropped in every kernel call)
    replayed on the multi-block set's token stream must fail the
    teacher-forced check (``lm_server_part``'s reading ``sound`` passed)."""
    def drop_last(q, k_blocks, v_blocks, block_ids, pos):
        ids = block_ids.clone()
        ids[..., -1] = -1
        return q, k_blocks, v_blocks, ids, pos
    rows_f = replay(model, params, tf_steps, drop_last,   # to the first rejection
                    stop=lambda rows: rejections(token_reading(
                        rows[-1:], rows_p[len(rows) - 1:len(rows)])))
    fault = token_reading(rows_f, rows_p)
    caught = rejections(fault)
    check(caught, f"planted fault (last listed block dropped) passes the "
                  f"teacher-forced check: {fault}")
    print(f"  planted fault, last listed block dropped in every call: "
          f"rejected at step {len(rows_f)} of {len(tf_steps)} "
          f"({'; '.join(caught)}); reading: {fault['differ']} of "
          f"{fault['decisive']} decisive greedy tokens differ (sound: 0 of "
          f"{sound['decisive']}), max |logit - plain| {fault['worst']:.4g} "
          f"(sound {sound['worst']:.4g}, limit {LOGIT_ATOL})", flush=True)


def long_cache(model, start: torch.Tensor) -> dict:
    """A long-context cache: K/V from a generator (seed 1, bf16) in the
    slots before each row's start position, zeros after; zone maps over the
    written slots."""
    from repro_torch import numerics
    cfg = model.cfg
    cache = model.init_cache(LONG_B, LONG_SLOTS)
    gen = torch.Generator(device="cuda").manual_seed(1)
    written = (torch.arange(LONG_SLOTS, device="cuda")[None, :]
               < start[:, None])                                  # (B, S)
    nb = LONG_SLOTS // LONG_BLOCK
    big = numerics.finite_max(torch.bfloat16)
    w5 = written.view(LONG_B, nb, LONG_BLOCK, 1, 1)
    for layer in range(cfg.n_layers):
        for name in ("k", "v"):
            t = cache[name][layer]
            t.normal_(generator=gen)
            t.mul_(written[:, :, None, None])
        kb = cache["k"][layer].view(LONG_B, nb, LONG_BLOCK, cfg.n_kv_heads,
                                    -1).float()
        cache["kmin"][layer] = torch.where(w5, kb, big).amin(dim=2)
        cache["kmax"][layer] = torch.where(w5, kb, -big).amax(dim=2)
        del kb
    return cache


def kv_err(got, want) -> tuple[float, float]:
    """(max |kernel - plain|, max |plain|) of one kv_visit_attention output;
    the check is err <= KV_RTOL * scale."""
    want = want.float()
    return (float((got.float() - want).abs().max()),
            float(want.abs().max()))


@contextlib.contextmanager
def plain_shadow(stats):
    """Within the block, hold every kernel call of ``ops.kv_visit_attention``
    against the plain version on the same inputs (before the next layer can
    change them); the plain calls launch no kernel and are not counted.
    ``stats`` collects the calls, the largest error and the largest error
    over its call's max |plain output|, the largest position, the calls
    whose list holds more than one block with valid keys (``multi``) and the
    inputs of the call with the most valid keys (``widest``)."""
    from repro_torch.kernels import ops, ref
    op = ops.kv_visit_attention
    stats.update(max_pos=-1, multi=0, keys=-1, widest=None)

    def checked(q, k_blocks, v_blocks, block_ids, pos, k_scale=None,
                v_scale=None, *, backend="auto"):
        out = op(q, k_blocks, v_blocks, block_ids, pos, k_scale, v_scale,
                 backend=backend)
        if backend == "auto":
            err, scale = kv_err(out, ref.kv_visit_attention_ref(
                q, k_blocks, v_blocks, block_ids, pos, k_scale, v_scale))
            check(err <= KV_RTOL * scale,
                  f"kv_visit_attention call {stats['calls']}: {err} from its "
                  f"plain version > {KV_RTOL} x max |plain| {scale}")
            stats["calls"] += 1
            stats["err"] = max(stats["err"], err)
            stats["rel"] = max(stats["rel"], err / scale)
            bs = k_blocks.shape[3]
            first = block_ids.long() * bs
            p = pos.long()[:, None, None]
            live = (block_ids >= 0) & (first <= p)
            keys = int(((p - first + 1).clamp(0, bs) * live).sum())
            stats["max_pos"] = max(stats["max_pos"], int(pos.max()))
            stats["multi"] += int((live.sum(-1) > 1).any())
            if keys > stats["keys"]:
                stats["keys"] = keys
                stats["widest"] = (q.clone(), k_blocks, v_blocks,
                                   block_ids.clone(), pos.clone(), k_scale,
                                   v_scale)
        return out
    ops.kv_visit_attention = checked
    try:
        yield
    finally:
        ops.kv_visit_attention = op


def profile_steps(model, params, cache, tok, pos, step_ms: float,
                  steps: int = 3) -> None:
    """torch.profiler over ``steps`` warm decode steps: device busy time (the
    device events' durations) against ``step_ms``, the warm step's wall time
    without the profiler (the idle share), and against the profiled steps'
    own wall time (which the profiler's host work lengthens); the ops that
    take the most device and host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            model.decode_step(params, cache, tok, pos)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    rows_us = sum(dev_us(e) for e in events)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    if busy <= 0:
        print("  profiler: no device time recorded; idle share not measured",
              flush=True)
        return
    busy_ms = busy / steps / 1e3
    print(f"  profiler, {steps} pruned decode steps: device busy "
          f"{busy_ms:.2f} ms/step (its {len(kernels) // steps} device events; "
          f"the sum over all profiler rows, ops and kernels, "
          f"{rows_us / steps / 1e3:.2f}); idle share {1 - busy_ms / step_ms:.3f}"
          f" of the warm step without the profiler ({step_ms:.2f} ms); under "
          f"the profiler the step took {wall_us / steps / 1e3:.2f} ms (share "
          f"{1 - busy / wall_us:.3f})", flush=True)
    kv = [e for e in kernels if "kv_visit" in e.name]
    print(f"  kv_visit_attention in the decode step: "
          f"{sum(e.time_range.elapsed_us() for e in kv) / steps / 1e3:.4f} "
          f"device ms/step in {len(kv) // steps} kernels/step "
          f"({sorted({e.name[:60] for e in kv})})", flush=True)
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        print(f"    device {dev_us(e) / steps / 1e3:8.3f} ms/step  calls "
              f"{e.count // steps:5d}  {e.key[:70]}", flush=True)
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        print(f"    host   {e.self_cpu_time_total / steps / 1e3:8.3f} ms/step  "
              f"calls {e.count // steps:5d}  {e.key[:70]}", flush=True)


def lm_long_part(params):
    """Teacher-forced long-context decode on both backends; step times with
    and without the prune on the same state -> (the kernel's cache, the
    inputs of the layer-0 kernel call of one more step)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config(LM_ARCH).replace(n_layers=LM_LAYERS,
                                      kv_block_prune=LONG_PRUNE,
                                      kv_block_size=LONG_BLOCK)
    model = build_model(cfg)
    plain = build_model(cfg, backend="torch")
    start = torch.tensor([LONG_SLOTS - 1 - LONG_STEPS - 64 * b
                          for b in range(LONG_B)], device="cuda")
    t0 = time.perf_counter()
    cache = long_cache(model, start)
    cache_p = {k: v.clone() for k, v in cache.items()}
    torch.cuda.synchronize()
    print(f"  long-context caches: 2 x {2 * cache['k'].nbytes / 1e9:.2f} GB "
          f"(K + V) + zone maps, filled in {time.perf_counter() - t0:.1f} s; "
          f"positions {start.tolist()}; device memory "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (LONG_STEPS, LONG_B, 1)), device="cuda")
    worst, rows, differ = 0.0, 0, 0
    shadow = {"calls": 0, "err": 0.0, "rel": 0.0}
    for t in range(LONG_STEPS):
        vk, vp = [], []
        with plain_shadow(shadow):
            lk, _ = model.decode_step(params, cache, toks[t], start + t,
                                      visits=vk)
        lp, _ = plain.decode_step(params, cache_p, toks[t], start + t,
                                  visits=vp)
        worst = max(worst, float((lk - lp).abs().max()))
        for layer, ((top_k, ub_k), (top_p, _)) in enumerate(zip(vk, vp)):
            # the selection on the card against numpy's stable sort: the
            # largest bounds first, ties to the lower block id
            want = np.argsort(-ub_k.cpu().numpy(), axis=-1,
                              kind="stable")[..., :top_k.shape[-1]]
            check(np.array_equal(top_k.cpu().numpy(), want),
                  f"step {t} layer {layer}: the visit list is not the top "
                  f"{LONG_PRUNE} blocks by bound with ties to the lower id")
            rows += top_k.shape[0] * top_k.shape[1]
            n = int((top_k != top_p).any(dim=-1).sum())
            # layer 0's bounds come from the same inputs on both sides
            check(layer > 0 or n == 0,
                  f"step {t}: layer-0 visit lists differ ({n} rows)")
            differ += n
    check(shadow["calls"] == LONG_STEPS * cfg.n_layers,
          f"{shadow['calls']} kernel calls held against the plain version")
    check(worst <= LOGIT_ATOL,
          f"long-context logits differ by {worst} > {LOGIT_ATOL}")
    print(f"  {LONG_STEPS} teacher-forced steps: each of {shadow['calls']} "
          f"kv_visit_attention calls within {shadow['err']:.4g} of its plain "
          f"version on the same inputs ({shadow['rel']:.4g} of its max "
          f"|plain|; limit {KV_RTOL:.4g}), each visit list the top "
          f"{LONG_PRUNE} by a numpy stable sort; max |logit kernel - plain| "
          f"{worst:.4f} (tolerance {LOGIT_ATOL}, |logit| <= "
          f"{float(lk.abs().max()):.2f}); visit lists: {rows} (b, kv) "
          f"selections, layer 0 equal, {differ} differ past layer 0",
          flush=True)
    del cache_p
    torch.cuda.empty_cache()

    pos = start + LONG_STEPS - 1
    tok = toks[-1]
    dense = build_model(cfg.replace(kv_block_prune=0))
    times = {}
    for name, m in (("pruned", model), ("full", dense)):
        for _ in range(2):
            m.decode_step(params, cache, tok, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LONG_TIMED_STEPS):
            m.decode_step(params, cache, tok, pos)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) / LONG_TIMED_STEPS * 1e3
        print(f"  warm decode step, B={LONG_B} at {LONG_SLOTS} slots, "
              f"kv_block_prune={m.cfg.kv_block_prune}: {times[name]:.2f} ms "
              f"({LONG_B * 1e3 / times[name]:.1f} tokens/s)", flush=True)
    profile_steps(model, params, cache, tok, pos, times["pruned"])
    return cache, decode_call(model, params, cache, tok, pos)


def decode_call(model, params, cache, tok, pos) -> tuple:
    """One more decode step; the inputs of its layer-0 kv_visit_attention
    call, as the model passes them (int64 ids from the selection, the
    strided views of the cache; an int8 cache's scale views, else None)."""
    from repro_torch.kernels import ops
    op, calls = ops.kv_visit_attention, []

    def recording(*args, **kw):
        calls.append((args, kw))
        return op(*args, **kw)
    ops.kv_visit_attention = recording
    try:
        model.decode_step(params, cache, tok, pos)
    finally:
        ops.kv_visit_attention = op
    (q, kb, vb, ids, p), kw = calls[0]
    return (q.clone(), kb, vb, ids.clone(), p.clone(), kw.get("k_scale"),
            kw.get("v_scale"))


PROFILE_PAD_S = 0.1     # host seconds of quiet at each edge of a window


def profile_window(fn, reps: int = TIMING_REPS,
                   pad_s: float = PROFILE_PAD_S) -> list:
    """torch.profiler over ``reps`` calls of ``fn`` after a warm-up step of
    the same calls -> the window's events (``prof.events()``).

    The profiler keeps only the device events whose device timestamps fall
    inside the window's bounds on the host clock, and on the H100 the two
    clocks disagree by up to milliseconds, more than ten calls of a small
    kernel take: a window without margins then keeps none of its kernels,
    or takes in the warm-up's. So each step is padded with ``pad_s``
    seconds of quiet before its first launch and after its last kernel
    ends: every kernel of the active step runs at least ``pad_s`` inside
    the window and every kernel of the warm-up ends at least ``pad_s``
    before it."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            time.sleep(pad_s)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad_s)
            prof.step()
    return list(prof.events())


def device_events(events) -> list:
    """The device events of a window, less the step's own span."""
    from torch.autograd import DeviceType
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not e.name.startswith("ProfilerStep")]


def device_kernels(fn, reps: int = TIMING_REPS,
                   tries: int = 10) -> tuple[float, float, list]:
    """torch.profiler over ``reps`` calls of ``fn`` after a warm one -> (the
    device ms per call: the summed durations of its device events, the
    device events per call, their names).

    Every call of ``fn`` launches at least one kernel, so a window
    (``profile_window``) with fewer device events than calls is incomplete:
    it is printed and taken again, up to ``tries`` windows in all. A window
    with as many events as calls or more is returned as it was read. Late
    in this script's process the first padded window of a call has come
    back with no device event and the next one whole (the cause is not
    known; a fresh process loses none, ``tools/profiler_probe.py``)."""
    fn()
    torch.cuda.synchronize()
    for window in range(1, tries + 1):
        events = profile_window(fn, reps)
        dev = device_events(events)
        if len(dev) >= reps:
            break
        print(f"  profiler window {window} of {tries} kept {len(dev)} device "
              f"events for {reps} calls ({len(events) - len(dev)} host "
              f"events): incomplete", flush=True)
    us = sum(e.time_range.elapsed_us() for e in dev)
    return us / reps / 1e3, len(dev) / reps, sorted({e.name for e in dev})


def host_us(fn, calls: int = 100) -> float:
    """Host microseconds per call of ``fn`` (the enqueue: Python, checks,
    launch), the device left to run behind."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def kv_visit_timing(q, kb, vb, ids, pos, ks=None, vs=None) -> dict:
    """``kv_visit.kv_visit_attention`` on these inputs: the eager CUDA-event
    ms (``time_ms``), the device ms and device kernels per call
    (``device_kernels``) and the wrapper's host us per call."""
    from repro_torch.kernels import kv_visit

    def call():
        return kv_visit.kv_visit_attention(q, kb, vb, ids, pos, ks, vs)
    device_ms, per_call, names = device_kernels(call)
    return {"ms": time_ms(call), "device_ms": device_ms,
            "kernels_per_call": per_call, "kernel_names": names,
            "host_us": host_us(call)}


def kv_bound(q, ids, pos, bs: int) -> tuple[float, str, int]:
    """Bound of one call: the valid keys (ids >= 0, slot <= pos) of the
    listed blocks, their K and V rows read once; q, the ids and the output
    once; 4 * G * hd flops per key -> (ms, by, keys)."""
    _, _, g, hd = q.shape
    first = ids.long() * bs
    keys = int(((pos.long()[:, None, None] - first + 1).clamp(0, bs)
                * (ids >= 0)).sum())
    nbytes = (keys * hd * 2 + 2 * q.numel()) * q.element_size() \
        + ids.numel() * ids.element_size()
    return (*bound_ms(nbytes, 4.0 * g * hd * keys), keys)


def decode_kv_case(pos: list, slots: int, block: int, prune: int,
                   seed: int = 1, arch: str = LM_ARCH) -> tuple:
    """One layer of a decode step of ``arch`` (Qwen3-8B unless named),
    without the model: token-major
    K/V (B, slots, KV, hd) bf16 from a generator (seed), zeros past each
    row's position; q from the same generator; the visit list as the
    model's prune makes it (the top ``prune`` blocks by the zone-map bound,
    blocks with no valid key last, the block being written first) -> (q, k
    view, v view, ids int64, pos int64), the views block-major. The
    long-context shape: ``pos`` as ``lm_long_part``'s last step, LONG_SLOTS,
    LONG_BLOCK, LONG_PRUNE."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.reducers import topk_ascending_ties
    from repro_torch.models import layers

    cfg = get_config(arch)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    b, g, nb = len(pos), cfg.n_heads // kv, slots // block
    pos = torch.tensor(pos, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    written = torch.arange(slots, device="cuda")[None, :] <= pos[:, None]
    k, v = (torch.randn((b, slots, kv, hd), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
            .mul_(written[:, :, None, None]) for _ in range(2))
    q = torch.randn((b, kv, g, hd), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kb = k.view(b, nb, block, kv, hd).float()
    w5 = written.view(b, nb, block, 1, 1)
    big = float(torch.finfo(torch.bfloat16).max)
    kmin = torch.where(w5, kb, big).amin(dim=2)
    kmax = torch.where(w5, kb, -big).amax(dim=2)
    del kb
    ub = layers.block_upper_bounds(q.float(), kmin, kmax)
    ub = torch.where(written.view(b, nb, block).any(-1)[:, None, :], ub,
                     float("-inf"))
    cur = torch.arange(nb, device="cuda")[None, :] == (pos // block)[:, None]
    ub = torch.where(cur[:, None, :], float("inf"), ub)
    ids = topk_ascending_ties(ub.reshape(b * kv, nb), prune,
                              largest=True).view(b, kv, prune)

    def view(c):
        return c.view(b, nb, block, kv, hd).permute(0, 3, 1, 2, 4)
    return q, view(k), view(v), ids, pos


def decode_kv_int8_case(pos: list, slots: int, block: int, prune: int,
                        seed: int = 1, arch: str = "deepseek_moe_16b") -> tuple:
    """``decode_kv_case`` of ``arch`` (deepseek-moe-16b, the int8 cache's
    model, unless named) with its cache quantized as the decode quantizes
    it (``quantize_kv`` per token and head) -> (q, k codes view, v codes
    view, ids, pos, k scales view, v scales view), every view block-major
    over a token-major tensor, as the model passes them."""
    from repro_torch.models.layers import quantize_kv
    q, kb, vb, ids, pos = decode_kv_case(pos, slots, block, prune, seed, arch)
    b, kv, nb, bs, hd = kb.shape
    out = []
    for blocks in (kb, vb):
        codes, scale = quantize_kv(
            blocks.permute(0, 2, 3, 1, 4).reshape(b, nb * bs, kv, hd))
        out += [c.view(b, nb, bs, kv, -1).permute(0, 3, 1, 2, 4)
                for c in (codes, scale)]
        del blocks
    kq, ks, vq, vs = out
    return q, kq, vq, ids, pos, ks, vs


def kv_visit_row(cfg, cache, call, server_call) -> dict:
    """Kernel 12 at the long-context shape, on the inputs of the last decode
    step's layer-0 call: against its plain version, two planted faults and
    SDPA over the whole cache with a mask of the same keys; its eager,
    device and host times; the same at the server shape (the multi-block
    set's call with the most valid keys)."""
    import torch.nn.functional as F
    from repro_torch.kernels import kv_visit, ref

    q, kb, vb, ids, pos = call[:5]
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    g = cfg.n_heads // kv
    nb = LONG_SLOTS // LONG_BLOCK
    got = kv_visit.kv_visit_attention(q, kb, vb, ids, pos)
    want = ref.kv_visit_attention_ref(q, kb, vb, ids, pos)
    err, scale = kv_err(got, want)
    check(err <= KV_RTOL * scale, f"kv_visit_attention differs from plain by "
                                  f"{err} > {KV_RTOL} x max |plain| {scale}")
    check(torch.equal(got, kv_visit.kv_visit_attention(q, kb, vb, ids, pos)),
          "kv_visit_attention differs between identical calls")
    check(torch.equal(got, kv_visit.kv_visit_attention(q, kb, vb, ids.int(),
                                                       pos.int())),
          "kv_visit_attention differs between int64 and int32 ids")
    # Planted faults: the kernel on altered inputs, held against the plain
    # output of the true ones, as a kernel with that fault would be. The
    # check above must reject each.
    dropped = ids.clone()
    dropped[..., -1] = -1                      # the last listed block
    tile_start = pos - pos % 128               # the keys of the partial tile
    for fault, args in (("last listed block dropped", (dropped, pos)),
                        ("partial 128-key tile masked", (ids, tile_start - 1))):
        f_err, _ = kv_err(kv_visit.kv_visit_attention(q, kb, vb, *args), want)
        check(f_err > KV_RTOL * scale,
              f"planted fault ({fault}) passes the check: {f_err}")
        print(f"  planted fault, {fault}: max |kernel - plain| {f_err:.4g} "
              f"= {f_err / scale:.4g} of max |plain| {scale:.4g} (limit "
              f"{KV_RTOL:.4g}; sound reading {err / scale:.4g})", flush=True)

    # The library yardstick reads the whole cache: SDPA with a mask of the
    # selected, valid slots per (b, query head).
    slots = torch.arange(LONG_SLOTS, device="cuda")
    sel = torch.zeros((LONG_B, kv, nb), dtype=torch.bool, device="cuda")
    sel.scatter_(2, ids.long(), True)
    mask = sel.repeat_interleave(LONG_BLOCK, dim=2) \
        & (slots[None, None, :] <= pos[:, None, None])
    mask = mask.repeat_interleave(g, dim=1)[:, :, None, :]      # (B, H, 1, S)
    qh = q.reshape(LONG_B, kv * g, 1, hd)
    kf = cache["k"][0].permute(0, 2, 1, 3)                       # (B, KV, S, hd)
    vf = cache["v"][0].permute(0, 2, 1, 3)

    def library():
        return F.scaled_dot_product_attention(qh, kf, vf, attn_mask=mask,
                                              enable_gqa=True)
    lib_err = float((library().reshape(got.shape).float() - got.float())
                    .abs().max())
    b_ms, by, keys = kv_bound(q, ids, pos, LONG_BLOCK)
    t = kv_visit_timing(q, kb, vb, ids, pos)
    t32 = kv_visit_timing(q, kb, vb, ids.int(), pos.int())
    check(t["kernels_per_call"] == 1 and t32["kernels_per_call"] == 1,
          f"kv_visit_attention launched {t['kernels_per_call']} / "
          f"{t32['kernels_per_call']} device kernels per call (int64 / int32 "
          f"ids and positions): {t['kernel_names']}")
    row = {"name": "kv_visit_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/kv_visit.cu",
           "replaces": "src/repro/kernels/kv_visit.py:110", "launches": 0,
           "max_abs_err": err, "ms": t["ms"], "device_ms": t["device_ms"],
           "plain_ms": time_ms(lambda: ref.kv_visit_attention_ref(q, kb, vb,
                                                                  ids, pos)),
           "bound_ms": b_ms, "bound_by": by, "library_ms": time_ms(library)}
    print(f"  kv_visit_attention, B={LONG_B} KV={kv} G={g} hd={hd}, "
          f"{ids.shape[-1]} of {nb} blocks of {LONG_BLOCK} ({keys} valid keys; "
          f"ids {ids.dtype}, pos {pos.dtype} as the decode step passes them): "
          f"err={err} ms={t['ms']:.4f} device_ms={t['device_ms']:.4f} "
          f"host_us={t['host_us']:.1f} ({t['kernels_per_call']:g} device "
          f"kernel per call: {t['kernel_names']}); int32 ids and pos: "
          f"ms={t32['ms']:.4f} device_ms={t32['device_ms']:.4f}; "
          f"plain_ms={row['plain_ms']:.4f} bound_ms={b_ms:.4f} ({by}) "
          f"library_ms={row['library_ms']:.4f} (SDPA over all {LONG_SLOTS} "
          f"slots; max |SDPA - kernel| {lib_err:.4g})", flush=True)

    q, kb, vb, ids, pos = server_call[:5]
    got = kv_visit.kv_visit_attention(q, kb, vb, ids, pos)
    err, scale = kv_err(got, ref.kv_visit_attention_ref(q, kb, vb, ids, pos))
    check(err <= KV_RTOL * scale, f"server shape: {err} from plain > "
                                  f"{KV_RTOL} x {scale}")
    s_ms, s_by, s_keys = kv_bound(q, ids, pos, kb.shape[3])
    ts = kv_visit_timing(q, kb, vb, ids, pos)
    check(ts["kernels_per_call"] == 1,
          f"server shape: {ts['kernels_per_call']} device kernels per call")
    print(f"  kv_visit_attention at the server shape (B={q.shape[0]} KV="
          f"{q.shape[1]} G={q.shape[2]}, {ids.shape[-1]} of {kb.shape[2]} "
          f"blocks of {kb.shape[3]}, positions {pos.tolist()}, {s_keys} valid "
          f"keys; ids {ids.dtype}, pos {pos.dtype} as the server passes them): "
          f"err={err} ms={ts['ms']:.4f} device_ms="
          f"{ts['device_ms']:.4f} host_us={ts['host_us']:.1f} "
          f"bound_ms={s_ms:.5f} ({s_by})", flush=True)
    return row


def lm_phase() -> dict:
    """The LM decode-serving path at Qwen3-8B's full width, LM_LAYERS deep
    -> the kernel table's row of kv_visit_attention."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.params import count_params
    from repro_torch.models.registry import build_model

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(LM_ARCH).replace(n_layers=LM_LAYERS,
                                      kv_block_prune=LM_PRUNE,
                                      kv_block_size=LM_BLOCK)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(LM_SEED))
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {count_params(params) / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
          f"initialised in {time.perf_counter() - t0:.1f} s", flush=True)
    # The launches of the main path: the served request sets and the
    # long-context decode, each counted from 0; not the planted fault's
    # replay between them (the kernel on altered inputs).
    ops.reset_kernel_launches()
    server_call, fault_case = lm_server_part(
        model, build_model(cfg, backend="torch"), params)
    served = ops.kernel_launches()
    served_fault(model, params, *fault_case)
    del fault_case
    ops.reset_kernel_launches()
    cache, call = lm_long_part(params)
    decoded = ops.kernel_launches()
    launches = {k: served.get(k, 0) + decoded.get(k, 0)
                for k in sorted({*served, *decoded})}
    print(f"  kernel launches on the LM path: {launches} (served sets "
          f"{served}, long-context decode {decoded})", flush=True)
    check(launches.get("kv_visit_attention", 0) > 0,
          "kernel kv_visit_attention was not launched on the LM path")
    row = kv_visit_row(cfg, cache, call, server_call)
    row["launches"] = launches["kv_visit_attention"]
    print(f"  LM phase peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return row


def family_prepare(model, params):
    """An encoder-decoder's cross cache (``fill_cross_cache``: stub frame
    embeddings (LM_SLOTS, LM_MAX_LEN // 4, d) from a generator, seed
    FAMILY_SEED, encoded once per fill) as a function of a fresh cache, for
    the server and each replay; None for a decoder-only model."""
    from repro_torch.models.encdec import EncDecLM
    if not isinstance(model, EncDecLM):
        return None
    gen = torch.Generator(device="cuda").manual_seed(FAMILY_SEED)
    frames = torch.randn((LM_SLOTS, LM_MAX_LEN // 4, model.cfg.d_model),
                         generator=gen, device="cuda", dtype=model.dtype)

    def prepare(cache):
        model.fill_cross_cache(params, cache, frames)
    return prepare


@contextlib.contextmanager
def routing(calls: "RecordedRoutes", forced: dict | None = None):
    """MoE routing, recorded or imposed. Without ``forced``: every
    ``moe.route`` call's expert ids are appended to ``calls``, and the gap
    between its k-th and (k+1)-th router probability to ``calls.gaps``.
    With ``forced`` (a dict): the calls take,
    in order, the recorded ids instead of their own (their gates from their
    own probabilities at those ids, normalised as ``route`` does);
    ``forced["flips"]`` gets, per call, the count on the device of the ids
    its own top-k would have chosen otherwise, and ``["decisions"]`` the
    number of ids. Teacher forcing of the routing, as the replays force the
    tokens: a kernel output one bf16 ulp from the plain one can swap a
    near-tied k-th and (k+1)-th expert, which moves the layer's output by a
    whole expert's share, so the backends are compared on one routing."""
    from repro_torch.models import moe
    route = moe.route
    order = iter(calls)

    def recording(p, x, cfg):
        probs, gates, idx = route(p, x, cfg)
        if forced is None:
            calls.append(idx)
            top = torch.topk(probs, cfg.moe.top_k + 1, dim=-1).values
            calls.gaps.append(top[..., -2] - top[..., -1])
            return probs, gates, idx
        want = next(order)
        forced.setdefault("flips", []).append((idx != want).sum())
        forced["decisions"] = forced.get("decisions", 0) + idx.numel()
        gates = torch.take_along_dim(probs, want, dim=-1)
        return probs, gates / gates.sum(-1, keepdim=True).clamp(min=1e-9), want
    moe.route = recording
    try:
        yield
    finally:
        moe.route = route


class RecordedRoutes(list):
    """``routing``'s record: the expert ids of each ``moe.route`` call, in
    order, and ``gaps``, each call's k-th minus (k+1)-th probability."""

    def __init__(self, items=()):
        super().__init__(items)
        self.gaps: list = []


def routing_reading(gaps: list, forced: dict, per_step: int) -> str:
    """The imposed routing's flips per MoE layer (``per_step`` calls, layer
    by layer, in each step) beside the recorded run's k-th minus (k+1)-th
    router probability ``gaps``."""
    flips = torch.stack(forced["flips"]).view(-1, per_step).sum(0).tolist()
    gaps = torch.cat([g.flatten() for g in gaps]).float()
    total = sum(flips)
    return (f"routing imposed: {total} of {forced['decisions']} expert "
            f"choices its own top-k would have made otherwise, by MoE layer "
            f"{flips}; served k-th minus (k+1)-th router probability: median "
            f"{float(gaps.median()):.3g}, {float((gaps < 1e-3).float().mean()):.3f}"
            f" of them below 1e-3")


def kv_kernel_name(cfg) -> str:
    """The launch counter of a pruned config's kv_visit_attention instance."""
    return "kv_visit_attention[int8]" if cfg.kv_cache_int8 \
        else "kv_visit_attention"


def ring_wrap(model, plain, params) -> None:
    """A sliding-window decode across the ring's wrap: a cache of ``window``
    slots (its codes and scales from a generator, seed 1, as an earlier
    request would have left them), positions RING_POS0 .. RING_POS0 +
    RING_STEPS - 1 on every slot, teacher-forced on both backends: each step
    writes ring slot pos % window and no other, logits finite and within
    LOGIT_ATOL of the plain backend's."""
    cfg = model.cfg
    w = cfg.sliding_window
    cache = model.init_cache(LM_SLOTS, w + LM_BLOCK)
    check(cache["k"].shape[2] == w, f"ring of {cache['k'].shape[2]} slots, "
                                    f"window {w}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for name in ("k", "v"):
        cache[name].random_(-127, 128, generator=gen)
        cache[f"{name}_scale"].uniform_(0.0, 0.05, generator=gen)
    cache_p = {k: v.clone() for k, v in cache.items()}
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (RING_STEPS, LM_SLOTS, 1)), device="cuda")
    worst, slots = 0.0, []
    for t in range(RING_STEPS):
        pos = torch.full((LM_SLOTS,), RING_POS0 + t, device="cuda")
        before = cache["k"].clone()
        lk, _ = model.decode_step(params, cache, toks[t], pos)
        lp, _ = plain.decode_step(params, cache_p, toks[t], pos)
        check(bool(torch.isfinite(lk).all()), f"ring step {t}: logits not "
                                              f"finite")
        worst = max(worst, float((lk - lp).abs().max()))
        changed = (cache["k"] != before).any(dim=(0, 1, 3, 4))
        written = torch.nonzero(changed).flatten().tolist()
        check(written == [(RING_POS0 + t) % w],
              f"ring step {t} (pos {RING_POS0 + t}) wrote slots {written}")
        slots.append(written[0])
    check(worst <= LOGIT_ATOL, f"ring wrap: logits differ by {worst}")
    print(f"  {cfg.name} ring wrap: positions {RING_POS0}-"
          f"{RING_POS0 + RING_STEPS - 1} wrote ring slots {slots} of {w}; "
          f"max |logit - plain| {worst:.4g}", flush=True)


def long_cache_int8(model, start: torch.Tensor) -> dict:
    """A long-context int8 cache: keys and values from a generator (seed 1,
    bf16) in the slots before each row's start position, zeros after,
    quantized as the decode quantizes (``quantize_kv``); zone maps over the
    written keys."""
    from repro_torch import numerics
    from repro_torch.models.layers import quantize_kv
    cfg = model.cfg
    cache = model.init_cache(LONG_B, LONG_SLOTS)
    gen = torch.Generator(device="cuda").manual_seed(1)
    written = (torch.arange(LONG_SLOTS, device="cuda")[None, :]
               < start[:, None])                                  # (B, S)
    nb = LONG_SLOTS // LONG_BLOCK
    big = numerics.finite_max(torch.bfloat16)
    w5 = written.view(LONG_B, nb, LONG_BLOCK, 1, 1)
    shape = cache["k"].shape[1:]
    for layer in range(cfg.n_layers):
        for name in ("k", "v"):
            x = torch.randn(shape, generator=gen, device="cuda",
                            dtype=torch.bfloat16) * written[:, :, None, None]
            cache[name][layer], cache[f"{name}_scale"][layer] = quantize_kv(x)
            if name == "k":
                kb = x.view(LONG_B, nb, LONG_BLOCK, cfg.n_kv_heads, -1).float()
                cache["kmin"][layer] = torch.where(w5, kb, big).amin(dim=2)
                cache["kmax"][layer] = torch.where(w5, kb, -big).amax(dim=2)
            del x
    return cache


def family_long_part(cfg, params, server_call) -> tuple[dict, dict]:
    """deepseek-moe-16b's long-context int8 decode: B = LONG_B at LONG_SLOTS
    slots, LONG_PRUNE of 64 blocks of LONG_BLOCK keys, LONG_STEPS steps
    teacher-forced on both backends, every kernel call held against its
    plain version; warm step times pruned and on the full int8 cache ->
    (the kernel row of the int8 instance, read also on ``server_call``, the
    launches)."""
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model

    lcfg = cfg.replace(kv_block_prune=LONG_PRUNE, kv_block_size=LONG_BLOCK)
    model = build_model(lcfg)
    plain = build_model(lcfg, backend="torch")
    start = torch.tensor([LONG_SLOTS - 1 - LONG_STEPS - 64 * b
                          for b in range(LONG_B)], device="cuda")
    t0 = time.perf_counter()
    cache = long_cache_int8(model, start)
    cache_p = {k: v.clone() for k, v in cache.items()}
    torch.cuda.synchronize()
    kv_gb = sum(cache[k].nbytes for k in ("k", "v", "k_scale", "v_scale"))
    print(f"  {lcfg.name} long context: int8 K/V + scales {kv_gb / 1e9:.2f} "
          f"GB per copy (two copies), filled in {time.perf_counter() - t0:.1f}"
          f" s; positions {start.tolist()}; device memory "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, lcfg.vocab_size, (LONG_STEPS, LONG_B, 1)), device="cuda")
    worst = 0.0
    shadow = {"calls": 0, "err": 0.0, "rel": 0.0}
    forced: dict = {}
    gaps: list = []
    ops.reset_kernel_launches()
    for t in range(LONG_STEPS):
        vk, vp, routes = [], [], RecordedRoutes()
        with plain_shadow(shadow), routing(routes):
            lk, _ = model.decode_step(params, cache, toks[t], start + t,
                                      visits=vk)
        with routing(routes, forced):
            lp, _ = plain.decode_step(params, cache_p, toks[t], start + t,
                                      visits=vp)
        worst = max(worst, float((lk - lp).abs().max()))
        gaps += routes.gaps
        check(torch.equal(vk[0][0], vp[0][0]),
              f"step {t}: layer-0 visit lists differ between the backends")
    launches = ops.kernel_launches()
    check(shadow["calls"] == LONG_STEPS * lcfg.n_layers
          == launches.get("kv_visit_attention[int8]", 0),
          f"{shadow['calls']} int8 kernel calls held against the plain "
          f"version, launches {launches}")
    check(worst <= LOGIT_ATOL,
          f"long-context int8 logits differ by {worst} > {LOGIT_ATOL}")
    print(f"  {LONG_STEPS} teacher-forced steps: each of {shadow['calls']} "
          f"kv_visit_attention[int8] calls within {shadow['err']:.4g} of its "
          f"plain version ({shadow['rel']:.4g} of its max |plain|; limit "
          f"{KV_RTOL:.4g}); max |logit kernel - plain| {worst:.4f} (limit "
          f"{LOGIT_ATOL}); layer-0 visit lists equal; on the plain steps "
          f"{routing_reading(gaps, forced, len(routes))}", flush=True)
    del cache_p
    gc.collect()
    torch.cuda.empty_cache()
    pos = start + LONG_STEPS - 1
    tok = toks[-1]
    for name, m in (("pruned", model),
                    ("full", build_model(lcfg.replace(kv_block_prune=0)))):
        for _ in range(2):
            m.decode_step(params, cache, tok, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LONG_TIMED_STEPS):
            m.decode_step(params, cache, tok, pos)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / LONG_TIMED_STEPS * 1e3
        print(f"  warm int8 decode step, B={LONG_B} at {LONG_SLOTS} slots, "
              f"kv_block_prune={m.cfg.kv_block_prune}: {ms:.2f} ms "
              f"({LONG_B * 1e3 / ms:.1f} tokens/s)", flush=True)
    call = decode_call(model, params, cache, tok, pos)
    return kv_int8_row(lcfg, cache, call, server_call), launches


def kv_int8_bound(q, ids, pos, bs: int) -> tuple[float, str, int]:
    """Bound of one int8 call: the valid keys' int8 K and V rows and their
    two float32 scales read once, q, the ids and the output once; 4 * G *
    hd flops per key for the attention and 2 * hd for the dequantization
    -> (ms, by, keys)."""
    _, _, g, hd = q.shape
    first = ids.long() * bs
    keys = int(((pos.long()[:, None, None] - first + 1).clamp(0, bs)
                * (ids >= 0)).sum())
    nbytes = keys * (2 * hd + 2 * 4) + 2 * q.numel() * q.element_size() \
        + ids.numel() * ids.element_size()
    return (*bound_ms(nbytes, (4.0 * g + 2.0) * hd * keys), keys)


def kv_int8_row(cfg, cache, call, server_call) -> dict:
    """Row 12b, the int8 instance at the long-context shape, on the inputs
    of the last step's layer-0 call: against its plain version and the
    bf16 instance on the dequantized cache, a planted fault;
    its time beside the bf16 instance's at the same shape and the
    gather-and-dequantize route's (gather the kept blocks and their scales,
    dequantize to bf16, the bf16 instance over them: every gathered key
    read, so not the same function, a yardstick of time only). Then the
    same reading at the server shape: ``server_call``, the served call with
    the most valid keys."""
    from repro_torch.kernels import kv_visit, ref

    q, kb, vb, ids, pos, ks, vs = call
    b, kv, g, hd = q.shape
    nb, bs = kb.shape[2], kb.shape[3]
    got = kv_visit.kv_visit_attention(q, kb, vb, ids, pos, ks, vs)
    want = ref.kv_visit_attention_ref(q, kb, vb, ids, pos, ks, vs)
    err, scale = kv_err(got, want)
    check(err <= KV_RTOL * scale, f"kv_visit_attention[int8] differs from "
                                  f"plain by {err} > {KV_RTOL} x {scale}")
    check(torch.equal(got, kv_visit.kv_visit_attention(q, kb, vb, ids, pos,
                                                       ks, vs)),
          "kv_visit_attention[int8] differs between identical calls")
    dropped = ids.clone()
    dropped[..., -1] = -1
    f_err, _ = kv_err(kv_visit.kv_visit_attention(q, kb, vb, dropped, pos, ks,
                                                  vs), want)
    check(f_err > KV_RTOL * scale,
          f"planted fault (last listed block dropped) passes: {f_err}")

    def dequantized(name):
        x = cache[name][0].to(q.dtype) * cache[f"{name}_scale"][0].to(q.dtype)
        return x.view(b, nb, bs, kv, hd).permute(0, 3, 1, 2, 4)
    kd, vd = dequantized("k"), dequantized("v")
    # the same operands; the int8 instance plans two blocks per SM, the
    # bf16 one one, so their merges run in another order
    d16, _ = kv_err(got, kv_visit.kv_visit_attention(q, kd, vd, ids, pos))
    check(d16 <= KV_RTOL * scale, f"the int8 instance differs from the bf16 "
                                  f"instance on the dequantized cache by "
                                  f"{d16}")
    keep = ids.shape[-1]
    local = torch.arange(keep, device="cuda").expand(b, kv, keep)
    every = torch.full((b,), keep * bs - 1, device="cuda")

    def gather_route():
        sel = ids.clamp(min=0)[..., None, None]
        kg = (torch.take_along_dim(kb, sel, 2).to(q.dtype)
              * torch.take_along_dim(ks, sel, 2).to(q.dtype))
        vg = (torch.take_along_dim(vb, sel, 2).to(q.dtype)
              * torch.take_along_dim(vs, sel, 2).to(q.dtype))
        return kv_visit.kv_visit_attention(q, kg, vg, local, every)
    b_ms, by, keys = kv_int8_bound(q, ids, pos, bs)
    t = kv_visit_timing(q, kb, vb, ids, pos, ks, vs)
    t16 = kv_visit_timing(q, kd, vd, ids, pos)
    check(t["kernels_per_call"] == 1,
          f"kv_visit_attention[int8]: {t['kernels_per_call']} device kernels "
          f"per call: {t['kernel_names']}")
    row = {"name": "kv_visit_attention[int8]", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/kv_visit.cu",
           "replaces": "src/repro/kernels/kv_visit.py:110", "launches": 0,
           "max_abs_err": err, "ms": t["ms"], "device_ms": t["device_ms"],
           "plain_ms": time_ms(lambda: ref.kv_visit_attention_ref(
               q, kb, vb, ids, pos, ks, vs)),
           "bound_ms": b_ms, "bound_by": by, "library_ms": None,
           "bf16_ms": t16["ms"], "bf16_device_ms": t16["device_ms"],
           "gather_route_ms": time_ms(gather_route)}
    print(f"  kv_visit_attention[int8], B={b} KV={kv} G={g} hd={hd}, {keep} "
          f"of {nb} blocks of {bs} ({keys} valid keys): err={err} (max "
          f"|plain| {scale:.4g}; planted fault {f_err:.4g}); {d16:.4g} from "
          f"the bf16 instance on the dequantized cache; ms={t['ms']:.4f} "
          f"device_ms={t['device_ms']:.4f} host_us={t['host_us']:.1f}; bf16 "
          f"instance ms={t16['ms']:.4f} device_ms={t16['device_ms']:.4f}; "
          f"gather-and-dequantize route ms={row['gather_route_ms']:.4f}; "
          f"plain_ms={row['plain_ms']:.4f} bound_ms={b_ms:.4f} ({by}); no "
          f"library call takes int8 K/V with scales", flush=True)

    q, kb, vb, ids, pos, ks, vs = server_call
    got = kv_visit.kv_visit_attention(q, kb, vb, ids, pos, ks, vs)
    err, scale = kv_err(got, ref.kv_visit_attention_ref(q, kb, vb, ids, pos,
                                                        ks, vs))
    check(err <= KV_RTOL * scale, f"kv_visit_attention[int8] at the server "
                                  f"shape: {err} from plain > {KV_RTOL} x "
                                  f"{scale}")
    s_ms, s_by, s_keys = kv_int8_bound(q, ids, pos, kb.shape[3])
    ts = kv_visit_timing(q, kb, vb, ids, pos, ks, vs)
    check(ts["kernels_per_call"] == 1,
          f"server shape: {ts['kernels_per_call']} device kernels per call")
    print(f"  kv_visit_attention[int8] at the server shape (B={q.shape[0]} "
          f"KV={q.shape[1]} G={q.shape[2]}, {ids.shape[-1]} of {kb.shape[2]} "
          f"blocks of {kb.shape[3]}, positions {pos.tolist()}, {s_keys} valid "
          f"keys): err={err} ms={ts['ms']:.4f} device_ms="
          f"{ts['device_ms']:.4f} host_us={ts['host_us']:.1f} "
          f"bound_ms={s_ms:.5f} ({s_by})", flush=True)
    return row


def family_part(arch: str, changes: dict) -> dict:
    """One model of the lm_families phase: random weights (seed FAMILY_SEED)
    on the card, the multi-block request set served (every kernel call held
    against its plain version) and replayed teacher-forced on the plain
    backend; h2o-danube also decodes across its ring's wrap,
    deepseek-moe-16b the long context -> its kernel launches (and the
    int8 row)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.params import count_params, leaves
    from repro_torch.models.registry import build_model

    torch.cuda.reset_peak_memory_stats()
    base = get_config(arch)
    cfg = base.replace(**changes)
    model = build_model(cfg)
    plain = build_model(cfg, backend="torch")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(FAMILY_SEED))
    torch.cuda.synchronize()
    cut = "" if cfg.n_layers == base.n_layers else \
        f" of {base.n_layers}, cut"
    print(f"  {cfg.name}: family {cfg.family}, {cfg.n_layers} layers{cut}, "
          f"d_model {cfg.d_model}; {count_params(params) / 1e9:.3f} B "
          f"parameters, {sum(t.nbytes for t in leaves(params)) / 1e9:.2f} GB; "
          f"kv_cache_int8={cfg.kv_cache_int8} kv_block_prune="
          f"{cfg.kv_block_prune}; initialised in {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    prepare = family_prepare(model, params)
    reqs = lm_requests(cfg, LM_SEED + 1, LM_MB_REQUESTS, LM_MB_PROMPT,
                       LM_MB_NEW, admit_all=True)
    tf_steps, routes = [], RecordedRoutes()
    shadow = {"calls": 0, "err": 0.0, "rel": 0.0}
    moe_family = cfg.family == "moe"
    ops.reset_kernel_launches()
    with plain_shadow(shadow), (routing(routes) if moe_family
                                else contextlib.nullcontext()):
        done, steps, seconds = lm_server(model, params, reqs, steps=tf_steps,
                                         prepare=prepare)
    launches = ops.kernel_launches()
    check(len(done) == LM_MB_REQUESTS, f"{cfg.name}: not all served")
    calls = steps * cfg.n_layers if cfg.kv_block_prune else 0
    check(shadow["calls"] == calls
          and launches.get(kv_kernel_name(cfg), 0) == calls,
          f"{cfg.name}: {shadow['calls']} kernel calls held against the plain "
          f"version, {steps} steps, launches {launches}")
    tokens = sum(r.output.size for r in done)
    kernel = (f"each of {shadow['calls']} {kv_kernel_name(cfg)} calls within "
              f"{shadow['err']:.4g} ({shadow['rel']:.4g} of its max |plain|) "
              f"of its plain version" if calls else "no kernel on this path")
    print(f"  {cfg.name}: {len(done)} requests (prompts "
          f"{LM_MB_PROMPT[0]}-{LM_MB_PROMPT[1] - 1}, {LM_MB_NEW} new), "
          f"{tokens} tokens in {steps} steps, {seconds:.2f} s "
          f"({seconds / steps * 1e3:.1f} ms/step, {tokens / seconds:.1f} "
          f"generated tokens/s); {kernel}; kernel launches {launches}",
          flush=True)
    forced: dict = {}
    with (routing(routes, forced) if moe_family
          else contextlib.nullcontext()):
        reading, _ = teacher_forced_check(cfg.name, plain, params, tf_steps,
                                          prepare)
    flips = ("; on the replay " + routing_reading(
        routes.gaps, forced, len(routes) // steps) if moe_family else "")
    print(f"  {cfg.name}: {reading['decisive'] - reading['differ']} of "
          f"{reading['decisive']} decisive tokens agree ({reading['tokens']} "
          f"generated){flips}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    del tf_steps, routes
    out = {"launches": launches, "row": None}
    if cfg.sliding_window:
        ring_wrap(model, plain, params)
    if arch == FAMILIES[0][0]:
        gc.collect()
        torch.cuda.empty_cache()
        out["row"], long_launches = family_long_part(cfg, params,
                                                     shadow["widest"])
        out["launches"] = {k: launches.get(k, 0) + long_launches.get(k, 0)
                           for k in {*launches, *long_launches}}
    del params, model, plain
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_families_phase(rows: list) -> None:
    """Every family's decode-serving path, one model at a time, each freed
    before the next; the int8 kernel row appended to ``rows`` and the
    kernels' launches on this phase's main paths added to theirs."""
    launches: dict[str, int] = {}
    int8_row = None
    for arch, changes in FAMILIES:
        out = family_part(arch, changes)
        for k, v in out["launches"].items():
            launches[k] = launches.get(k, 0) + v
        int8_row = out["row"] or int8_row
    print(f"  kernel launches on the lm_families paths: {launches}",
          flush=True)
    check(launches.get("kv_visit_attention[int8]", 0) > 0,
          "kv_visit_attention[int8] was not launched on the lm_families path")
    int8_row["launches"] = launches["kv_visit_attention[int8]"]
    for r in rows:
        if r["name"] == "kv_visit_attention":
            r["launches"] += launches.get("kv_visit_attention", 0)
    rows.append(int8_row)


def kv_build_check() -> None:
    """kv_visit.cu's instances: 0 spills in each (``ptxas -v``, from the
    build log kept beside the library), the keys per tile the wrapper plans
    with equal to the kernel's, and the dynamic shared memory (the ring) of
    each per thread block, as the built library reports them."""
    from repro_torch.kernels import _build, kv_visit
    log = _build.BUILD_LOG.get("kv_visit.cu")
    check(log is not None, "kv_visit.cu: no build log (ptxas -v) to read")
    n = 2 * len(kv_visit.DTYPES) * len(kv_visit.HEAD_DIMS)   # and int8 K/V
    spills = [int(k) for k in re.findall(r"(\d+) bytes spill stores", log)]
    check(len(spills) == n and not any(spills),
          f"kv_visit.cu spills (ptxas -v, {n} instances): {spills}")
    smem = []
    for int8 in (False, True):
        for dt in kv_visit.DTYPES:
            for hd in kv_visit.HEAD_DIMS:
                tile, nbytes = kv_visit.instance_shape(hd, dt, int8)
                check(tile == kv_visit.tile_keys(hd, dt),
                      f"kv_visit {dt} hd {hd} int8 {int8}: the kernel's tile "
                      f"is {tile} keys, the wrapper plans with "
                      f"{kv_visit.tile_keys(hd, dt)}")
                smem.append(f"{str(dt)[6:]}{' int8 K/V' if int8 else ''} hd "
                            f"{hd}: {tile} keys, {nbytes}")
    print(f"  kv_visit.cu: {n} instances, 0 bytes spill stores; keys per "
          f"tile and dynamic shared memory per block (B, as the library "
          f"reports them): "
          f"{', '.join(smem)}", flush=True)


def budget_specs() -> tuple:
    """(spec, B) of the budget phase: Count, Agg sum and TopK d3 at
    ``BUDGET_BATCH``, Ids at ``BUDGET_IDS_BATCH``."""
    from repro_torch.core import Agg, Count, Ids, TopK
    return ((Count(), BUDGET_BATCH), (Agg("sum", 3), BUDGET_BATCH),
            (TopK(k=10, dim=3), BUDGET_BATCH), (Ids(), BUDGET_IDS_BATCH))


def certified_counts(entry: dict) -> dict:
    """A ``BUDGET_torch.json`` entry as ``ops.counters()`` reports it."""
    want = dict(entry["launches"])
    if entry["host_syncs"]:
        want["host_sync"] = entry["host_syncs"]
    return want


def port_site(stack, filename: str, lineno: int) -> str:
    """The innermost frame of ``repro_torch`` in ``stack``, as
    file:line function: code (else the warning's own location)."""
    frames = [f for f in stack if "/repro_torch/" in f.filename]
    if not frames:
        return f"{filename}:{lineno}"
    f = frames[-1]
    name = f.filename.split("/src/")[-1]
    return f"{name}:{f.lineno} {f.name}: {(f.line or '').strip()}"


def spec_label(spec) -> str:
    """Count, Ids, "agg sum d3", "topk d3"."""
    if spec.kind == "agg":
        return f"agg {spec.op} d{spec.dim}"
    if spec.kind == "topk":
        return f"topk d{spec.dim}"
    return spec.kind


def count_label(counts: dict) -> str:
    """An ``ops.counters()`` dict as "op:n ... sync:n"."""
    ops_ = " ".join(f"{k}:{v}" for k, v in sorted(counts.items())
                    if k != "host_sync")
    return f"{ops_} sync:{counts.get('host_sync', 0)}"


class SyncWatch:
    """Synchronizing CUDA calls outside ``ops.device_get``.

    Under ``torch.cuda.set_sync_debug_mode("warn")`` PyTorch warns at each
    call that makes the host wait for the card (``.item()``, ``nonzero``,
    a device->host copy, a host->device copy from pageable memory); each
    warning is recorded with the innermost frame of the port that made it.
    The counted ``ops.device_get`` runs with the mode lifted — its transfer
    is the certified sync — and returns what it returns. Tracing stays off.
    """

    def __init__(self):
        self.sites: list[str] = []

    @contextlib.contextmanager
    def watch(self):
        from repro_torch.kernels import ops
        counted = ops.device_get

        def device_get(x):
            torch.cuda.set_sync_debug_mode(0)
            try:
                return counted(x)
            finally:
                torch.cuda.set_sync_debug_mode("warn")

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            shown = warnings.showwarning

            def record(message, category, filename, lineno, file=None,
                       line=None):
                if "called a synchronizing CUDA operation" in str(message):
                    self.sites.append(port_site(traceback.extract_stack(),
                                                filename, lineno))
                else:
                    shown(message, category, filename, lineno, file, line)
            warnings.showwarning = record
            ops.device_get = device_get
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield self
            finally:
                torch.cuda.set_sync_debug_mode(0)
                ops.device_get = counted


def sync_watch_check(dev) -> bool:
    """Whether ``SyncWatch`` sees a planted pageable upload and an
    ``.item()``, and sees neither a pinned non-blocking upload nor
    ``ops.device_get``'s own transfer."""
    from repro_torch.kernels import ops
    host = np.arange(1 << 20, dtype=np.float32)
    x = torch.ones(8, device=dev)
    planted = (("pageable upload", 1,
                lambda: torch.as_tensor(host, device=dev)),
               (".item()", 1, lambda: x.sum().item()),
               ("pinned non-blocking upload", 0,
                lambda: torch.from_numpy(host).pin_memory().to(
                    dev, non_blocking=True)),
               ("ops.device_get", 0, lambda: ops.device_get(x)))
    seen = {}
    for name, _, fn in planted:
        w = SyncWatch()
        with w.watch():
            fn()
        torch.cuda.synchronize()
        seen[name] = w.sites
    ok = all((len(seen[name]) > 0) == bool(want) for name, want, _ in planted)
    print("  sync-debug detector: " + "; ".join(
        f"{name} {len(seen[name])} ({seen[name][0] if seen[name] else '-'})"
        for name, _, _ in planted) + f" -> {'ok' if ok else 'BLIND'}",
        flush=True)
    return ok


class GcClock:
    """Milliseconds the interpreter spent collecting garbage while
    installed (``gc.callbacks``)."""

    def __init__(self):
        self.ms = 0.0
        self._t0 = None

    def _note(self, phase_, info) -> None:
        if phase_ == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self._t0 = None

    def __enter__(self) -> "GcClock":
        gc.callbacks.append(self._note)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._note)


def alloc_snapshot() -> tuple[int, int, int]:
    """(pinned host blocks, device segments, device allocation retries)
    that PyTorch's caching allocators have made so far: a new pinned block
    is a ``cudaHostAlloc``, a new segment a ``cudaMalloc``, a retry a
    ``cudaFree`` of the cache (-1 where this torch does not report it)."""
    host_stats = getattr(torch.cuda, "host_memory_stats", None)
    host = host_stats() if host_stats is not None else {}
    dev = torch.cuda.memory_stats()
    return (int(host.get("num_host_alloc", -1)),
            int(dev.get("segment.all.allocated", -1)),
            int(dev.get("num_alloc_retries", -1)))


def timed_launch(eng, qs, method, spec) -> tuple:
    """One ``launch_batch`` -> (its pending batch, host ms, what the
    allocators made during it as ``alloc_snapshot`` differences, gc ms)."""
    a0 = alloc_snapshot()
    with GcClock() as gcc:
        t0 = time.perf_counter()
        pb = eng.launch_batch(qs, method=method, spec=spec)
        ms = (time.perf_counter() - t0) * 1e3
    made = tuple(b - a for a, b in zip(a0, alloc_snapshot()))
    return pb, ms, made, gcc.ms


def behind_readings(eng, qs, method, spec, calls=BEHIND_CALLS) -> dict:
    """``launch_batch``'s host ms deeper behind in-flight batches: one
    batch launched, then ``calls`` more, each while every batch before it
    is still in flight (2 .. calls + 1 deep), then all finalized; twice.
    The first pass meets each depth for the first time, the second after
    it. Per pass: each call's host ms and what the allocators made during
    it, the first and the median ms, and the pinned blocks, device
    segments, retries and gc ms of the whole pass."""
    out = {}
    for label in ("first pass", "second pass"):
        torch.cuda.synchronize()
        pending = [eng.launch_batch(qs, method=method, spec=spec)]
        ms, per_call, gc_ms = [], [], 0.0
        for _ in range(calls):
            pb, t, m, g = timed_launch(eng, qs, method, spec)
            pending.append(pb)
            ms.append(t)
            per_call.append(m)
            gc_ms += g
        for pb in pending:
            pb.finalize()
        made = [sum(col) for col in zip(*per_call)]
        out[label] = {"ms": ms, "made": per_call, "first_ms": ms[0],
                      "median_ms": float(np.median(ms)),
                      "pinned_blocks": made[0], "segments": made[1],
                      "retries": made[2], "gc_ms": gc_ms}
    return out


def made_label(made, gc_ms: float) -> str:
    """Allocator and gc activity during a timed call, for the log."""
    return (f"pinned +{made[0]}, segments +{made[1]}, retries +{made[2]}, "
            f"gc {gc_ms:.1f} ms")


def budget_case(eng, eng_plain, qs, method, spec, context, cert) -> dict:
    """One (path, context, spec): warm; ``launch_batch``'s host ms on an
    idle card (with the device ms of the work it launched, CUDA events)
    and then behind that batch (as the pipelined server launches window
    k+1 while window k runs), with what the allocators and gc did during
    it; on ``BEHIND_METHODS`` (not Ids) ``behind_readings`` and the device
    events per batch (``device_kernels``); then ``launch_batch`` and
    ``finalize`` under ``SyncWatch`` with the counters reset -> the row
    the phase prints and checks."""
    from repro_torch.kernels import ops
    entry = cert["paths"][method][context]
    eng.launch_batch(qs, method=method, spec=spec).finalize()   # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    first = eng.launch_batch(qs, method=method, spec=spec)
    idle_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    pb, behind_ms, behind_made, behind_gc = timed_launch(eng, qs, method,
                                                         spec)
    first.finalize()
    pb.finalize()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end)
    deeper = kernels = None
    if method in BEHIND_METHODS and spec.kind != "ids":
        deeper = behind_readings(eng, qs, method, spec)
        kernels = device_kernels(lambda: eng.query_batch(
            qs, method=method, spec=spec), reps=3)[1]

    stage, fin = SyncWatch(), SyncWatch()
    ops.reset_counters()
    with stage.watch():
        pb = eng.launch_batch(qs, method=method, spec=spec)
    stage_counts = ops.counters()
    with fin.watch():
        got = pb.finalize()
    total_counts = ops.counters()
    plain = eng_plain.query_batch(qs, method=method, spec=spec)
    return {"method": method, "context": context, "spec": spec_label(spec),
            "batch": len(qs),
            "equal_plain": len(got) == len(plain) and all(
                same_result(spec, x, y) for x, y in zip(got, plain)),
            "stage": stage_counts,
            "stage_cert": certified_counts(entry["device_stage"]),
            "total": total_counts,
            "total_cert": certified_counts(entry["total"]),
            "uncounted_stage": stage.sites, "uncounted_finalize": fin.sites,
            "launch_host_ms_idle": idle_ms, "launch_host_ms_behind": behind_ms,
            "behind_made": behind_made, "behind_gc_ms": behind_gc,
            "deeper": deeper, "kernels_per_batch": kernels,
            "device_ms": device_ms}


def budget_faults(r: dict) -> list[str]:
    """What fails a budget row: counts off the certificate, an uncounted
    sync, a result off the plain engine's."""
    out = []
    if r["stage"] != r["stage_cert"]:
        out.append(f"device stage {r['stage']} != certificate "
                   f"{r['stage_cert']}")
    if r["total"] != r["total_cert"]:
        out.append(f"total {r['total']} != certificate {r['total_cert']}")
    for where in ("stage", "finalize"):
        if r[f"uncounted_{where}"]:
            out.append(f"{len(r[f'uncounted_{where}'])} uncounted sync(s) in "
                       f"the {where}, first at {r[f'uncounted_{where}'][0]}")
    if not r["equal_plain"]:
        out.append("results != the plain engine's")
    return out


def budget_phase(eng, eng_plain, queries, context, strict=True) -> list:
    """Every certified path by name at B = 128 of the workload (Ids at 32)
    under Count, Agg sum, TopK d3 and Ids, in ``context`` ("frozen" or
    "delta"): counted launches and syncs per stage beside
    ``BUDGET_torch.json``'s, uncounted syncs per stage with the first call
    site, ``launch_batch``'s host ms beside the device ms; every result
    equal to the plain engine's. With ``strict``, a blind detector fails
    the run at once, and any fault once every row is printed."""
    cert = json.loads((ROOT / "BUDGET_torch.json").read_text())
    detector_ok = sync_watch_check(eng.device)
    check(detector_ok or not strict, "budget: the sync-debug detector missed "
          "a planted sync (or saw one that is not)")
    rows, faults = [], []
    for method in BUDGET_METHODS:
        for spec, b in budget_specs():
            r = budget_case(eng, eng_plain, queries[:b], method, spec,
                            context, cert)
            rows.append(r)
            bad = budget_faults(r)
            faults += [f"{context} {method} {r['spec']}: {f}" for f in bad]
            cert_ = {k: "=" if r[k] == r[f"{k}_cert"]
                     else "!= " + count_label(r[f"{k}_cert"])
                     for k in ("stage", "total")}
            print(f"  {context:<6} {method:<13} {r['spec']:<11} "
                  f"B={r['batch']:<3} stage {count_label(r['stage'])} "
                  f"[cert {cert_['stage']}]; total "
                  f"{count_label(r['total'])} [cert {cert_['total']}]; "
                  f"uncounted syncs {len(r['uncounted_stage'])} stage, "
                  f"{len(r['uncounted_finalize'])} finalize; launch_batch "
                  f"host ms {r['launch_host_ms_idle']:.3f} idle, "
                  f"{r['launch_host_ms_behind']:.3f} behind a batch; "
                  f"device ms {r['device_ms']:.3f}"
                  + ("" if not bad else " FAULT"), flush=True)
            print(f"      behind a batch: "
                  f"{made_label(r['behind_made'], r['behind_gc_ms'])}",
                  flush=True)
            if r["kernels_per_batch"] is not None:
                print(f"      device events per batch (profiler, 3 "
                      f"batches): {r['kernels_per_batch']:.1f}", flush=True)
            for label, d in (r["deeper"] or {}).items():
                print(f"      deeper, {label}: host ms "
                      + " ".join(f"{t:.3f}" + ("[+{}/+{}/+{}]".format(*m)
                                               if any(m) else "")
                                 for t, m in zip(d["ms"], d["made"]))
                      + f" (first {d['first_ms']:.3f}, median "
                      f"{d['median_ms']:.3f}); "
                      + made_label((d["pinned_blocks"], d["segments"],
                                    d["retries"]), d["gc_ms"]), flush=True)
            for where in ("stage", "finalize"):
                for site in sorted(set(r[f"uncounted_{where}"])):
                    print(f"      uncounted in {where} "
                          f"(x{r[f'uncounted_{where}'].count(site)}): "
                          f"{site}", flush=True)
    check(not (strict and faults), "budget: " + "; ".join(faults[:8]))
    return rows


def columnar_batch_checks(eng, eng_plain, queries) -> None:
    """``ColumnarScan.mask_batch``, ``mask_batch_partial`` and
    ``count_batch`` at B = ``COLUMNAR_BATCH`` on the engine's (compacted)
    columnar scan: equal to the plain engine's, ``ORACLE_SAMPLE`` queries
    equal to ``numpy_scan_ids``; each call one counted op and one host sync,
    and no synchronizing CUDA call outside ``ops.device_get``."""
    from repro_torch.core import QueryBatch
    from repro_torch.core.scan import numpy_scan_ids
    from repro_torch.kernels import ops
    batch = QueryBatch.from_queries(queries[:COLUMNAR_BATCH])
    cols = eng.dataset.cols
    want_ids = [numpy_scan_ids(cols, batch[i]) for i in range(ORACLE_SAMPLE)]
    calls = (("mask_batch", {}), ("mask_batch_partial", {}),
             ("count_batch", {}), ("count_batch", {"partial": True}))
    for name, kw in calls:
        label = name + (" partial" if kw else "")
        fn = getattr(eng.columnar, name)
        fn(batch, **kw)                                  # warm
        watch = SyncWatch()
        ops.reset_counters()
        t0 = time.perf_counter()
        with watch.watch():
            got = fn(batch, **kw)
        ms = (time.perf_counter() - t0) * 1e3
        counts = ops.counters()
        want = getattr(eng_plain.columnar, name)(batch, **kw)
        if name == "count_batch":
            equal = got == want
            sample = all(got[i] == want_ids[i].size
                         for i in range(ORACLE_SAMPLE))
        else:
            equal = got.shape == want.shape and np.array_equal(got, want)
            sample = all(np.array_equal(np.nonzero(got[i])[0], want_ids[i])
                         for i in range(ORACLE_SAMPLE))
        print(f"  columnar {label:<19} B={len(batch)}: {ms:.3f} host ms; "
              f"counts {count_label(counts)}; uncounted syncs "
              f"{len(watch.sites)}; equal plain {equal}, numpy "
              f"{ORACLE_SAMPLE} {sample}", flush=True)
        check(equal and sample, f"columnar {label}: results differ")
        check(counts.get("host_sync") == 1 and len(counts) == 2
              and sum(counts.values()) == 2,
              f"columnar {label}: counts {counts} != one op + one sync")
        check(not watch.sites, f"columnar {label}: uncounted sync at "
              f"{watch.sites[:1]}")


def load_example(name: str):
    """The port example ``examples/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lm_example_checks(name: str, mod, out: dict) -> None:
    """An LM example's summary: train_lm_torch ran every step with finite
    logged losses; serve_lm_torch served exactly the requests whose features
    satisfy its admission query (numpy), each its max_new tokens."""
    if name == "train_lm_torch":
        losses = [r["loss"] for r in out["log"]]
        check(out["step"] == LM_EXAMPLE_STEPS and out["resumed_from"] is None
              and losses and all(np.isfinite(losses)),
              f"train_lm_torch: {out}")
        print(f"  train_lm_torch: {out['params']:,} parameters, losses "
              f"{[round(x, 4) for x in losses]}", flush=True)
        return
    want = {rid for rid, f in out["features"].items()
            if mod.MIN_PRIORITY <= f[0] <= 1.0 and 0.0 <= f[3] <= mod.MAX_COST}
    check(set(out["served"]) == want,
          f"serve_lm_torch served {sorted(out['served'])} != {sorted(want)}")
    check(all(t.shape == (mod.MAX_NEW,) for t in out["served"].values()),
          "serve_lm_torch: an output of another length")
    check(np.all(np.isfinite(out["losses"])), "serve_lm_torch: a loss")
    print(f"  serve_lm_torch: served {len(want)} of {len(out['features'])} "
          f"requests, {mod.MAX_NEW} tokens each; warm-up loss "
          f"{out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}", flush=True)


def run_examples(runs) -> dict:
    """Each (example, argv, kernel groups) of ``runs``: its ``main`` on the
    card; it launched a kernel of each group; an LM example's summary is
    checked (``lm_example_checks``). -> kernel launches summed."""
    from repro_torch.kernels import ops
    total: dict[str, int] = {}
    for name, argv, groups in runs:
        ops.reset_kernel_launches()
        t0 = time.perf_counter()
        mod = load_example(name)
        out = mod.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ops.kernel_launches()
        print(f"  {name}: {secs:.1f} s wall; kernel launches {launches}",
              flush=True)
        for group in groups:
            check(any(launches.get(k, 0) for k in group),
                  f"{name} launched none of {group}")
        if name.endswith("_lm_torch"):
            lm_example_checks(name, mod, out)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def lm_examples_part() -> dict:
    """``train_lm_torch`` (its demo preset, ``LM_EXAMPLE_STEPS`` steps, a
    checkpoint directory under ``build/`` removed after) and
    ``serve_lm_torch`` on cuda:0, each launching an admission kernel. ->
    their kernel launches."""
    import shutil
    ckpt = ROOT / "build" / "chip_examples"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        return run_examples([
            ("train_lm_torch", ["--device", "cuda:0", "--steps",
                                str(LM_EXAMPLE_STEPS), "--ckpt-dir",
                                str(ckpt)], (ADMISSION_KERNELS,)),
            ("serve_lm_torch", ["--device", "cuda:0"], (ADMISSION_KERNELS,))])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def examples_phase() -> dict:
    """Each port example's ``main`` on cuda:0: the MDRQ examples at their
    default size (their own asserts hold, and each launched a scan, a visit
    and a VA-filter kernel), then the two LM examples
    (``lm_examples_part``). -> kernel launches summed over the examples."""
    total = run_examples([(name, ["--device", "cuda:0"], EXAMPLE_KERNELS)
                          for name in EXAMPLES])
    for k, v in lm_examples_part().items():
        total[k] = total.get(k, 0) + v
    return total


def train_flops(cfg, n_params: int, batch: int, seq: int,
                enc_len: int = 0) -> float:
    """Model FLOPs of one train step: 6 per weight per token that meets it
    (2 forward, 4 backward) plus the products that weigh no parameter, each
    counted 2 per multiply-add forward and three times that with the
    backward; remat's recomputed forward is not model work and is not
    counted. Elementwise work (norms, gates, decays, the RG-LRU scan) is not
    counted.

    - dense: 6 N per token of the B S, N = ``n_params`` (every weight, the
      tied unembedding included), plus the attention's score and value
      products over the full square, 2 x 2 B S^2 H hd per layer forward,
      12 B S^2 H hd per layer with the backward;
    - moe: 6 N_active per token, N_active = ``cfg.param_counts()``'s active
      count: the attention, the router, the top-k of E experts and the
      shared experts (and the dense residual FFN) per layer, and both
      embedding tables; plus 12 B S^2 H hd per layer;
    - ssm (Mamba-2): 6 N per token, plus the chunked SSD's four products
      per layer, over the full square of each chunk as ``ssd_chunked``
      computes them (c = min(chunk, S), H heads of P, state N_s): C B^T
      (2 S c N_s H per row) and its product with x (2 S c P H), the
      chunk-final states and the inter-chunk output (2 S P N_s H each), so
      6 B S H (c (N_s + P) + 2 P N_s) per layer with the backward; no
      attention term;
    - hybrid (RecurrentGemma): 6 N per token, plus 12 B S^2 H hd for each
      of the n_layers // 3 local-attention layers alone (their window, 2,048
      keys, covers S = 512, so each is the full square); the recurrent
      layers add no product beyond their weights;
    - the encoder-decoder (``enc_len`` frames a row): 6 x (the encoder's
      weights) per encoder token (B enc_len), 6 x (each decoder layer's
      self-attention, cross-attention query and output projections and MLP,
      and the tied unembedding) per decoder token (B S), 6 x (each decoder
      layer's cross-attention key and value projections, which read the
      encoder output) per encoder token; plus 12 H hd x (B enc_len^2 per
      encoder layer, B S^2 + B S enc_len per decoder layer)."""
    h_hd = cfg.n_heads * cfg.resolved_head_dim
    if cfg.family == "ssm":
        s = cfg.ssm
        heads = s.expand * cfg.d_model // s.head_dim
        c = min(s.chunk, seq)
        per_head = (c * (s.state_dim + s.head_dim)
                    + 2 * s.head_dim * s.state_dim)
        ssd = 3 * 2 * batch * seq * heads * per_head
        return 6 * n_params * batch * seq + ssd * cfg.n_layers
    if cfg.family == "hybrid":
        return (6 * n_params * batch * seq
                + 3 * 4 * batch * seq * seq * h_hd * (cfg.n_layers // 3))
    if not enc_len:
        n = n_params if cfg.moe is None else cfg.param_counts()["active"]
        return (6 * n * batch * seq
                + 3 * 4 * batch * seq * seq * h_hd * cfg.n_layers)
    d, kv = cfg.d_model, cfg.n_kv_heads * cfg.resolved_head_dim
    mlp = 3 * d * cfg.d_ff
    enc_w = cfg.encoder_layers * (2 * d * h_hd + 2 * d * kv + mlp)
    dec_w = cfg.n_layers * (2 * d * h_hd + 2 * d * kv + 2 * d * h_hd + mlp) \
        + cfg.vocab_size * d
    cross_kv = cfg.n_layers * 2 * d * kv
    weights = 6 * (batch * seq * dec_w
                   + batch * enc_len * (enc_w + cross_kv))
    attn = 3 * 4 * h_hd * batch * (cfg.encoder_layers * enc_len * enc_len
                                   + cfg.n_layers * (seq * seq
                                                     + seq * enc_len))
    return weights + attn


def train_full_part() -> tuple:
    """(a) launch.train at full width -> (trainer, its checkpoint dir, its
    kernel launches)."""
    from repro_torch.core import MDRQEngine
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models.params import count_params

    ckpt = TRAIN_DIR / "full"
    ops.reset_kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = launch_train.run([
        "--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
        "--ckpt-every", str(TRAIN_STEPS), "--ckpt-dir", str(ckpt),
        "--device", TRAIN_DEVICE])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = ops.kernel_launches()
    print(f"  launch.train: {secs:.1f} s wall (model init, the admission "
          f"filter, {TRAIN_STEPS} steps, one checkpoint); kernel launches "
          f"{launches}", flush=True)
    check(any(launches.get(k, 0) for k in ADMISSION_KERNELS),
          f"the admission filter launched none of {ADMISSION_KERNELS}")

    pipe = tr.pipeline
    plain = MDRQEngine(pipe.features, structures=("scan", "kdtree"),
                       device=TRAIN_DEVICE, backend="torch")
    want = plain.query(pipe.query, method="auto")
    check(np.array_equal(pipe.admitted, want),
          "admitted ids differ from the plain-backend engine's")
    print(f"  admission: {pipe.admitted.size} of {pipe.cfg.n_pool} samples "
          f"via {pipe.filter_stats.method}, equal to the plain backend's",
          flush=True)

    log = tr.metrics_log
    losses = [r["loss"] for r in log]
    check([r["step"] for r in log] == list(range(1, TRAIN_STEPS + 1)),
          f"logged steps {[r['step'] for r in log]}")
    check(all(np.isfinite(losses)), f"a non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss at step {TRAIN_STEPS} "
          f"{losses[-1]} is not below step 1's {losses[0]}")
    check(tr.ckpt.latest_step() == TRAIN_STEPS,
          f"checkpoint steps {tr.ckpt.all_steps()}")

    cfg = tr.model.cfg
    step_s = float(np.median([r["sec"] for r in log[1:]]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = count_params(tr.params)
    flops = train_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    print(f"  losses: step 1 {losses[0]:.4f}, step {TRAIN_STEPS} "
          f"{losses[-1]:.4f}; all {[round(x, 4) for x in losses]}",
          flush=True)
    print(f"  train step ({cfg.name}, {n_params / 1e6:.1f} M parameters, "
          f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, remat {cfg.remat}): "
          f"{step_s * 1e3:.2f} ms/step (median of steps 2-{TRAIN_STEPS}), "
          f"{tokens / step_s:.0f} tokens/s, peak allocated "
          f"{peak / 1e9:.2f} GB, model FLOPs {flops:.4e} per step, "
          f"model-FLOP share {flops / (step_s * PEAK_BF16_FLOPS):.4f} of "
          f"{PEAK_BF16_FLOPS / 1e12:.1f} TFLOP/s dense bf16; "
          f"{nvidia_smi_line()}", flush=True)
    return tr, ckpt, launches


def train_serve_part(tr, ckpt) -> dict:
    """(b) launch.serve --ckpt-dir loads the last step; its greedy tokens
    equal a BatchServer's built on the trainer's final parameters. -> the
    served run's kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.registry import build_model
    from repro_torch.serve import BatchServer, admission_query

    ops.reset_kernel_launches()
    done = launch_serve.run([
        "--arch", TRAIN_ARCH, "--ckpt-dir", str(ckpt), "--device", TRAIN_DEVICE,
        "--kv-prune", str(LM_PRUNE), "--requests", str(TRAIN_SERVE_REQUESTS),
        "--max-new", str(TRAIN_SERVE_NEW)])
    launches = ops.kernel_launches()
    print(f"  launch.serve --ckpt-dir: kernel launches {launches}",
          flush=True)
    check(launches.get("kv_visit_attention", 0) > 0,
          "launch.serve --ckpt-dir launched no kv_visit_attention")
    cfg = get_config(TRAIN_ARCH).replace(kv_block_prune=LM_PRUNE,
                                         kv_block_size=32)
    model = build_model(cfg, device=TRAIN_DEVICE)
    want = BatchServer(model, tr.params, slots=4, max_len=128,
                       device=model.device).serve(
        launch_serve.requests(cfg, TRAIN_SERVE_REQUESTS, TRAIN_SERVE_NEW, 0),
        admission_query())
    check(done and [r.rid for r in done] == [r.rid for r in want],
          f"served {[r.rid for r in done]} != {[r.rid for r in want]}")
    for a, b in zip(done, want):
        check(np.array_equal(a.output, b.output),
              f"request {a.rid}: tokens {a.output} != {b.output}")
    print(f"  served {len(done)} requests from the checkpoint: tokens equal "
          f"to the trainer's parameters' ({sum(len(r.output) for r in done)} "
          f"tokens)", flush=True)
    return launches


def prefill_and_decode(model, params, toks: torch.Tensor,
                       frames: torch.Tensor | None = None) -> tuple:
    """(prefill's last-token logits, decode_step's after the same prompt),
    both float32; an encoder-decoder's prefill takes ``frames`` and its
    decode their cross cache (``fill_cross_cache``)."""
    b, n = toks.shape
    batch = {"tokens": toks}
    with torch.inference_mode():
        if frames is None:
            cache = model.init_cache(b, n)
        else:
            batch["enc_embeds"] = frames
            cache = model.init_cache(b, n, enc_len=frames.shape[1])
            model.fill_cross_cache(params, cache, frames)
        pre, _ = model.prefill(params, batch)
        for t in range(n):
            lg, cache = model.decode_step(
                params, cache, toks[:, t:t + 1],
                torch.full((b,), t, dtype=torch.int32, device=toks.device))
    return pre, lg


def train_prefill_part(tr, frames: torch.Tensor | None = None) -> None:
    """(c) prefill's last-token logits against decode_step over the same
    prompt, at full width on the trained parameters, within
    ``LOGIT_ATOL`` (Mamba-2 within ``PREFILL_SSM_BF16_ATOL``). For the scan
    families (the chunked SSD, the RG-LRU scan against the ported
    recurrences) also on a float32 copy of the same parameters: the float32
    prefill within ``PREFILL_F32_ATOL`` of the float32 decode, and each
    bf16 path within the same limit of its float32 counterpart."""
    from repro_torch.kernels import ops
    from repro_torch.models.params import map_tree
    from repro_torch.models.registry import build_model
    model = tr.model
    cfg = model.cfg
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_LEN),
                         generator=gen, device=TRAIN_DEVICE, dtype=torch.int32)
    pre, lg = prefill_and_decode(model, tr.params, toks, frames)
    err, top = ops.device_get(((pre - lg).abs().amax(),
                               lg[..., :cfg.vocab_size].abs().amax()))
    same = ops.device_get((pre[0, 0].argmax() == lg[0, 0].argmax()))
    limit = PREFILL_SSM_BF16_ATOL if cfg.family == "ssm" else LOGIT_ATOL
    print(f"  prefill vs decode over {PREFILL_LEN} tokens (B = {PREFILL_B}):"
          f" last-token logits max |diff| {float(err):.4f} at |logit| <= "
          f"{float(top):.2f} (limit {limit}); argmax of row 0 equal: "
          f"{bool(same)}", flush=True)
    check(float(err) <= limit,
          f"prefill vs decode logits differ by {float(err)}")
    if cfg.family not in ("ssm", "hybrid"):
        return
    model32 = build_model(cfg.replace(param_dtype="float32"),
                          device=TRAIN_DEVICE)
    p32 = map_tree(tr.params, lambda t: t.float())
    pre32, lg32 = prefill_and_decode(model32, p32, toks, frames)
    del p32
    errs = [float(e) for e in ops.device_get((
        (pre32 - lg32).abs().amax(), (pre - pre32).abs().amax(),
        (lg - lg32).abs().amax()))]
    print(f"  float32 copy of the same parameters: prefill vs decode "
          f"{errs[0]:.3e} (limit {PREFILL_F32_ATOL}); bf16 against float32: "
          f"prefill {errs[1]:.4f}, decode {errs[2]:.4f} (limit {limit} "
          f"each)", flush=True)
    check(errs[0] <= PREFILL_F32_ATOL,
          f"float32 prefill vs decode logits differ by {errs[0]}")
    check(max(errs[1:]) <= limit,
          f"a bf16 path is {max(errs[1:])} from its float32 counterpart")


def train_resume_part() -> None:
    """(d) a SimulatedPreemption at step RESUME_AT with checkpoints every
    RESUME_EVERY ends at RESUME_STEPS with the loss and parameters of an
    uninterrupted run, bit for bit (deterministic algorithms on)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, FilteredTokenPipeline
    from repro_torch.models.params import leaves
    from repro_torch.models.registry import build_model
    from repro_torch.train import (OptConfig, SimulatedPreemption, Trainer,
                                   TrainerConfig)

    cfg = get_config(TRAIN_ARCH).reduced()
    model = build_model(cfg, device=TRAIN_DEVICE)
    pipe = FilteredTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=RESUME_SEQ, global_batch=8,
        n_pool=2048, seed=0), device=TRAIN_DEVICE)
    opt = OptConfig(peak_lr=1e-3, warmup_steps=5, decay_steps=100)
    fail = {"n": 0}

    def hook(step):
        if step == RESUME_AT and fail["n"] == 0:
            fail["n"] += 1
            raise SimulatedPreemption()

    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for name, every, fh in (("preempted", RESUME_EVERY, hook),
                                ("uninterrupted", 10 * RESUME_STEPS, None)):
            tr = Trainer(model, pipe, opt, str(TRAIN_DIR / name),
                         TrainerConfig(num_steps=RESUME_STEPS,
                                       ckpt_every=every, log_every=1),
                         failure_hook=fh, device=TRAIN_DEVICE)
            tr.init_state()
            t0 = time.perf_counter()
            losses = {r["step"]: r["loss"] for r in tr.run()}
            runs.append((tr, losses, time.perf_counter() - t0))
    finally:
        torch.use_deterministic_algorithms(False)
    (a, la, sa), (b, lb, sb) = runs
    check(fail["n"] == 1, "the preemption was not raised")
    check(a.ckpt.all_steps() == [10, 20, 30],
          f"checkpoints {a.ckpt.all_steps()}")
    check(la[RESUME_STEPS] < la[1], "the reduced run's loss did not fall")
    check(la[RESUME_STEPS] == lb[RESUME_STEPS],
          f"resumed loss {la[RESUME_STEPS]!r} != uninterrupted "
          f"{lb[RESUME_STEPS]!r}")
    check(all(torch.equal(x, y) for x, y in zip(leaves(a.params),
                                                leaves(b.params))),
          "resumed parameters differ from the uninterrupted run's")
    print(f"  preemption at step {RESUME_AT}, resumed from step 20: loss at "
          f"step {RESUME_STEPS} {la[RESUME_STEPS]!r} bit-identical to the "
          f"uninterrupted run's, parameters equal; {sa:.1f} s and {sb:.1f} s "
          f"(reduced {cfg.name}, seq {RESUME_SEQ})", flush=True)


class FramedPipeline:
    """The MDRQ-filtered pipeline's tokens and labels with the
    encoder-decoder's stub frame embeddings beside them: (batch,
    ``frames``, d) float32 drawn from numpy seed (SEED, step), so a step's
    batch is a function of the step, as the pipeline's is."""

    def __init__(self, pipe, frames: int, d_model: int):
        self.pipe, self.frames, self.d_model = pipe, frames, d_model

    def batch(self, step: int) -> dict:
        out = self.pipe.batch(step)
        rng = np.random.default_rng((SEED, step))
        out["enc_embeds"] = rng.normal(size=(
            out["tokens"].shape[0], self.frames, self.d_model)).astype(
                np.float32)
        return out


def train_family_part(arch: str, changes: dict) -> tuple:
    """(e) - (h) A model of another family at its published widths
    trained TRAIN_FAMILY_STEPS steps through the Trainer on the MDRQ-filtered
    pipeline (the encoder-decoder's with stub frames): finite losses, the
    last below the first, a positive finite MoE aux loss at every step (zero
    for the others), the admission kernel launched; ms/step, tokens/s, peak
    memory (allocated, and reserved of the card's total) and the model-FLOP
    share printed. -> (trainer, kernel launches, the prefill check's frames
    or None)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, FilteredTokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models.params import count_params
    from repro_torch.models.registry import build_model
    from repro_torch.train import OptConfig, Trainer, TrainerConfig

    base = get_config(arch)
    cfg = base.replace(**changes)
    ops.reset_kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    t0 = time.perf_counter()
    model = build_model(cfg, device=TRAIN_DEVICE)
    pipe = FilteredTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, n_pool=16384, seed=SEED),
        device=model.device)
    enc_len = max(8, TRAIN_SEQ // 4) if cfg.encoder_layers else 0
    if enc_len:
        pipe = FramedPipeline(pipe, enc_len, cfg.d_model)
    tr = Trainer(model, pipe, OptConfig(peak_lr=3e-4, warmup_steps=5,
                                        decay_steps=TRAIN_FAMILY_STEPS),
                 str(TRAIN_DIR / arch), TrainerConfig(
                     num_steps=TRAIN_FAMILY_STEPS,
                     ckpt_every=10 * TRAIN_FAMILY_STEPS, log_every=1),
                 device=model.device)
    tr.init_state(SEED)
    aux: list = []
    step = tr.train_step

    def recording(params, opt_state, batch):
        out = step(params, opt_state, batch)
        aux.append(out[2]["aux_loss"])
        return out
    tr.train_step = recording
    log = tr.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    total = torch.cuda.get_device_properties(0).total_memory
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    launches = ops.kernel_launches()
    n_params = count_params(tr.params)
    cut = "" if cfg.n_layers == base.n_layers else \
        f" of {base.n_layers}, cut"
    layers = (f"{cfg.encoder_layers} + {cfg.n_layers}" if enc_len
              else str(cfg.n_layers))
    print(f"  {cfg.name}: family {cfg.family}, {layers} layers{cut}, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}; {n_params / 1e9:.3f} B "
          f"parameters; {TRAIN_FAMILY_STEPS} steps in {secs:.1f} s wall (init,"
          f" the admission filter, the steps); kernel launches {launches}",
          flush=True)
    check(any(launches.get(k, 0) for k in ADMISSION_KERNELS),
          f"{cfg.name}: the admission filter launched none of "
          f"{ADMISSION_KERNELS}")
    losses = [r["loss"] for r in log]
    aux = [float(a) for a in ops.device_get(torch.stack(aux))]
    check([r["step"] for r in log] == list(range(1, TRAIN_FAMILY_STEPS + 1)),
          f"{cfg.name}: logged steps {[r['step'] for r in log]}")
    check(all(np.isfinite(losses)), f"{cfg.name}: a non-finite loss {losses}")
    check(losses[-1] < losses[0], f"{cfg.name}: loss at step "
          f"{TRAIN_FAMILY_STEPS} {losses[-1]} is not below step 1's "
          f"{losses[0]}")
    if cfg.family == "moe":
        check(all(np.isfinite(aux)) and min(aux) > 0,
              f"{cfg.name}: aux losses {aux}")
    else:
        check(not any(aux), f"{cfg.name}: aux losses {aux}")
    step_s = float(np.median([r["sec"] for r in log[1:]]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ, enc_len)
    frames = f" + {enc_len} stub frames a row" if enc_len else ""
    print(f"  {cfg.name} losses: step 1 {losses[0]:.4f}, step "
          f"{TRAIN_FAMILY_STEPS} {losses[-1]:.4f}; all "
          f"{[round(x, 4) for x in losses]}; aux losses "
          f"{[round(x, 6) for x in aux]}", flush=True)
    print(f"  train step ({cfg.name}, batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}{frames}, remat {cfg.remat}): {step_s * 1e3:.2f} "
          f"ms/step (median of steps 2-{TRAIN_FAMILY_STEPS}), first step "
          f"{log[0]['sec']:.2f} s, {tokens / step_s:.0f} tokens/s, peak "
          f"allocated {peak / 1e9:.2f} GB (reserved {reserved / 1e9:.2f} GB of "
          f"{total / 1e9:.2f} GB, {retries} allocator retries), model FLOPs {flops:.4e} per step, "
          f"model-FLOP share {flops / (step_s * PEAK_BF16_FLOPS):.4f} of "
          f"{PEAK_BF16_FLOPS / 1e12:.1f} TFLOP/s dense bf16; "
          f"{nvidia_smi_line()}", flush=True)
    prefill_frames = None
    if enc_len:
        gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(SEED)
        prefill_frames = torch.randn((PREFILL_B, enc_len, cfg.d_model),
                                     generator=gen, device=TRAIN_DEVICE)
    return tr, launches, prefill_frames


def train_moe_serve_part(tr) -> dict:
    """(e) 8 requests served from the trained MoE parameters with an int8,
    pruned cache (``LM_PRUNE`` of ``LM_BLOCK``-key blocks): each
    ``kv_visit_attention[int8]`` call within ``KV_RTOL`` of its plain
    version, every request admitted and served its new tokens. -> the
    served run's kernel launches."""
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    cfg = tr.model.cfg.replace(kv_cache_int8=True, kv_block_prune=LM_PRUNE,
                               kv_block_size=LM_BLOCK)
    model = build_model(cfg)       # on "cuda", as lm_server's BatchServer
    reqs = lm_requests(cfg, LM_SEED + 2, TRAIN_SERVE_REQUESTS, LM_MB_PROMPT,
                       TRAIN_SERVE_NEW, admit_all=True)
    shadow = {"calls": 0, "err": 0.0, "rel": 0.0}
    ops.reset_kernel_launches()
    with plain_shadow(shadow):
        done, steps, seconds = lm_server(model, tr.params, reqs)
    launches = ops.kernel_launches()
    check(len(done) == TRAIN_SERVE_REQUESTS, f"{cfg.name}: not all served")
    calls = steps * cfg.n_layers
    check(shadow["calls"] == calls
          and launches.get("kv_visit_attention[int8]", 0) == calls,
          f"{cfg.name}: {shadow['calls']} kernel calls held against the "
          f"plain version, {steps} steps, launches {launches}")
    tokens = sum(r.output.size for r in done)
    print(f"  {cfg.name} served from the trained parameters (int8 cache, "
          f"prune {LM_PRUNE} of {LM_BLOCK}-key blocks): {len(done)} requests,"
          f" {tokens} tokens in {steps} steps, {seconds:.2f} s; each of "
          f"{shadow['calls']} kv_visit_attention[int8] calls within "
          f"{shadow['err']:.4g} ({shadow['rel']:.4g} of its max |plain|) of "
          f"its plain version; kernel launches {launches}", flush=True)
    return launches


def train_families_parts() -> dict:
    """(e) - (h), each model freed before the next. -> their kernel
    launches (training and serving)."""
    total: dict[str, int] = {}
    for arch, changes in TRAIN_FAMILIES:
        tr, launches, frames = train_family_part(arch, changes)
        if tr.model.cfg.family == "moe":
            served = train_moe_serve_part(tr)
            launches = {k: launches.get(k, 0) + served.get(k, 0)
                        for k in {*launches, *served}}
            check(served.get("kv_visit_attention[int8]", 0) > 0,
                  "the trained MoE's served run launched no "
                  "kv_visit_attention[int8]")
        else:
            train_prefill_part(tr, frames)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del tr, frames
        gc.collect()
        torch.cuda.empty_cache()
    return total


def train_phase() -> dict:
    """launch.train at full width, serving from its checkpoint, prefill
    against decode, the preemption resume at the reduced config, then the
    MoE and encoder-decoder parts. -> the kernel launches of the training
    runs and the served runs."""
    import shutil
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    try:
        tr, ckpt, trained = train_full_part()
        served = train_serve_part(tr, ckpt)
        train_prefill_part(tr)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        train_resume_part()
        gc.collect()
        torch.cuda.empty_cache()
        families = train_families_parts()
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    parts = (trained, served, families)
    return {k: sum(p.get(k, 0) for p in parts)
            for k in sorted({k for p in parts for k in p})}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    # cuBLAS reads this when its first handle is made: the train phase's
    # resume check turns on deterministic algorithms, which need it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.core import MDRQEngine
    from repro_torch.data import gmrqb
    from repro_torch.kernels import _build, ops

    with phase("device"):
        smi = nvidia_smi_line()
        print(f"  {smi}")
        print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} devices "
              f"{torch.cuda.device_count()}", flush=True)

    with phase("build"):
        _build.build()
        print(f"  nvcc build: {_build.BUILD_SECONDS:.1f} s")
        for src, log in _build.BUILD_LOG.items():
            for line in log.splitlines():
                if "registers" in line or "Compiling entry" in line:
                    print(f"  {src}: {line.strip()}")
        kv_build_check()

    with phase("data"):
        ds = gmrqb.build(N, seed=SEED)
        # the plain engine builds on a second thread beside the engine
        eng, eng_plain = side_by_side(
            lambda: MDRQEngine(ds, tile_n=TILE_N, rowscan=True),
            lambda: MDRQEngine(ds, tile_n=TILE_N, rowscan=True,
                               backend="torch"))
        queries = [q for _, q in gmrqb.mixed_workload(ds, 128, seed=SEED)]
        oracle = Oracle(eng, ds.cols, queries)
        print(f"  GMRQB n={ds.n} m={ds.m}; device array "
              f"{tuple(eng.columnar.data_dev.shape)} float32 per structure; "
              f"packed VA codes {tuple(eng.vafile.packed_dev.shape)} int32",
              flush=True)
        for name, secs in (("engine", eng.build_seconds),
                           ("plain engine", eng_plain.build_seconds)):
            print(f"  {name} build seconds (side by side): " + ", ".join(
                f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
        print(f"  device memory allocated: "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)

    with phase("kernels"):
        rows = kernel_phase(eng, queries)

    # The kernels of each path, counted over that path's phase alone.
    scan_kernels = [r for r in rows if r["name"].partition("[")[0] in (
        "multi_scan_tiles", "multi_scan_vertical", "masked_fill_tiles",
        "masked_agg_tiles", "range_scan_tiles", "range_scan_vertical")]
    rowscan_kernels = [r for r in rows if r["name"] == "range_scan_rows"]
    index_kernels = [r for r in rows
                     if r not in scan_kernels and r not in rowscan_kernels]

    def read_launches(kernels, path, by_method=None):
        launches = ops.kernel_launches()
        print(f"  kernel launches on the {path}: {launches}")
        for r in kernels:
            # "multi_scan_visit[vafile]": the multi_scan_visit launches of
            # the vafile path alone
            name, _, method = r["name"].partition("[")
            counts = by_method[method[:-1]] if method else launches
            r["launches"] = counts.get(name, 0)
            check(r["launches"] > 0,
                  f"kernel {r['name']} was not launched on the {path}")

    with phase("slice"):
        ops.reset_kernel_launches()
        topk_peak = slice_phase(eng, eng_plain, oracle, queries)
        read_launches(scan_kernels, "main path")
        print(f"  TopK B=128 peak device memory: {topk_peak / 1e9:.2f} GB")

    with phase("index"):
        ops.reset_kernel_launches()
        by_method = index_phase(eng, eng_plain, oracle, queries)
        read_launches(index_kernels, "two-phase paths", by_method)

    with phase("server"):
        server_phase(eng, ds)

    # The serving slice: the kernels its paths run, counted over each phase.
    def slice_launches(path, names):
        launches = ops.kernel_launches()
        print(f"  kernel launches on the {path}: {launches}", flush=True)
        for name in names:
            check(launches.get(name, 0) > 0,
                  f"kernel {name} was not launched on the {path}")

    with phase("calibrate"):
        ops.reset_kernel_launches()
        calibrate_phase(eng, eng_plain, oracle, queries)
        slice_launches("calibrate phase", (
            "multi_scan_tiles", "multi_scan_vertical", "multi_scan_visit",
            "multi_va_filter_packed"))

    with phase("pipeline"):
        ops.reset_kernel_launches()
        pipeline_phase(eng, ds)
        slice_launches("pipeline phase", ("multi_scan_tiles",
                                          "multi_scan_vertical"))

    with phase("dist"):
        launches = dist_phase(eng, ds, oracle, queries)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  kernel launches on the dist path: {launches}", flush=True)
        for name in ("multi_scan_tiles", "range_scan_tiles",
                     "masked_fill_tiles", "masked_agg_tiles"):
            check(launches.get(name, 0) > 0,
                  f"kernel {name} was not launched on the dist path")

    with phase("rowscan"):
        ops.reset_kernel_launches()
        rowscan_phase(eng, eng_plain, oracle, queries)
        read_launches(rowscan_kernels, "row-scan path")

    with phase("budget:frozen"):
        budget_phase(eng, eng_plain, queries, "frozen")

    with phase("delta"):
        ingest = delta_phase(eng, eng_plain, ds, queries)

    with phase("budget:delta"):
        budget_phase(eng, eng_plain, queries, "delta")

    with phase("compact"):
        compact_phase(eng, eng_plain, queries, *ingest)

    with phase("examples"):
        columnar_batch_checks(eng, eng_plain, queries)
        # The examples and the LM phases need the card's memory: free both
        # engines first (the delta phase's server holds the engine too).
        del eng, eng_plain, oracle, ingest
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  engines freed: {torch.cuda.memory_allocated() / 1e9:.2f} "
              f"GB allocated", flush=True)
        examples_phase()

    with phase("lm"):
        rows.append(lm_phase())

    with phase("lm_families"):
        lm_families_phase(rows)

    with phase("train"):
        launches = train_phase()
        print(f"  kernel launches on the training path: {launches}",
              flush=True)
        # rows 5, 6 or 8 (the admission filter), row 12 (the served run
        # from the checkpoint) and row 12b (the trained MoE's served run)
        for r in rows:
            r["launches"] += launches.get(r["name"], 0)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
