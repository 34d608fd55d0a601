#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Usage (from the root of a checkout, on a machine with an NVIDIA H100):

    python3 chip_smoke.py [--sf 10] [--repeat 10] [--profile]

Phases, each of which fails the script (non-zero exit) on any mismatch:

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: every CUDA kernel of ``src/repro_torch/kernels/csrc/`` is built
   from source into ``build/kernels/`` (one ``nvcc`` per source, all in
   parallel); prints the build seconds and the compiler's register report.
3. Kernels against their plain PyTorch versions on the card:
   ``scan_filter`` bit-identical and repeatable over every width 1..30 at
   1, 31, 33 and 1,025 groups a node with P = 1 and 8, bounds inside the
   codes, below 0, past the top code, crossed (lo > hi), equal and the
   whole int32 range, rows = padded_rows, ending inside a group and 0,
   both ``negate`` values, on 16-byte-aligned words and a misaligned copy
   (both variants); ``filtered_group_sum`` at Q1's
   shape (8 nodes x the lineitem rows per node, G = 6, C = 6) and on both
   of its variants (registers: (6, 6), (1, 1), (8, 8), (9, 7), (64, 1);
   shared slabs: (64, 64), (512, 6), (512, 64), (65, 1), (1, 9)), with N
   not a multiple of 4, groups outside [0, G) and no row passing, within
   rtol 1e-5 of the plain version in float64 (f32 sums in another order),
   and bit-identical from run to run.  The wire codec (``ef_encode``,
   ``ef_decode``, ``mask_fold``, ``mask_unfold``) bit-identical to its
   plain version at the CPU tests' shapes (low-bit widths l = 0..17,
   empty, full and duplicate-key rows), on node-stacked rows, and at the
   three SF 10 exchange shapes (q4_sj: 64 rows x 8,388,608 slots, l = 17;
   q18_sj: 131,072, l = 14; q14_promo_request: 262,144, l = 14);
   fold/unfold at ragged widths; then on adversarial inputs: capacities
   1, 31, 33, 1,023, 1,025, 4,096, 65,552 and 1,000,003 (rows on and off
   16-byte boundaries, so both the 16-byte and the scalar variants run,
   the aligned ones also from misaligned copies) by l in {0, 1, 2, 4, 7,
   8, 14, 16, 17}, with the top keys' high part at 15 (upper bits past
   ceil(cap / 32) words), keys below base and past base + domain
   (clipped), runs of equal keys across the kernels' tile boundaries and
   masks that are no prefix.  The same inputs twice give identical
   words.
4. Queries: ``TPCHDriver(sf, num_nodes=8, device="cuda")`` generates the
   packed TPC-H tables and places them on the card; q6, q1 and q1_kernel
   run through ``run_ir`` and must match the float64 oracle within rtol
   2e-4.  The launch counters are set to 0 before each query and read
   after it: q6 must launch ``scan_filter`` 3 times, q1 once, q1_kernel
   ``filtered_group_sum`` once and no scan.  The packed scans of q6, q1
   and q1_kernel's plans are then held bit-identical against the plain
   version on the resident words, twice.
   Then the exchange queries: q4_sj and q18_sj (packed/xla,
   packed/one_factor, raw/xla), q14_promo (auto: the bitset semi-join),
   q14_promo_request, q4 and q18, each against its oracle (q4 and q4_sj
   exactly, q14 and q18_sj within rtol 2e-4, q18's keys, values and
   fetched attributes exactly) and with no overflow.  Each query's
   launches must equal what its lowered plan implies: one ``scan_filter``
   per packed scan, and one each of the four codec kernels per request
   semi-join on the packed wire (none on the raw wire or the bitset).
   The codec kernels are then held against the plain version on the
   inputs the q4_sj and q18_sj runs gave them.
5. Bytes: per-node all-to-all bytes of each exchange query, packed and
   raw, and their ratio; packed must be smaller.
6. Times: warm median of each query (CUDA events), generation seconds and
   resident bytes; each kernel's time at its main-path shape beside its
   plain version, a PyTorch library call where one exists, and its bound
   (the codec kernels at the q4_sj and q18_sj inputs, with the share of
   ``ef_decode`` that its per-row marker pass ``ef_zeros`` takes; B1 at
   q6's ``l_shipdate`` input also as a CUDA graph of 20 calls, and beside
   the earlier one-warp-a-group kernel's time, ``EARLIER_MS``).
6b. The hand plans on the same driver: ``block_topk`` (B4),
   ``predicate_bitset`` (B5) and ``mbit_encode`` (B6) bit-identical to
   their plain versions, each twice: B4 over k in {1, 10, 100, 128},
   ragged N, masked and exhausted blocks, blocks of 1,000 to 12,288, and
   on adversarial values (equal blocks, ties straddling the k-th value,
   mixed -0.0 and +0.0, +-inf, subnormals) with k up to the block; B5
   over N in {1, 4, 31, 32, 33, 1,025, 1,028, 187,500, 7,500,001} with 1
   and 8 rows and over 70,000 rows of 33 and 36, the value absent,
   present in every row, random and the int32 extremes, each on its own
   storage and on a copy 4 bytes past 16 bytes (both variants must run);
   B6 over m in {4, 8, 16}, groups 1 to 1,024 and rows that end in half a
   word, then over m in {1, 2, 4, 8, 16, 32} x groups {1, 2, 3, 4, 5, 32,
   625, 1,000, 1,024, 4,096} wherever the group divides a row of 375,
   1,250, 12,500, 12,288 or 30,000 values, as 1-, 2- and 3-D inputs, with
   all-zero groups and group maxima of 2^31 - 1, 2^m - 1 and 2^m planted
   (every unit of the kernel runs).  Then q1, q1_kernel, q6, q4, q18,
   q15, q15_1factor, q15_approx, q21 and q21_late through ``drv.run(name)``, each against its oracle
   (q1, q1_kernel, q6 within rtol 2e-4; q4 exactly; q15 and q18 keys
   exactly, values within rtol 2e-4; q21 keys and counts exactly), no
   overflow, q15_approx shipping fewer bits than the naive variant.  The
   counters are set to 0 before each plan: ``block_topk`` once in q15,
   q15_1factor and q15_approx, ``mbit_encode`` once in q15_approx,
   ``predicate_bitset`` once in q21 (never in q21_late, which launches the
   four codec kernels once on its packed request), ``filtered_group_sum``
   once in q1_kernel, nothing else.  B4-B6 are then held against their
   plain versions on the plans' own inputs and at the lineitem size (8 x
   the lineitem rows per node: B4 at k = 100, unmasked and masked by
   Q15's window; B5; B6 at m = 8).  Times: each plan's warm median, each
   kernel at its main-path input and at the lineitem size (device time of
   a CUDA graph of 20 calls, and an eager loop's time a call beside it)
   beside its plain version, its bound and (B4) ``torch.topk`` on the
   (blocks, block) view; B5's and B6's beside the earlier kernels' times
   (``EARLIER_MS``).
6c. The semi-join hand plans on the same driver: q2, q3, q3_lazy,
   q3_repl, q5, q11, q13 and q14 through ``drv.run(name)``, each against
   its oracle (q2, the q3s and q11: keys exactly, values within rtol
   2e-4; q5 within rtol 2e-4, atol 1e-2; q13 exactly; q14 within rtol
   2e-4), no overflow.  The counters are set to 0 before each plan:
   ``predicate_bitset`` once in q3 and in q11; the four codec kernels
   once for each packed request semi-join (q2, q14, and each of
   q3_lazy's rounds, whose count is printed), ``ef_encode`` and
   ``ef_decode`` once for q5's int32-reply request and for each packed
   owner-routed exchange (q2, q13); nothing else.  B5 is held against its
   plain version on q3's and q11's inputs; times: each plan's warm
   median and B5 at those inputs; the phase's seconds.
6d. Prepared statements on the same driver.  ``scan_filter`` with its
   bounds as int32 tensors on the card, bit-identical to its plain
   version over every width 1..30 with (B,) lanes of bounds for B in
   {1, 2, 8, 64} and 0-d bounds (empty, negative, past the top code,
   crossed, equal and int32-extreme ranges in every run), rows ending
   inside the last group, both ``negate`` values, on its own storage
   and on a copy 4 bytes past 16 bytes (both variants).  Then q1, q6
   and q14_promo (``auto`` and ``alt="request"``) from
   ``PARAM_QUERIES``, each prepared once and executed at its default
   binding and 8 ``random_binding`` draws (a fixed generator), each
   answer against ``oracle_params`` + the oracle (rtol 2e-4; q14_promo
   also atol 1e-2), no overflow; ``execute_batch`` of the 8 draws, each
   lane byte-equal to its scalar execute (q1's lanes, the batched lane
   mask product, against the oracle, their distance from the executes
   printed).  Launches, the counters set to 0 before each call: an
   execute runs ``scan_filter`` once a packed scan and the four codec
   kernels once a packed request semi-join, nothing else; an
   ``execute_batch`` the same scans whatever B is, the codec once a
   lane.  One lowering per shape and per batched specialization
   (``compile_events``).  q14_promo's request exchange at the capacity
   the literal one-month query derives: the one-month lane equals the
   oracle and only a five-year lane overflows.  A q6 execute captured
   in a CUDA graph, replayed after its parameter tensors are overwritten
   with two other bindings: each replay equals that binding's oracle and
   execute.  Times: warm medians of ``execute`` and ``execute_batch(8)``
   (CUDA events) and ms a binding; ``scan_filter`` at q6's
   ``l_shipdate`` input with 1 and 8 lanes of bounds, beside 8 x the one
   lane time, the plain version and the bound; the phase's seconds.
6e. The two-tier query path on the same driver.  ``build_cubes()``
   builds the default cubes (``tpch.cubes``: lineitem_pricing, 516
   cells, and orders_status, 1,275, both one-hot products summed in
   chunks under ``core.aggregation.ONEHOT_MAX_BYTES``), launching no
   kernel; each cube's build seconds and peak allocated bytes.  Each
   finest rollup against a float64 numpy group-by of the host tables
   (sums within rtol 2e-4; min, max, and counts and rows up to 2^24
   exactly, larger counts within rtol 1e-6), every coarser rollup against
   the float64 marginals of the finest.  Two kernel-method cubes
   (returnflag x linestatus with sum_qty and count_order, B2's register
   variant; lineitem_pricing's six measures over returnflag x linestatus
   x the year of l_shipdate, 48 cells x 7 columns, its shared slabs):
   ``filtered_group_sum`` launched exactly once a build, each equal to
   the numpy group-by and within rtol 2e-4 of its one-hot twin.  Each
   ``SERVING_QUERIES`` entry through ``drv.query`` at tier 1 from the
   expected cube and ``uncovered_query`` at tier 2 (the launches its plan
   implies), each against the float64 oracle or a numpy group-by (rtol
   2e-4); the prepared ``q1_param`` at an on-edge binding from tier 1,
   off-edge and out of range from tier 2, against the oracle.  At SF 0.1:
   raw storage over a budget between the packed and the raw bytes raises
   ``ResidentBudgetError``, packed storage under it does not.  Times:
   ``measure_query`` (tier 1 in microseconds, trimmed median of 10; tier
   2 in ms, of 3, the card synchronized around each) for each serving
   query; the metrics report; the phase's seconds.
7. The language model, after the TPC-H phases have
   dropped what they placed on the card:
   a. B7's two CUDA variants.  The f32 CUDA-core ``flash_attention_fwd``
      against its plain version computed in f32 from the same inputs: f32
      within 2e-5 and bf16 within one bf16 rounding (rtol 2^-8, atol
      1e-5) over H/KV in {4/4, 8/2, 8/1}, causal, window 4, prefix 8,
      both, non-causal, ragged and mixed lengths, D = 8 .. 256, a fully
      masked row (0), and the prefill shape (8, 8, 4096, 128) bf16; lse
      within 2e-5.  The tensor-core ``flash_attention_fwd_tc`` against the
      plain version with the same rounding (``p_dtype`` = bf16 or f16:
      p rounded before p v) over every mask at D = 64, 128 and 256 with
      G = 1, 2, 3, 4 and 8, ragged and uneven lengths, a fully masked row,
      in bf16 and f16, and the prefill shape in bf16: out within one
      rounding of its type plus 1e-5, plus the rounding slack (where the
      plain version's p lies within 2^-16 of a rounding boundary, the
      kernel's p, summed in another order, may round the other way; the
      slack is what that moves the output), lse within 2e-5; its distance
      from the f32 plain version is printed.  ``decode_attention`` (B9)
      likewise over f32, bf16 and int8 caches at (4, 4, 16) x 64,
      (8, 8, 128) x 4160, (2, 8, 256) x 300, (3, 12, 20) x 200 and
      decode_32k's 32,768 positions, the length a 0-d int32 on the card at
      0 (zeros), 1, 37, each boundary of the launch's split (a block of
      one position, every warp one full tile) and Smax.  Each twice:
      identical.  Then B9 captured alone in a CUDA graph and replayed at
      three other lengths, each replay equal to an eager call.
   b. Path (i): qwen2.5-3b at full width (36 layers, d_model 2048, random
      weights from seed 0, cast once to bf16), batch 4: prefill of 4,096
      tokens with ``attn_impl="flash"``, then ``decode_loop`` of 64 greedy
      tokens with the sharded head (shards 8, k 8), one captured step
      replayed as a CUDA graph.  Launches: the tensor-core B7 36 times,
      the f32 CUDA-core B7 and B9 never.  The same 64 steps run eagerly on
      a copy of the state, teacher-forced: the same tokens, logits within
      rtol 2^-8.  The same prefill with the plain B7, the plain path's
      decode steps teacher-forced on the same tokens, and a prefill of
      4,095 tokens plus one decode step, each within 0.05 x the largest
      |logit|; the sharded head equals argmax on every step.  A sampled
      decode of 8 steps through the graph (its generator registered):
      every drawn token among its step's top 8.
   c. Path (ii): the int8 cache, 512 prompt tokens fed one a step
      (``decode_loop(forced=...)``), then 64 greedy tokens, each loop
      replayed from one captured graph: B9 36 x 576 times (a replay adds
      the launches recorded at capture), B7 never; the 64 greedy steps
      run eagerly on a copy of the state give the same tokens, logits
      within rtol 2^-8; logits within rtol 0.1, atol 0.15 of the bf16
      cache fed the same tokens, the int8 argmax among its top 5 on every
      row and step.
   d. The tensor-core B7 on each of the 36 layers' prefill inputs of path
      (i) within the limit of 7a, and B9 on each layer's input of path
      (ii)'s last (eager) step against its plain version within one bf16
      rounding (rtol 2^-8, atol 1e-5).
   e. Times (CUDA events, medians of warm runs): prefill, time to first
      token; decode ms a step for both flavours, graph-replayed (the whole
      loop, and the replays alone) and eager, and the device busy share
      of a replayed loop (torch.profiler); resident bytes; both B7
      variants and B9 at their main-path inputs (B9 also at 32,768
      positions; device time from a graph of calls) beside their plain
      versions, ``scaled_dot_product_attention`` and their bounds.
8. Training qwen2.5-3b at full width, after the serving phases have
   dropped what they placed on the card:
   a. B8's two CUDA variants.  The f32 CUDA-core ``flash_attention_bwd``
      against its plain version computed in f32 from the same inputs (out
      and lse from the f32 CUDA-core B7) over the f32 variant's shapes of
      7a and the training shape (4, 8, 4096, 128) bf16 causal: f32 within
      2e-5 of the largest |gradient|, bf16 within one output rounding on
      top of that (|got - want| <= 2^-8 |want| + 2e-5 max |want|).  The
      tensor-core ``flash_attention_bwd_tc`` (out and lse from the
      tensor-core B7) against the plain version with the same rounding (p
      rounded before p^T do, ds before ds k and ds^T q) over the
      tensor-core shapes of 7a in bf16 and f16 and the training shape in
      bf16: one rounding of the output type plus 2e-5 max |want|, plus the
      rounding slack; its distance from the f32 plain version printed.
      Both: a fully masked row gives zero gradients; each twice,
      identical.
   c. f32 parameters from seed 0, bf16 compute, remat full, one batch of
      2 x 4,096 tokens from ``SyntheticLM``: the first step's loss and
      gradients through B7 + B8 (``attn_impl="flash"``) against the plain
      chunked attention under autograd (``"xla"``), before any AdamW
      state exists: losses within 1e-2 relative, each parameter's
      gradient within ``GRAD_RTOL`` relative Frobenius distance (backed by
      ``tools/grad_fault_control.py``); then the tensor-core B8 on each of
      the 36 layers' inputs of that step within the limit of 8a.
   b. 4 AdamW steps on that batch through ``make_train_step(...,
      fwd_kw={"attn_impl": "flash"})``: every loss and gradient norm
      finite, the loss after the last step below the first step's, and
      exactly 72 tensor-core B7 launches (36 forward + 36 recompute) and
      36 tensor-core B8 launches a step, no other kernel (the f32
      CUDA-core variants never).
   d. ``launch/train.py main --smoke --device cuda --ckpt <dir>``: the
      loss falls over 30 steps; a second run to 32 steps resumes at the
      saved step 30 and runs steps 31 and 32.
   e. Times: the train step (CUDA events, median of the 3 warm steps),
      tokens/s, ``torch.cuda.max_memory_allocated``; both B8 variants at
      layer 0's training input beside their plain versions, the backward
      of ``scaled_dot_product_attention`` and the bound.
9. One ``{"kernels": [...]}`` line (fifteen entries: B7 and B8 once for
   each variant, the f32 CUDA-core ones with ``"main_path": false`` and
   0 launches; B2's launches those of q1_kernel and the two
   kernel-method cubes of 6e; B5's launches those of q21, q3 and q11,
   its times at q3's and q11's inputs under ``"q3"`` and ``"q11"``; B1
   twice, its batched entry ``scan_filter_batched`` with 8 lanes of
   bounds at q6's input and the launches of the ``execute_batch`` runs),
   then the last line ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when CUDA is unavailable or when
it is run outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA data sheet) for the bounds
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12     # tensor cores, dense

NODES = 8

# The redesigned kernels' earlier times on this script's yardsticks, one
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6): B1 (the kernel of one warp
# a 32-row group, an eager loop of 20 calls at q6's l_shipdate input), B6
# (the two-launch kernel, a CUDA graph of 20 calls at q15_approx's input
# and at the lineitem stress size) and B5 (the kernel of one warp a word,
# a CUDA graph of 20 calls at q21's input and at the lineitem stress
# size).  Printed beside this run's times, never compared.
EARLIER_MS = {"scan_filter": 0.1867, "mbit_encode": 0.0062,
              "mbit_encode stress": 0.2771, "predicate_bitset": 0.0017,
              "predicate_bitset stress": 0.1648}


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after a warm-up
    (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, rate: float = F32_OPS_PER_S) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over ``rate`` (by default the f32 rate)."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_query(torch, run, name: str, top: int = 6) -> tuple:
    """One warm run of ``run()`` under torch.profiler: device time by
    kernel (kernels replayed from a CUDA graph included), and the device's
    busy share of the run's wall time (the profiler's own overhead
    inflates the wall time).  Prints them; returns (busy ms, wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an operator's row repeats its kernels' time
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"{name} profile: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
          f"wall ({busy / wall_ms:.1%}), {sum(r[1] for r in rows)} kernel "
          f"launches; top: " + "; ".join(
              f"{key[:70]} x{n} {ms:.3f} ms" for ms, n, key in rows[:top]))
    return busy, wall_ms


def graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed (after a warm-up call): the host's cost of each
    launch, which eager timing of a short kernel measures instead, is
    left out."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def max_abs_diff(a, b) -> int:
    """Largest absolute difference of two integer or bool tensors of one
    shape, row by row (the q4_sj rows hold 8 M slots)."""
    if a.shape != b.shape:
        fail(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    return max((int((x.long() - y.long()).abs().max())
                for x, y in zip(a, b) if x.numel()), default=0)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _misaligned(torch, t):
    """A contiguous copy of int32 or bool ``t`` whose data starts 4 bytes
    past a 16-byte boundary (the kernels' scalar variants)."""
    skip = 4 // t.element_size()
    flat = torch.empty(t.numel() + skip, dtype=t.dtype, device=t.device)
    return flat[skip:].view(t.shape).copy_(t)


SCAN_GROUPS = (1, 31, 33, 1025)     # 32-row groups a node


def check_scan_filter(torch, compression, ops, ref, gen):
    """B1 against its plain version, bit-identical and repeatable: every
    width 1..30 at 1, 31, 33 and 1,025 groups a node, P = 1 and 8; bounds
    in range, below 0, past the top code, crossed (lo > hi), equal and the
    whole int32 range; rows = padded_rows, ending inside a group, and 0;
    both negate values; the words on 16 bytes and as a misaligned copy
    (the 16-byte and the scalar variant)."""
    from repro_torch.kernels.scan_filter import vector_loads

    n_cases = 0
    for width in range(1, 31):
        top = (1 << width) - 1
        for nodes in (1, NODES):
            for groups in SCAN_GROUPS:
                padded = 32 * groups
                codes = torch.randint(0, top + 1, (nodes, padded),
                                      generator=gen, device="cuda")
                words = compression.pack_bits(codes, width)
                mis = _misaligned(torch, words)
                if not vector_loads(words.data_ptr()) or vector_loads(
                        mis.data_ptr()):
                    fail("scan_filter inputs do not reach both variants")
                lo = int(codes[0, 0]) // 2
                hi = min(lo + (top + 1) // 3, top)
                inside = padded - 13     # rows end inside the last group
                for rows, a, b in ((padded, lo, hi), (inside, -5, hi),
                                   (0, lo, top + 7), (padded, lo + 1, lo),
                                   (inside, lo, lo),
                                   (padded, -(2 ** 31), 2 ** 31 - 1)):
                    for negate in (False, True):
                        want = ref.scan_filter(words, a, b, rows, padded,
                                               width, negate)
                        for w in (words, mis):
                            for _ in range(2):
                                got = ops.scan_filter(
                                    w, a, b, rows=rows, padded_rows=padded,
                                    width=width, negate=negate)
                                if not torch.equal(got, want):
                                    fail(f"scan_filter width={width} "
                                         f"P={nodes} groups={groups} "
                                         f"rows={rows} lo={a} hi={b} "
                                         f"negate={negate} aligned="
                                         f"{w is words} differs from its "
                                         f"plain version (or its first run)")
                        n_cases += 1
    torch.cuda.synchronize()
    print(f"scan_filter: bit-identical to the plain version and repeatable "
          f"over {n_cases} cases (widths 1..30 x groups a node "
          f"{SCAN_GROUPS} x P in {{1, {NODES}}} x 6 (rows, bounds) x negate), "
          f"each on 16-byte-aligned words and a misaligned copy")


def make_buckets(torch, gen, rows, cap, domain, nodes):
    """Sorted key buckets on the card, node-stacked: row r's keys lie in
    [(r % nodes) * domain, ... + domain).  Rows cycle through empty, full,
    duplicate keys (eight distinct offsets, full) and a random fill."""
    r = torch.arange(rows, device="cuda")
    kind = r % 4
    fill = torch.randint(1, cap + 1, (rows,), generator=gen, device="cuda")
    count = torch.where(kind == 0, 0, torch.where(kind == 3, fill, cap))
    offs = torch.randint(0, domain, (rows, cap), generator=gen,
                         device="cuda")
    dup = torch.randint(0, 8, (rows, cap), generator=gen,
                        device="cuda") * (domain // 8)
    offs = torch.where((kind == 2)[:, None], dup, offs)
    offs = torch.sort(offs, dim=1).values
    mask = torch.arange(cap, device="cuda") < count[:, None]
    base = (r % nodes) * domain
    keys = torch.where(mask, offs + base[:, None], 0).to(torch.int32)
    return keys, mask, base


def check_codec_rows(torch, ops, ref, keys, mask, base, domain, what):
    """ef_encode / ef_decode against the plain version on one input:
    bit-identical words, exact keys and mask, the same words twice."""
    cap = keys.shape[1]
    words = ops.ef_encode(keys, mask, base, domain=domain)
    again = ops.ef_encode(keys, mask, base, domain=domain)
    want = ref.ef_encode(keys, mask, base, domain)
    torch.cuda.synchronize()
    if not torch.equal(words, want):
        fail(f"ef_encode {what} differs from its plain version")
    if not torch.equal(words, again):
        fail(f"ef_encode {what} not repeatable")
    del want, again
    dk, dm = ops.ef_decode(words, base, capacity=cap, domain=domain)
    wk, wm = ref.ef_decode(words, base, cap, domain)
    torch.cuda.synchronize()
    if not (torch.equal(dk, wk) and torch.equal(dm, wm)):
        fail(f"ef_decode {what} differs from its plain version")
    if not (torch.equal(dm, mask) and torch.equal(dk, keys)):
        fail(f"ef_decode {what} does not recover the keys")


def check_wire_codec(torch, compression, ops, ref, gen):
    """B3 against its plain versions on the card."""
    shapes = [(8, 16), (33, 32), (64, 250), (100, 1000), (96, 4096),
              (257, 1875), (300, 187500), (64, 1875000)]
    for cap, domain in shapes:
        keys, mask, base = make_buckets(torch, gen, 4, cap, domain, 4)
        check_codec_rows(torch, ops, ref, keys, mask, base, domain,
                         f"cap={cap} domain={domain}")
        # node-stacked: rows src * P + dst encode with dst's base, the
        # receivers' rows dst * P + src decode with theirs
        keys, mask, base = make_buckets(torch, gen, 16, cap, domain, 4)
        words = ops.ef_encode(keys, mask, base, domain=domain)
        recv = words.reshape(4, 4, -1).transpose(0, 1).reshape(16, -1)
        rbase = (torch.arange(16, device="cuda") // 4) * domain
        dk, dm = ops.ef_decode(recv.contiguous(), rbase, capacity=cap,
                               domain=domain)
        if not torch.equal(dk.reshape(4, 4, cap),
                           keys.reshape(4, 4, cap).transpose(0, 1)):
            fail(f"node-stacked codec rows cap={cap} domain={domain}")
    print(f"ef_encode/ef_decode: bit-identical to the plain version at "
          f"{shapes} (l = 0..17; empty, full, duplicate-key and random "
          f"rows; node-stacked rows), repeatable")
    # the SF 10 exchange shapes, 64 = 8 x 8 node-stacked rows
    for what, cap, domain in (("q4_sj", 8388608, 1875000),
                              ("q18_sj", 131072, 187500),
                              ("q14_promo_request", 262144, 250000)):
        torch.cuda.empty_cache()
        keys, mask, base = make_buckets(torch, gen, NODES * NODES, cap,
                                        domain, NODES)
        check_codec_rows(torch, ops, ref, keys, mask, base, domain,
                         f"{what} shape")
        l, uw, lw = compression.ef_params(cap, domain)
        print(f"ef_encode/ef_decode at the SF 10 {what} shape (64 rows x "
              f"{cap} slots, domain {domain}, l={l}, "
              f"{uw + lw + compression.bitset_words(cap)} words a row): "
              f"bit-identical to the plain version, all rows")
        del keys, mask, base
    torch.cuda.empty_cache()
    for cols in (8, 32, 33, 97, 256, 4099, 131077):
        m = torch.rand((NODES * NODES, cols), generator=gen,
                       device="cuda") < 0.5
        words = ops.mask_fold(m)
        if not (torch.equal(words, ops.mask_fold(m))
                and torch.equal(words, ref.mask_fold(m))):
            fail(f"mask_fold cols={cols} differs from its plain version")
        back = ops.mask_unfold(words, n=cols)
        if not (torch.equal(back, ref.mask_unfold(words, cols))
                and torch.equal(back, m)):
            fail(f"mask_unfold cols={cols} differs from its plain version")
    print("mask_fold/mask_unfold: bit-identical to the plain version at "
          "ragged widths {8,32,33,97,256,4099,131077}, repeatable")


# Adversarial codec inputs: capacities whose rows start on no 16-byte
# boundary (scalar variants) and on one (16-byte variants), domains of a
# power of two for l = 0, 1, 2, 4, 7, 8, 14, 16, 17 (a power of two puts
# the top key's high part at 15), each with every kind of
# adversarial_buckets
CODEC_CAPS = (1, 31, 33, 1023, 1025, 4096, 65552, 1_000_003)
CODEC_DOMAINS = (16, 32, 64, 256, 2048, 4096, 2 ** 18, 2 ** 20, 2 ** 21)
CODEC_KINDS = ("top", "clip", "dups", "holes")


def adversarial_buckets(torch, gen, rows, cap, domain, kind):
    """Key buckets on the card, ascending over each row's valid slots,
    row r's keys based at r * domain; row 0 is full, the others hold a
    random count.  Kinds: "top" (the last 40 valid keys at the top of the
    domain: high part 15, so the upper bits spill past ceil(cap / 32)
    words), "clip" (keys from base - domain to base + 2 domain, clipped by
    the encoder), "dups" (runs of 61 equal keys, so runs straddle every
    tile boundary of the kernels), "holes" (a random mask, no prefix: the
    encoder and fold/unfold must not assume one)."""
    r = torch.arange(rows, device="cuda")
    j = torch.arange(cap, device="cuda")
    count = torch.randint(1, cap + 1, (rows,), generator=gen, device="cuda")
    count[0] = cap
    mask = j < count[:, None]
    lo, hi = (-domain, 2 * domain) if kind == "clip" else (0, domain)
    offs = torch.randint(lo, hi, (rows, cap), generator=gen, device="cuda")
    if kind == "dups":
        offs = torch.clamp((j // 61) * max(1, domain // (cap // 61 + 1)),
                           max=domain - 1).expand(rows, cap)
    offs = torch.sort(offs, dim=1).values
    if kind == "top":
        offs = torch.where(j >= count[:, None] - 40, domain - 1, offs)
    if kind == "holes":
        mask = torch.rand((rows, cap), generator=gen, device="cuda") < 0.5
    base = r * domain
    keys = torch.where(mask, offs + base[:, None], 0).to(torch.int32)
    return keys, mask, base


def check_codec_adversarial(torch, compression, ops, ref, gen):
    """B3's four kernels against their plain versions on CODEC_CAPS x
    CODEC_DOMAINS x CODEC_KINDS, the 16-byte-ready inputs also as
    misaligned copies: words, keys and masks bit-identical, every input
    encoded twice with the same words; ef_decode on every well-formed row
    (all but "holes").  Returns the cases run and how many took each
    variant."""
    from repro_torch.kernels import wire_codec as wc

    cases, variants = 0, collections.Counter()
    for cap in CODEC_CAPS:
        rows = 3 if cap > 100_000 else 5
        domains = CODEC_DOMAINS if cap < 100_000 else (256, 2 ** 21)
        for domain in domains:
            for kind in CODEC_KINDS:
                keys, mask, base = adversarial_buckets(torch, gen, rows, cap,
                                                       domain, kind)
                inputs = [(keys, mask)]
                if wc.vector_rows(cap, keys, mask):
                    inputs.append((_misaligned(torch, keys),
                                   _misaligned(torch, mask)))
                want = ref.ef_encode(keys, mask, base, domain)
                what = f"cap={cap} domain={domain} {kind}"
                for k, m in inputs:
                    variants["encode 16-byte" if wc.vector_rows(cap, k, m)
                             else "encode scalar"] += 1
                    words = ops.ef_encode(k, m, base, domain=domain)
                    again = ops.ef_encode(k, m, base, domain=domain)
                    folded = ops.mask_fold(m)
                    torch.cuda.synchronize()
                    if not torch.equal(words, want):
                        fail(f"ef_encode {what} differs from its plain "
                             f"version")
                    if not torch.equal(words, again):
                        fail(f"ef_encode {what} not repeatable")
                    if not torch.equal(folded, ref.mask_fold(m)):
                        fail(f"mask_fold {what} differs from its plain "
                             f"version")
                    variants["fold 16-byte" if wc.vector_rows(cap, m)
                             else "fold scalar"] += 1
                back = ops.mask_unfold(folded, n=cap)
                variants["decode and unfold 16-byte" if cap % 16 == 0
                         else "decode and unfold scalar"] += 1
                torch.cuda.synchronize()
                if not torch.equal(back, mask):
                    fail(f"mask_unfold {what} does not recover the mask")
                cases += 1
                if kind == "holes":
                    # EF decodes the i-th upper bit into slot i: these
                    # words are no valid row, which no decoder defines
                    continue
                dk, dm = ops.ef_decode(words, base, capacity=cap,
                                       domain=domain)
                wk, wm = ref.ef_decode(want, base, cap, domain)
                torch.cuda.synchronize()
                if not (torch.equal(dk, wk) and torch.equal(dm, wm)):
                    fail(f"ef_decode {what} differs from its plain version")
                # a clipped key decodes clipped
                if kind != "clip" and not (torch.equal(dk, keys)
                                           and torch.equal(dm, mask)):
                    fail(f"ef_decode {what} does not recover the keys")
    return cases, dict(variants)


def check_group_sum(torch, ops, ref, gen, n, num_groups, c, cutoff, *,
                    outside=False, none_pass=False):
    """B2 against the plain version in float64: rtol 1e-5, and identical
    from run to run.  ``outside`` draws groups from [-2, G + 2) (rows
    outside [0, G) are dropped), ``none_pass`` predicates that no row
    passes (the sums are exactly 0).  Returns (max_abs_err, inputs)."""
    from repro_torch.kernels.grouped_agg import uses_registers

    measures = torch.rand((NODES, n, c), generator=gen, device="cuda")
    lo, hi = (-2, num_groups + 2) if outside else (0, num_groups)
    groups = torch.randint(lo, hi, (NODES, n), generator=gen, device="cuda",
                           dtype=torch.int32)
    lo, hi = (cutoff + 1, 2 * cutoff + 1) if none_pass else (0, 2 * cutoff)
    pred = torch.randint(lo, hi, (NODES, n), generator=gen, device="cuda",
                         dtype=torch.int32)
    got = ops.filtered_group_sum(measures, groups, pred, cutoff=cutoff,
                                 num_groups=num_groups)
    again = ops.filtered_group_sum(measures, groups, pred, cutoff=cutoff,
                                   num_groups=num_groups)
    want = ref.filtered_group_sum(measures.double(), groups, pred, cutoff,
                                  num_groups)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"filtered_group_sum G={num_groups} C={c} not repeatable")
    err = (got.double() - want).abs()
    rel = float((err / want.abs().clamp_min(1e-30)).max())
    if rel > 1e-5:
        fail(f"filtered_group_sum G={num_groups} C={c} N={n}: max relative "
             f"error {rel} > 1e-5")
    path = ("registers" if uses_registers(num_groups, c) else "slabs") + (
        ", 16-byte loads" if uses_registers(num_groups, c) and n % 4 == 0
        else "")
    print(f"filtered_group_sum P={NODES} N={n} G={num_groups} C={c} "
          f"({path}{'; groups outside [0, G)' if outside else ''}"
          f"{'; no row passes' if none_pass else ''}): max relative error "
          f"{rel:.3e} (rtol 1e-5), repeatable")
    return float(err.max()), (measures, groups, pred)


def host_bounds(drv, name, d) -> tuple:
    """A lowered query's scan bounds for its own literals: the rewrite of
    decision ``d`` at the query's prepared binding, given on the host, so
    Python ints."""
    return d.rewrite.bounds(drv.prepare(name).binding())


def tpch_phases(args, torch, smi: str):
    """The TPC-H phases (3-6 of the module docstring): B1-B3 against
    their plain versions, the queries, bytes and times.  Returns (the
    kernels' entries of the JSON line, a summary dict).  Everything
    they placed on the card is dropped when they return."""
    from repro_torch.core import compression
    from repro_torch.core.columnar import PackedColumn
    from repro_torch.kernels import ops, ref
    from repro_torch.tpch import dbgen
    from repro_torch.tpch.driver import TPCHDriver
    from repro_torch.tpch.schema import DEFAULT_PARAMS as DP

    # -- 3. kernels against their plain versions -------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_scan_filter(torch, compression, ops, ref, gen)
    rows_per_node = dbgen.table_sizes(args.sf, NODES)["lineitem"] // NODES
    cutoff = DP.q1_shipdate_max
    fgs_err, fgs_inputs = check_group_sum(torch, ops, ref, gen,
                                          rows_per_node, 6, 6, cutoff)
    # both variants and the register variant's bounds on G * C; N not a
    # multiple of 4; groups outside [0, G); no row passing
    for n, g, c, kw in ((50_001, 512, 64, {}), (50_003, 6, 6, {}),
                        (4_099, 1, 1, {}), (65_536, 8, 8, {"outside": True}),
                        (30_001, 9, 7, {}), (30_000, 64, 1, {}),
                        (30_000, 65, 1, {}), (30_000, 1, 9, {}),
                        (4_097, 64, 64, {"outside": True}),
                        (50_001, 512, 6, {"outside": True}),
                        (50_000, 6, 6, {"none_pass": True}),
                        (50_001, 6, 6, {"none_pass": True})):
        check_group_sum(torch, ops, ref, gen, n, g, c, cutoff, **kw)
    check_wire_codec(torch, compression, ops, ref, gen)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n_cases, variants = check_codec_adversarial(torch, compression, ops,
                                                ref, gen)
    print(f"codec kernels: bit-identical to the plain version on {n_cases} "
          f"adversarial inputs (capacities {CODEC_CAPS}, domains "
          f"{CODEC_DOMAINS}, kinds {CODEC_KINDS}), each encoded twice "
          f"alike; variants run {variants} ({time.perf_counter() - t0:.1f} "
          f"s)")
    torch.cuda.empty_cache()

    # -- 4. queries through the port's main path --------------------------------
    t0 = time.perf_counter()
    drv = TPCHDriver(args.sf, num_nodes=NODES, device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    li = drv.placed["lineitem"]
    if li.columns["l_shipdate"].rows != rows_per_node:
        fail("lineitem rows per node differ from the kernel-check shape")
    li_bytes = sum(c.nbytes if isinstance(c, PackedColumn)
                   else c.numel() * c.element_size()
                   for c in li.columns.values())
    print(f"data: sf={args.sf} nodes={NODES} lineitem rows "
          f"{drv.tables['lineitem'].num_rows}, generated + placed in "
          f"{gen_s:.1f} s; resident {drv.resident_bytes} B on the card "
          f"(lineitem {li_bytes} B)")

    zero = dict.fromkeys(ops.launch_counts(), 0)
    expected = {"q6": {**zero, "scan_filter": 3},
                "q1": {**zero, "scan_filter": 1},
                "q1_kernel": {**zero, "filtered_group_sum": 1}}
    main_launches = dict(zero)
    import numpy as np

    for name, want in expected.items():
        ops.reset_launch_counts()
        out = drv.run_ir(name)["value"]
        torch.cuda.synchronize()
        got = ops.launch_counts()
        if got != want:
            fail(f"{name} launched {got}, expected {want}")
        for k, v in got.items():
            main_launches[k] += v
        value = out.cpu().numpy().astype(np.float64)
        oracle = np.asarray(drv.oracle(name), np.float64)
        if value.size != oracle.size or not np.isfinite(value).all():
            fail(f"{name}: shape {value.shape} / non-finite values")
        value = value.reshape(oracle.shape)
        rel = float(np.max(np.abs(value - oracle)
                           / np.maximum(np.abs(oracle), 1e-30)))
        if not np.allclose(value, oracle, rtol=2e-4, atol=0):
            fail(f"{name}: max relative error {rel} vs the oracle > 2e-4")
        print(f"{name}: matches the float64 oracle (max relative error "
              f"{rel:.3e}, rtol 2e-4); launches {got}")

    # the main-path scans, on the resident words, against the plain version
    # (twice: repeatable)
    from repro_torch.tpch.queries import IR_QUERIES

    scans = drv.compile_ir("q6").plan.scans
    scan_err, scanned = 0, []
    for name in expected:
        for d in drv.compile_ir(name).plan.scans:
            if d.mode != "packed":
                continue
            col = li.columns[d.column]
            args_ = (col.words, *host_bounds(drv, name, d))
            kw = dict(rows=col.rows, padded_rows=col.padded_rows,
                      width=col.width, negate=d.rewrite.negate)
            got = ops.scan_filter(*args_, **kw)
            want = ref.scan_filter(*args_, **kw)
            scan_err = max(scan_err,
                           int((got.long() - want.long()).abs().max()))
            if not (torch.equal(got, want)
                    and torch.equal(ops.scan_filter(*args_, **kw), got)):
                fail(f"{name} scan of {d.column} differs from its plain "
                     f"version (or its first run)")
            scanned.append(f"{name}:{d.column}")
    print(f"main-path scans {scanned}: bit-identical to the plain version "
          f"on the resident words, repeatable")

    # the exchange queries, each compiled under its wire and backend, and
    # the launches its lowered plan implies
    from repro_torch.core import exchange
    from repro_torch.tpch import queries as tq

    codec = ("ef_encode", "ef_decode", "mask_fold", "mask_unfold")

    def implied_launches(plan):
        """One scan_filter per packed scan; one of each codec kernel per
        request semi-join on the packed wire."""
        want = {**zero, "scan_filter": sum(d.mode == "packed"
                                           for d in plan.scans)}
        n_codec = sum(sj.alt == "request" and sj.wire.packed
                      for sj in plan.semijoins)
        want.update(dict.fromkeys(codec, n_codec))
        return want

    xq = {}
    for sj in ("q4_sj", "q18_sj"):
        q = getattr(tq, f"{sj}_ir")()
        for wire, backend in (("packed", "xla"), ("packed", "one_factor"),
                              ("raw", "xla")):
            xq[f"{sj}/{wire}/{backend}"] = (q, wire, backend, q.name)
    xq["q14_promo"] = (IR_QUERIES["q14_promo"], "packed", "xla", "q14_promo")
    q = tq.q14_promo_ir(alt="request")
    xq["q14_promo_request"] = (q, "packed", "xla", q.name)
    xq["q14_promo_request/raw/xla"] = (q, "raw", "xla", q.name)
    for name in ("q4", "q18"):
        xq[name] = (IR_QUERIES[name], "packed", "xla", name)

    # the codec inputs of the q4_sj / q18_sj packed runs, for the kernel
    # checks and times at the main-path shapes
    recorded = {}

    def recording(label):
        originals = {k: getattr(ops, k) for k in codec}

        def wrap(k):
            def call(*a, **kw):
                recorded.setdefault((label, k), (a, kw))
                return originals[k](*a, **kw)
            return call

        for k in codec:
            setattr(ops, k, wrap(k))
        return originals

    runs = {name: (lambda n=name: drv.run_ir(n)) for name in expected}
    a2a_bytes = {}
    for name, (q, wire, backend, oracle_of) in xq.items():
        fn = drv.compile_query(q, wire=wire, backend=backend)
        plan, want = fn.plan, implied_launches(fn.plan)
        runs[name] = run = (lambda f=fn: f(drv.columns()))
        label = name.split("/")[0]
        originals = (recording(label) if name.endswith("packed/xla")
                     else None)
        torch.cuda.empty_cache()
        exchange.reset_wire_bytes()
        ops.reset_launch_counts()
        out = run()
        torch.cuda.synchronize()
        got = ops.launch_counts()
        a2a_bytes[name] = exchange.wire_bytes()["all-to-all"]
        if originals is not None:
            for k, fn in originals.items():
                setattr(ops, k, fn)
        if got != want:
            fail(f"{name} launched {got}, its plan implies {want}")
        for k, v in got.items():
            main_launches[k] += v
        if bool(out.pop("overflow", False)):
            fail(f"{name}: an exchange buffer overflowed")
        oracle = drv.oracle(oracle_of)
        if name == "q18":
            o = {k: v.cpu().numpy() for k, v in out.items()}
            ov, ok = oracle
            n = int(o["valid"].sum())
            keys = o["keys"][:n]
            orders = drv.tables["orders"].columns
            cust = drv.tables["customer"].columns
            ck = orders["o_custkey"][keys]
            if not (n == int(np.isfinite(ov).sum()) and n > 0
                    and np.array_equal(keys, ok[:n])
                    and np.array_equal(o["values"][:n], ov[:n])
                    and np.array_equal(o["o_custkey"][:n], ck)
                    and np.array_equal(o["o_orderdate"][:n],
                                       orders["o_orderdate"][keys])
                    and np.array_equal(o["c_name_code"][:n],
                                       cust["c_name_code"][ck])):
                fail("q18: keys, values or fetched attributes differ from "
                     "the oracle and the host tables")
            print(f"q18: {n} winners; keys, values and the fetched "
                  f"o_custkey / o_orderdate / c_name_code equal the oracle "
                  f"and the host tables; launches {got}")
            continue
        value = out["value"].cpu().numpy().astype(np.float64).reshape(-1)
        oracle = np.asarray(oracle, np.float64).reshape(-1)
        if value.shape != oracle.shape or not np.isfinite(value).all():
            fail(f"{name}: shape {value.shape} / non-finite values")
        rel = float(np.max(np.abs(value - oracle)
                           / np.maximum(np.abs(oracle), 1e-30)))
        exact = name == "q4" or name.startswith("q4_sj")
        if not (np.array_equal(value, oracle) if exact
                else np.allclose(value, oracle, rtol=2e-4, atol=0)):
            fail(f"{name}: {value} vs the oracle {oracle}")
        tol = "exactly" if exact else f"max relative error {rel:.3e}"
        sjs = [(sj.alt, sj.capacity, sj.wire.kind) for sj in plan.semijoins]
        print(f"{name}: matches the float64 oracle ({tol}), no overflow, "
              f"semi-joins {sjs}; launches {got}")

    # the codec kernels on the inputs the main path gave them; the largest
    # absolute difference of any word, key or mask bit is their max_abs_err
    codec_err = dict.fromkeys(codec, 0)
    for (label, k), (a, kw) in sorted(recorded.items()):
        got = getattr(ops, k)(*a, **kw)
        plain = {"ef_encode": lambda: ref.ef_encode(*a, **kw),
                 "ef_decode": lambda: ref.ef_decode(*a, kw["capacity"],
                                                    kw["domain"]),
                 "mask_fold": lambda: ref.mask_fold(*a),
                 "mask_unfold": lambda: ref.mask_unfold(*a, kw["n"])}[k]()
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        plain if isinstance(plain, tuple) else (plain,)):
            codec_err[k] = max(codec_err[k], max_abs_diff(g, w))
        if codec_err[k]:
            fail(f"{k} on the {label} main-path input differs from its "
                 f"plain version by up to {codec_err[k]}")
        del got, plain
        torch.cuda.empty_cache()
    print(f"codec kernels bit-identical to the plain version on the "
          f"main-path inputs of {sorted({lb for lb, _ in recorded})}: max "
          f"abs difference {codec_err}")
    if {k for _, k in recorded} != set(codec):
        fail(f"the packed exchange runs did not reach every codec kernel: "
             f"{sorted(recorded)}")

    # -- 5. bytes ---------------------------------------------------------------
    for sj in ("q4_sj", "q18_sj", "q14_promo_request"):
        packed = a2a_bytes[f"{sj}/packed/xla" if sj != "q14_promo_request"
                           else sj]
        raw = a2a_bytes[f"{sj}/raw/xla"]
        if not 0 < packed < raw:
            fail(f"{sj}: packed all-to-all bytes {packed} not below raw {raw}")
        print(f"{sj}: all-to-all bytes per node packed {packed}, raw {raw}, "
              f"raw/packed {raw / packed:.3f}")

    # -- 5. times --------------------------------------------------------------
    query_ms = {}
    for name, run in runs.items():
        times = []
        for _ in range(args.repeat):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        query_ms[name] = statistics.median(times)
        print(f"{name}: warm median {query_ms[name]:.3f} ms over "
              f"{args.repeat} runs (CUDA events) on {smi}")
        if args.profile:
            profile_query(torch, run, name)
    runs.clear()
    torch.cuda.empty_cache()

    iters = 20
    ship = li.columns["l_shipdate"]
    q6_ship = next(d for d in scans if d.column == "l_shipdate")
    sf_kw = dict(rows=ship.rows, padded_rows=ship.padded_rows,
                 width=ship.width)
    sf_args = (ship.words, *host_bounds(drv, "q6", q6_ship))
    from repro_torch.kernels.scan_filter import scan_filter_cuda
    from repro_torch.kernels.grouped_agg import filtered_group_sum_cuda

    b1_ms = cuda_ms(lambda: scan_filter_cuda(*sf_args, **sf_kw), iters)
    b1_graph = graph_ms(lambda: scan_filter_cuda(*sf_args, **sf_kw), iters)
    b1_plain = cuda_ms(lambda: ref.scan_filter(*sf_args, **sf_kw), iters)
    b1_bytes = (ship.words.numel() + NODES * ship.padded_rows // 32) * 4
    b1_bound, b1_by = bound(b1_bytes, 2 * NODES * ship.padded_rows)
    print(f"scan_filter at q6's l_shipdate input (P={NODES}, "
          f"{ship.padded_rows} padded rows a node, width {ship.width}): "
          f"{b1_ms:.4f} ms (eager loop of {iters} calls; a CUDA graph of "
          f"them {b1_graph:.4f} ms a call), {b1_bound / b1_ms:.1%} of the "
          f"bound {b1_bound:.4f} ms ({b1_by}, {b1_bytes} B); plain "
          f"{b1_plain:.3f} ms; the earlier one-warp-a-group kernel "
          f"{EARLIER_MS['scan_filter']} ms on this yardstick")

    measures, groups, pred = fgs_inputs
    n = measures.shape[1]
    b2_ms = cuda_ms(lambda: filtered_group_sum_cuda(
        measures, groups, pred, cutoff=cutoff, num_groups=6), iters)
    b2_plain = cuda_ms(lambda: ref.filtered_group_sum(
        measures, groups, pred, cutoff, 6), iters)
    # library yardstick: one index_add_ over pre-masked rows
    sel = pred <= cutoff
    flat_idx = ((torch.arange(NODES, device="cuda")[:, None] * 6
                 + groups.long()).reshape(-1))
    masked = torch.where(sel[..., None], measures, 0.0).reshape(-1, 6)
    acc = torch.zeros(NODES * 6, 6, device="cuda")
    b2_lib = cuda_ms(lambda: acc.index_add_(0, flat_idx, masked), iters)
    b2_bytes = NODES * n * (6 * 4 + 8) + NODES * 6 * 6 * 4
    b2_bound, b2_by = bound(b2_bytes, int(sel.sum()) * 6)

    # the codec kernels at the q4_sj and q18_sj main-path inputs
    from repro_torch.kernels import wire_codec as wc

    def codec_case(k, a, kw):
        """(kernel call, plain call, bytes moved) of one recorded input."""
        # bytes this input needs: the keys of masked slots are never read,
        # nor the low words that hold only masked slots
        if k == "ef_encode":
            (b, m, base), dom = a, kw["domain"]
            rows, cap = b.shape
            out_words = compression.packed_request_words(cap, dom)
            return (lambda: wc.ef_encode_cuda(b, m, base, domain=dom),
                    lambda: ref.ef_encode(b, m, base, dom),
                    m.numel() + 4 * int(m.sum()) + rows * (8 + out_words * 4))
        if k == "ef_decode":
            (w, base), cap, dom = a, kw["capacity"], kw["domain"]
            rows = w.shape[0]
            l, uw, lw = compression.ef_params(cap, dom)
            # each row's valid count, from the input's mask words; the
            # decode needs the upper words up to the 15th zero (bit
            # <= n + 14) and the low words of the n valid slots
            n_r = ref.mask_unfold(w[:, uw + lw:], cap).sum(1)
            upper = torch.clamp((n_r + 14) // 32 + 1, max=uw)
            lows = (n_r * l + 31) // 32
            return (lambda: wc.ef_decode_cuda(w, base, capacity=cap,
                                              domain=dom),
                    lambda: ref.ef_decode(w, base, cap, dom),
                    4 * int((upper + lows).sum())
                    + rows * compression.bitset_words(cap) * 4
                    + rows * (cap * 5 + 8))
        if k == "mask_fold":
            (m,) = a
            return (lambda: wc.mask_fold_cuda(m), lambda: ref.mask_fold(m),
                    m.numel() + m.shape[0] * compression.bitset_words(
                        m.shape[1]) * 4)
        (w,), n = a, kw["n"]
        return (lambda: wc.mask_unfold_cuda(w, n),
                lambda: ref.mask_unfold(w, n),
                w.numel() * 4 + w.shape[0] * n)

    codec_times = {}
    for (label, k), (a, kw) in sorted(recorded.items()):
        fn, plain, nbytes = codec_case(k, a, kw)
        b_ms, b_by = bound(nbytes, 10 * a[0].numel())
        t = codec_times[(label, k)] = {
            "ms": cuda_ms(fn, iters),
            "plain_ms": cuda_ms(plain, 3),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"{tuple(a[0].shape)} {dict(kw)}"}
        torch.cuda.empty_cache()
        print(f"{k} at the {label} input {t['shape']}: {t['ms']:.4f} ms "
              f"({t['ms'] / b_ms:.2f}x the bound), plain "
              f"{t['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}, "
              f"{nbytes} B)")
        if k == "ef_decode":
            # the per-row marker pass, the first of ef_decode's launches
            zeros_ms = cuda_ms(lambda: wc.ef_zeros_cuda(
                a[0], capacity=kw["capacity"], domain=kw["domain"]), iters)
            t["ef_zeros_ms"] = zeros_ms
            print(f"ef_zeros at the {label} input: {zeros_ms:.4f} ms, "
                  f"{zeros_ms / t['ms']:.1%} of ef_decode")
    recorded.clear()

    # -- 6b. the hand plans, kernels B4-B6 ---------------------------------------
    hand_kernels, hand = hand_plan_phase(args, torch, smi, drv,
                                         main_launches, zero)
    # -- 6c. the semi-join hand plans, B5 on q3's and q11's inputs -------------
    b5_inputs, semijoin = semijoin_plan_phase(args, torch, smi, drv,
                                              main_launches, zero)
    # -- 6d. prepared statements, B1 with lanes of bounds ------------------------
    b1_lanes, prepared = prepared_phase(args, torch, smi, drv,
                                        main_launches, zero, gen)
    # -- 6e. the two-tier query path: cubes through B2, router, budget ---------
    cubes = cube_phase(args, torch, smi, drv, main_launches, zero)
    for k in hand_kernels:
        k["launches"] = main_launches[k["name"]]
        if k["name"] == "predicate_bitset":
            k.update(b5_inputs)

    kernels = [
        {"name": "scan_filter", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/scan_filter.cu",
         "replaces": "src/repro/kernels/scan_filter.py:76",
         "tpu_function": "src/repro/kernels/scan_filter.py:scan_filter_pallas",
         "launches": main_launches["scan_filter"],
         "max_abs_err": float(scan_err),
         "ms": b1_ms, "plain_ms": b1_plain, "bound_ms": b1_bound,
         "bound_by": b1_by, "library_ms": None,
         "shape": f"P={NODES} rows/node={ship.rows} width={ship.width}"},
        {"name": "filtered_group_sum", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/grouped_agg.cu",
         "replaces": "src/repro/kernels/grouped_agg.py:43",
         "tpu_function":
             "src/repro/kernels/grouped_agg.py:filtered_group_sum",
         "launches": main_launches["filtered_group_sum"],
         "max_abs_err": fgs_err, "ms": b2_ms, "plain_ms": b2_plain,
         "bound_ms": b2_bound, "bound_by": b2_by, "library_ms": b2_lib,
         "shape": f"P={NODES} N/node={n} G=6 C=6"},
    ]
    tpu = {"ef_encode": "src/repro/kernels/wire_codec.py:197",
           "ef_decode": "src/repro/kernels/wire_codec.py:251",
           "mask_fold": "src/repro/kernels/wire_codec.py:102",
           "mask_unfold": "src/repro/kernels/wire_codec.py:117"}
    for k in codec:
        t4, t18 = codec_times[("q4_sj", k)], codec_times[("q18_sj", k)]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wire_codec.cu",
            "replaces": "src/repro/kernels/wire_codec.py:86",
            "tpu_function": tpu[k] + " (lane kernels via _row_call)",
            "launches": main_launches[k],
            "max_abs_err": float(codec_err[k]),
            "ms": t4["ms"], "plain_ms": t4["plain_ms"],
            "bound_ms": t4["bound_ms"], "bound_by": t4["bound_by"],
            "library_ms": None, "shape": "q4_sj " + t4["shape"],
            "q18_sj": t18})
    kernels += hand_kernels + [b1_lanes]
    return kernels, {"queries_ms": query_ms, "hand_plans": hand,
                     "semijoin_plans": semijoin, "prepared": prepared,
                     "cubes": cubes,
                     "gen_s": gen_s,
                     "resident_bytes": drv.resident_bytes,
                     "lineitem_bytes": li_bytes, "sf": args.sf,
                     "nodes": NODES}


# ---------------------------------------------------------------------------
# phase 6b: the hand plans through TPCHDriver.run, kernels B4-B6
# ---------------------------------------------------------------------------

HAND_PLANS = ("q1", "q1_kernel", "q6", "q4", "q18", "q15", "q15_1factor",
              "q15_approx", "q21", "q21_late")
HAND_KERNELS = ("block_topk", "predicate_bitset", "mbit_encode")


def hold_exact(torch, got, want, what: str):
    """Bit-identical outputs (f32 compared as bits); fails otherwise."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        bits = (lambda t: t.view(torch.int32) if t.dtype == torch.float32
                else t)
        if (g.shape != w.shape or g.dtype != w.dtype
                or not torch.equal(bits(g), bits(w))):
            fail(f"{what}: differs from its plain version (or its first "
                 f"run)")


def _quantized(torch, gen, shape):
    """§3.2.5-like q: 0 <= q <= 2**30 over all magnitudes, a zero group."""
    q = torch.randint(0, (1 << 30) + 1, shape, generator=gen, device="cuda")
    q = q >> torch.randint(0, 31, shape, generator=gen, device="cuda")
    q.view(-1)[:3] = 0
    return q.to(torch.int32)


def _adversarial_values(torch, gen, kind, shape):
    """B4 inputs that stress the selection: equal blocks, ties straddling
    the k-th value, mixed -0.0 and +0.0, +-inf, subnormals (random bits
    under the smallest normal, either sign)."""
    def pick(choices):
        c = torch.tensor(choices, device="cuda")
        return c[torch.randint(0, len(choices), shape, generator=gen,
                               device="cuda")]
    if kind == "equal":
        return torch.full(shape, 3.0, device="cuda")
    if kind == "ties_at_k":
        return pick([9.0] + [5.0] * 30 + [1.0] * 8)
    if kind == "signed_zeros":
        return pick([0.0, -0.0, -0.0, 0.0, -1.0, 2.0])
    if kind == "infinities":
        return pick([float("inf"), float("-inf"), float("-inf"), 1.0, -1.0,
                     0.0])
    bits = torch.randint(0, 1 << 23, shape, generator=gen, device="cuda",
                         dtype=torch.int32)
    sign = torch.randint(0, 2, shape, generator=gen, device="cuda",
                         dtype=torch.int32) << 31
    return (bits | sign).view(torch.float32)


def check_topk_adversarial(torch, ops, ref, gen) -> int:
    """B4 bit-identical to its plain version (and to itself) on the
    adversarial values of ``_adversarial_values``, masked and not, k from
    1 to the block (a ragged block of pads), blocks of 33 to 12,288."""
    n_cases = 0
    for kind in ("equal", "ties_at_k", "signed_zeros", "infinities",
                 "subnormals"):
        for k, rows, n, block, frac in ((1, 2, 9_999, 4096, 0.5),
                                        (10, 2, 9_999, 4096, 1.0),
                                        (100, 3, 20_001, 4096, 0.3),
                                        (33, 2, 77, 33, 0.5),
                                        (128, 1, 30_000, 12_288, 1.0),
                                        (12_288, 1, 30_000, 12_288, 0.7)):
            vals = _adversarial_values(torch, gen, kind, (rows, n))
            keys = torch.randint(-(2 ** 31), 2 ** 31 - 1, (rows, n),
                                 generator=gen, device="cuda",
                                 dtype=torch.int32)
            mask = (None if frac == 1.0 else
                    torch.rand((rows, n), generator=gen, device="cuda")
                    < frac)
            got = ops.block_topk(vals, keys, k=k, mask=mask, block=block)
            what = (f"block_topk {kind} k={k} {rows}x{n} block={block} "
                    f"frac={frac}")
            hold_exact(torch, got, ops.block_topk(vals, keys, k=k, mask=mask,
                                                  block=block), what)
            hold_exact(torch, got, ref.block_topk(vals, keys, k, mask,
                                                  block), what)
            n_cases += 1
    return n_cases


MBIT_M = (1, 2, 4, 8, 16, 32)
MBIT_GROUPS = (1, 2, 3, 4, 5, 32, 625, 1000, 1024, 4096)
# row lengths: q15_approx's 12,500 and the plan's per-destination 1,250
# rows, 375 (K m / 32 not whole below m = 32), 30,000 and 12,288
MBIT_K = (375, 1_250, 12_500, 12_288, 30_000)


def _mbit_edges(torch, gen, shape, m, group):
    """``_quantized`` values with the encoder's edges planted in the first
    groups: all zeros, a maximum of 2^31 - 1, a maximum of exactly
    2^m - 1 and of exactly 2^m (where shift_of changes), and ones."""
    q = _quantized(torch, gen, shape)
    g = q.view(-1, group)
    top = 2 ** 31 - 1
    edges = [0, top]
    if m < 31:
        edges += [(1 << m) - 1, 1 << m]
    edges.append(1)
    for i, e in enumerate(edges[:g.shape[0]]):
        g[i] = torch.clamp(g[i], max=e)
        g[i, -1] = e
    return q


def check_mbit(torch, ops, ref, gen) -> int:
    """B6 against its plain version, bit-identical and repeatable: m in
    MBIT_M, every group of MBIT_GROUPS that divides a row length of
    MBIT_K, as 1-, 2- and 3-D inputs, with the value edges planted; every
    unit of the kernel runs.  Returns the cases run."""
    from repro_torch.kernels.mbit_codec import variant

    n_cases, units = 0, set()
    for m in MBIT_M:
        for K in MBIT_K:
            for group in MBIT_GROUPS:
                if K % group:
                    continue
                for shape in ((K,), (7, K), (2, 3, K)):
                    q = _mbit_edges(torch, gen, shape, m, group)
                    got = ops.mbit_encode(q, m=m, group=group)
                    what = f"mbit_encode m={m} group={group} {shape}"
                    hold_exact(torch, got, ops.mbit_encode(q, m=m,
                                                           group=group),
                               what)
                    hold_exact(torch, got, ref.mbit_encode(q, m, group),
                               what)
                    units.add(variant(K, m, group, q.data_ptr()))
                    n_cases += 1
    if units != {"thread", "thread16", "warp"}:
        fail(f"mbit_encode checks ran the units {units} only")
    print(f"mbit_encode: bit-identical to the plain version and repeatable "
          f"over {n_cases} cases (m {MBIT_M}, groups {MBIT_GROUPS} where "
          f"they divide K in {MBIT_K}, 1-3-D, value edges); units {units}")
    return n_cases


# B5's shapes: (rows, N) with N on and off a multiple of 4 (the 16-byte
# variant and the scalar one), rows above 65,535, q3's 187,500 columns a
# node and one more than the lineitem's 7,500,000
B5_SHAPES = tuple((rows, n) for n in (1, 4, 31, 32, 33, 1_025, 1_028,
                                      187_500, 7_500_001)
                  for rows in (1, 8)) + ((70_000, 33), (70_000, 36))
I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _b5_columns(torch, gen, shape):
    """(label, column, value): the value absent, present in every row,
    random, and the int32 extremes among extremes."""
    col = torch.randint(0, 5, shape, generator=gen, device="cuda",
                        dtype=torch.int32)
    edges = torch.tensor([I32_MIN, I32_MAX, 0, 1], device="cuda",
                         dtype=torch.int32)
    ext = edges[torch.randint(0, 4, shape, generator=gen, device="cuda")]
    return (("absent", col, -1), ("every", torch.full_like(col, 5), 5),
            ("random", col, 2), ("int32 min", ext, I32_MIN),
            ("int32 max", ext, I32_MAX))


def check_predicate_bitset(torch, ops, ref, gen) -> int:
    """B5 bit-identical to its plain version and to itself over
    ``B5_SHAPES`` x ``_b5_columns``, each on its own storage (16 bytes
    aligned) and on a copy 4 bytes past it; fails unless both variants
    ran.  Returns the cases run."""
    from repro_torch.kernels.bitset_pack import vector_loads

    n_cases, variants = 0, set()
    for shape in B5_SHAPES:
        for label, col, value in _b5_columns(torch, gen, shape):
            for where, c in (("aligned", col),
                             ("misaligned", _misaligned(torch, col))):
                got = ops.predicate_bitset(c, value=value)
                what = f"predicate_bitset {shape} {label} {where}"
                hold_exact(torch, got, ops.predicate_bitset(c, value=value),
                           what)
                hold_exact(torch, got, ref.predicate_bitset(c, value), what)
                variants.add(vector_loads(shape[-1], c.data_ptr()))
                n_cases += 1
    if variants != {True, False}:
        fail(f"predicate_bitset checks ran the variants {variants} only")
    print(f"predicate_bitset: bit-identical to the plain version and "
          f"repeatable over {n_cases} cases (shapes {B5_SHAPES}; absent, "
          f"every row, random, int32 extremes; aligned and misaligned); "
          f"both variants ran")
    return n_cases


def check_hand_kernels(torch, ops, ref, gen):
    """B4-B6 against their plain versions at test shapes, each twice:
    bit-identical."""
    n_cases = 0
    # B4: ties (integer values), ragged N, masked, exhausted blocks (0.2%
    # unmasked: about 8 rows a block against k up to 128)
    for k in (1, 10, 100, 128):
        for rows, n, block, frac in ((1, 100_003, 4096, 1.0),
                                     (3, 50_001, 4096, 0.3),
                                     (8, 12_500, 4096, 0.002),
                                     (2, 9_999, 1000, 0.5),
                                     (1, 30_000, 12_288, 1.0)):
            vals = torch.randint(0, 1000, (rows, n), generator=gen,
                                 device="cuda").float()
            keys = torch.randint(-(2 ** 31), 2 ** 31 - 1, (rows, n),
                                 generator=gen, device="cuda",
                                 dtype=torch.int32)
            mask = (None if frac == 1.0 else
                    torch.rand((rows, n), generator=gen, device="cuda")
                    < frac)
            got = ops.block_topk(vals, keys, k=k, mask=mask, block=block)
            what = f"block_topk k={k} {rows}x{n} block={block} frac={frac}"
            hold_exact(torch, got, ops.block_topk(vals, keys, k=k, mask=mask,
                                                  block=block), what)
            hold_exact(torch, got, ref.block_topk(vals, keys, k, mask,
                                                  block), what)
            n_cases += 1
    n_cases += check_topk_adversarial(torch, ops, ref, gen)
    n_cases += check_predicate_bitset(torch, ops, ref, gen)
    # B6: m in {4, 8, 16}, groups 1..1024, rows of 125 groups (a half word
    # where 125 * group * m / 32 is not whole)
    for m in (4, 8, 16):
        for group in (1, 2, 3, 4, 32, 100, 1000, 1024):
            for rows in (1, 64):
                q = _quantized(torch, gen, (rows, 125 * group))
                got = ops.mbit_encode(q, m=m, group=group)
                what = f"mbit_encode m={m} group={group} {tuple(q.shape)}"
                hold_exact(torch, got, ops.mbit_encode(q, m=m, group=group),
                           what)
                hold_exact(torch, got, ref.mbit_encode(q, m, group), what)
                n_cases += 1
    n_cases += check_mbit(torch, ops, ref, gen)
    torch.cuda.synchronize()
    print(f"block_topk, predicate_bitset, mbit_encode: bit-identical to "
          f"their plain versions and repeatable over {n_cases} cases")


def hand_kernel_fns():
    """(plain version, CUDA wrapper) of each hand-plan kernel by name; the
    plain one takes a recorded call's (args, kwargs)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitset_pack import predicate_bitset_cuda
    from repro_torch.kernels.mbit_codec import mbit_encode_cuda
    from repro_torch.kernels.topk_select import block_topk_cuda

    plain = {"block_topk": lambda a, kw: ref.block_topk(
                 *a, kw["k"], kw.get("mask"), kw.get("block", 4096)),
             "predicate_bitset": lambda a, kw: ref.predicate_bitset(
                 *a, kw["value"]),
             "mbit_encode": lambda a, kw: ref.mbit_encode(*a, kw["m"],
                                                          kw["group"])}
    cuda_fn = {"block_topk": block_topk_cuda,
               "predicate_bitset": predicate_bitset_cuda,
               "mbit_encode": mbit_encode_cuda}
    return plain, cuda_fn


def hand_kernel_case(torch, k, a, kw):
    """Times, bound and library time of hand-plan kernel ``k`` on one
    recorded input."""
    plain, cuda_fn = hand_kernel_fns()
    x = a[0]
    rows_n = x.numel()
    if k == "block_topk":
        block, kk = kw.get("block", 4096), kw["k"]
        nb = -(-x.shape[-1] // block)
        outs = x.numel() // x.shape[-1] * nb * kk
        mask = kw.get("mask")
        # each value (and mask byte) read once, the winners' keys and
        # the outputs; one compare per value
        nbytes = rows_n * 4 + (0 if mask is None else rows_n) \
            + outs * 12
        ops_ = rows_n
        pad = (-x.shape[-1]) % block
        xv = torch.nn.functional.pad(
            x if mask is None else torch.where(mask, x, float("-inf")),
            (0, pad), value=float("-inf")).reshape(-1, block)
        lib = graph_ms(lambda: torch.topk(xv, kk, dim=1), 20)
        del xv
    elif k == "predicate_bitset":
        nbytes = rows_n * 4 + rows_n // x.shape[-1] * (
            (x.shape[-1] + 31) // 32) * 4
        ops_ = rows_n
        lib = None
    else:
        m, group = kw["m"], kw["group"]
        nbytes = rows_n * 4 + rows_n * m // 8 + rows_n // group * 4
        ops_ = 2 * rows_n
        lib = None
    b_ms, b_by = bound(nbytes, ops_)
    # device time from a graph of 20 calls; an eager loop of calls
    # times the wrapper's host cost at the small inputs
    return {"ms": graph_ms(lambda: cuda_fn[k](*a, **kw), 20),
            "eager_loop_ms": cuda_ms(lambda: cuda_fn[k](*a, **kw), 20),
            "plain_ms": cuda_ms(lambda: plain[k](a, kw), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "bytes": nbytes, "shape": f"{tuple(x.shape)} "
            f"{ {n: v for n, v in kw.items() if n != 'mask'} }"
            + (" masked" if kw.get("mask") is not None else "")}


def hand_plan_phase(args, torch, smi, drv, main_launches, zero):
    """Phase 6b: B4-B6 against their plain versions (test shapes, the
    stress size, the plans' own inputs), the ten hand plans through
    ``drv.run(name)`` against the oracle with their launches, and times.
    Adds the plans' launches to ``main_launches``; returns the three
    kernels' entries of the JSON line and a summary."""
    import numpy as np

    from repro_torch.core.columnar import PackedColumn
    from repro_torch.kernels import ops, ref
    from repro_torch.tpch.schema import DEFAULT_PARAMS as DP

    gen = torch.Generator(device="cuda").manual_seed(1)
    check_hand_kernels(torch, ops, ref, gen)

    # -- the plans, each with the launches it implies --------------------------
    expected = {name: dict(zero) for name in HAND_PLANS}
    expected["q1_kernel"]["filtered_group_sum"] = 1
    for name in ("q15", "q15_1factor"):
        expected[name]["block_topk"] = 1
    expected["q15_approx"].update(block_topk=1, mbit_encode=1)
    expected["q21"]["predicate_bitset"] = 1
    q21_wire = drv.ctx.wire_fmt("q21_request")
    if q21_wire.packed:
        expected["q21_late"].update(ef_encode=1, ef_decode=1, mask_fold=1,
                                    mask_unfold=1)
    recorded = {}
    originals = {k: getattr(ops, k) for k in HAND_KERNELS}

    def wrap(k, label):
        def call(*a, **kw):
            recorded.setdefault((label, k), (a, kw))
            return originals[k](*a, **kw)
        return call

    from repro_torch.core.plans import REGISTRY

    t0 = time.perf_counter()
    by_oracle = {}
    for name in HAND_PLANS:   # q1_kernel answers q1, q15_* q15, q21_late q21
        if REGISTRY[name].oracle not in by_oracle:
            by_oracle[REGISTRY[name].oracle] = drv.oracle(name)
    oracles = {name: by_oracle[REGISTRY[name].oracle] for name in HAND_PLANS}
    oracle_s = time.perf_counter() - t0
    print(f"hand-plan oracles (float64 numpy): {oracle_s:.1f} s")
    tables = drv.tables
    for name in HAND_PLANS:
        for k in HAND_KERNELS:
            setattr(ops, k, wrap(k, name))
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        out = drv.run(name)
        torch.cuda.synchronize()
        got = ops.launch_counts()
        for k, fn in originals.items():
            setattr(ops, k, fn)
        if got != expected[name]:
            fail(f"{name} launched {got}, expected {expected[name]}")
        for k, v in got.items():
            main_launches[k] += v
        oracle = oracles[name]
        if name in ("q1", "q1_kernel", "q6", "q4"):
            value = out.cpu().numpy().astype(np.float64)
            want = np.asarray(oracle, np.float64)
            if value.shape != want.shape or not np.isfinite(value).all():
                fail(f"{name}: shape {value.shape} / non-finite values")
            rel = float(np.max(np.abs(value - want)
                               / np.maximum(np.abs(want), 1e-30)))
            ok = (np.array_equal(value, want) if name == "q4"
                  else np.allclose(value, want, rtol=2e-4, atol=0))
            if not ok:
                fail(f"{name}: max relative error {rel} vs the oracle")
            print(f"{name} (hand plan): matches the float64 oracle "
                  f"({'exactly' if name == 'q4' else f'{rel:.3e}'}); "
                  f"launches {got}")
            continue
        overflow = False
        if name == "q21_late":
            out, overflow = out
        elif isinstance(out, dict):
            overflow = out.pop("overflow", False)
        if bool(overflow):
            fail(f"{name}: an exchange buffer overflowed")
        if name.startswith("q21"):
            v, keys, valid = (a.cpu().numpy() for a in out)
        else:
            o = {k: (a.cpu().numpy() if isinstance(a, torch.Tensor) else a)
                 for k, a in out.items()}
            vk = (("total_revenue", "s_suppkey") if name.startswith("q15")
                  else ("o_totalprice", "o_orderkey"))
            v, keys, valid = o[vk[0]], o[vk[1]], o["valid"]
        ov, ok = oracle
        n = int(valid.sum())
        exact = name.startswith("q21")
        if not (n == min(int(np.isfinite(ov).sum()), len(v)) and n > 0
                and np.array_equal(keys[:n], ok[:n])
                and (np.array_equal(v[:n], ov[:n]) if exact
                     else np.allclose(v[:n], ov[:n], rtol=2e-4, atol=0))):
            fail(f"{name}: {n} winners; keys or values differ from the "
                 f"oracle")
        if name.startswith("q15"):
            if not np.array_equal(o["s_name_code"][:n], keys[:n]):
                fail(f"{name}: fetched s_name_code differs from the key")
        if name == "q18":
            orders = tables["orders"].columns
            ck = orders["o_custkey"][keys[:n]]
            if not (np.array_equal(o["o_custkey"][:n], ck)
                    and np.array_equal(o["c_name_code"][:n],
                                       tables["customer"].columns[
                                           "c_name_code"][ck])):
                fail("q18: fetched attributes differ from the host tables")
        extra = ""
        if name == "q15_approx":
            st = o["stats"]
            approx, naive = (float(st.approx_bits_per_node),
                             float(st.naive_bits_per_node))
            if not approx < naive:
                fail(f"q15_approx ships {approx} bits, naive {naive}")
            extra = (f"; bits per node approx {approx:.0f} vs naive "
                     f"{naive:.0f}, {int(st.num_candidates)} candidates")
        tol = ("keys and values exactly" if exact
               else "keys exactly, values within rtol 2e-4")
        print(f"{name}: {n} winners, {tol} of the oracle, no overflow"
              f"{extra}; launches { {k: c for k, c in got.items() if c} }")
    if {k for _, k in recorded} != set(HAND_KERNELS):
        fail(f"the hand plans did not reach every new kernel: "
             f"{sorted(recorded)}")

    # -- B4-B6 on the plans' own inputs, against their plain versions ----------
    plain, _ = hand_kernel_fns()
    for (label, k), (a, kw) in sorted(recorded.items()):
        hold_exact(torch, getattr(ops, k)(*a, **kw), plain[k](a, kw),
                   f"{k} on the {label} input")
    print(f"B4-B6 bit-identical to their plain versions on the plans' "
          f"inputs {sorted(recorded)}")

    # -- stress: each kernel at the lineitem size ------------------------------
    li = drv.placed["lineitem"].columns
    dec = {c: (li[c].decode() if isinstance(li[c], PackedColumn) else li[c])
           for c in ("l_extendedprice", "l_returnflag", "l_shipdate")}
    price = dec["l_extendedprice"].float().contiguous()
    P, n = price.shape
    row_keys = torch.arange(P * n, device="cuda",
                            dtype=torch.int32).reshape(P, n)
    in_q15 = ((dec["l_shipdate"] >= DP.q15_date_min)
              & (dec["l_shipdate"] < DP.q15_date_max))
    flag = dec["l_returnflag"].to(torch.int32).contiguous()
    q_li = torch.floor(price * (float(1 << 30) / price.max())).to(
        torch.int32).contiguous()
    # the paper's group of 1,024, cut to the largest that divides the row
    group = max(g for g in range(1, 1025) if n % g == 0)
    stress = {"block_topk": ((price, row_keys), {"k": 100}),
              "block_topk_masked": ((price, row_keys),
                                    {"k": 100, "mask": in_q15}),
              "predicate_bitset": ((flag,), {"value": 1}),
              "mbit_encode": ((q_li,), {"m": 8, "group": group})}
    for label, (a, kw) in stress.items():
        k = label.removesuffix("_masked")
        hold_exact(torch, getattr(ops, k)(*a, **kw), plain[k](a, kw),
                   f"{k} at the stress size {tuple(a[0].shape)} {kw.keys()}")
        hold_exact(torch, getattr(ops, k)(*a, **kw),
                   getattr(ops, k)(*a, **kw), f"{label} twice")
    del dec, in_q15
    torch.cuda.empty_cache()
    print(f"B4-B6 at the stress size (P={P} x {n} lineitem rows): "
          f"bit-identical to their plain versions, repeatable")

    # -- times ----------------------------------------------------------------
    plan_ms = {}
    for name in HAND_PLANS:
        times = []
        for _ in range(args.repeat):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            drv.run(name)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        plan_ms[name] = statistics.median(times)
        print(f"{name} (hand plan): warm median {plan_ms[name]:.3f} ms over "
              f"{args.repeat} runs (CUDA events) on {smi}")
        if args.profile:
            profile_query(torch, lambda nm=name: drv.run(nm), name)
        torch.cuda.empty_cache()

    main_input = {"block_topk": recorded[("q15", "block_topk")],
                  "predicate_bitset": recorded[("q21", "predicate_bitset")],
                  "mbit_encode": recorded[("q15_approx", "mbit_encode")]}
    tpu = {"block_topk": ("src/repro/kernels/topk_select.py:40",
                          "src/repro/kernels/topk_select.py:block_topk"),
           "predicate_bitset": (
               "src/repro/kernels/bitset_pack.py:28",
               "src/repro/kernels/bitset_pack.py:predicate_bitset"),
           "mbit_encode": ("src/repro/kernels/mbit_codec.py:51",
                           "src/repro/kernels/mbit_codec.py:encode")}
    src = {"block_topk": "topk_select", "predicate_bitset": "bitset_pack",
           "mbit_encode": "mbit_codec"}
    kernels = []
    for k in HAND_KERNELS:
        main = hand_kernel_case(torch, k, *main_input[k])
        at_stress = {lbl: hand_kernel_case(torch, k, *stress[lbl])
                     for lbl in stress if lbl.removesuffix("_masked") == k}
        for what, t in [("main-path", main), *at_stress.items()]:
            lib = ("" if t["library_ms"] is None
                   else f", torch.topk {t['library_ms']:.4f} ms")
            earlier = EARLIER_MS.get(k if what == "main-path"
                                     else f"{what} stress")
            if earlier is not None:
                lib += (f"; the earlier kernel {earlier} ms on this "
                        f"yardstick")
            print(f"{k} at the {what} input {t['shape']}: {t['ms']:.4f} ms "
                  f"(graph of 20 calls; eager loop {t['eager_loop_ms']:.4f} "
                  f"ms a call), plain {t['plain_ms']:.3f} ms{lib}, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bytes']} B,"
                  f" {t['bound_ms'] / t['ms']:.1%} of it)")
        kernels.append({
            "name": k, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src[k]}.cu",
            "replaces": tpu[k][0], "tpu_function": tpu[k][1],
            "launches": main_launches[k], "max_abs_err": 0.0,
            **{f: main[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "eager_loop_ms")},
            "shape": main["shape"], "stress": at_stress})
    del stress, price, row_keys, flag, q_li
    recorded.clear()
    torch.cuda.empty_cache()
    return kernels, {"plans_ms": plan_ms, "oracle_s": oracle_s}


# ---------------------------------------------------------------------------
# phase 6c: the semi-join hand plans through TPCHDriver.run
# ---------------------------------------------------------------------------

SEMIJOIN_PLANS = ("q2", "q3", "q3_lazy", "q3_repl", "q5", "q11", "q13",
                  "q14")
CODEC = ("ef_encode", "ef_decode", "mask_fold", "mask_unfold")


def _semijoin_expected(drv, zero) -> dict:
    """The launches each semi-join plan implies, but q3_lazy's rounds: a
    request semi-join on the packed wire runs the four codec kernels once
    (keys coded, boolean replies folded); q5's request with int32 replies
    and the owner-routed exchanges of q2 and q13 with 4-byte values (the
    value rows ride the coded key rows) run ef_encode and ef_decode once;
    the Alt-2 bitsets of q3 and q11 launch B5 once; nothing else runs a
    kernel (the one-hot sums of q5 and q13 are matmuls, the masked top-k
    steps sorts)."""
    def packed(exchange):
        return drv.ctx.wire_fmt(exchange).packed

    expected = {name: dict(zero) for name in SEMIJOIN_PLANS}
    for name, exchange in (("q2", "q2_request"), ("q14", "q14_request")):
        if packed(exchange):
            for k in CODEC:
                expected[name][k] += 1
    for name, exchange in (("q2", "q2_owner"), ("q5", "q5_request"),
                           ("q13", "q13_route")):
        if packed(exchange):
            expected[name]["ef_encode"] += 1
            expected[name]["ef_decode"] += 1
    for name in ("q3", "q11"):
        expected[name]["predicate_bitset"] = 1
    return expected


def _check_semijoin_answer(np, name, out, oracle) -> str:
    """Holds one plan's answer to its oracle (fails otherwise); returns a
    description."""
    ovf = False
    if name == "q2":
        ovf = out.pop("overflow")
        out = (out["s_acctbal"], out["part_supp_key"], out["valid"])
    elif name in ("q3_lazy", "q5", "q13", "q14"):
        out, ovf = out
    if bool(ovf):
        fail(f"{name}: an exchange buffer overflowed")
    if name in ("q5", "q13", "q14"):
        value = out.cpu().numpy().astype(np.float64)
        want = np.asarray(oracle, np.float64)
        if value.shape != want.shape or not np.isfinite(value).all():
            fail(f"{name}: shape {value.shape} / non-finite values")
        if name == "q13":
            ok, tol = np.array_equal(value, want), "exactly"
        elif name == "q5":
            ok = np.allclose(value, want, rtol=2e-4, atol=1e-2)
            tol = "within rtol 2e-4, atol 1e-2"
        else:
            ok, tol = np.allclose(value, want, rtol=2e-4), "within rtol 2e-4"
        if not ok:
            fail(f"{name}: {value} differs from the oracle {want}")
        return f"{tol} of the oracle"
    v, keys, valid = (a.cpu().numpy() for a in out)
    ov, okeys = oracle
    n = int(valid.sum())
    if not (n == min(int(np.isfinite(ov).sum()), len(v)) and n > 0
            and np.array_equal(keys[:n], okeys[:n])
            and np.allclose(v[:n], ov[:n], rtol=2e-4, atol=0)):
        fail(f"{name}: {n} winners; keys or values differ from the oracle")
    return f"{n} winners, keys exactly, values within rtol 2e-4 of the oracle"


def semijoin_plan_phase(args, torch, smi, drv, main_launches, zero):
    """Phase 6c: the eight semi-join hand plans through ``drv.run(name)``
    against the oracle with their launches, B5 on q3's and q11's inputs
    against its plain version, and times.  Adds the plans' launches to
    ``main_launches``; returns B5's times at those inputs (for its entry
    of the JSON line) and a summary."""
    import numpy as np

    from repro_torch.core import semijoin
    from repro_torch.core.plans import REGISTRY
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    expected = _semijoin_expected(drv, zero)
    t0 = time.perf_counter()
    by_oracle = {}
    for name in SEMIJOIN_PLANS:    # q3_lazy and q3_repl answer q3
        if REGISTRY[name].oracle not in by_oracle:
            by_oracle[REGISTRY[name].oracle] = drv.oracle(name)
    oracle_s = time.perf_counter() - t0
    print(f"semi-join plan oracles (float64 numpy): {oracle_s:.1f} s")

    recorded = {}
    kernel, request = ops.predicate_bitset, semijoin.alt1_request
    rounds = {}

    def b5(*a, **kw):
        recorded.setdefault(label, (a, kw))
        return kernel(*a, **kw)

    def counted_request(*a, **kw):
        rounds[label] = rounds.get(label, 0) + 1
        return request(*a, **kw)

    for label in SEMIJOIN_PLANS:
        ops.predicate_bitset, semijoin.alt1_request = b5, counted_request
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        try:
            out = drv.run(label)
            torch.cuda.synchronize()
        finally:
            ops.predicate_bitset, semijoin.alt1_request = kernel, request
        got = ops.launch_counts()
        want = expected[label]
        if label == "q3_lazy" and drv.ctx.wire_fmt("q3_request").packed:
            for k in CODEC:      # one packed request a round
                want[k] = rounds[label]
        if got != want:
            fail(f"{label} launched {got}, expected {want}")
        for k, v in got.items():
            main_launches[k] += v
        what = _check_semijoin_answer(
            np, label, out, by_oracle[REGISTRY[label].oracle])
        extra = (f"; {rounds[label]} lazy rounds" if label == "q3_lazy"
                 else "")
        print(f"{label}: {what}, no overflow{extra}; launches "
              f"{ {k: c for k, c in got.items() if c} }")
    del out
    if sorted(recorded) != ["q11", "q3"]:
        fail(f"B5 ran on the inputs of {sorted(recorded)}, not q3 and q11")

    # -- B5 on the plans' own inputs, against its plain version ----------------
    plain, _ = hand_kernel_fns()
    for label, (a, kw) in sorted(recorded.items()):
        got = ops.predicate_bitset(*a, **kw)
        hold_exact(torch, got, plain["predicate_bitset"](a, kw),
                   f"predicate_bitset on the {label} input")
        hold_exact(torch, got, ops.predicate_bitset(*a, **kw),
                   f"predicate_bitset on the {label} input, twice")
    print("predicate_bitset bit-identical to its plain version on the q3 "
          "and q11 inputs, repeatable")

    # -- times ----------------------------------------------------------------
    plan_ms = {}
    for name in SEMIJOIN_PLANS:
        times = []
        for _ in range(args.repeat):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            drv.run(name)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        plan_ms[name] = statistics.median(times)
        print(f"{name} (hand plan): warm median {plan_ms[name]:.3f} ms over "
              f"{args.repeat} runs (CUDA events) on {smi}")
        if args.profile:
            profile_query(torch, lambda nm=name: drv.run(nm), name)
        torch.cuda.empty_cache()
    b5 = {}
    for label, (a, kw) in sorted(recorded.items()):
        t = hand_kernel_case(torch, "predicate_bitset", a, kw)
        print(f"predicate_bitset at the {label} input {t['shape']}: "
              f"{t['ms']:.4f} ms (graph of 20 calls; eager loop "
              f"{t['eager_loop_ms']:.4f} ms a call), plain "
              f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}, {t['bytes']} B, "
              f"{t['bound_ms'] / t['ms']:.1%} of it)")
        b5[label] = t
    recorded.clear()
    phase_s = time.perf_counter() - t_phase
    print(f"phase 6c (semi-join plans): {phase_s:.1f} s")
    return b5, {"plans_ms": plan_ms, "oracle_s": oracle_s,
                "lazy_rounds": rounds.get("q3_lazy"), "phase_s": phase_s}


# ---------------------------------------------------------------------------
# phase 6d: prepared statements, B1 with lanes of bounds on the card
# ---------------------------------------------------------------------------

LANES = (1, 2, 8, 64)          # lanes of bounds of the B1 checks
PREPARED = (("q1", {}), ("q6", {}), ("q14_promo", {}),
            ("q14_promo", {"alt": "request"}))
PREPARED_DRAWS = 8             # random bindings a prepared query
PREPARED_SEED = 2026           # their generator


def _lane_bounds(torch, gen, width, lanes):
    """``lanes`` (lo, hi) pairs of int32 bounds: the edge cases in turn
    (inside the codes, below 0, past the top code, crossed, equal, empty
    above the codes, negative, the int32 extremes), then random pairs
    from [-top, 2 top]."""
    top = (1 << width) - 1
    lo = top // 3
    edges = [(lo, top // 2), (-5, lo), (lo, top + 7), (lo + 1, lo),
             (lo, lo), (top + 1, top + 9), (-9, -1),
             (-(2 ** 31), 2 ** 31 - 1), (-(2 ** 31), -(2 ** 31)),
             (2 ** 31 - 1, 2 ** 31 - 1), (0, top)]
    pairs = [edges[(b + width) % len(edges)] for b in range(min(lanes,
                                                                len(edges)))]
    while len(pairs) < lanes:
        a, b = torch.randint(-top, 2 * top + 1, (2,), generator=gen,
                             device="cuda").tolist()
        pairs.append((a, b))
    return pairs


def check_scan_lanes(torch, compression, ops, ref, gen) -> int:
    """B1 with bounds on the card against its plain version, bit-identical:
    every width 1..30, (B,) lanes of bounds for B in LANES and 0-d bounds,
    the edge cases of :func:`_lane_bounds` in every run, rows = padded and
    ending inside the last group, both negate values, on the words'
    storage (16-byte variant) and on a copy 4 bytes past 16 (scalar)."""
    n_cases = 0
    groups = 33
    padded = 32 * groups
    for width in range(1, 31):
        top = (1 << width) - 1
        codes = torch.randint(0, top + 1, (NODES, padded), generator=gen,
                              device="cuda")
        words = compression.pack_bits(codes, width)
        mis = _misaligned(torch, words)
        for lanes in LANES + (None,):
            pairs = _lane_bounds(torch, gen, width, lanes or 1)
            lo = torch.tensor([a for a, _ in pairs], dtype=torch.int32,
                              device="cuda")
            hi = torch.tensor([b for _, b in pairs], dtype=torch.int32,
                              device="cuda")
            if lanes is None:       # 0-d bounds: one prepared binding
                lo, hi = lo[0], hi[0]
            for rows in (padded, padded - 13):
                for negate in (False, True):
                    want = ref.scan_filter(words, lo, hi, rows, padded,
                                           width, negate)
                    for w in (words, mis):
                        got = ops.scan_filter(w, lo, hi, rows=rows,
                                              padded_rows=padded,
                                              width=width, negate=negate)
                        if not torch.equal(got, want):
                            fail(f"scan_filter with lanes={lanes} "
                                 f"width={width} rows={rows} bounds "
                                 f"{pairs} negate={negate} aligned="
                                 f"{w is words} differs from its plain "
                                 f"version")
                    n_cases += 1
    torch.cuda.synchronize()
    return n_cases


def _oracle_of(drv, tq, name, binding):
    p = tq.oracle_params(name, binding)
    if name == "q14_promo":
        return drv.oracle("q14", p=p)[1]
    return drv.oracle(name, p=p)


def _hold_to_oracle(np, name, value, want, what):
    got = np.asarray(value.cpu(), np.float64).reshape(np.shape(want))
    if not np.isfinite(got).all():
        fail(f"{what}: non-finite values")
    atol = 1e-2 if name == "q14_promo" else 0.0
    if not np.allclose(got, want, rtol=2e-4, atol=atol):
        fail(f"{what}: {got} differs from the oracle {want}")
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-30)))


def _events_median(torch, fn, repeat):
    times = []
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def prepared_phase(args, torch, smi, drv, main_launches, zero, gen):
    """Phase 6d: B1 with lanes of bounds on the card against its plain
    version; q1, q6 and q14_promo (auto and request) prepared once and
    executed at the default binding and PREPARED_DRAWS random ones, each
    against the oracle, and as one ``execute_batch`` whose lanes equal the
    scalar executes; per-lane overflow; a captured q6 execute replayed
    for other bindings; launches and times.  Adds the executes' launches
    to ``main_launches``; returns B1's batched entry of the JSON line and
    a summary."""
    import concurrent.futures
    import dataclasses

    import numpy as np

    from repro_torch.core import compression
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.scan_filter import scan_filter_cuda
    from repro_torch.query.lower import lower
    from repro_torch.tpch import queries as tq

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    n_cases = check_scan_lanes(torch, compression, ops, ref, gen)
    print(f"scan_filter with bounds on the card: bit-identical to the "
          f"plain version over {n_cases} cases (widths 1..30 x lanes "
          f"{LANES} and 0-d x 2 rows x negate; edge bounds in every run), "
          f"each on 16-byte-aligned words and a misaligned copy "
          f"({time.perf_counter() - t0:.1f} s)")

    rng = np.random.default_rng(PREPARED_SEED)
    bindings = {name: [tq.default_binding(name)]
                + [tq.random_binding(name, rng)
                   for _ in range(PREPARED_DRAWS)]
                for name in tq.PARAM_QUERIES}
    # the float64 oracles run on the host beside the card's work (numpy
    # lets go of the interpreter lock in its loops)
    pool = concurrent.futures.ThreadPoolExecutor(6)
    oracles = {(name, i): pool.submit(_oracle_of, drv, tq, name, b)
               for name, bs in bindings.items() for i, b in enumerate(bs)}
    codec = ("ef_encode", "ef_decode", "mask_fold", "mask_unfold")
    timings, batched_launches, lane_diff = {}, 0, {}
    for name, kw in PREPARED:
        label = name + "".join(f"/{v}" for v in kw.values())
        prep = drv.prepare(tq.PARAM_QUERIES[name](**kw))
        plan = drv._ensure_compiled(prep.entry).plan
        n_scan = sum(d.mode == "packed" for d in plan.scans)
        n_codec = sum(sj.alt == "request" and sj.wire.packed
                      for sj in plan.semijoins)
        want = {**zero, "scan_filter": n_scan,
                **dict.fromkeys(codec, n_codec)}
        scalar, errs = [], []
        for i, b in enumerate(bindings[name]):
            torch.cuda.empty_cache()
            ops.reset_launch_counts()
            ans = prep.execute(b)
            torch.cuda.synchronize()
            got = ops.launch_counts()
            if got != want:
                fail(f"{label} execute launched {got}, its plan implies "
                     f"{want}")
            for k, v in got.items():
                main_launches[k] += v
            if ans.overflow:
                fail(f"{label} at {b}: an exchange buffer overflowed")
            errs.append(_hold_to_oracle(np, name, ans.value,
                                        oracles[(name, i)].result(),
                                        f"{label} at {b}"))
            scalar.append(ans.value.cpu())
        draws = bindings[name][1:]
        ops.reset_launch_counts()
        ansb = prep.execute_batch(draws)
        torch.cuda.synchronize()
        got = ops.launch_counts()
        want_b = {**want, **dict.fromkeys(codec, n_codec * len(draws))}
        if got != want_b:
            fail(f"{label} execute_batch({len(draws)}) launched {got}, "
                 f"expected {want_b}")
        batched_launches += got["scan_filter"]
        for k, v in got.items():
            main_launches[k] += v
        if ansb.overflow.shape != (len(draws),) or bool(ansb.overflow.any()):
            fail(f"{label} execute_batch: overflow {ansb.overflow}")
        value = ansb.value.cpu()
        diff = 0.0
        for i in range(len(draws)):
            if name == "q1":
                # the batched q1 is the lane-mask product: sums in another
                # order than the scalar one-hot product
                _hold_to_oracle(np, name, value[i],
                                oracles[(name, i + 1)].result(),
                                f"{label} lane {i}")
                d = (value[i].double() - scalar[i + 1].double()).abs()
                diff = max(diff, float((d / scalar[i + 1].double().abs()
                                        .clamp(min=1e-30)).max()))
            elif value[i].numpy().tobytes() != scalar[i + 1].numpy(
                    ).tobytes():
                fail(f"{label} execute_batch lane {i} differs from its "
                     f"scalar execute")
        lane_diff[label] = diff
        print(f"{label}: {len(bindings[name])} bindings equal the oracle "
              f"(max relative error {max(errs):.3e}), no overflow; "
              f"execute_batch({len(draws)}) lanes "
              + ("within the oracle's tolerance, max relative distance "
                 f"from the scalar executes {diff:.3e}" if name == "q1"
                 else "byte-equal to the scalar executes")
              + f"; launches an execute {want}, a batch "
              f"{ {k: c for k, c in want_b.items() if c} }")
        t_exec = _events_median(torch, lambda: prep.execute(draws[0]),
                                args.repeat)
        t_batch = _events_median(torch, lambda: prep.execute_batch(draws),
                                 args.repeat)
        timings[label] = {"execute_ms": t_exec, "batch_ms": t_batch,
                          "batch_ms_per_binding": t_batch / len(draws)}
        print(f"{label}: warm median execute {t_exec:.3f} ms, "
              f"execute_batch({len(draws)}) {t_batch:.3f} ms "
              f"({t_batch / len(draws):.3f} ms a binding) over "
              f"{args.repeat} runs (CUDA events) on {smi}")
        if args.profile:
            profile_query(torch, lambda: prep.execute(draws[0]),
                          f"{label} execute")
            profile_query(torch, lambda: prep.execute_batch(draws),
                          f"{label} execute_batch({len(draws)})")
        del ans, ansb, value
        torch.cuda.empty_cache()

    # one lowering per shape and per batched specialization
    for name, kw in PREPARED:
        shape = tq.PARAM_QUERIES[name](**kw).name
        for lab in (shape, f"{shape}@batch"):
            if drv.compile_events.count(lab) != 1:
                fail(f"{lab} lowered {drv.compile_events.count(lab)} "
                     f"times: {drv.compile_events}")
    print(f"compile events: {drv.compile_events}")

    # per-lane overflow: the request exchange at the capacity a literal
    # one-month q14_promo derives, for that month and for five years
    prep = drv.prepare(tq.q14_promo_param_ir(alt="request"))
    cap = lower(tq.q14_promo_ir(alt="request"), drv.catalog,
                wire=drv.wire).semijoins[0].capacity
    plan = lower(prep.query, drv.catalog, wire=drv.wire,
                 binding=prep.entry.stats_binding, batched=True)
    ctx = dataclasses.replace(drv.ctx, capacities={
        **drv.ctx.capacities, plan.semijoins[0].key: cap})
    narrow = tq.default_binding("q14_promo")
    wide = {"q14_date_min": tq.day(1993, 1, 1),
            "q14_date_max": tq.day(1998, 1, 1)}
    stacked = {p.name: torch.tensor([m[p.name] for m in
                                     (prep.binding(narrow),
                                      prep.binding(wide))],
                                    dtype=torch.int32, device="cuda")
               for p in prep.params}
    out = drv.cluster.compile(plan, ctx, batch=True)(drv.columns(), stacked)
    overflow = out["overflow"].cpu().tolist()
    if overflow != [False, True]:
        fail(f"q14_promo request at capacity {cap}: lanes overflowed "
             f"{overflow}, expected [False, True]")
    _hold_to_oracle(np, "q14_promo", out["value"][0],
                    oracles[("q14_promo", 0)].result(),
                    "q14_promo request, narrow lane")
    print(f"q14_promo request at capacity {cap} (the literal one-month "
          f"plan's): the one-month lane equals the oracle, only the "
          f"five-year lane overflows")
    del out
    torch.cuda.empty_cache()

    # the bounds never pass through the host: a captured q6 execute,
    # replayed after its parameter tensors are overwritten
    prep = drv.prepare(tq.q6_param_ir())
    fn = drv._ensure_compiled(prep.entry)
    cols = drv.columns()
    pv = prep._cast(prep.binding(bindings["q6"][0]))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(cols, pv)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn(cols, pv)
    for i in (3, 5):
        b = bindings["q6"][i]
        for k, v in prep._cast(prep.binding(b)).items():
            pv[k].copy_(v)
        graph.replay()
        torch.cuda.synchronize()
        _hold_to_oracle(np, "q6", captured["value"],
                        oracles[("q6", i)].result(),
                        f"captured q6 replayed at {b}")
        eager = prep.execute(b).value.cpu()
        if not torch.equal(captured["value"].cpu(), eager):
            fail(f"captured q6 replayed at {b} differs from its execute "
                 f"{eager}")
    del graph, captured
    print("q6 captured in a CUDA graph: replayed after its parameter "
          "tensors were overwritten with two other bindings, each equals "
          "that binding's oracle and execute")
    pool.shutdown()

    # -- times: B1 at q6's l_shipdate input, 1 and 8 lanes ---------------------
    ship = drv.placed["lineitem"].columns["l_shipdate"]
    dec = next(d for d in fn.plan.scans if d.column == "l_shipdate")
    lanes = [dec.rewrite.bounds(prep.binding(b))
             for b in bindings["q6"][1:]]
    lo8 = torch.tensor([a for a, _ in lanes], dtype=torch.int32,
                       device="cuda")
    hi8 = torch.tensor([b for _, b in lanes], dtype=torch.int32,
                       device="cuda")
    kw = dict(rows=ship.rows, padded_rows=ship.padded_rows,
              width=ship.width)
    iters = 20
    want = ref.scan_filter(ship.words, lo8, hi8, **kw)
    got = scan_filter_cuda(ship.words, lo8, hi8, **kw)
    err = max_abs_diff(got.reshape(-1, got.shape[-1]),
                       want.reshape(-1, want.shape[-1]))
    if err:
        fail(f"scan_filter with 8 lanes at q6's input differs from its "
             f"plain version by up to {err}")
    del got, want
    t1 = cuda_ms(lambda: scan_filter_cuda(ship.words, lo8[0], hi8[0], **kw),
                 iters)
    t8 = cuda_ms(lambda: scan_filter_cuda(ship.words, lo8, hi8, **kw), iters)
    g1 = graph_ms(lambda: scan_filter_cuda(ship.words, lo8[0], hi8[0],
                                           **kw), iters)
    g8 = graph_ms(lambda: scan_filter_cuda(ship.words, lo8, hi8, **kw),
                  iters)
    plain8 = cuda_ms(lambda: ref.scan_filter(ship.words, lo8, hi8, **kw), 3)
    torch.cuda.empty_cache()
    groups = ship.padded_rows // 32
    nbytes = (ship.words.numel() + 8 * NODES * groups) * 4
    b8_bound, b8_by = bound(nbytes, 4 * 8 * NODES * ship.padded_rows)
    b1_bytes = (ship.words.numel() + NODES * groups) * 4
    b1_bound, _ = bound(b1_bytes, 4 * NODES * ship.padded_rows)
    print(f"scan_filter at q6's l_shipdate input, bounds on the card: "
          f"B = 1 {t1:.4f} ms (eager loop; a CUDA graph of the calls "
          f"{g1:.4f}; bound {b1_bound:.4f}), B = 8 {t8:.4f} ms (graph "
          f"{g8:.4f}) against 8 x B = 1 = {8 * g1:.4f} (graphs); bound "
          f"{b8_bound:.4f} ms ({b8_by}, {nbytes} B, {b8_bound / g8:.1%} "
          f"of the graph time); plain {plain8:.3f} ms")
    phase_s = time.perf_counter() - t_phase
    print(f"phase 6d (prepared statements): {phase_s:.1f} s")
    entry = {"name": "scan_filter_batched", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/scan_filter.cu",
             "replaces": "src/repro/kernels/scan_filter.py:76",
             "tpu_function":
                 "src/repro/kernels/scan_filter.py:scan_filter_pallas "
                 "(under vmap: bounds with a lane axis)",
             "launches": batched_launches, "max_abs_err": float(err),
             "ms": t8, "plain_ms": plain8, "bound_ms": b8_bound,
             "bound_by": b8_by, "library_ms": None, "lanes": 8,
             "graph_ms": g8, "ms_b1": t1, "graph_ms_b1": g1,
             "bound_ms_b1": b1_bound,
             "shape": f"P={NODES} rows/node={ship.rows} width={ship.width}"}
    return entry, {"prepared_ms": timings,
                   "lane_rel_diff_vs_execute": lane_diff,
                   "scan_lane_cases": n_cases, "phase_s": phase_s}


# ---------------------------------------------------------------------------
# phase 6e: the two-tier query path (rollup cubes, router, resident budget)
# ---------------------------------------------------------------------------

CUBE_REPEAT = 3             # measure_query's repeats
BUDGET_SF = 0.1             # scale factor of the resident-budget check


def _kernel_specs(CubeSpec, Dimension, Measure, tc, day):
    """The kernel-method cubes of phase 6e, each with its one-hot twin: the
    JAX test's two measures over returnflag x linestatus (6 cells, 3
    columns with the rows: B2's register variant), and lineitem_pricing's
    six over returnflag x linestatus x the year of l_shipdate (48 cells,
    7 columns: its shared slabs)."""
    dims = (Dimension("returnflag", "l_returnflag", 3),
            Dimension("linestatus", "l_linestatus", 2))
    years = tuple(day(y, 1, 1) - 1 for y in range(1993, 2000))
    out = {}
    for method in ("kernel", "onehot"):
        out[("li_small", method)] = CubeSpec(
            f"li_small_{method}", "lineitem", dims,
            (Measure("sum_qty", "sum", "l_quantity"),
             Measure("count_order", "count")), method=method)
        out[("li_yearly", method)] = CubeSpec(
            f"li_yearly_{method}", "lineitem",
            dims + (Dimension("shipyear", "l_shipdate", edges=years,
                              integral=True),),
            tc.lineitem_cube().measures, method=method)
    return out


def _numpy_cube(np, tables, spec, tq):
    """Float64 numpy group-by of a spec's finest rollup over the host
    tables: {measure: array of spec.shape}, the rows under ``__rows``."""
    cols = tables[spec.table].columns
    key = np.zeros(len(next(iter(cols.values()))), np.int64)
    for d in spec.dimensions:
        col = cols[d.column]
        code = (np.searchsorted(np.asarray(d.edges, col.dtype), col,
                                side="left") if d.binned
                else np.clip(col.astype(np.int64), 0, d.cardinality - 1))
        key = key * d.cardinality + code
    G = spec.num_cells
    f64 = {c: v.astype(np.float64) for c, v in cols.items()
           if v.dtype.kind == "f"}

    def values(m):
        if isinstance(m.column, str):
            return f64[m.column]
        from repro_torch.query.ir import eval_expr

        return eval_expr(m.column, f64)

    out = {"__rows": np.bincount(key, minlength=G).astype(np.float64)}
    order = starts = None
    for m in spec.measures:
        if m.agg == "count":
            out[m.name] = out["__rows"]
        elif m.agg == "sum":
            out[m.name] = np.bincount(key, values(m), G)
        else:
            if order is None:  # cells as runs of the sorted keys
                order = np.argsort(key, kind="stable")
                starts = np.flatnonzero(np.r_[True, np.diff(key[order])])
            arr = np.full(G, np.inf if m.agg == "min" else -np.inf)
            ufunc = np.minimum if m.agg == "min" else np.maximum
            arr[key[order][starts]] = ufunc.reduceat(values(m)[order],
                                                     starts)
            out[m.name] = arr
    return {k: v.reshape(spec.shape) for k, v in out.items()}


def _hold_cube(np, cube, want, what) -> float:
    """A built cube's finest rollup against ``want`` (sums within rtol
    2e-4; min, max, and counts and rows up to 2^24, f32's last exact
    integer, exactly; larger counts, f32 sums of exact per-node partials,
    within rtol 1e-6), and every coarser rollup against float64 marginals
    of the finest (sums and counts within rtol 1e-5: one more f32
    reduction; min and max exactly).  Returns the largest relative
    difference of the sums."""
    spec = cube.spec
    fine = cube.rollup(spec.dim_names)
    aggs = {m.name: m.agg for m in spec.measures}
    aggs["__rows"] = "count"
    worst = 0.0
    for name, agg in aggs.items():
        got = fine[name].astype(np.float64)
        if got.shape != spec.shape:
            fail(f"{what} {name}: shape {got.shape}, expected {spec.shape}")
        if agg == "sum":
            rel = np.abs(got - want[name]) / np.maximum(np.abs(want[name]),
                                                        1e-30)
            worst = max(worst, float(rel.max()))
            if not np.allclose(got, want[name], rtol=2e-4, atol=0):
                fail(f"{what} {name}: max relative error {rel.max()} vs "
                     f"the numpy group-by > 2e-4")
        elif agg == "count":
            exact = want[name] <= 2 ** 24
            if not (np.array_equal(got[exact], want[name][exact])
                    and np.allclose(got[~exact], want[name][~exact],
                                    rtol=1e-6, atol=0)):
                fail(f"{what} {name}: counts differ from the numpy "
                     f"group-by")
        elif not np.array_equal(got, want[name]):
            fail(f"{what} {name}: differs from the numpy group-by (exact)")
    for dims, arrays in cube.rollups.items():
        axes = tuple(i for i, n in enumerate(spec.dim_names)
                     if n not in dims)
        for name, arr in arrays.items():
            f = fine[name].astype(np.float64)
            agg = aggs[name]
            m = (f.min(axis=axes) if agg == "min" else
                 f.max(axis=axes) if agg == "max" else f.sum(axis=axes))
            ok = (np.array_equal(arr, m) if agg in ("min", "max")
                  else np.allclose(arr, m, rtol=1e-5, atol=0))
            if not ok:
                fail(f"{what} rollup {dims} {name}: differs from the "
                     f"marginal of the finest")
    return worst


def _hold_answer(np, got, want, what) -> float:
    got = np.asarray(got, np.float64).reshape(np.shape(want))
    if not np.isfinite(got).all():
        fail(f"{what}: non-finite values")
    if not np.allclose(got, want, rtol=2e-4, atol=0):
        fail(f"{what}: {got} differs from the oracle {want}")
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-30)))


def cube_phase(args, torch, smi, drv, main_launches, zero):
    """Phase 6e: the default cubes built on the card against a numpy
    group-by of the host tables, the kernel-method cubes through B2, the
    serving queries and q1_param through both tiers, the resident budget,
    times.  Adds B2's launches to ``main_launches``; returns a summary."""
    import numpy as np

    from repro_torch.cube import CubeSpec, Dimension, Measure
    from repro_torch.cube.build import build_cube
    from repro_torch.cube.serving import measure_query
    from repro_torch.kernels import ops
    from repro_torch.tpch import cubes as tc
    from repro_torch.tpch import queries as tq
    from repro_torch.tpch.driver import (
        ResidentBudgetError,
        TPCHDriver,
        _raw_bytes,
    )
    from repro_torch.tpch.schema import DEFAULT_PARAMS as DP
    from repro_torch.tpch.schema import day

    t_phase = time.perf_counter()

    def counted(fn):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, ops.launch_counts()

    # -- the default cubes, one-hot products in chunks under 8 GiB ---------
    builds = {}
    for spec in tc.default_specs():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        _, got = counted(lambda s=spec: drv.build_cubes([s]))
        if got != zero:
            fail(f"the {spec.name} build launched {got}, expected no kernel "
                 f"(method {spec.resolve_method()})")
        cube = drv.cubes[spec.name]
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        rel = _hold_cube(np, cube, _numpy_cube(np, drv.tables, spec, tq),
                         spec.name)
        builds[spec.name] = {"build_s": cube.build_seconds,
                             "peak_allocated_bytes": peak,
                             "allocated_before_bytes": before,
                             "cells": spec.num_cells,
                             "rows": cube.rows_scanned,
                             "sum_max_rel_err": rel}
        print(f"cube {spec.name} ({spec.num_cells} cells, "
              f"{spec.resolve_method()}, {cube.rows_scanned} rows): built "
              f"in {cube.build_seconds:.3f} s on {smi}; peak allocated {peak}"
              f" B ({before} B before); finest rollup equals the numpy "
              f"group-by (sums max relative error {rel:.3e}, rtol 2e-4; "
              f"min, max, counts and rows exactly up to 2^24), coarser "
              f"rollups its marginals ({time.perf_counter() - t0:.1f} s to "
              f"check)")
        if args.profile:
            profile_query(torch, lambda s=spec: build_cube(
                drv.cluster, drv.ctx, drv.placed, s), f"{spec.name} build")
    if drv.router is None or len(drv.router.cubes) != 2:
        fail("build_cubes did not install a router over both cubes")

    # -- the kernel-method cubes through B2 ----------------------------------
    specs = _kernel_specs(CubeSpec, Dimension, Measure, tc, day)
    kernel_builds = {}
    for label in ("li_small", "li_yearly"):
        spec = specs[(label, "kernel")]
        cube, got = counted(lambda s=spec: build_cube(
            drv.cluster, drv.ctx, drv.placed, s))
        if got != {**zero, "filtered_group_sum": 1}:
            fail(f"the kernel-method {label} build launched {got}, expected "
                 f"filtered_group_sum once")
        main_launches["filtered_group_sum"] += 1
        twin, got = counted(lambda s=specs[(label, "onehot")]: build_cube(
            drv.cluster, drv.ctx, drv.placed, s))
        if got != zero:
            fail(f"the one-hot {label} build launched {got}")
        want = _numpy_cube(np, drv.tables, spec, tq)
        rel = _hold_cube(np, cube, want, f"{label} (kernel)")
        twin_err = _hold_cube(np, twin, want, f"{label} (onehot)")
        fine, tfine = cube.rollup(spec.dim_names), twin.rollup(spec.dim_names)
        twin_rel = 0.0
        for name, arr in fine.items():
            t = tfine[name].astype(np.float64)
            d = np.abs(arr - t) / np.maximum(np.abs(t), 1e-30)
            twin_rel = max(twin_rel, float(d.max()))
            if not np.allclose(arr, t, rtol=2e-4, atol=0):
                fail(f"{label} {name}: the kernel build differs from its "
                     f"one-hot twin")
        kernel_builds[label] = {"cells": spec.num_cells,
                                "columns": len(spec.measures) + 1,
                                "build_s": cube.build_seconds,
                                "onehot_build_s": twin.build_seconds,
                                "sum_max_rel_err": rel,
                                "onehot_sum_max_rel_err": twin_err,
                                "vs_onehot_max_rel": twin_rel}
        print(f"kernel-method cube {label} ({spec.num_cells} cells x "
              f"{len(spec.measures) + 1} columns): filtered_group_sum "
              f"launched once; equals the numpy group-by (sums max relative "
              f"error {rel:.3e}; the one-hot twin's {twin_err:.3e}) and its "
              f"one-hot twin (max relative distance {twin_rel:.3e}); built "
              f"in {cube.build_seconds:.3f} s, the one-hot twin "
              f"{twin.build_seconds:.3f} s")
    del cube, twin
    torch.cuda.empty_cache()

    # -- answers through query(): tier 1 from the cubes, tier 2 lowered --------
    li = drv.tables["lineitem"].columns
    o = drv.tables["orders"].columns
    f64 = lambda a: a.astype(np.float64)  # noqa: E731
    ship = np.searchsorted(np.asarray(tq.month_edges(
        extra=(DP.q1_shipdate_max,)), np.int32), li["l_shipdate"])
    rev = f64(li["l_extendedprice"]) * (1.0 - f64(li["l_discount"]))
    window = ((o["o_orderdate"] >= DP.q4_date_min)
              & (o["o_orderdate"] < DP.q4_date_max))
    pri = o["o_orderpriority"][window]
    sel = li["l_shipdate"] <= DP.q1_shipdate_max - 1
    g = li["l_returnflag"][sel] * 2 + li["l_linestatus"][sel]
    oracles = {
        "q1_cube": drv.oracle("q1"),
        "revenue_by_shipmonth": np.stack(
            [np.bincount(ship, rev, 86), np.bincount(ship, minlength=86)],
            axis=1),
        "orders_by_priority": np.stack(
            [np.bincount(pri, minlength=5),
             np.bincount(pri, f64(o["o_totalprice"][window]), 5)], axis=1),
        "q1_offedge": np.stack([np.bincount(g, f64(li["l_quantity"][sel]),
                                            6),
                                np.bincount(g, minlength=6)], axis=1),
    }
    del rev, ship
    cube_of = {"q1_cube": "lineitem_pricing",
               "revenue_by_shipmonth": "lineitem_pricing",
               "orders_by_priority": "orders_status"}
    queries = {**{n: f() for n, f in tq.SERVING_QUERIES.items()},
               "q1_offedge": tq.uncovered_query()}
    answers = {}
    for name, q in queries.items():
        ans, got = counted(lambda q=q: drv.query(q))
        tier, source = (1, cube_of[name]) if name in cube_of else (
            2, "q1_offedge")
        if (ans.tier, ans.source) != (tier, source):
            fail(f"{name}: answered from tier {ans.tier} ({ans.source}), "
                 f"expected tier {tier} ({source})")
        want = {**zero}
        if tier == 2:
            plan = drv._ensure_compiled(drv.prepare(q).entry).plan
            want["scan_filter"] = sum(d.mode == "packed" for d in plan.scans)
            if ans.overflow:
                fail(f"{name}: an exchange buffer overflowed")
        if got != want:
            fail(f"{name} (tier {tier}) launched {got}, expected {want}")
        value = ans.value if tier == 1 else ans.value.cpu().numpy()
        rel = _hold_answer(np, value, oracles[name], name)
        answers[name] = {"tier": tier, "source": source, "max_rel_err": rel,
                         "launches": {k: v for k, v in got.items() if v}}
        print(f"{name}: tier {tier} ({source}) equals the float64 "
              f"reference (max relative error {rel:.3e}, rtol 2e-4); "
              f"launches {answers[name]['launches']}")

    # -- q1_param through one PreparedQuery: the tier follows the binding ----
    prep = drv.prepare(tq.q1_param_ir())
    for label, cut in (("on-edge", DP.q1_shipdate_max),
                       ("off-edge", DP.q1_shipdate_max - 1),
                       ("out-of-range", day(1999, 6, 1))):
        b = {"q1_shipdate_max": cut}
        ans, got = counted(lambda b=b: prep.execute(b))
        tier = 1 if label == "on-edge" else 2
        if ans.tier != tier:
            fail(f"q1_param {label} ({cut}): tier {ans.tier}, expected "
                 f"{tier}")
        value = ans.value if tier == 1 else ans.value.cpu().numpy()
        rel = _hold_answer(np, value, drv.oracle(
            "q1", p=tq.oracle_params("q1", b)), f"q1_param {label}")
        answers[f"q1_param {label}"] = {"tier": tier, "max_rel_err": rel}
        print(f"q1_param {label} (l_shipdate <= {cut}): tier {tier}, equals "
              f"the oracle (max relative error {rel:.3e}); launches "
              f"{ {k: v for k, v in got.items() if v} }")

    # -- the resident budget at a small scale factor on the card -------------
    torch.cuda.empty_cache()
    small = TPCHDriver(BUDGET_SF, num_nodes=NODES, device="cuda")
    packed = small.resident_bytes
    raw = sum(_raw_bytes(t) for t in small.resident.values())
    del small
    budget = (packed + raw) // 2
    try:
        TPCHDriver(BUDGET_SF, num_nodes=NODES, device="cuda", storage="raw",
                   resident_budget=budget)
        fail(f"raw storage at sf={BUDGET_SF} ({raw} B) did not raise "
             f"ResidentBudgetError under a budget of {budget} B")
    except ResidentBudgetError as e:
        msg = str(e)
    if str(budget) not in msg or str(raw) not in msg:
        fail(f"ResidentBudgetError message lacks the budget or the raw "
             f"bytes: {msg}")
    TPCHDriver(BUDGET_SF, num_nodes=NODES, device="cuda",
               resident_budget=budget)
    torch.cuda.empty_cache()
    print(f"resident budget at sf={BUDGET_SF}: raw storage ({raw} B) over "
          f"a budget of {budget} B raises ResidentBudgetError, packed "
          f"({packed} B) under it does not")

    # -- times: tier 1 in microseconds beside tier 2 ---------------------------
    serving = {}
    for name, f in tq.SERVING_QUERIES.items():
        m = measure_query(drv, f(), repeat=CUBE_REPEAT)
        if m is None:
            fail(f"measure_query found no cube for {name}")
        serving[name] = {"tier1_us": m["tier1_s"] * 1e6,
                         "tier1_p99_us": m["tier1_p99_s"] * 1e6,
                         "tier2_ms": m["tier2_s"] * 1e3,
                         "tier2_p99_ms": m["tier2_p99_s"] * 1e3,
                         "rollup": "x".join(m["route"].rollup)}
        print(f"{name}: tier 1 {serving[name]['tier1_us']:.1f} us "
              f"(trimmed median of 10; p99 "
              f"{serving[name]['tier1_p99_us']:.1f}) from the "
              f"{serving[name]['rollup']} rollup, tier 2 "
              f"{serving[name]['tier2_ms']:.3f} ms (trimmed median of "
              f"{CUBE_REPEAT}, the card synchronized around each; p99 "
              f"{serving[name]['tier2_p99_ms']:.3f}) on {smi}")
    print("metrics report:\n" + drv.obs.metrics.report())
    phase_s = time.perf_counter() - t_phase
    print(f"phase 6e (two-tier query path): {phase_s:.1f} s")
    return {"builds": builds, "kernel_builds": kernel_builds,
            "answers": answers, "serving": serving,
            "budget": {"sf": BUDGET_SF, "packed_bytes": packed,
                       "raw_bytes": raw, "budget_bytes": budget},
            "phase_s": phase_s}


# ---------------------------------------------------------------------------
# the language-model phases: B7, B9 and qwen2.5-3b serving at full width
# ---------------------------------------------------------------------------

LM_BATCH = 4
LM_PROMPT = 4096            # prefill tokens a sequence, path (i)
LM_MAX_LEN = 4160           # cache positions: the prompt + 64 decode steps
LM_STEPS = 64               # greedy tokens of each path
LM_QUANT_PROMPT = 512       # prompt fed one token a step, path (ii)
LM_PROMPT_CHECK = 32        # of them held against eager steps
LM_SHARDS = 8               # stacked vocab shards of the top-k head
LM_TOPK = 8
LM_REPEAT = 3               # warm runs of each timed LM step
F32_TOL = 2e-5              # the JAX tests' own f32 tolerance
BF16_ULP = 2.0 ** -8        # one bf16 rounding of an output, relative
# Full-width bf16 paths that differ only in where f32 results are rounded
# to bf16: the largest logit difference may reach this share of the
# step's largest |logit|.  tools/logit_fault_control.py measured the sound
# B7 at 0.0064-0.0096 of it in (b)-(d), p rounded to bf16 before p.v (a
# tensor-core kernel's rounding) at 0.0101, and planted B7 faults in (b)
# and (c) at 0.22 (one future key visible) to 1.59 (output zeroed); the
# limit sits between them, about 5x from the rounding and 4x from the
# faults.
LOGIT_RTOL = 0.05
# int8 cache against the bf16 cache: the JAX test's bounds
# (tests/test_serve_sampling.py::test_quant_cache_decode_matches_bf16)
QUANT_RTOL, QUANT_ATOL = 0.1, 0.15


def _errs(got, want) -> dict:
    """Max and mean absolute difference, and the largest |want|."""
    d = (got.float() - want.float()).abs()
    return {"max": float(d.max()), "mean": float(d.mean()),
            "ref_max": float(want.float().abs().max())}


# (BKV, G, S, Sk, D, mask) of the attention kernels' checks: the CPU
# tests' shapes and masks, ragged and mixed lengths, D = 8 .. 256, a fully
# masked row (window 0)
FLASH_MASKS = [dict(causal=True), dict(causal=True, window=4),
               dict(causal=True, prefix=8),
               dict(causal=True, window=4, prefix=8), dict(causal=False)]
FLASH_CASES = [(2 * kv, h // kv, 64, 64, 16, m)
               for h, kv in ((4, 4), (8, 2), (8, 1)) for m in FLASH_MASKS]
FLASH_CASES += [(8, 4, 48, 48, 16, dict(causal=True)),
                (8, 4, 32, 80, 16, dict(causal=False)),
                (8, 4, 80, 32, 16, dict(causal=True)),
                (4, 8, 1000, 1000, 128, dict(causal=True)),
                (4, 3, 129, 77, 64, dict(causal=True, prefix=40)),
                (2, 8, 37, 37, 256, dict(causal=True, window=9)),
                (4, 2, 32, 32, 8, dict(causal=True, window=0))]
# the tensor-core variants' cases: every mask at D = 64, 128 and 256 with
# G = 1, 2, 4 and 8 in turn, ragged S and Sk (200 keys a row; 100 queries
# against 300 keys without a mask), short and uneven lengths, G = 3, a
# fully masked row (window 0)
FLASH_TC_CASES = [
    (16 // g, g, 200 if m.get("causal") else 100,
     200 if m.get("causal") else 300, d, m)
    for i, m in enumerate(FLASH_MASKS)
    for j, d in enumerate((64, 128, 256))
    for g in [(1, 2, 4, 8)[(i + j) % 4]]]
FLASH_TC_CASES += [(8, 8, 200, 200, 128, dict(causal=True)),
                   (8, 4, 48, 48, 64, dict(causal=True)),
                   (8, 4, 32, 80, 128, dict(causal=False)),
                   (8, 4, 80, 32, 128, dict(causal=True)),
                   (4, 8, 1000, 1000, 128, dict(causal=True)),
                   (4, 3, 129, 77, 64, dict(causal=True, prefix=40)),
                   (2, 8, 37, 37, 256, dict(causal=True, window=9)),
                   (4, 2, 32, 32, 128, dict(causal=True, window=0))]
# one rounding of a tensor-core variant's output (by dtype), relative
OUT_ULP = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}


def check_flash(torch, fa, ref, gen):
    """The f32 CUDA-core B7 (``flash_attention_fwd_cuda``) against its
    plain version (f32, from the same inputs) over ``FLASH_CASES``, f32
    and bf16 inputs, twice identical; then at the prefill shape."""
    cases = FLASH_CASES
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in worst:
        for bkv, g, s, sk, d, m in cases:
            q = torch.randn((bkv, g, s, d), generator=gen, device="cuda")
            k = torch.randn((bkv, sk, d), generator=gen, device="cuda")
            v = torch.randn((bkv, sk, d), generator=gen, device="cuda")
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            out, lse = fa.flash_attention_fwd_cuda(q, k, v, **m)
            out2, lse2 = fa.flash_attention_fwd_cuda(q, k, v, **m)
            want, wlse = ref.flash_attention_fwd(q.float(), k.float(),
                                                 v.float(), **m)
            torch.cuda.synchronize()
            what = f"flash {dtype} BKV={bkv} G={g} S={s} Sk={sk} D={d} {m}"
            if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
                fail(f"{what}: not repeatable")
            rtol = F32_TOL if dtype == torch.float32 else BF16_ULP
            atol = F32_TOL if dtype == torch.float32 else 1e-5
            if not torch.allclose(out.float(), want, rtol=rtol, atol=atol):
                fail(f"{what}: out differs from the plain version by "
                     f"{_errs(out, want)}")
            if not torch.allclose(lse, wlse, rtol=F32_TOL, atol=F32_TOL):
                fail(f"{what}: lse differs by {_errs(lse, wlse)}")
            if m.get("window") == 0 and out.any():
                fail(f"{what}: a fully masked row is not 0")
            worst[dtype] = max(worst[dtype], _errs(out, want)["max"])
    print(f"flash_attention_fwd (f32 CUDA cores): {len(cases)} shapes x "
          f"f32/bf16 within the plain version (f32 {F32_TOL}; bf16 one "
          f"rounding, rtol 2^-8 atol 1e-5; lse {F32_TOL}), repeatable; max "
          f"abs err f32 {worst[torch.float32]:.3e}, bf16 "
          f"{worst[torch.bfloat16]:.3e}")
    # the prefill's shape: 4 sequences x 2 kv heads, 8 query heads each
    q = torch.randn((8, 8, LM_PROMPT, 128), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn((8, LM_PROMPT, 128), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn_like(k)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, causal=True)
    want, wlse = ref.flash_attention_fwd(q.float(), k.float(), v.float())
    if not (torch.allclose(out.float(), want, rtol=BF16_ULP, atol=1e-5)
            and torch.allclose(lse, wlse, rtol=F32_TOL, atol=F32_TOL)):
        fail(f"flash at the prefill shape differs: {_errs(out, want)}, "
             f"lse {_errs(lse, wlse)}")
    err = _errs(out, want)["max"]
    print(f"flash_attention_fwd (f32 CUDA cores) at the prefill shape (8, 8, "
          f"{LM_PROMPT}, 128) bf16 causal: max abs err {err:.3e} (rtol 2^-8, "
          f"atol 1e-5)")
    return err


def _hold_rounded(torch, got, want, slack, what: str, floor: float) -> int:
    """A tensor-core kernel's output against its plain version with the
    same rounding (``p_dtype``): within one rounding of the output type
    (``OUT_ULP``) plus ``floor``, today's limits, plus the rounding slack
    (``ref.rounding_slack``: where the plain version's p or ds lies within
    2^-16 of a rounding boundary, the kernel may round it the other way).
    Returns how many elements only the slack admits."""
    w = want.float()
    err = (got.float() - w).abs()
    ulp = OUT_ULP[str(got.dtype).split(".")[-1]]
    lim = ulp * w.abs() + floor
    if not bool((err <= lim + slack).all()):
        fail(f"{what}: differs from the plain version with the same "
             f"rounding by {_errs(got, w)} ({ulp} |want| + {floor:.3g} + "
             f"the rounding slack)")
    return int((err > lim).sum())


def check_flash_tc(torch, fa, ref, gen) -> dict:
    """The tensor-core B7 (``flash_attention_fwd_tc_cuda``) against its
    plain version with the same rounding (``p_dtype`` = the input type)
    over ``FLASH_TC_CASES`` in bf16 and f16 and at the prefill shape in
    bf16: out within one rounding of its type plus 1e-5 (and the rounding
    slack), lse within 2e-5; twice identical; a fully masked row gives 0.
    Also reads each output's distance from the f32 plain version."""
    prefill = (8, 8, LM_PROMPT, LM_PROMPT, 128, dict(causal=True))
    worst, dist, slack_only = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float16):
        cases = FLASH_TC_CASES + ([prefill] if dtype == torch.bfloat16
                                  else [])
        for bkv, g, s, sk, d, m in cases:
            q = torch.randn((bkv, g, s, d), generator=gen, device="cuda")
            k = torch.randn((bkv, sk, d), generator=gen, device="cuda")
            v = torch.randn((bkv, sk, d), generator=gen, device="cuda")
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            out, lse = fa.flash_attention_fwd_tc_cuda(q, k, v, **m)
            out2, lse2 = fa.flash_attention_fwd_tc_cuda(q, k, v, **m)
            want, wlse, slack = ref.flash_attention_fwd(
                q.float(), k.float(), v.float(), p_dtype=dtype, slack=True,
                **m)
            torch.cuda.synchronize()
            what = (f"flash tc {dtype} BKV={bkv} G={g} S={s} Sk={sk} D={d} "
                    f"{m}")
            if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
                fail(f"{what}: not repeatable")
            n = _hold_rounded(torch, out, want, slack, what, 1e-5)
            if not torch.allclose(lse, wlse, rtol=F32_TOL, atol=F32_TOL):
                fail(f"{what}: lse differs by {_errs(lse, wlse)}")
            if m.get("window") == 0 and out.any():
                fail(f"{what}: a fully masked row is not 0")
            key = str(dtype).split(".")[-1]
            worst[key] = max(worst.get(key, 0.0), _errs(out, want)["max"])
            slack_only[key] = slack_only.get(key, 0) + n
            del want, wlse, slack
            f32, _ = ref.flash_attention_fwd(q.float(), k.float(), v.float(),
                                             **m)
            dist[key] = max(dist.get(key, 0.0), _errs(out, f32)["max"])
            del q, k, v, out, out2, lse, lse2, f32
    print(f"flash_attention_fwd_tc: {len(FLASH_TC_CASES)} shapes x bf16/f16 "
          f"and the prefill shape (8, 8, {LM_PROMPT}, 128) bf16 causal "
          f"within the plain version with the same rounding (one rounding "
          f"of the output + 1e-5, plus the rounding slack; lse {F32_TOL}), "
          f"repeatable; max abs err {worst}; elements only the slack admits "
          f"{slack_only}; max abs distance from the f32 plain version "
          f"{dist}")
    return {"max_abs_err": worst, "slack_only": slack_only,
            "dist_from_f32_plain": dist}


def _decode_inputs(torch, gen, bkv, g, smax, d, kind):
    q = torch.randn((bkv, g, d), generator=gen, device="cuda")
    scales = {}
    if kind == "int8":
        k = torch.randint(-127, 128, (bkv, smax, d), generator=gen,
                          device="cuda", dtype=torch.int8)
        v = torch.randint(-127, 128, (bkv, smax, d), generator=gen,
                          device="cuda", dtype=torch.int8)
        for name in ("k_scale", "v_scale"):
            scales[name] = (torch.rand((bkv, smax), generator=gen,
                                       device="cuda") * 0.04 + 1e-3)
        return q.to(torch.bfloat16), k, v, scales
    k = torch.randn((bkv, smax, d), generator=gen, device="cuda")
    v = torch.randn((bkv, smax, d), generator=gen, device="cuda")
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    return q.to(dtype), k.to(dtype), v.to(dtype), scales


def _device_length(torch, n: int):
    return torch.tensor(n, dtype=torch.int32, device="cuda")


def check_decode(torch, ops, ref, da, gen) -> dict:
    """B9 against its plain version (f32, from the same inputs): f32, bf16
    and int8 caches at the CPU tests' shape, the path's (8, 8, 128) x
    4160, D = 256, D = 20 with G = 12, 20 kv rows (more clusters than run
    at once) and decode_32k's 32,768 positions; the length a 0-d int32 on the card at 0, 1, 37, each split
    boundary of the launch (a block of 1 position, of one full tile a
    warp) and Smax; each call twice identical.  Then B9 captured alone in
    a CUDA graph at one length and replayed at three others, each replay
    equal to an eager call at that length.  Returns the launch
    configurations."""
    shapes = [(4, 4, 64, 16), (8, 8, LM_MAX_LEN, 128), (2, 8, 300, 256),
              (3, 12, 200, 20), (20, 8, 600, 128), (8, 8, 32768, 128)]
    worst, configs, n_cases = {}, {}, 0
    for bkv, g, smax, d in shapes:
        for kind in ("f32", "bf16", "int8"):
            q, k, v, sc = _decode_inputs(torch, gen, bkv, g, smax, d, kind)
            cfg = []
            da.decode_attention_cuda(q, k, v, _device_length(torch, 1), **sc,
                                     config=cfg)
            cl, warps = cfg[0], cfg[1]
            configs[f"{kind} ({bkv}, {g}, {d}) x {smax}"] = cfg
            tile = cl * warps * 32     # every warp one full tile
            lengths = sorted({n for n in (0, 1, 37, cl - 1, cl, cl + 1, tile,
                                          tile + 1, smax - 1, smax)
                              if 0 <= n <= smax})
            for length in lengths:
                lt = _device_length(torch, length)
                out = ops.decode_attention(q, k, v, lt, **sc)
                again = ops.decode_attention(q, k, v, lt, **sc)
                want = ref.decode_attention(q.float(), k, v, lt,
                                            sc.get("k_scale"),
                                            sc.get("v_scale"))
                torch.cuda.synchronize()
                what = (f"decode {kind} BKV={bkv} G={g} Smax={smax} D={d} "
                        f"length={length}")
                if not torch.equal(out, again):
                    fail(f"{what}: not repeatable")
                tol = (dict(rtol=F32_TOL, atol=F32_TOL) if kind == "f32"
                       else dict(rtol=BF16_ULP, atol=1e-5))
                if not torch.allclose(out.float(), want, **tol):
                    fail(f"{what}: differs from the plain version by "
                         f"{_errs(out, want)}")
                if length == 0 and out.any():
                    fail(f"{what}: length 0 does not give zeros")
                worst[kind] = max(worst.get(kind, 0.0),
                                  _errs(out, want)["max"])
                n_cases += 1
            del q, k, v, sc
    print(f"decode_attention: f32/bf16/int8 caches within the plain version "
          f"(f32 {F32_TOL}; bf16 out rtol 2^-8 atol 1e-5) over {n_cases} "
          f"(shape, length) cases, lengths 0..Smax on the card, repeatable; "
          f"max abs err {worst}; launch configurations [cluster, warps, "
          f"stages, shared bytes] {configs}")
    # captured once, replayed at other lengths: the grid does not depend
    # on the length
    q, k, v, sc = _decode_inputs(torch, gen, 8, 8, LM_MAX_LEN, 128, "int8")
    lt = _device_length(torch, 5)
    da.decode_attention_cuda(q, k, v, lt, **sc)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out = da.decode_attention_cuda(q, k, v, lt, **sc)
    for length in (576, 1, LM_MAX_LEN):
        lt.fill_(length)
        graph.replay()
        eager = da.decode_attention_cuda(q, k, v, lt, **sc)
        torch.cuda.synchronize()
        if not torch.equal(g_out, eager):
            fail(f"decode_attention replayed from a graph at length {length} "
                 f"differs from an eager call")
    del graph, g_out
    print(f"decode_attention captured in a CUDA graph at length 5, replayed "
          f"at 576, 1 and {LM_MAX_LEN}: each equal to an eager call")
    return configs


def _recording(obj, name, store):
    """Wrap ``obj.name`` to append the arguments of each call to ``store``
    (a list, or a bounded deque to keep the last calls); returns the
    original for restoring."""
    orig = getattr(obj, name)

    def call(*a, **kw):
        store.append((a, kw))
        return orig(*a, **kw)

    setattr(obj, name, call)
    return orig


def _replay_vs_eager(torch, model, params, state, toks, logits, head,
                     what: str, fed=None) -> float:
    """The graph-replayed decode steps (their tokens ``toks``, logits
    ``logits``) against the same steps run eagerly from ``state``, a copy
    of the state they started from, fed ``toks`` (a greedy loop) or
    ``fed`` (a prompt: the tokens as they were before the loop):
    identical tokens, logits within one bf16 rounding (rtol 2^-8).
    Returns the largest absolute logit difference."""
    fed = toks if fed is None else fed
    worst = 0.0
    for t, want in enumerate(logits):
        lg, state = model.decode_step(params, state, fed[:, t:t + 1])
        if not torch.equal(head(lg), toks[:, t + 1]):
            fail(f"{what} step {t}: the eager step chose other tokens than "
                 f"the replayed graph")
        if not torch.allclose(want.float(), lg.float(), rtol=BF16_ULP,
                              atol=0.0):
            fail(f"{what} step {t}: the replayed logits differ from the "
                 f"eager step's by {_errs(want, lg)} (rtol 2^-8)")
        worst = max(worst, _errs(want, lg)["max"])
    return worst


SAMPLED_STEPS = 8


def _sampled_decode(torch, model, params, state, first) -> dict:
    """A sampled decode (``greedy=False``) through the graph-replayed
    decode_loop, its generator registered with the graph: every drawn
    token among the top k of its step's logits.  The same steps run
    eagerly on a copy of the state from a generator with the same seed
    are compared token for token (reported, not required)."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import decode_loop, make_head

    eager_state = T.copy_cache(state)
    logits = []
    toks, _ = decode_loop(model, params, state, first, SAMPLED_STEPS,
                          shards=LM_SHARDS, k=LM_TOPK, greedy=False,
                          generator=torch.Generator(device="cuda")
                          .manual_seed(5), logits_out=logits)
    for t, lg in enumerate(logits):
        top = torch.topk(lg.float(), LM_TOPK, dim=-1).indices
        if not bool((top == toks[:, t + 1, None]).any(-1).all()):
            fail(f"sampled decode step {t}: a drawn token is outside the "
                 f"step's top {LM_TOPK}")
    head = make_head(model, shards=LM_SHARDS, k=LM_TOPK, greedy=False,
                     generator=torch.Generator(device="cuda").manual_seed(5))
    tok, same = first, 0
    for t in range(SAMPLED_STEPS):
        lg, eager_state = model.decode_step(params, eager_state, tok[:, None])
        tok = head(lg)
        same += int(torch.equal(tok, toks[:, t + 1]))
    print(f"sampled decode ({SAMPLED_STEPS} steps, replayed, generator "
          f"registered with the graph): every drawn token among its step's "
          f"top {LM_TOPK}; the eager steps from the same seed drew the same "
          f"tokens on {same}/{SAMPLED_STEPS} steps")
    return {"steps": SAMPLED_STEPS, "eager_same_tokens": same}


def _events_ms(torch, fn, repeat: int):
    """Median device time of ``fn()`` over ``repeat`` warm runs (CUDA
    events around each), with the last run's result."""
    times = []
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def _hold_bf16(torch, out, want, what: str):
    """A bf16 kernel output within one bf16 rounding of its plain
    version computed in f32 (the limit of ``check_flash``/``check_decode``)."""
    if not torch.allclose(out.float(), want, rtol=BF16_ULP, atol=1e-5):
        fail(f"{what}: differs from the plain version by {_errs(out, want)} "
             f"(rtol 2^-8, atol 1e-5)")


def _logit_check(torch, got, want, what: str) -> dict:
    e = _errs(got, want)
    if not e["max"] <= LOGIT_RTOL * e["ref_max"]:
        fail(f"{what}: logits differ by {e} (limit {LOGIT_RTOL} x max "
             f"|logit|)")
    return e


def lm_phases(args, torch, smi: str):
    """B7 and B9 against their plain versions, then qwen2.5-3b at full
    width: path (i) prefill through B7 + bf16-cache decode, path (ii)
    int8-cache decode through B9, and their times.  Returns (the kernels'
    entries of the JSON line, a summary dict)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build
    from repro_torch.serve import sampling
    from repro_torch.serve.engine import decode_loop

    # f32 references in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    b7_old_err = check_flash(torch, fa, ref, gen)
    b7_tc_check = check_flash_tc(torch, fa, ref, gen)
    b9_configs = check_decode(torch, ops, ref, da, gen)
    torch.cuda.empty_cache()

    # -- the model at full width, random weights from seed 0 ------------------
    cfg = get_arch("qwen2.5-3b")
    model = build(cfg)
    B, V = LM_BATCH, cfg.padded_vocab()
    t0 = time.perf_counter()
    p32 = model.init(0, device="cuda")
    f32_bytes = sum(t.numel() * t.element_size() for t in p32.parameters())
    n_params = sum(t.numel() for t in p32.parameters())
    params = model.cast(p32)
    del p32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size()
                      for t in params.parameters())
    print(f"qwen2.5-3b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size} padded to {V}: "
          f"{n_params} parameters, f32 {f32_bytes} B -> bf16 {param_bytes} "
          f"B on the card, initialised and cast in {init_s:.1f} s")
    tokens = torch.randint(0, cfg.vocab_size, (B, LM_PROMPT), generator=gen,
                           device="cuda")
    zero = dict.fromkeys(ops.launch_counts(), 0)

    def head(logits):
        """The sharded greedy head on one step's logits (B, V)."""
        local = logits.reshape(B, LM_SHARDS, V // LM_SHARDS).transpose(0, 1)
        return sampling.topk_logits(local, LM_TOPK)[1][0, :, 0]

    # -- path (i): prefill through B7, greedy decode over the bf16 cache ------
    state0 = model.init_decode_state(B, LM_MAX_LEN)
    cache_bytes = sum(t.numel() * t.element_size() for t in state0[:2])
    flash_in, logits_k = [], []
    orig_fa = _recording(ops, "flash_attention_fwd", flash_in)
    ops.reset_launch_counts()
    logits0, st = model.prefill(params, {"tokens": tokens}, state0,
                                attn_impl="flash")
    first = torch.argmax(logits0, dim=-1)
    st_eager, st_sampled = T.copy_cache(st), T.copy_cache(st)
    gen_toks, st = decode_loop(model, params, st, first, LM_STEPS,
                               shards=LM_SHARDS, k=LM_TOPK,
                               logits_out=logits_k)
    torch.cuda.synchronize()
    got = ops.launch_counts()
    ops.flash_attention_fwd = orig_fa
    want = {**zero, "flash_attention_fwd_tc": cfg.n_layers}
    if got != want:
        fail(f"path (i) launched {got}, expected {want}")
    fa_launches = got["flash_attention_fwd_tc"]
    fa_old_launches = got["flash_attention_fwd"]
    if (int(st.length) != LM_MAX_LEN or st.host_length.n != LM_MAX_LEN
            or gen_toks.shape != (B, LM_STEPS + 1)):
        fail(f"path (i): cache length {int(st.length)} (host "
             f"{st.host_length.n}), tokens {tuple(gen_toks.shape)}")
    if not all(torch.isfinite(x.float()).all() for x in [logits0, *logits_k]):
        fail("path (i): non-finite logits")
    # the sharded greedy head equals argmax of the full logits
    if not torch.equal(head(logits0), first):
        fail("path (i): the sharded head differs from argmax on the prefill")
    for t, lg in enumerate(logits_k):
        a = torch.argmax(lg, dim=-1)
        if not (torch.equal(head(lg), a) and torch.equal(a, gen_toks[:, t + 1])):
            fail(f"path (i) step {t}: the sharded head differs from argmax")
    e_replay_i = _replay_vs_eager(torch, model, params, st_eager, gen_toks,
                                  logits_k, head, "path (i)")
    del st_eager
    sampled = _sampled_decode(torch, model, params, st_sampled, first)
    del st_sampled
    print(f"path (i): prefill {B} x {LM_PROMPT} tokens + {LM_STEPS} greedy "
          f"steps replayed from one captured CUDA graph (shards {LM_SHARDS}, "
          f"k {LM_TOPK}); launches {got}; the sharded head equals argmax of "
          f"the full logits on every step; the same steps run eagerly on a "
          f"copy of the state chose the same tokens, logits within rtol 2^-8 "
          f"(max abs difference {e_replay_i})")
    # (b) + (c): the plain B7, then the same decode steps teacher-forced
    ops.use_kernels(False)
    lp0, stp = model.prefill(params, {"tokens": tokens},
                             model.init_decode_state(B, LM_MAX_LEN),
                             attn_impl="flash")
    ops.use_kernels(True)
    e_b = _logit_check(torch, logits0, lp0, "(b) prefill vs the plain B7")
    e_c = {"max": 0.0, "mean": 0.0, "ref_max": 0.0}
    agree = 0
    for t in range(LM_STEPS):
        lp, stp = model.decode_step(params, stp, gen_toks[:, t:t + 1])
        e = _logit_check(torch, logits_k[t], lp, f"(c) decode step {t}")
        e_c = {k: max(e_c[k], e[k]) for k in e_c}
        agree += int(torch.equal(torch.argmax(lp, -1), gen_toks[:, t + 1]))
    del stp, lp0
    print(f"(b) prefill logits vs the plain B7: {e_b}; (c) {LM_STEPS} decode "
          f"steps teacher-forced on the plain path's cache: worst {e_c}, "
          f"argmax equal on {agree}/{LM_STEPS} steps (limit {LOGIT_RTOL} x "
          f"max |logit|)")
    # (d) prefill of S - 1 tokens + one decode step vs the full prefill
    _, std = model.prefill(params, {"tokens": tokens[:, :-1]},
                           model.init_decode_state(B, LM_MAX_LEN),
                           attn_impl="flash")
    ld, std = model.decode_step(params, std, tokens[:, -1:])
    e_d = _logit_check(torch, ld, logits0,
                       "(d) prefill S-1 + decode vs prefill S")
    del std, ld
    print(f"(d) prefill of {LM_PROMPT - 1} + one decode step vs the "
          f"{LM_PROMPT}-token prefill: {e_d}")
    torch.cuda.empty_cache()

    # -- path (ii): int8-cache decode through B9 ------------------------------
    mq = build(cfg, cache_quant=True)
    sq = mq.init_decode_state(B, LM_MAX_LEN)
    qcache_bytes = sum(t.numel() * t.element_size() for t in sq[:4])
    n_steps = LM_QUANT_PROMPT + LM_STEPS
    logits_q = []
    # for the eager check of the prompt: the state and tokens before it
    sq_start = T.copy_cache(sq)
    fed_prompt = tokens[:, :LM_QUANT_PROMPT].clone()
    ops.reset_launch_counts()
    # the prompt fed one token a step (teacher-forced), then greedy steps,
    # each loop one captured graph replayed
    prompt, sq = decode_loop(mq, params, sq, tokens[:, 0], LM_QUANT_PROMPT,
                             shards=LM_SHARDS, k=LM_TOPK,
                             forced=tokens[:, 1:LM_QUANT_PROMPT],
                             logits_out=logits_q)
    sq_prompt, sq_eager = T.copy_cache(sq), T.copy_cache(sq)
    q_toks, sq = decode_loop(mq, params, sq, prompt[:, -1], LM_STEPS,
                             shards=LM_SHARDS, k=LM_TOPK, logits_out=logits_q)
    torch.cuda.synchronize()
    got = ops.launch_counts()
    want = {**zero, "decode_attention": cfg.n_layers * n_steps}
    if got != want:
        fail(f"path (ii) launched {got}, expected {want}")
    da_launches = got["decode_attention"]
    if int(sq.length) != n_steps or sq.host_length.n != n_steps:
        fail(f"path (ii): cache length {int(sq.length)} (host "
             f"{sq.host_length.n}), expected {n_steps}")
    if not torch.equal(tokens[:, :LM_QUANT_PROMPT], fed_prompt):
        fail("path (ii): decode_loop wrote into the prompt it was fed")
    # the first prompt steps (the warm-up, the captured step and replays)
    # against eager steps from a copy of the state before the prompt, fed
    # the prompt as it was before the loop: a fault in decode_loop's feed
    # of forced tokens shows here, where the int8-vs-bf16 check below,
    # both of whose sides decode_loop feeds, cannot see it
    e_replay_prompt = _replay_vs_eager(
        torch, mq, params, sq_start, prompt, logits_q[:LM_PROMPT_CHECK],
        head, "path (ii) prompt", fed=fed_prompt)
    del sq_start
    # the replayed greedy steps against the same steps eagerly, on a copy
    # of the state after the prompt; the last eager step's B9 inputs, one
    # call a layer, are kept for (d) and (e)
    dec_in = collections.deque(maxlen=cfg.n_layers)
    orig_da = _recording(ops, "decode_attention", dec_in)
    e_replay_ii = _replay_vs_eager(torch, mq, params, sq_eager, q_toks,
                                   logits_q[LM_QUANT_PROMPT:], head,
                                   "path (ii)")
    ops.decode_attention = orig_da
    del sq_eager
    fed = torch.cat([tokens[:, :LM_QUANT_PROMPT], q_toks[:, :LM_STEPS]], 1)
    # the bf16-cache path fed the same tokens, through graphs as well
    mf = build(cfg)
    sf = mf.init_decode_state(B, LM_MAX_LEN)
    logits_f = []
    _, sf = decode_loop(mf, params, sf, fed[:, 0], LM_QUANT_PROMPT,
                        shards=LM_SHARDS, k=LM_TOPK,
                        forced=fed[:, 1:LM_QUANT_PROMPT], logits_out=logits_f)
    sf_prompt = T.copy_cache(sf)
    _, sf = decode_loop(mf, params, sf, fed[:, LM_QUANT_PROMPT], LM_STEPS,
                        shards=LM_SHARDS, k=LM_TOPK,
                        forced=fed[:, LM_QUANT_PROMPT + 1:], logits_out=logits_f)
    worst = {"max": 0.0, "mean": 0.0, "ref_max": 0.0}
    over, in_top5 = 0.0, True
    for t in range(n_steps):
        lf, lq = logits_f[t], logits_q[t].float()
        if not torch.isfinite(lq).all():
            fail(f"path (ii) step {t}: non-finite logits")
        e = _errs(lq, lf)
        worst = {k: max(worst[k], e[k]) for k in worst}
        excess = (lq - lf.float()).abs() - (QUANT_ATOL
                                            + QUANT_RTOL * lf.float().abs())
        over = max(over, float(excess.max()))
        top5 = torch.topk(lf.float(), 5, dim=-1).indices
        in_top5 &= bool((top5 == lq.argmax(-1, keepdim=True)).any(-1).all())
    if over > 0:
        fail(f"path (ii): int8 logits outside rtol {QUANT_RTOL} atol "
             f"{QUANT_ATOL} of the bf16 cache's by up to {over}; {worst}")
    if not in_top5:
        fail("path (ii): an int8 argmax outside the bf16 path's top 5")
    print(f"path (ii): {LM_QUANT_PROMPT} prompt tokens one a step + "
          f"{LM_STEPS} greedy steps over the int8 cache, each loop replayed "
          f"from one captured CUDA graph; launches {got}; the greedy steps "
          f"run eagerly on a copy of the state chose the same tokens, logits "
          f"within rtol 2^-8 (max abs difference {e_replay_ii}), and so did "
          f"the first {LM_PROMPT_CHECK} prompt steps run eagerly from a copy "
          f"of the state before the prompt ({e_replay_prompt}); logits vs "
          f"the bf16 cache fed the same tokens: worst {worst} (rtol "
          f"{QUANT_RTOL}, atol {QUANT_ATOL}); int8 argmax in the bf16 top 5 "
          f"on every row and step")
    del logits_q, logits_k, logits_f
    torch.cuda.empty_cache()

    # -- times ----------------------------------------------------------------
    times = {}
    st_t = model.init_decode_state(B, LM_MAX_LEN)

    def prefill_and_head():
        lg, s = model.prefill(params, {"tokens": tokens}, st_t,
                              attn_impl="flash")
        return lg, s, torch.argmax(lg, dim=-1)

    ttft, (_, st_after, first_t) = _events_ms(torch, prefill_and_head,
                                              LM_REPEAT)
    pre_ms, _ = _events_ms(torch, lambda: model.prefill(
        params, {"tokens": tokens}, st_t, attn_impl="flash"), LM_REPEAT)
    times["prefill_ms"] = pre_ms
    times["prefill_tokens_per_s"] = B * LM_PROMPT / pre_ms * 1e3
    times["ttft_ms"] = ttft

    def rewind(s, n):
        """The same positions again: both counts back to the prompt's
        ``n``."""
        T.set_length(s, n)
        return s

    def replayed(m, s, n, tok, steps=LM_STEPS):
        return lambda: decode_loop(m, params, rewind(s, n), tok, steps,
                                   shards=LM_SHARDS, k=LM_TOPK)

    def eager(m, s, n, tok):
        def run():
            st_, t_ = rewind(s, n), tok
            for _ in range(LM_STEPS):
                lg, st_ = m.decode_step(params, st_, t_[:, None])
                t_ = head(lg)
            return t_
        return run

    for name, m, s, tok in (
            ("bf16_at_4096", model, st_after, first_t),
            ("bf16_at_512", mf, sf_prompt, fed[:, LM_QUANT_PROMPT]),
            ("int8_at_512", mq, sq_prompt, fed[:, LM_QUANT_PROMPT])):
        n = s.host_length.n
        ms, _ = _events_ms(torch, replayed(m, s, n, tok), LM_REPEAT)
        ms2, _ = _events_ms(torch, replayed(m, s, n, tok, 2), 1)
        times[f"decode_{name}_ms_per_step"] = ms / LM_STEPS
        times[f"decode_{name}_tokens_per_s"] = B * LM_STEPS / ms * 1e3
        times[f"decode_{name}_replay_ms_per_step"] = (ms - ms2) / (
            LM_STEPS - 2)
        if name != "bf16_at_512":    # eager beside the two main paths
            ms_eager, _ = _events_ms(torch, eager(m, s, n, tok), 1)
            times[f"decode_{name}_eager_ms_per_step"] = ms_eager / LM_STEPS
        busy, wall = profile_query(torch, replayed(m, s, n, tok),
                                   f"decode {name} x{LM_STEPS} replayed")
        times[f"decode_{name}_busy_ms"] = busy
        times[f"decode_{name}_profiled_wall_ms"] = wall
        times[f"decode_{name}_busy_share"] = busy / wall
    print(f"qwen2.5-3b times (CUDA events, median of {LM_REPEAT} warm runs, "
          f"batch {B}; decode ms a step: a whole {LM_STEPS}-step decode_loop "
          f"(warm-up, capture, replays) / {LM_STEPS}; replay: (the "
          f"{LM_STEPS}-step loop - one 2-step loop) / {LM_STEPS - 2}; eager: "
          f"one run of {LM_STEPS} eager steps; busy share: device time of the "
          f"profiled {LM_STEPS}-step loop over its wall time) on {smi}: "
          f"{times}")
    if args.profile:
        profile_query(torch, lambda: model.prefill(
            params, {"tokens": tokens}, st_t, attn_impl="flash"), "prefill")
        profile_query(torch, eager(mq, sq_prompt, LM_QUANT_PROMPT,
                                   fed[:, LM_QUANT_PROMPT]),
                      "decode int8 cache x64 eager (lengths 513-576)")
    resident = {"params_bf16": param_bytes, "params_f32_master": f32_bytes,
                "kv_cache_bf16": cache_bytes, "kv_cache_int8": qcache_bytes}
    print(f"resident bytes: {resident}")
    del st_t, st_after, sf, sf_prompt, sq, sq_prompt, st
    torch.cuda.empty_cache()

    # -- the kernels at their main-path inputs --------------------------------
    # every layer's prefill input, held to the plain version with the same
    # rounding (as check_flash_tc)
    b7_err, b7_dist, b7_slack_only = 0.0, 0.0, 0
    for i, ((qg, kg, vg), kw) in enumerate(flash_in):
        out, _ = fa.flash_attention_fwd_tc_cuda(qg, kg, vg, **kw)
        want, _, slack = ref.flash_attention_fwd(
            qg.float(), kg.float(), vg.float(), p_dtype=qg.dtype, slack=True,
            **kw)
        b7_slack_only += _hold_rounded(
            torch, out, want, slack,
            f"flash_attention_fwd_tc on layer {i}'s prefill input", 1e-5)
        b7_err = max(b7_err, _errs(out, want)["max"])
        del want, slack
        want, _ = ref.flash_attention_fwd(qg.float(), kg.float(), vg.float(),
                                          **kw)
        b7_dist = max(b7_dist, _errs(out, want)["max"])
        del out, want
    (qg, kg, vg), kw = flash_in[0]
    b7_ms = cuda_ms(lambda: fa.flash_attention_fwd_tc_cuda(qg, kg, vg, **kw),
                    20)
    b7_plain = cuda_ms(lambda: ref.flash_attention_fwd(
        qg, kg, vg, p_dtype=qg.dtype, **kw), 2)
    b7_old_ms = cuda_ms(lambda: fa.flash_attention_fwd_cuda(qg, kg, vg, **kw),
                        3)
    b7_old_plain = cuda_ms(lambda: ref.flash_attention_fwd(qg, kg, vg, **kw),
                           2)
    bkv, g, s, d = qg.shape
    q4 = qg.reshape(B, bkv // B * g, s, d)
    k4, v4 = (t.reshape(B, bkv // B, s, d) for t in (kg, vg))
    b7_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True), 20)
    b7_bytes = 2 * (2 * qg.numel() + kg.numel() + vg.numel()) + 4 * bkv * g * s
    b7_ops = 4 * d * bkv * g * s * (s + 1) // 2
    b7_bound, b7_by = bound(b7_bytes, b7_ops, BF16_OPS_PER_S)
    b7_f32 = b7_ops / F32_OPS_PER_S * 1e3
    print(f"flash_attention_fwd_tc at the prefill input {tuple(qg.shape)} "
          f"bf16 causal: {b7_ms:.4f} ms, plain (p in bf16) {b7_plain:.3f} ms, "
          f"sdpa {b7_lib:.4f} ms, bound {b7_bound:.4f} ms ({b7_by}: {b7_ops} "
          f"FLOP at 989 TFLOP/s bf16; {b7_bytes} B); over the "
          f"{len(flash_in)} layers' inputs max abs err {b7_err:.3e} against "
          f"the plain version with the same rounding ({b7_slack_only} "
          f"elements admitted by the rounding slack only), {b7_dist:.3e} "
          f"from the f32 plain version; the f32 CUDA-core "
          f"flash_attention_fwd at the same input {b7_old_ms:.3f} ms, its "
          f"plain version {b7_old_plain:.3f} ms, 67 TFLOP/s f32 bound "
          f"{b7_f32:.3f} ms")

    # every layer's input of the last int8 step
    b9_err = 0.0
    for i, ((qd, kq, vq, length), kwd) in enumerate(dec_in):
        out = da.decode_attention_cuda(qd, kq, vq, length, **kwd)
        want = ref.decode_attention(qd.float(), kq, vq, length,
                                    kwd["k_scale"], kwd["v_scale"])
        _hold_bf16(torch, out, want,
                   f"decode_attention on layer {i}'s last int8 step input")
        b9_err = max(b9_err, _errs(out, want)["max"])
    (qd, kq, vq, length), kwd = dec_in[-1]
    n = int(length)
    # device time from a graph of 50 calls (an eager loop of calls times
    # the wrapper's host cost), and the eager loop beside it
    b9_ms = graph_ms(lambda: da.decode_attention_cuda(qd, kq, vq, length,
                                                      **kwd), 50)
    b9_eager = cuda_ms(lambda: da.decode_attention_cuda(qd, kq, vq, length,
                                                        **kwd), 50)
    b9_plain = cuda_ms(lambda: ref.decode_attention(
        qd, kq, vq, length, kwd["k_scale"], kwd["v_scale"]), 10)
    bkv, g, d = qd.shape
    b9_bytes = (bkv * n * (2 * d * kq.element_size() + 8)
                + 2 * qd.numel() * qd.element_size())
    b9_bound, b9_by = bound(b9_bytes, 4 * bkv * g * n * d, BF16_OPS_PER_S)
    # the same function over a bf16 cache holding the dequantised values
    kb = (kq.float() * kwd["k_scale"][..., None]).to(torch.bfloat16)
    vb = (vq.float() * kwd["v_scale"][..., None]).to(torch.bfloat16)
    b9b_ms = graph_ms(lambda: da.decode_attention_cuda(qd, kb, vb, length),
                      50)
    b9b_plain = cuda_ms(lambda: ref.decode_attention(qd, kb, vb, length), 10)
    qs = qd.reshape(B, bkv // B * g, 1, d)
    ks4, vs4 = (t.reshape(B, bkv // B, -1, d)[:, :, :n] for t in (kb, vb))
    b9b_lib = graph_ms(lambda: F.scaled_dot_product_attention(
        qs, ks4, vs4, enable_gqa=True), 50)
    b9b_bytes = bkv * n * 2 * d * 2 + 2 * qd.numel() * qd.element_size()
    b9b_bound, _ = bound(b9b_bytes, 4 * bkv * g * n * d, BF16_OPS_PER_S)
    print(f"decode_attention at the last int8 step's input q "
          f"{tuple(qd.shape)}, cache {tuple(kq.shape)}, length {n}: "
          f"{b9_ms:.4f} ms (graph of 50 calls; {b9_eager:.4f} ms a call in "
          f"an eager loop), plain {b9_plain:.4f} ms, bound {b9_bound:.5f} ms "
          f"({b9_by}, {b9_bytes} B); bf16 cache: {b9b_ms:.4f} ms, plain "
          f"{b9b_plain:.4f} ms, sdpa {b9b_lib:.4f} ms, bound "
          f"{b9b_bound:.5f} ms; max abs err over the {len(dec_in)} layers' "
          f"inputs {b9_err:.3e} (rtol 2^-8, atol 1e-5)")
    del kb, vb, ks4, vs4
    # decode_32k's length: 32,768 positions of 8 kv rows
    at_32k = {}
    for kind in ("int8", "bf16"):
        q, k, v, sc = _decode_inputs(torch, gen, 8, 8, 32768, 128, kind)
        lt = _device_length(torch, 32768)
        t = graph_ms(lambda: da.decode_attention_cuda(q, k, v, lt, **sc), 20)
        nbytes = (8 * 32768 * (2 * 128 * k.element_size() + (8 if sc else 0))
                  + 2 * q.numel() * q.element_size())
        b_ms, b_by = bound(nbytes, 4 * 8 * 8 * 32768 * 128, BF16_OPS_PER_S)
        lib = None
        if kind == "bf16":
            q4, k4, v4 = (q.reshape(4, 16, 1, 128),
                          k.reshape(4, 2, 32768, 128),
                          v.reshape(4, 2, 32768, 128))
            lib = graph_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, enable_gqa=True), 20)
        at_32k[kind] = {"ms": t, "bound_ms": b_ms, "bound_by": b_by,
                        "share_of_bound": b_ms / t, "library_ms": lib}
        del q, k, v, sc
    print(f"decode_attention at decode_32k's 32,768 positions, q (8, 8, 128) "
          f"bf16 (graph of 20 calls): {at_32k}")

    shape = f"q {tuple(qg.shape)} bf16 causal (layer 0 of the prefill)"
    kernels = [
        {"name": "flash_attention_fwd_tc", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
         "replaces": "src/repro/kernels/flash_attention.py:134",
         "tpu_function": "src/repro/kernels/flash_attention.py:"
                         "flash_attention_fwd_grouped",
         "launches": fa_launches, "max_abs_err": b7_err, "ms": b7_ms,
         "plain_ms": b7_plain, "bound_ms": b7_bound, "bound_by": b7_by,
         "library_ms": b7_lib, "main_path": True,
         "max_abs_dist_from_f32_plain": b7_dist,
         "slack_only_elements": b7_slack_only, "checks": b7_tc_check,
         "shape": shape},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:134",
         "tpu_function": "src/repro/kernels/flash_attention.py:"
                         "flash_attention_fwd_grouped",
         "launches": fa_old_launches, "max_abs_err": b7_old_err,
         "ms": b7_old_ms,
         "plain_ms": b7_old_plain, "bound_ms": b7_bound, "bound_by": b7_by,
         "library_ms": b7_lib, "f32_ops_bound_ms": b7_f32,
         "main_path": False,
         "note": "f32 CUDA-core variant for f32 inputs and other head dims; "
                 "checked in check_flash, not on the bf16 D = 128 paths",
         "shape": shape},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:69",
         "tpu_function": "src/repro/kernels/decode_attention.py:"
                         "decode_attention",
         "launches": da_launches, "max_abs_err": b9_err, "ms": b9_ms,
         "plain_ms": b9_plain, "bound_ms": b9_bound, "bound_by": b9_by,
         "library_ms": None, "eager_loop_ms": b9_eager,
         "shape": f"q {tuple(qd.shape)} bf16, int8 cache "
                  f"{tuple(kq.shape)}, length {n}",
         "bf16_cache": {"ms": b9b_ms, "plain_ms": b9b_plain,
                        "library_ms": b9b_lib, "bound_ms": b9b_bound},
         "at_32k": at_32k, "configs": b9_configs},
    ]
    summary = {**times, "resident_bytes": resident, "params": n_params,
               "batch": B, "prompt": LM_PROMPT, "max_len": LM_MAX_LEN,
               "logit_errs": {"b": e_b, "c": e_c, "d": e_d,
                              "int8_vs_bf16": worst,
                              "replayed_vs_eager_i": e_replay_i,
                              "replayed_vs_eager_ii": e_replay_ii,
                              "replayed_vs_eager_ii_prompt":
                                  e_replay_prompt},
               "sampled": sampled}
    return kernels, summary


# ---------------------------------------------------------------------------
# phase 8: training qwen2.5-3b at full width through B7 and B8
# ---------------------------------------------------------------------------

TRAIN_BATCH = 2             # sequences a step (the registry's train_4k: 256)
TRAIN_SEQ = 4096
TRAIN_STEPS = 4             # AdamW steps on one batch, phase 8b
TRAIN_LR = 1e-3
# The first step through B7 + B8 against the plain attention path, both
# bf16 at full width: the losses within this relative difference, and each
# parameter's gradient within GRAD_RTOL relative Frobenius distance
# (||g - g_plain|| / ||g_plain||).  tools/grad_fault_control.py read the
# largest distance over the 435 tensors at 0.0476 for the sound B8 and
# 0.0477 with p rounded to bf16 (a tensor-core kernel's rounding; both at
# layers.26.attn.bk, whose gradient cancels most), and at 0.926 (the
# diagonal query tile skipped in dk/dv), 10.6 (dq unscaled) and 876
# (delta dropped) for planted B8 faults.  The limit sits near the
# geometric mean of 0.0477 and 0.926, about 4x from each (PERF.md, PR 14).
TRAIN_LOSS_RTOL = 1e-2
GRAD_RTOL = 0.2


def _hold_bf16_grad(torch, got, want, what: str):
    """A bf16 gradient within one output rounding of its plain version
    computed in f32, on top of the f32 tolerance:
    |got - want| <= 2^-8 |want| + 2e-5 max |want|.  The f32 term is the
    f32 check's own (F32_TOL): on the training inputs both the kernel and
    the plain version differ from an f64 computation by up to 7e-5 of the
    largest |gradient| (PERF.md, PR 14), so a floor of 1e-6 of it, below
    that noise, failed one element in a million near zero."""
    w = want.float()
    lim = BF16_ULP * w.abs() + F32_TOL * float(w.abs().max())
    if not bool(((got.float() - w).abs() <= lim).all()):
        fail(f"{what}: differs from the plain version by {_errs(got, w)} "
             f"(2^-8 |want| + 2e-5 max |want|)")


def check_flash_bwd(torch, fa, fb, ref, gen):
    """The f32 CUDA-core B8 (``flash_attention_bwd_cuda``) against its
    plain version (f32, from the same inputs, out and lse from the f32
    CUDA-core B7) over ``FLASH_CASES`` in f32 and bf16 and at the training
    shape in bf16: f32 within 2e-5 of the largest |gradient|, bf16 within
    one output rounding on top of that (``_hold_bf16_grad``); each twice,
    identical; a fully masked row gives zero gradients.  Returns the
    largest absolute errors by dtype."""
    train = (2 * TRAIN_BATCH, 8, TRAIN_SEQ, TRAIN_SEQ, 128,
             dict(causal=True))
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in worst:
        cases = FLASH_CASES + ([train] if dtype == torch.bfloat16 else [])
        for bkv, g, s, sk, d, m in cases:
            q, do = (torch.randn((bkv, g, s, d), generator=gen,
                                 device="cuda").to(dtype) for _ in range(2))
            k, v = (torch.randn((bkv, sk, d), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            out, lse = fa.flash_attention_fwd_cuda(q, k, v, **m)
            got = fb.flash_attention_bwd_cuda(q, k, v, out, lse, do, **m)
            again = fb.flash_attention_bwd_cuda(q, k, v, out, lse, do, **m)
            want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                           out.float(), lse, do.float(), **m)
            torch.cuda.synchronize()
            what = (f"flash bwd {dtype} BKV={bkv} G={g} S={s} Sk={sk} D={d} "
                    f"{m}")
            for name, a, b, w in zip("qkv", got, again, want):
                if not torch.equal(a, b):
                    fail(f"{what}: d{name} not repeatable")
                if dtype == torch.float32:
                    e = _errs(a, w)
                    if not e["max"] <= F32_TOL * e["ref_max"]:
                        fail(f"{what}: d{name} differs from the plain "
                             f"version by {e} (2e-5 x max |grad|)")
                else:
                    _hold_bf16_grad(torch, a, w, f"{what}: d{name}")
                if m.get("window") == 0 and a.any():
                    fail(f"{what}: a fully masked row gives d{name} != 0")
                worst[dtype] = max(worst[dtype], _errs(a, w)["max"])
            del q, k, v, do, out, lse, got, again, want
    print(f"flash_attention_bwd (f32 CUDA cores): {len(FLASH_CASES)} shapes x "
          f"f32/bf16 and the training shape {train[:5]} bf16 causal within "
          f"the plain version (f32 2e-5 x max |grad|; bf16 2^-8 |want| + "
          f"2e-5 max |want|), repeatable; max abs err f32 "
          f"{worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e}")
    return worst


def _hold_rounded_grads(torch, got, want, slack, what: str) -> int:
    """Tensor-core gradients against the plain version with the same
    rounding: ``_hold_rounded`` with the floor of ``_hold_bf16_grad``
    (2e-5 of the largest |gradient|).  Returns the elements only the
    rounding slack admits."""
    return sum(_hold_rounded(torch, a, w, sl, f"{what}: d{name}",
                             F32_TOL * float(w.float().abs().max()))
               for name, a, w, sl in zip("qkv", got, want, slack))


def check_flash_bwd_tc(torch, fa, fb, ref, gen) -> dict:
    """The tensor-core B8 (``flash_attention_bwd_tc_cuda``, out and lse
    from the tensor-core B7) against its plain version with the same
    rounding (``p_dtype`` = the input type) over ``FLASH_TC_CASES`` in bf16
    and f16 and at the training shape in bf16: each gradient within one
    rounding of its type plus 2e-5 of its largest |value| (and the rounding
    slack); twice identical; a fully masked row gives zero gradients.
    Also reads the distance from the f32 plain version."""
    train = (2 * TRAIN_BATCH, 8, TRAIN_SEQ, TRAIN_SEQ, 128,
             dict(causal=True))
    worst, dist, slack_only = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float16):
        cases = FLASH_TC_CASES + ([train] if dtype == torch.bfloat16 else [])
        for bkv, g, s, sk, d, m in cases:
            q, do = (torch.randn((bkv, g, s, d), generator=gen,
                                 device="cuda").to(dtype) for _ in range(2))
            k, v = (torch.randn((bkv, sk, d), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            out, lse = fa.flash_attention_fwd_tc_cuda(q, k, v, **m)
            got = fb.flash_attention_bwd_tc_cuda(q, k, v, out, lse, do, **m)
            again = fb.flash_attention_bwd_tc_cuda(q, k, v, out, lse, do, **m)
            ins = (q.float(), k.float(), v.float(), out.float(), lse,
                    do.float())
            want, slack = ref.flash_attention_bwd(*ins, p_dtype=dtype,
                                                  slack=True, **m)
            torch.cuda.synchronize()
            what = (f"flash bwd tc {dtype} BKV={bkv} G={g} S={s} Sk={sk} "
                    f"D={d} {m}")
            for name, a, b in zip("qkv", got, again):
                if not torch.equal(a, b):
                    fail(f"{what}: d{name} not repeatable")
                if m.get("window") == 0 and a.any():
                    fail(f"{what}: a fully masked row gives d{name} != 0")
            key = str(dtype).split(".")[-1]
            slack_only[key] = slack_only.get(key, 0) + _hold_rounded_grads(
                torch, got, want, slack, what)
            worst[key] = max([worst.get(key, 0.0)] + [
                _errs(a, w)["max"] for a, w in zip(got, want)])
            del want, slack
            f32 = ref.flash_attention_bwd(*ins, **m)
            dist[key] = max([dist.get(key, 0.0)] + [
                _errs(a, w)["max"] for a, w in zip(got, f32)])
            del q, k, v, do, out, lse, got, again, ins, f32
    print(f"flash_attention_bwd_tc: {len(FLASH_TC_CASES)} shapes x bf16/f16 "
          f"and the training shape {train[:5]} bf16 causal within the plain "
          f"version with the same rounding (one rounding of the output + "
          f"2e-5 max |want|, plus the rounding slack), repeatable; max abs "
          f"err {worst}; elements only the slack admits {slack_only}; max "
          f"abs distance from the f32 plain version {dist}")
    return {"max_abs_err": worst, "slack_only": slack_only,
            "dist_from_f32_plain": dist}


def _named_grads(params) -> dict:
    """name -> gradient of every parameter; the .grad fields cleared."""
    out = {}
    for n, p in params.named_parameters():
        out[n], p.grad = p.grad, None
    return out


def first_step_grads(model, params, batch, attn_impl: str):
    """One step's loss and gradients, no update: (loss, name -> grad)."""
    loss = model.loss(params, batch, attn_impl=attn_impl)
    loss.backward()
    return float(loss.detach()), _named_grads(params)


def grad_distances(torch, got: dict, want: dict) -> dict:
    """name -> ||got - want||_F / ||want||_F."""
    return {n: float(torch.linalg.vector_norm(got[n] - want[n])
                     / torch.linalg.vector_norm(want[n]).clamp_min(1e-30))
            for n in want}


def train_phases(args, torch, smi: str):
    """Phase 8: B8 against its plain version; qwen2.5-3b at full width,
    its first step through B7 + B8 against the plain attention path, then
    AdamW steps; the smoke trainer through ``launch/train.py``; times.
    Returns (B8's entries of the JSON line, both variants, the launches of
    the training steps by kernel, a summary dict)."""
    import shutil
    import tempfile

    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import build
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.train_step import TrainState, make_train_step

    # -- 8a. B8 against its plain version ------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(2)
    b8_old_err = check_flash_bwd(torch, fa, fb, ref, gen)[torch.bfloat16]
    b8_tc_check = check_flash_bwd_tc(torch, fa, fb, ref, gen)
    torch.cuda.empty_cache()

    # -- the model at full width, random f32 weights from seed 0 -------------
    cfg = get_arch("qwen2.5-3b")
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device="cuda", trainable=True)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH, seed=0)
    batch = data.device_batch(0, device="cuda")
    torch.cuda.synchronize()
    param_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
    print(f"training qwen2.5-3b: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {param_bytes} B of f32 parameters ({cfg.compute_dtype} "
          f"compute, remat full), batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
          f"from SyntheticLM seed 0; initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    zero = dict.fromkeys(ops.launch_counts(), 0)
    per_step = {**zero, "flash_attention_fwd_tc": 2 * cfg.n_layers,
                "flash_attention_bwd_tc": cfg.n_layers}

    # -- 8c. the first step through B7 + B8 and through the plain path -------
    # (before any AdamW state: parameters + two f32 gradient sets, 41 GB)
    b8_in = []
    orig_bwd = _recording(ops, "flash_attention_bwd", b8_in)
    ops.reset_launch_counts()
    loss_f, g_flash = first_step_grads(model, params, batch, "flash")
    torch.cuda.synchronize()
    got = ops.launch_counts()
    ops.flash_attention_bwd = orig_bwd
    if got != per_step:
        fail(f"the first training step launched {got}, expected {per_step}")
    loss_x, g_plain = first_step_grads(model, params, batch, "xla")
    torch.cuda.synchronize()
    if not all(torch.isfinite(g).all() for g in (*g_flash.values(),
                                                   *g_plain.values())):
        fail("the first step: non-finite gradients")
    loss_rel = abs(loss_f - loss_x) / abs(loss_x)
    dist = grad_distances(torch, g_flash, g_plain)
    worst_name = max(dist, key=dist.get)
    if not (math.isfinite(loss_f) and loss_rel <= TRAIN_LOSS_RTOL):
        fail(f"the first step's loss {loss_f} through B7 + B8 vs {loss_x} "
             f"through the plain path: relative {loss_rel} > "
             f"{TRAIN_LOSS_RTOL}")
    if dist[worst_name] > GRAD_RTOL:
        fail(f"the first step's gradient of {worst_name} through B7 + B8 is "
             f"{dist[worst_name]} (relative Frobenius) from the plain "
             f"path's, limit {GRAD_RTOL}")
    del g_flash, g_plain
    torch.cuda.empty_cache()
    print(f"(8c) the first step through B7 + B8 vs the plain attention path: "
          f"loss {loss_f} vs {loss_x} (relative {loss_rel:.3e}, limit "
          f"{TRAIN_LOSS_RTOL}); launches {got}; gradients' relative "
          f"Frobenius distance at most {dist[worst_name]:.4e} "
          f"({worst_name}; limit {GRAD_RTOL}), median "
          f"{statistics.median(dist.values()):.4e} over {len(dist)} tensors")
    # B8 on each layer's inputs of that step (the backward runs the last
    # layer first)
    b8_in = [(tuple(t.detach() for t in a), kw) for a, kw in b8_in]
    b8_err, b8_dist, b8_slack_only = 0.0, 0.0, 0
    for i, ((qg, kg, vg, out, lse, do), kw) in enumerate(b8_in):
        layer = cfg.n_layers - 1 - i
        g = fb.flash_attention_bwd_tc_cuda(qg, kg, vg, out, lse, do, **kw)
        ins = (qg.float(), kg.float(), vg.float(), out.float(), lse,
                do.float())
        w, sl = ref.flash_attention_bwd(*ins, p_dtype=qg.dtype, slack=True,
                                        **kw)
        b8_slack_only += _hold_rounded_grads(
            torch, g, w, sl,
            f"flash_attention_bwd_tc on layer {layer}'s training input")
        b8_err = max([b8_err] + [_errs(a, b)["max"] for a, b in zip(g, w)])
        del w, sl
        w = ref.flash_attention_bwd(*ins, **kw)
        b8_dist = max([b8_dist] + [_errs(a, b)["max"] for a, b in zip(g, w)])
        del g, w, ins
    # its times at layer 0's input, beside the plain version and the
    # backward of scaled_dot_product_attention at the same shape
    (qg, kg, vg, out, lse, do), kw = b8_in[-1]
    del b8_in
    b8_ms = cuda_ms(lambda: fb.flash_attention_bwd_tc_cuda(
        qg, kg, vg, out, lse, do, **kw), 20)
    b8_plain = cuda_ms(lambda: ref.flash_attention_bwd(
        qg, kg, vg, out, lse, do, p_dtype=qg.dtype, **kw), 2)
    b8_old_ms = cuda_ms(lambda: fb.flash_attention_bwd_cuda(
        qg, kg, vg, out, lse, do, **kw), 3)
    b8_old_plain = cuda_ms(lambda: ref.flash_attention_bwd(
        qg, kg, vg, out, lse, do, **kw), 2)
    bkv, g, s, d = qg.shape
    B, KV = TRAIN_BATCH, bkv // TRAIN_BATCH
    q4 = qg.reshape(B, KV * g, s, d).detach().requires_grad_()
    k4, v4 = (t.reshape(B, KV, s, d).detach().requires_grad_()
              for t in (kg, vg))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                        enable_gqa=True)
    do4 = do.reshape(B, KV * g, s, d)
    b8_lib = cuda_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), do4,
                                                 retain_graph=True), 20)
    pairs = bkv * g * s * (s + 1) // 2          # causal, Sk = S
    b8_ops = 10 * d * pairs                     # 5 products of 2 D a pair
    b8_bytes = (2 * (3 * qg.numel() + 2 * kg.numel()) + 4 * lse.numel()
                + 2 * (qg.numel() + 2 * kg.numel()))
    b8_bound, b8_by = bound(b8_bytes, b8_ops, BF16_OPS_PER_S)
    b8_f32 = b8_ops / F32_OPS_PER_S * 1e3
    print(f"flash_attention_bwd_tc on the {cfg.n_layers} layers' training "
          f"inputs: within the limit of check_flash_bwd_tc, max abs err "
          f"{b8_err:.3e} ({b8_slack_only} elements admitted by the rounding "
          f"slack only), {b8_dist:.3e} from the f32 plain version; at layer "
          f"0's input q {tuple(qg.shape)} bf16 causal: {b8_ms:.4f} ms, plain "
          f"(p and ds in bf16) {b8_plain:.3f} ms, sdpa backward "
          f"{b8_lib:.4f} ms, bound {b8_bound:.4f} ms ({b8_by}: {b8_ops} FLOP "
          f"at 989 TFLOP/s bf16; {b8_bytes} B); the f32 CUDA-core "
          f"flash_attention_bwd at the same input {b8_old_ms:.3f} ms, its "
          f"plain version {b8_old_plain:.3f} ms, 67 TFLOP/s f32 bound "
          f"{b8_f32:.3f} ms")
    shape = f"q {tuple(qg.shape)} bf16 causal (layer 0 of a training step)"
    del qg, kg, vg, out, lse, do, q4, k4, v4, o4, do4
    torch.cuda.empty_cache()

    # -- 8b. AdamW steps on the batch through B7 + B8 -------------------------
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                          total_steps=TRAIN_STEPS)
    state = TrainState(params, adamw_init(params))
    del params
    step_fn = make_train_step(model, opt_cfg, fwd_kw={"attn_impl": "flash"})
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, step_ms = [], [], []
    launches = dict(zero)
    for t in range(TRAIN_STEPS):
        ops.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, met = step_fn(state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        got = ops.launch_counts()
        if got != per_step:
            fail(f"training step {t + 1} launched {got}, expected {per_step}")
        for k, n in got.items():
            launches[k] += n
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        final = float(model.loss(state.params, batch, attn_impl="flash"))
    if not all(map(math.isfinite, losses + gnorms + [final])):
        fail(f"training: non-finite loss or gradient norm: {losses}, "
             f"{gnorms}, {final}")
    if not final < losses[0]:
        fail(f"training: the loss after {TRAIN_STEPS} steps, {final}, is not "
             f"below the first step's {losses[0]}")
    ms = statistics.median(step_ms[1:])
    times = {"train_step_ms": ms,
             "train_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
             "step_ms": step_ms, "peak_allocated_bytes": peak}
    print(f"(8b) {TRAIN_STEPS} AdamW steps (lr {TRAIN_LR}) on one batch "
          f"through B7 + B8: losses {losses}, then {final}; gradient norms "
          f"{gnorms}; launches a step {per_step}; step {ms:.1f} ms (median of "
          f"the {TRAIN_STEPS - 1} warm steps, CUDA events; all {step_ms}), "
          f"{times['train_tokens_per_s']:.1f} tokens/s; peak allocated "
          f"{peak} B on {smi}")
    if args.profile:
        profile_query(torch, lambda: step_fn(state, batch),
                      "train step (2 x 4096)", top=14)
    del state, batch, step_fn
    torch.cuda.empty_cache()

    # -- 8d. the smoke trainer through launch/train.py, with a restart -------
    (ROOT / "build").mkdir(exist_ok=True)         # git-ignored
    ckdir = tempfile.mkdtemp(prefix="train-ckpt-", dir=ROOT / "build")
    histories = []
    orig_run = trainer_mod.Trainer.run

    def run(self, *a, **kw):
        out = orig_run(self, *a, **kw)
        histories.append(out[1])
        return out

    argv = ["--arch", "qwen2.5-3b", "--smoke", "--batch", "8", "--seq",
            "32", "--lr", "1e-2", "--device", "cuda", "--ckpt", ckdir,
            "--ckpt-every", "10"]
    trainer_mod.Trainer.run = run
    try:
        launch_train.main(argv + ["--steps", "30"])
        first = statistics.mean(h["loss"] for h in histories[0][:5])
        last = statistics.mean(h["loss"] for h in histories[0][-5:])
        if not last < first - 0.1 or ckpt.latest_step(ckdir) != 30:
            fail(f"the smoke trainer: loss {first} -> {last} over 30 steps, "
                 f"latest checkpoint {ckpt.latest_step(ckdir)}")
        launch_train.main(argv + ["--steps", "32"])
        resumed = [h["step"] for h in histories[1]]
        if resumed != [31, 32]:
            fail(f"the restarted smoke trainer ran steps {resumed}, not "
                 f"[31, 32]")
    finally:
        trainer_mod.Trainer.run = orig_run
        shutil.rmtree(ckdir, ignore_errors=True)
    print(f"(8d) launch/train.py --smoke --device cuda: loss {first:.4f} -> "
          f"{last:.4f} (means of the first and last 5 of 30 steps); the "
          f"restart resumed at step 30 and ran steps {resumed}")

    b8_kernels = [
        {"name": "flash_attention_bwd_tc", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu",
         "replaces": "src/repro/kernels/flash_attention_bwd.py:126",
         "tpu_function": "src/repro/kernels/flash_attention_bwd.py:"
                         "flash_attention_bwd",
         "launches": launches["flash_attention_bwd_tc"],
         "max_abs_err": b8_err, "ms": b8_ms, "plain_ms": b8_plain,
         "bound_ms": b8_bound, "bound_by": b8_by, "library_ms": b8_lib,
         "main_path": True, "max_abs_dist_from_f32_plain": b8_dist,
         "slack_only_elements": b8_slack_only, "checks": b8_tc_check,
         "shape": shape},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention_bwd.py:126",
         "tpu_function": "src/repro/kernels/flash_attention_bwd.py:"
                         "flash_attention_bwd",
         "launches": launches["flash_attention_bwd"],
         "max_abs_err": b8_old_err, "ms": b8_old_ms,
         "plain_ms": b8_old_plain, "bound_ms": b8_bound, "bound_by": b8_by,
         "library_ms": b8_lib, "f32_ops_bound_ms": b8_f32,
         "main_path": False,
         "note": "f32 CUDA-core variant for f32 inputs and other head dims; "
                 "checked in check_flash_bwd, not on the bf16 D = 128 path",
         "shape": shape}]
    summary = {**times, "losses": losses, "loss_after": final,
               "grad_norms": gnorms, "first_step": {
                   "loss": loss_f, "loss_plain": loss_x,
                   "loss_rel": loss_rel, "grad_dist_max": dist[worst_name],
                   "grad_dist_argmax": worst_name},
               "smoke_trainer": {"first5": first, "last5": last,
                                 "resumed": resumed},
               "batch": TRAIN_BATCH, "seq": TRAIN_SEQ}
    return b8_kernels, launches, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor (default 10: 60M lineitems)")
    ap.add_argument("--repeat", type=int, default=10,
                    help="warm runs per query for the median")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm run of each query, of the "
                         "prefill, of each decode flavour and of a training "
                         "step (torch.profiler: device time by kernel)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    # -- 1. device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"nvidia-smi: {smi}")
    print(f"device: {kind} (count {torch.cuda.device_count()}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(reports)} "
          f"into {build.BUILD_DIR.relative_to(ROOT)}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if any(w in line for w in ("built in", "registers", "spill",
                                       "Function properties for")):
                print(f"  ptxas {name}: {line.strip()}")

    phase_s = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    tpch_kernels, tpch = tpch_phases(args, torch, smi)
    torch.cuda.empty_cache()
    phase_s["tpch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm_kernels, lm = lm_phases(args, torch, smi)
    torch.cuda.empty_cache()
    phase_s["lm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b8_kernels, train_launches, train = train_phases(args, torch, smi)
    phase_s["train"] = time.perf_counter() - t0
    for k in lm_kernels:
        if k["name"].startswith("flash_attention_fwd"):
            k["launches_by_path"] = {"prefill": k["launches"],
                                     "training": train_launches[k["name"]]}
            k["launches"] += train_launches[k["name"]]
    kernels = tpch_kernels + lm_kernels + b8_kernels
    summary = {"card": smi, "tpch": tpch, "lm": lm, "train": train}
    for k in kernels:
        if k.get("main_path", True) and k["launches"] < 1:
            fail(f"{k['name']} was never launched on the main path")
        if not k.get("main_path", True) and k["launches"]:
            fail(f"{k['name']} was launched on the main path")
    summary["phase_s"] = phase_s
    summary["total_s"] = time.perf_counter() - t_start
    print(json.dumps(summary))
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
