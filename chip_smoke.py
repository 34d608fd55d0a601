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
   ``scan_filter`` bit-identical over widths {1, 2, 4, 6, 12, 21, 30}, both
   ``negate`` values and ragged row counts; ``filtered_group_sum`` at Q1's
   shape (8 nodes x the lineitem rows per node, G = 6, C = 6) and at
   G = 512, C = 64 with ragged N, within rtol 1e-5 of the plain version in
   float64 (f32 sums in another order), and bit-identical from run to run.
4. Queries: ``TPCHDriver(sf, num_nodes=8, device="cuda")`` generates the
   packed TPC-H tables and places them on the card; q6, q1 and q1_kernel
   run through ``run_ir`` and must match the float64 oracle within rtol
   2e-4.  The launch counters are set to 0 before each query and read
   after it: q6 must launch ``scan_filter`` 3 times, q1 once, q1_kernel
   ``filtered_group_sum`` once and no scan.  The main-path scans are then
   held bit-identical against the plain version on the resident words.
5. Times: warm median of each query (CUDA events), generation seconds and
   resident bytes; each kernel's time at its main-path shape beside its
   plain version, a PyTorch library call where one exists, and its bound.
6. One ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when CUDA is unavailable or when
it is run outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA data sheet) for the bounds
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

NODES = 8


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


def bound(nbytes: float, ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 rate."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_query(torch, drv, name: str, top: int = 6):
    """One warm run of ``name`` under torch.profiler: device time by
    kernel, and the device's busy share of the run's wall time (the
    profiler's own overhead inflates the wall time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drv.run_ir(name)
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


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check_scan_filter(torch, compression, ops, ref, gen):
    """B1 against its plain version: bit-identical, ragged rows."""
    for width in (1, 2, 4, 6, 12, 21, 30):
        rows = 4099 + 37 * width          # never a multiple of 32
        padded = -(-rows // 32) * 32
        codes = torch.randint(0, 1 << width, (NODES, padded),
                              generator=gen, device="cuda")
        words = compression.pack_bits(codes, width)
        lo = int(torch.randint(0, 1 << width, (1,), generator=gen,
                               device="cuda"))
        hi = lo + (1 << width) // 3
        for negate in (False, True):
            got = ops.scan_filter(words, lo, hi, rows=rows,
                                  padded_rows=padded, width=width,
                                  negate=negate)
            want = ref.scan_filter(words, lo, hi, rows, padded, width,
                                   negate)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"scan_filter width={width} negate={negate} differs "
                     f"from its plain version")
    print("scan_filter: bit-identical to the plain version at widths "
          "{1,2,4,6,12,21,30} x negate {F,T}, ragged rows")


def check_group_sum(torch, ops, ref, gen, n, num_groups, c, cutoff):
    """B2 against the plain version in float64: rtol 1e-5, and identical
    from run to run.  Returns (max_abs_err, inputs)."""
    measures = torch.rand((NODES, n, c), generator=gen, device="cuda")
    groups = torch.randint(0, num_groups, (NODES, n), generator=gen,
                           device="cuda", dtype=torch.int32)
    pred = torch.randint(0, 2 * cutoff, (NODES, n), generator=gen,
                         device="cuda", dtype=torch.int32)
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
    print(f"filtered_group_sum P={NODES} N={n} G={num_groups} C={c}: max "
          f"relative error {rel:.3e} (rtol 1e-5), repeatable")
    return float(err.max()), (measures, groups, pred)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor (default 10: 60M lineitems)")
    ap.add_argument("--repeat", type=int, default=10,
                    help="warm runs per query for the median")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm run of each query "
                         "(torch.profiler: device time by kernel)")
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
    from repro_torch.core import compression
    from repro_torch.core.columnar import PackedColumn
    from repro_torch.kernels import build, ops, ref
    from repro_torch.tpch import dbgen
    from repro_torch.tpch.driver import TPCHDriver
    from repro_torch.tpch.schema import DEFAULT_PARAMS as DP

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
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- 3. kernels against their plain versions -------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_scan_filter(torch, compression, ops, ref, gen)
    rows_per_node = dbgen.table_sizes(args.sf, NODES)["lineitem"] // NODES
    cutoff = DP.q1_shipdate_max
    fgs_err, fgs_inputs = check_group_sum(torch, ops, ref, gen,
                                          rows_per_node, 6, 6, cutoff)
    check_group_sum(torch, ops, ref, gen, 50_001, 512, 64, cutoff)

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

    expected = {"q6": {"scan_filter": 3, "filtered_group_sum": 0},
                "q1": {"scan_filter": 1, "filtered_group_sum": 0},
                "q1_kernel": {"scan_filter": 0, "filtered_group_sum": 1}}
    main_launches = {"scan_filter": 0, "filtered_group_sum": 0}
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
    from repro_torch.query.lower import lower
    from repro_torch.tpch.queries import IR_QUERIES

    scans = lower(IR_QUERIES["q6"], drv.catalog).scans
    scan_err = 0
    for d in scans:
        col = li.columns[d.column]
        args_ = (col.words, d.rewrite.lo, d.rewrite.hi)
        kw = dict(rows=col.rows, padded_rows=col.padded_rows,
                  width=col.width, negate=d.rewrite.negate)
        got = ops.scan_filter(*args_, **kw)
        want = ref.scan_filter(*args_, **kw)
        scan_err = max(scan_err, int((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want):
            fail(f"q6 scan of {d.column} differs from its plain version")
    print(f"q6 scans {[d.column for d in scans]}: bit-identical to the "
          f"plain version on the resident words")

    # -- 5. times --------------------------------------------------------------
    query_ms = {}
    for name in expected:
        times = []
        for _ in range(args.repeat):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            drv.run_ir(name)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        query_ms[name] = statistics.median(times)
        print(f"{name}: warm median {query_ms[name]:.3f} ms over "
              f"{args.repeat} runs (CUDA events) on {smi}")
        if args.profile:
            profile_query(torch, drv, name)

    iters = 20
    ship = li.columns["l_shipdate"]
    q6_ship = next(d for d in scans if d.column == "l_shipdate").rewrite
    sf_kw = dict(rows=ship.rows, padded_rows=ship.padded_rows,
                 width=ship.width)
    sf_args = (ship.words, q6_ship.lo, q6_ship.hi)
    from repro_torch.kernels.scan_filter import scan_filter_cuda
    from repro_torch.kernels.grouped_agg import filtered_group_sum_cuda

    b1_ms = cuda_ms(lambda: scan_filter_cuda(*sf_args, **sf_kw), iters)
    b1_plain = cuda_ms(lambda: ref.scan_filter(*sf_args, **sf_kw), iters)
    b1_bytes = (ship.words.numel() + NODES * ship.padded_rows // 32) * 4
    b1_bound, b1_by = bound(b1_bytes, 2 * NODES * ship.padded_rows)

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
    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} was never launched on the main path")
    print(json.dumps({"queries_ms": query_ms, "gen_s": gen_s,
                      "resident_bytes": drv.resident_bytes,
                      "lineitem_bytes": li_bytes, "sf": args.sf,
                      "nodes": NODES, "card": smi,
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
