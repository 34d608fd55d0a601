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
   The wire codec (``ef_encode``, ``ef_decode``, ``mask_fold``,
   ``mask_unfold``) bit-identical to its plain version at the CPU tests'
   shapes (low-bit widths l = 0..17, empty, full and duplicate-key rows),
   on node-stacked rows, and at the three SF 10 exchange shapes (q4_sj:
   64 rows x 8,388,608 slots, l = 17; q18_sj: 131,072, l = 14;
   q14_promo_request: 262,144, l = 14); fold/unfold at ragged widths; the
   same inputs twice give identical words.
4. Queries: ``TPCHDriver(sf, num_nodes=8, device="cuda")`` generates the
   packed TPC-H tables and places them on the card; q6, q1 and q1_kernel
   run through ``run_ir`` and must match the float64 oracle within rtol
   2e-4.  The launch counters are set to 0 before each query and read
   after it: q6 must launch ``scan_filter`` 3 times, q1 once, q1_kernel
   ``filtered_group_sum`` once and no scan.  The main-path scans are then
   held bit-identical against the plain version on the resident words.
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
   (the codec kernels at the q4_sj and q18_sj shapes).
7. One ``{"kernels": [...]}`` line, then the last line
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


def profile_query(torch, run, name: str, top: int = 6):
    """One warm run of ``run()`` under torch.profiler: device time by
    kernel, and the device's busy share of the run's wall time (the
    profiler's own overhead inflates the wall time)."""
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


def max_abs_diff(a, b) -> int:
    """Largest absolute difference of two integer or bool tensors of one
    shape, row by row (the q4_sj rows hold 8 M slots)."""
    if a.shape != b.shape:
        fail(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    return max((int((x.long() - y.long()).abs().max())
                for x, y in zip(a, b) if x.numel()), default=0)


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
    check_wire_codec(torch, compression, ops, ref, gen)
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
    from repro_torch.tpch.queries import IR_QUERIES

    scans = drv.compile_ir("q6").plan.scans
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
        codec_times[(label, k)] = {
            "ms": cuda_ms(fn, iters),
            "plain_ms": cuda_ms(plain, 3),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"{tuple(a[0].shape)} {dict(kw)}"}
        torch.cuda.empty_cache()
        print(f"{k} at the {label} input {codec_times[(label, k)]['shape']}: "
              f"{codec_times[(label, k)]['ms']:.4f} ms, plain "
              f"{codec_times[(label, k)]['plain_ms']:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}, {nbytes} B)")
    recorded.clear()

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
