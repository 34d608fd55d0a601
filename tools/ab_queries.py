#!/usr/bin/env python3
"""Warm medians of TPC-H queries for two checkouts of the port, in turns.

Usage (from the root of a checkout, on a machine with an NVIDIA H100):

    git archive <parent commit> | tar -x -C build/parent   # build/ is
    python3 tools/ab_queries.py build/parent .              # git-ignored

Runs A, B, B, A on one card: each turn is a fresh process that imports
``repro_torch`` from that checkout's ``src`` (which builds its kernels
into that checkout's ``build/kernels``), generates the TPC-H tables at
``--sf`` over 8 stacked nodes, and for each query of QUERIES checks one
run against the float64 oracle (rtol 2e-4) and takes the median of
``--repeat`` warm runs (CUDA events).  Prints each turn's medians, then
for each query both sides' medians and B's mean less A's.  The last line
is one JSON object of all readings.  It exits non-zero when CUDA is
unavailable, a turn fails or an answer is off.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

# name -> (IR builder in repro_torch.tpch.queries and its arguments, wire);
# q1_kernel runs through TPCHDriver.run_ir
QUERIES = {
    "q1_kernel": None,
    "q4_sj/packed/xla": ("q4_sj_ir", {}, "packed"),
    "q4_sj/raw/xla": ("q4_sj_ir", {}, "raw"),
    "q18_sj/packed/xla": ("q18_sj_ir", {}, "packed"),
    "q14_promo_request": ("q14_promo_ir", {"alt": "request"}, "packed"),
}


def turn(src: pathlib.Path, sf: float, repeat: int) -> dict:
    """One side's medians (ms) by query, in this process."""
    sys.path.insert(0, str(src / "src"))
    import numpy as np
    import torch
    from repro_torch.tpch import queries as tq
    from repro_torch.tpch.driver import TPCHDriver

    drv = TPCHDriver(sf, num_nodes=8, device="cuda")
    medians = {}
    for name, spec in QUERIES.items():
        if spec is None:
            run, oracle_of = (lambda n=name: drv.run_ir(n)), name
        else:
            builder, kw, wire = spec
            q = getattr(tq, builder)(**kw)
            fn = drv.compile_query(q, wire=wire, backend="xla")
            run, oracle_of = (lambda f=fn: f(drv.columns())), q.name
        value = run()["value"].cpu().numpy().astype(np.float64).reshape(-1)
        oracle = np.asarray(drv.oracle(oracle_of), np.float64).reshape(-1)
        if not np.allclose(value, oracle, rtol=2e-4, atol=0):
            raise SystemExit(f"{name} from {src}: {value} vs the oracle "
                             f"{oracle}")
        times = []
        for _ in range(repeat):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        medians[name] = statistics.median(times)
    return medians


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=pathlib.Path, help="checkout A (the parent)")
    ap.add_argument("b", type=pathlib.Path, help="checkout B (the change)")
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--repeat", type=int, default=10)
    ap.add_argument("--turn", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ab_queries: no CUDA device available", file=sys.stderr)
        return 1
    if args.turn is not None:
        print(json.dumps(turn(args.turn.resolve(), args.sf, args.repeat)))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    readings = {"a": [], "b": []}
    for side in ("a", "b", "b", "a"):
        src = getattr(args, side).resolve()
        proc = subprocess.run(
            [sys.executable, __file__, str(args.a), str(args.b), "--turn",
             str(src), "--sf", str(args.sf), "--repeat", str(args.repeat)],
            capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise SystemExit(f"ab_queries: the turn of {src} failed")
        medians = json.loads(proc.stdout.strip().splitlines()[-1])
        readings[side].append(medians)
        print(f"{side.upper()} ({src}): " + ", ".join(
            f"{k} {v:.3f}" for k, v in medians.items()) + " ms", flush=True)
    print(f"on {smi}, sf {args.sf}, medians of {args.repeat} warm runs:")
    for name in QUERIES:
        a = [m[name] for m in readings["a"]]
        b = [m[name] for m in readings["b"]]
        print(f"{name}: A {a[0]:.3f}, {a[1]:.3f}; B {b[0]:.3f}, {b[1]:.3f} "
              f"ms; B - A {statistics.mean(b) - statistics.mean(a):+.3f} ms")
    print(json.dumps({"card": smi, "sf": args.sf, "repeat": args.repeat,
                      "a": str(args.a), "b": str(args.b), **readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
