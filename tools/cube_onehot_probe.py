#!/usr/bin/env python3
"""Accuracy and time of the cube build's one-hot product by rows a chunk,
and where a default cube build spends its device time.

Usage (from the root of a checkout, on a machine with an NVIDIA H100):

    python3 tools/cube_onehot_probe.py [--sf 10]

Generates TPC-H at ``--sf`` over 8 stacked nodes on the card.  For two
cube keys over the lineitem rows — returnflag x linestatus x the year of
l_shipdate (48 cells) and lineitem_pricing's returnflag x linestatus x
ship month (516 cells) — and the seven columns of lineitem_pricing's
measure stack (its six measures and the rows), sums the one-hot product
``core.aggregation.group_sum_onehot`` computes, over chunks of ROWS rows
a node (one product where ROWS is the whole column), and holds each
against a float64 scatter-add on the card: the largest relative error of
each column, and the device time (CUDA events, median of 3).  Then both
default cubes are built once more under ``torch.profiler``: the device
time by kernel.  Prints one line a case and the card's name and power
limit; the last line is one JSON object of all readings.  It exits
non-zero when CUDA is unavailable.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROWS = (1 << 14, 1 << 16, 1 << 17, 1 << 18, 1 << 20, 1 << 21)


def chunked_onehot(torch, v, key, G, step):
    """The one-hot product over chunks of ``step`` rows, partials summed
    in f32 (``group_sum_onehot``'s chunked branch at a given step)."""
    groups = torch.arange(G, dtype=key.dtype, device=key.device)
    out = None
    for lo in range(0, key.shape[1], step):
        onehot = key[:, None, lo:lo + step] == groups[None, :, None]
        part = torch.matmul(onehot.to(torch.float32), v[:, lo:lo + step])
        out = part if out is None else out.add_(part)
        del onehot
    return out


def events_ms(torch, fn, repeat=3) -> float:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("cube_onehot_probe: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import profile_query
    from repro_torch.core.columnar import PackedColumn
    from repro_torch.cube import build_cube
    from repro_torch.cube.build import _codes
    from repro_torch.query.ir import eval_expr
    from repro_torch.tpch import cubes as tc
    from repro_torch.tpch.driver import TPCHDriver
    from repro_torch.tpch.schema import day

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    drv = TPCHDriver(args.sf, num_nodes=8, device="cuda")
    cols = {c: (col.decode() if isinstance(col, PackedColumn) else col)
            for c, col in drv.placed["lineitem"].columns.items()}
    spec = tc.lineitem_cube()
    stack = torch.stack(
        [torch.ones_like(cols["l_quantity"]) if m.agg == "count"
         else eval_expr(m.column, cols).to(torch.float32)
         for m in spec.measures] + [torch.ones_like(cols["l_quantity"])],
        dim=-1)
    P, n, C = stack.shape
    rf, ls = (_codes(d, cols) for d in spec.dimensions[:2])
    years = tuple(day(y, 1, 1) - 1 for y in range(1993, 2000))
    year = torch.searchsorted(
        torch.tensor(years, dtype=torch.int32, device="cuda"),
        cols["l_shipdate"].contiguous()).to(torch.int32)
    month = _codes(spec.dimensions[2], cols)
    keys = {"yearly (48 cells)": ((rf * 2 + ls) * 8 + year, 48),
            "lineitem_pricing (516 cells)": ((rf * 2 + ls) * 86 + month,
                                             516)}
    readings = {"card": smi, "sf": args.sf, "cases": [], "profiles": {}}
    for label, (key, G) in keys.items():
        want = torch.zeros(P, G, C, dtype=torch.float64, device="cuda")
        want.scatter_add_(1, key.long()[..., None].expand(P, n, C),
                          stack.double())
        limit = (8 << 30) // (4 * P * G)
        for step in sorted(set(ROWS) | {limit, n}):
            if 4 * P * G * step > 24 << 30:
                continue  # a one-hot past 24 GB
            got = chunked_onehot(torch, stack, key, G, step).double()
            rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).amax(
                dim=(0, 1))
            ms = events_ms(torch, lambda: chunked_onehot(torch, stack, key,
                                                         G, step))
            case = {"key": label, "rows_a_chunk": step,
                    "chunks": -(-n // step), "ms": ms,
                    "max_rel_err": [float(r) for r in rel.cpu()]}
            readings["cases"].append(case)
            print(f"{label}: {step} rows a chunk ({case['chunks']} chunks"
                  f"{', one product' if step >= n else ''}"
                  f"{', the 8 GiB limit' if step == limit else ''}): "
                  f"{ms:.3f} ms; max relative error by column "
                  + " ".join(f"{r:.2e}" for r in case["max_rel_err"]))
            del got
            torch.cuda.empty_cache()
    del stack, want
    torch.cuda.empty_cache()
    for spec in tc.default_specs():
        busy, wall = profile_query(
            torch, lambda s=spec: build_cube(drv.cluster, drv.ctx,
                                             drv.placed, s),
            f"{spec.name} build", top=8)
        readings["profiles"][spec.name] = {"busy_ms": busy, "wall_ms": wall}
    print(f"nvidia-smi: {smi}")
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
