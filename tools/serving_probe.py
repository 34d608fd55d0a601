#!/usr/bin/env python3
"""Phase 6f of ``chip_smoke.py`` alone: the serving tier on the card.

Usage (from the root of a checkout, on a machine with an NVIDIA H100):

    python3 tools/serving_probe.py [--sf 10] [--profile]

Builds the kernels, generates TPC-H at ``--sf`` over 8 stacked nodes on
the card, builds the default cubes and runs ``chip_smoke.serving_phase``:
the mixed workload through the sequential baseline and the engine (closed
loop, unpadded, open loop), every check of the phase, and the launcher.
``--profile`` adds the device's busy share of the baseline and of a
closed loop (torch.profiler).  Prints the card; the last line is one JSON
object of the phase's summary.  Exits non-zero when CUDA is unavailable
or a check fails.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("serving_probe: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.kernels import build, ops
    from repro_torch.tpch import queries as tq
    from repro_torch.tpch.driver import TPCHDriver
    from repro_torch.tpch.schema import DEFAULT_PARAMS as DP

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    drv = TPCHDriver(args.sf, num_nodes=chip_smoke.NODES, device="cuda")
    drv.build_cubes()
    torch.cuda.synchronize()
    print(f"data + cubes: sf={args.sf}, {time.perf_counter() - t0:.1f} s")
    oracles = chip_smoke._serving_oracles(np, drv, tq, DP)
    launches = dict.fromkeys(ops.launch_counts(), 0)
    summary, _ = chip_smoke.serving_phase(torch, smi, drv, launches,
                                          oracles, args.profile)
    summary["card"] = smi
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
