#!/usr/bin/env python3
"""Device times of the packed scan (B1) and the m-bit encoder (B6) for one
or more checkouts of the port, in turns.

Usage (from the root of a checkout, on a machine with an NVIDIA H100):

    git archive <parent commit> | tar -x -C build/parent   # build/ is
    python3 tools/b1_b6_probe.py build/parent . . build/parent   # ignored

Each argument is a checkout; each runs in a fresh process that imports
``repro_torch`` from that checkout's ``src`` (which builds its kernels into
that checkout's ``build/kernels``), makes the inputs from seed 0 on the
card, holds each kernel bit-identical to its plain version on them, and
times it: B1 at q6's ``l_shipdate`` shape at SF 10 over 8 stacked nodes
(8 x 7,500,000 padded rows at width 12, the date range of Q6), the words
on 16 bytes and (where the checkout has :func:`vector_loads`) off them;
B1 also, where the checkout takes bounds on the card
(``scan_filter.device_bounds``), with B = 1 (0-d tensors), 8 and 64 lanes
of bounds (one-year ranges, each lane held to a call with its bounds as
ints); B6 at q15_approx's input at SF 10 ((8, 8, 12,500), m = 8, group
4) and at the lineitem stress size ((8, 7,500,000), m = 8, group 1,000).  Each time
is the mean over 20 calls: ``eager`` an eager loop (CUDA events; it
includes the wrapper's host cost where that is the longer), ``graph`` 20
calls captured in one CUDA graph and replayed.  Prints each turn's
readings and the card; the last line is one JSON object of all of them.
Exits non-zero when CUDA is unavailable, a turn fails or a kernel differs
from its plain version.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ITERS = 20
Q6_ROWS, Q6_PADDED, Q6_WIDTH = 7_498_257, 7_500_000, 12
Q6_LO, Q6_HI = 731, 1095        # a year of day codes, as Q6's range


def _mean_ms(torch, fn, graph: bool) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(ITERS):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        for _ in range(3):
            g.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (3 * ITERS)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def _misaligned(torch, t):
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return flat[1:].view(t.shape).copy_(t)


def turn(root: pathlib.Path) -> dict:
    """One checkout's readings, in this process."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.core import compression
    from repro_torch.kernels import ref
    from repro_torch.kernels import scan_filter as sfm
    from repro_torch.kernels.mbit_codec import mbit_encode_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    codes = torch.randint(0, 2557, (8, Q6_PADDED), generator=gen,
                          device="cuda")
    words = compression.pack_bits(codes, Q6_WIDTH)
    del codes
    kw = dict(rows=Q6_ROWS, padded_rows=Q6_PADDED, width=Q6_WIDTH)
    cases = {"aligned": words}
    if hasattr(sfm, "vector_loads"):
        cases["misaligned"] = _misaligned(torch, words)
    for label, w in cases.items():
        want = ref.scan_filter(w, Q6_LO, Q6_HI, Q6_ROWS, Q6_PADDED, Q6_WIDTH)
        got = sfm.scan_filter_cuda(w, Q6_LO, Q6_HI, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"B1 ({label}) from {root} differs from its "
                             f"plain version")
        fn = (lambda w=w: sfm.scan_filter_cuda(w, Q6_LO, Q6_HI, **kw))
        out[f"B1 {label}"] = {"eager": _mean_ms(torch, fn, False),
                              "graph": _mean_ms(torch, fn, True)}
    if hasattr(sfm, "device_bounds"):
        for lanes in (None, 8, 64):
            n = 1 if lanes is None else lanes
            lo = torch.tensor([Q6_LO + 37 * b for b in range(n)],
                              dtype=torch.int32, device="cuda")
            hi = lo + (Q6_HI - Q6_LO)
            if lanes is None:
                lo, hi = lo[0], hi[0]
            got = sfm.scan_filter_cuda(words, lo, hi, **kw)
            torch.cuda.synchronize()
            for b in range(n):
                one = sfm.scan_filter_cuda(words, Q6_LO + 37 * b,
                                           Q6_HI + 37 * b, **kw)
                if not torch.equal(got if lanes is None else got[b], one):
                    raise SystemExit(f"B1 lane {b} of {n} from {root} "
                                     f"differs from the int-bound call")
            fn = (lambda lo=lo, hi=hi: sfm.scan_filter_cuda(words, lo, hi,
                                                            **kw))
            out[f"B1 lanes={n}"] = {"eager": _mean_ms(torch, fn, False),
                                    "graph": _mean_ms(torch, fn, True)}
    del cases, words
    for label, shape, group in (("q15_approx", (8, 8, 12_500), 4),
                                ("stress", (8, 7_500_000), 1000)):
        q = torch.randint(0, (1 << 30) + 1, shape, generator=gen,
                          device="cuda")
        q = (q >> torch.randint(0, 31, shape, generator=gen,
                                device="cuda")).to(torch.int32)
        want = ref.mbit_encode(q, 8, group)
        got = mbit_encode_cuda(q, m=8, group=group)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"B6 ({label}) from {root} differs from its "
                             f"plain version")
        fn = (lambda q=q, g=group: mbit_encode_cuda(q, m=8, group=g))
        out[f"B6 {label}"] = {"eager": _mean_ms(torch, fn, False),
                              "graph": _mean_ms(torch, fn, True)}
    return out


def run_turns(script: str, turn_fn, doc: str, argv=None) -> int:
    """The command line of a probe: each checkout in ``argv`` runs
    ``turn_fn(root)`` in a fresh process of ``script``, in turns."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("roots", nargs="*", type=pathlib.Path,
                    help="checkouts, run in this order")
    ap.add_argument("--turn", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    name = pathlib.Path(script).stem
    if not torch.cuda.is_available():
        print(f"{name}: CUDA is not available", file=sys.stderr)
        return 1
    if args.turn is not None:
        print(json.dumps(turn_fn(args.turn.resolve())))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    readings = []
    for root in args.roots or [pathlib.Path(".")]:
        proc = subprocess.run([sys.executable, script, "--turn",
                               str(root)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        readings.append({"root": str(root), **r})
        print(f"{root}: " + "; ".join(
            f"{k} eager {v['eager']:.4f} graph {v['graph']:.4f} ms"
            for k, v in r.items()))
    print(json.dumps({"card": smi, "readings": readings}))
    return 0


def main(argv=None) -> int:
    return run_turns(__file__, turn, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
