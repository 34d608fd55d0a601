#!/usr/bin/env python3
"""Device times of the predicate bitset (B5) for one or more checkouts of
the port, in turns.

Usage (from the root of a checkout, on a machine with an NVIDIA H100):

    git archive <parent commit> | tar -x -C build/parent   # build/ is
    python3 tools/b5_probe.py build/parent . . build/parent  # ignored

Each argument is a checkout; each runs in a fresh process that imports
``repro_torch`` from that checkout's ``src`` (which builds its kernels into
that checkout's ``build/kernels``), makes the inputs from seed 0 on the
card, holds the kernel bit-identical to its plain version on them, and
times it at the three inputs of the main path at SF 10 over 8 stacked
nodes: q21's and q11's ``s_nationkey`` (8, 12,500), q3's ``c_mktsegment``
(8, 187,500) and a lineitem column (8, 7,500,000), each on 16 bytes and
(``misaligned``) 4 bytes past them.  Each time is the mean over 20 calls:
``eager`` an eager loop (CUDA events; it includes the wrapper's host cost
where that is the longer), ``graph`` 20 calls captured in one CUDA graph
and replayed.  Prints each turn's readings and the card; the last line is
one JSON object of all of them.  Exits non-zero when CUDA is unavailable,
a turn fails or the kernel differs from its plain version.
"""
from __future__ import annotations

import pathlib
import sys

from b1_b6_probe import _mean_ms, _misaligned, run_turns

# (label, per-node columns, distinct values, the tested value)
INPUTS = (("q21", 12_500, 25, 20), ("q3", 187_500, 5, 1),
          ("lineitem", 7_500_000, 3, 1))


def turn(root: pathlib.Path) -> dict:
    """One checkout's readings, in this process."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitset_pack import predicate_bitset_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for label, n, distinct, value in INPUTS:
        col = torch.randint(0, distinct, (8, n), generator=gen,
                            device="cuda", dtype=torch.int32)
        for where, c in (("aligned", col),
                         ("misaligned", _misaligned(torch, col))):
            want = ref.predicate_bitset(c, value)
            got = predicate_bitset_cuda(c, value=value)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"B5 ({label} {where}) from {root} "
                                 f"differs from its plain version")
            fn = (lambda c=c, v=value: predicate_bitset_cuda(c, value=v))
            out[f"{label} {where}"] = {"eager": _mean_ms(torch, fn, False),
                                       "graph": _mean_ms(torch, fn, True)}
    return out


def main(argv=None) -> int:
    return run_turns(__file__, turn, __doc__, argv)


if __name__ == "__main__":
    sys.exit(main())
