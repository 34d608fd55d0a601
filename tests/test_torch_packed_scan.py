"""Predicate-on-packed scan plus late decode equals decode-then-filter, held
to the FLOAT VALUE-SPACE predicate: the literal compared in float64 with
the decoded values, never cast to the column's dtype first (a cast would
turn ``x <= -6.5`` on an int column into ``x <= -6``)."""
from __future__ import annotations

import dataclasses
import operator
import zlib

import numpy as np
import pytest
import torch

from repro_torch.core import compression
from repro_torch.core.columnar import pack_column, plan_packing
from repro_torch.kernels import ops
from repro_torch.query.ir import BinOp, C, Lit, PackedInfo
from repro_torch.query.stats import scan_rewrite

_OPS = {"<": operator.lt, "<=": operator.le, ">": operator.gt,
        ">=": operator.ge, "==": operator.eq, "!=": operator.ne}


def _chunks(kind: str, rng, nodes: int, rows: int) -> list:
    if kind == "for_int":
        return [rng.integers(-7, 40, rows).astype(np.int32)
                for _ in range(nodes)]
    if kind == "for_float":
        return [rng.integers(1, 51, rows).astype(np.float32)
                for _ in range(nodes)]
    # dictionary floats on the hundredths grid, as l_discount / l_tax
    return [(rng.integers(0, 11, rows) / 100.0).astype(np.float32)
            for _ in range(nodes)]


def _literal(kind: str, rng, values: np.ndarray, case: int) -> float:
    v = float(rng.choice(values))
    if case == 0:
        return v                            # a stored value, exactly
    if case == 1:
        return v + (0.5 if kind != "dict" else 0.005)   # between values
    if case == 2:
        return float(values.min()) - 1.5    # below everything
    # a decimal literal float32 rounds onto a stored value: in value space
    # it matches nothing (0.05 != float32(0.05))
    return round(v, 2) if kind == "dict" else v - 6.5


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("op", sorted(_OPS))
@pytest.mark.parametrize("kind", ["for_int", "for_float", "dict"])
def test_packed_scan_equals_value_space_filter(kind, op, case):
    rng = np.random.default_rng(zlib.crc32(f"{kind}{op}{case}".encode()))
    nodes, rows = 3, 203                   # ragged: not a multiple of 32
    chunks = _chunks(kind, rng, nodes, rows)
    spec = plan_packing(chunks)
    assert (spec["values"] is not None) == (kind == "dict")
    col = pack_column(chunks, spec)
    info = PackedInfo(width=col.width, offset=col.offset, values=col.values,
                      dtype=col.dtype)
    v = _literal(kind, rng, np.concatenate(chunks), case)
    rw = scan_rewrite(BinOp(op, C("x"), Lit(v)), {"x": info})
    assert rw is not None and rw.negate == (op == "!=")

    bits = ops.scan_filter(col.words, rw.lo, rw.hi, rows=col.rows,
                           padded_rows=col.padded_rows, width=col.width,
                           negate=rw.negate)
    mask = compression.unpack_bitset(bits, col.padded_rows)[:, :rows].numpy()
    decoded = col.decode().numpy()
    np.testing.assert_array_equal(decoded, np.stack(chunks))
    want = _OPS[op](decoded.astype(np.float64), v)
    np.testing.assert_array_equal(mask, want)
    # late materialization: gather the survivors only, bit-identical
    for p in range(nodes):
        node = dataclasses.replace(col, words=col.words[p:p + 1],
                                   num_nodes=1)
        idx = torch.from_numpy(np.nonzero(mask[p])[0])[None]
        np.testing.assert_array_equal(node.gather(idx)[0].numpy(),
                                      decoded[p][want[p]])
