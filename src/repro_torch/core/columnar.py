"""Node-stacked main-memory column store.

Counterpart of ``repro.core.columnar``.  The paper's storage model (§3.1):
every table is range-partitioned across the P nodes of a shared-nothing
cluster; only constant-size tables (NATION, REGION) are replicated.  In the
port the P nodes are stacked on a leading tensor axis of one device:

- a raw partitioned column is a ``(P, rows_per_node)`` tensor,
- a packed partitioned column is a :class:`PackedColumn` whose ``words``
  are ``(P, words_per_node)`` int32,
- a replicated table's columns carry no node axis.

String columns are dictionary-encoded at generation time (int32 codes plus
a host-side vocabulary).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import compression

_TORCH_DTYPES = {"int32": torch.int32, "float32": torch.float32,
                 "bool": torch.bool}


@dataclasses.dataclass
class PackedColumn:
    """A bit-packed RESIDENT column: the execution format, not a wire
    format.  Codes are frame-of-reference (``offset``) or dictionary
    (``values``) positions packed at ``width`` bits.

    Each node's ``padded_rows`` (a multiple of 32) codes occupy exactly
    ``padded_rows * width / 32`` words, row ``p`` of ``words``.  The words
    are int32, bit-identical to the JAX package's uint32 words."""

    words: torch.Tensor                   # int32, (num_nodes, words_per_node)
    rows: int                             # valid rows per node
    padded_rows: int                      # multiple of 32
    width: int                            # bits per code, 1..30
    offset: int = 0                       # frame-of-reference bias
    values: Optional[tuple] = None        # sorted dictionary, or None (FOR)
    dtype: str = "int32"                  # 'int32' | 'float32' | 'bool'
    num_nodes: int = 1

    @property
    def words_per_node(self) -> int:
        return (self.padded_rows * self.width) // 32

    @property
    def shape(self) -> tuple:
        """Shape of the decoded column: (nodes, rows per node)."""
        return (self.words.shape[0], self.rows)

    @property
    def nbytes(self) -> int:
        return self.words.numel() * 4

    @property
    def raw_nbytes(self) -> int:
        """Bytes the same rows would occupy in the raw resident format."""
        itemsize = 1 if self.dtype == "bool" else 4
        return self.words.shape[0] * self.rows * itemsize

    def to(self, device) -> "PackedColumn":
        return dataclasses.replace(self, words=self.words.to(device))

    def _from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """int32 codes -> the column's logical dtype."""
        if self.values is not None:
            table = torch.as_tensor(
                np.asarray(self.values, dtype=np.dtype(self.dtype)),
                device=codes.device)
            return table[codes.to(torch.int64)]
        if self.dtype == "bool":
            return codes.to(torch.bool)
        out = codes + self.offset
        return out.to(_TORCH_DTYPES[self.dtype])

    def decode(self) -> torch.Tensor:
        """Full decode to a dense (nodes, rows) tensor."""
        codes = compression.unpack_bits(self.words, self.padded_rows,
                                        self.width)
        return self._from_codes(codes[:, :self.rows])

    def gather(self, idx: torch.Tensor) -> torch.Tensor:
        """Late materialization: decode ONLY the rows ``idx`` (nodes, k) —
        row indices are node-local."""
        return self._from_codes(
            compression.gather_bits(self.words, idx, self.width))


def _pad32(n: int) -> int:
    return -(-n // 32) * 32


def plan_packing(chunks: Sequence[np.ndarray],
                 max_width: int = 24) -> Optional[dict]:
    """Decide whether a column (given as per-node chunks) is
    pack-eligible, and with what parameters.  Returns
    ``{'width', 'offset', 'values', 'dtype'}`` or None (stay raw).

    Eligible: bools (width 1); ints whose span fits ``max_width`` bits
    (frame-of-reference); floats that are all-integral with a small span
    (FOR on the integer codes) or low-cardinality (sorted dictionary)."""
    arr = np.concatenate([np.asarray(c) for c in chunks])
    if arr.size == 0:
        return None
    if arr.dtype == np.bool_:
        return {"width": 1, "offset": 0, "values": None, "dtype": "bool"}
    if np.issubdtype(arr.dtype, np.integer):
        lo, hi = int(arr.min()), int(arr.max())
        w = compression.required_width(hi - lo)
        if w > max_width:
            return None
        return {"width": max(1, w), "offset": lo, "values": None,
                "dtype": "int32"}
    if np.issubdtype(arr.dtype, np.floating):
        if not np.isfinite(arr).all():
            return None
        if (arr == np.floor(arr)).all():
            lo, hi = int(arr.min()), int(arr.max())
            w = compression.required_width(hi - lo)
            if w <= max_width:
                return {"width": max(1, w), "offset": lo, "values": None,
                        "dtype": "float32"}
        vals = np.unique(arr)
        if vals.size <= 64:
            w = compression.required_width(max(vals.size - 1, 0))
            return {"width": max(1, w), "offset": 0,
                    "values": tuple(float(v) for v in vals),
                    "dtype": "float32"}
    return None


def pack_column(chunks: Sequence[np.ndarray], spec: dict) -> PackedColumn:
    """Pack per-node chunks (equal length) into one node-stacked
    PackedColumn with the globally consistent ``spec`` from
    :func:`plan_packing`.  Packing runs on the host (CPU torch)."""
    rows = int(np.asarray(chunks[0]).shape[0])
    padded = _pad32(rows)
    width, offset, values = spec["width"], spec["offset"], spec["values"]
    codes = np.zeros((len(chunks), padded), np.int64)
    for p, c in enumerate(chunks):
        a = np.asarray(c)
        if a.shape[0] != rows:
            raise ValueError("per-node chunks must be equal length")
        if values is not None:
            codes[p, :rows] = np.searchsorted(np.asarray(values, a.dtype), a)
        elif a.dtype == np.bool_:
            codes[p, :rows] = a
        else:
            codes[p, :rows] = a.astype(np.int64) - offset
    return PackedColumn(
        words=compression.pack_bits(torch.from_numpy(codes), width),
        rows=rows, padded_rows=padded, width=width, offset=offset,
        values=values, dtype=spec["dtype"], num_nodes=len(chunks))


def decode_columns(columns: Mapping) -> dict:
    """Decode any PackedColumn entries to dense tensors (raw columns pass
    through) — the entry shim for plans that consume raw columns."""
    return {n: (c.decode() if isinstance(c, PackedColumn) else c)
            for n, c in columns.items()}


@dataclasses.dataclass
class Table:
    """A columnar table.

    columns: name -> (P, rows_per_node) tensor or PackedColumn for a
        partitioned table; name -> (rows,) tensor for a replicated one
        (or flat global numpy arrays, the driver's host view).
    dictionaries: name -> tuple of strings for dictionary-encoded columns.
    replicated: if True the table is replicated on every node instead of
        partitioned (paper §3.1: only for tables with <= ~50 rows).
    """

    name: str
    columns: dict
    dictionaries: dict = dataclasses.field(default_factory=dict)
    replicated: bool = False

    @property
    def num_rows(self) -> int:
        """Global row count (all nodes together)."""
        col = next(iter(self.columns.values()))
        if isinstance(col, PackedColumn):
            return col.words.shape[0] * col.rows
        return math.prod(col.shape)

    def column_names(self) -> Sequence[str]:
        return tuple(self.columns.keys())

    def select(self, names: Sequence[str]) -> "Table":
        return Table(
            name=self.name,
            columns={n: self.columns[n] for n in names},
            dictionaries={n: d for n, d in self.dictionaries.items()
                          if n in names},
            replicated=self.replicated,
        )

    def to(self, device) -> "Table":
        """The same table with every column on ``device`` (the
        node-stacked placement: one copy, nodes on the leading axis)."""
        cols = {n: c.to(device) for n, c in self.columns.items()}
        return Table(self.name, cols, self.dictionaries, self.replicated)

    def decode(self, name: str, codes) -> list:
        """Host-side dictionary decode for result presentation."""
        vocab = self.dictionaries[name]
        return [vocab[int(c)] for c in np.asarray(codes).ravel()]


def table_from_numpy(name: str, columns: Mapping, dictionaries=None,
                     replicated: bool = False, *, num_nodes: int,
                     device="cpu") -> Table:
    """A port :class:`Table` from plain numpy, node-stacked on ``device``.

    A raw column is an array: global ``(P * rows,)`` or already stacked
    ``(P, rows)`` (replicated tables keep their 1-D columns).  A packed
    column is a dict with ``words`` (uint32 or int32, global ``(P * wpn,)``
    or ``(P, wpn)``), ``rows``, ``padded_rows``, ``width``, ``offset``,
    ``values``, ``dtype`` and ``num_nodes``."""
    cols = {}
    for cname, col in columns.items():
        if isinstance(col, Mapping):
            words = np.ascontiguousarray(col["words"]).view(np.int32)
            cols[cname] = PackedColumn(
                words=torch.from_numpy(words.reshape(col["num_nodes"], -1)
                                       .copy()).to(device),
                rows=int(col["rows"]), padded_rows=int(col["padded_rows"]),
                width=int(col["width"]), offset=int(col["offset"]),
                values=(tuple(col["values"]) if col["values"] is not None
                        else None),
                dtype=col["dtype"], num_nodes=int(col["num_nodes"]))
            continue
        a = np.ascontiguousarray(col)
        if not replicated:
            a = a.reshape(num_nodes, -1)
        cols[cname] = torch.from_numpy(a.copy()).to(device)
    return Table(name, cols, dict(dictionaries or {}), replicated)


def concat_tables(parts: Sequence[Table]) -> Table:
    """Concatenate node-stacked tables along the node axis (e.g. chunks
    generated separately)."""
    first = parts[0]
    cols = {}
    for n in first.columns:
        vals = [p.columns[n] for p in parts]
        if isinstance(vals[0], PackedColumn):
            cols[n] = dataclasses.replace(
                vals[0], words=torch.cat([v.words for v in vals]),
                num_nodes=sum(v.num_nodes for v in vals))
        else:
            cols[n] = torch.cat(vals)
    return Table(first.name, cols, first.dictionaries, first.replicated)
