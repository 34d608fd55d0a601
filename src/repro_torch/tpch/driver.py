"""TPC-H driver: generate, place, lower and run queries on the node-stacked
cluster.

Counterpart of the constructor, ``run_ir``, ``query`` and ``oracle`` of
``repro.tpch.driver.TPCHDriver``.  The constructor generates the tables
(packed by default), builds the catalog with each packed column's
encoding, and places the tables on the device once; ``run_ir`` lowers a
registered IR query and runs it over the packed residents.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.columnar import PackedColumn, Table
from repro_torch.core.engine import Cluster
from repro_torch.query.ir import (
    LoweringError,
    PackedInfo,
    Query,
    UnknownPlanError,
    build_catalog,
)
from repro_torch.query.lower import lower
from repro_torch.tpch import dbgen, reference
from repro_torch.tpch.queries import IR_QUERIES

# registry name -> oracle name (q1_kernel answers q1, as the JAX
# registry's explicit oracle binding says)
ORACLES = {"q1": "q1", "q1_kernel": "q1", "q6": "q6"}


@dataclasses.dataclass
class QueryAnswer:
    """Result of :meth:`TPCHDriver.query`: the value and the query that
    produced it (every answer here comes from a lowered plan)."""

    value: torch.Tensor
    source: str


def _resident_bytes(t: Table) -> int:
    return sum(c.nbytes if isinstance(c, PackedColumn)
               else c.numel() * c.element_size()
               for c in t.columns.values())


class TPCHDriver:
    """TPC-H at scale factor ``sf`` on ``num_nodes`` stacked nodes.

    ``device=None`` means ``cuda`` and raises without it; pass
    ``device="cpu"`` to run on the CPU (kernels then use their plain
    PyTorch versions)."""

    def __init__(self, sf: float, num_nodes: int = 8, seed: int = 0,
                 storage: str = "packed", device=None):
        self.cluster = Cluster(num_nodes, device=device)
        self.sf = sf
        self.seed = seed
        self.storage = storage
        # host-side generation + packing; ``resident`` is what the cluster
        # holds, ``tables`` a DECODED global numpy view (bit-identical to
        # the packed codes) for the oracle and the catalog statistics
        self.resident = dbgen.generate(sf, num_nodes, seed, storage=storage)
        self.tables = {n: Table(n, {c: self._host_column(col)
                                    for c, col in t.columns.items()},
                                t.dictionaries, t.replicated)
                       for n, t in self.resident.items()}
        packed_meta = {
            n: {c: PackedInfo(width=col.width, offset=col.offset,
                              values=col.values, dtype=col.dtype)
                for c, col in t.columns.items()
                if isinstance(col, PackedColumn)}
            for n, t in self.resident.items()
        }
        self.catalog = build_catalog(self.tables, num_nodes=num_nodes,
                                     packed=packed_meta)
        self.resident_bytes = sum(_resident_bytes(t)
                                  for t in self.resident.values())
        self.placed = {n: self.cluster.load(t)
                       for n, t in self.resident.items()}
        self.ctx = self.cluster.context(self.placed, scale_factor=sf)
        self._compiled = {}   # registry name -> bound plan

    @staticmethod
    def _host_column(col) -> np.ndarray:
        if isinstance(col, PackedColumn):
            col = col.decode()
        return col.reshape(-1).numpy()

    def _columns(self) -> dict:
        return {n: t.columns for n, t in self.placed.items()}

    def compile_query(self, q: Query):
        """Lower + bind an IR query: returns ``fn(columns)``."""
        if not isinstance(q, Query):
            raise TypeError(f"compile_query() takes a repro_torch.query "
                            f"Query, got {type(q)}")
        return self.cluster.compile(lower(q, self.catalog), self.ctx)

    def compile_ir(self, name: str):
        """Bound lowered plan of a registered IR query (cached)."""
        if name not in self._compiled:
            if name not in IR_QUERIES:
                raise UnknownPlanError(
                    f"unknown query {name!r}; the port lowers "
                    f"{sorted(IR_QUERIES)}")
            self._compiled[name] = self.compile_query(IR_QUERIES[name])
        return self._compiled[name]

    def run_ir(self, name: str) -> dict:
        """Run a registered IR query: ``{"value": tensor}`` on the device."""
        return self.compile_ir(name)(self._columns())

    def query(self, q) -> QueryAnswer:
        """Run an IR ``Query`` with literal predicates (or a registered
        name) through the lowering."""
        if isinstance(q, str):
            return QueryAnswer(self.run_ir(q)["value"], source=q)
        out = self.compile_query(q)(self._columns())
        return QueryAnswer(out["value"], source=q.name or "<lowered-ir>")

    def oracle(self, name: str, **kw):
        """Float64 numpy reference for a registered query."""
        if name not in ORACLES:
            raise LoweringError(f"{name!r} has no oracle binding")
        return reference.ALL[ORACLES[name]](self.tables, **kw)
