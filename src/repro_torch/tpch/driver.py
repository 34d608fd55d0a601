"""TPC-H driver: generate, place, lower and run queries on the node-stacked
cluster.

Counterpart of the constructor, ``run_ir``, ``query`` and ``oracle`` of
``repro.tpch.driver.TPCHDriver``.  The constructor generates the tables
(packed by default), builds the catalog with each packed column's
encoding, and places the tables on the device once; ``run_ir`` lowers a
registered IR query and runs it over the packed residents.  The exchange
settings (``capacities`` overrides, the all-to-all ``backend``, the
``wire`` format) are threaded into the plan context.
"""
from __future__ import annotations

import dataclasses

import numpy as np

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
ORACLES = {"q1": "q1", "q1_kernel": "q1", "q4": "q4", "q6": "q6",
           "q18": "q18"}
# name prefix -> (oracle, component): the exchange queries and their
# forced variants; q14_promo answers the promo revenue, component 1 of q14
ORACLE_PREFIXES = {"q14_promo": ("q14", 1), "q4_sj_": ("q4", None),
                   "q18_sj_": ("q18_sj", None)}


def oracle_binding(name: str) -> tuple:
    """(oracle, component or None) that answers the registered or forced
    query ``name``."""
    if name in ORACLES:
        return ORACLES[name], None
    for prefix, binding in ORACLE_PREFIXES.items():
        if name.startswith(prefix):
            return binding
    raise LoweringError(f"{name!r} has no oracle binding")


@dataclasses.dataclass
class QueryAnswer:
    """Result of :meth:`TPCHDriver.query`: the value, the query that
    produced it (every answer here comes from a lowered plan), and whether
    an exchange buffer overflowed (the answer is then incomplete)."""

    value: object
    source: str
    overflow: bool = False


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
                 storage: str = "packed", device=None, capacities=None,
                 backend: str = "xla", wire: str = "packed"):
        self.cluster = Cluster(num_nodes, device=device)
        self.sf = sf
        self.seed = seed
        self.storage = storage
        self.backend = backend
        self.wire = wire
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
        self.ctx = self.cluster.context(self.placed, capacities,
                                        backend=backend, scale_factor=sf,
                                        wire=wire)
        self._compiled = {}   # registry name -> bound plan

    @staticmethod
    def _host_column(col) -> np.ndarray:
        if isinstance(col, PackedColumn):
            col = col.decode()
        return col.reshape(-1).numpy()

    def columns(self) -> dict:
        """The placed column dicts (table name -> column name -> column)
        that a bound plan runs over."""
        return {n: t.columns for n, t in self.placed.items()}

    def compile_query(self, q: Query, *, wire: str | None = None,
                      backend: str | None = None):
        """Lower + bind an IR query: returns ``fn(columns)``, its lowered
        plan as ``fn.plan``.  ``wire`` and ``backend`` (default: the
        driver's) set both the lowering's wire, which the semi-join
        decision reads, and the context's, which the exchange ships."""
        if not isinstance(q, Query):
            raise TypeError(f"compile_query() takes a repro_torch.query "
                            f"Query, got {type(q)}")
        wire = self.wire if wire is None else wire
        backend = self.backend if backend is None else backend
        ctx = (self.ctx if (wire, backend) == (self.wire, self.backend)
               else dataclasses.replace(self.ctx, wire=wire,
                                        backend=backend))
        return self.cluster.compile(lower(q, self.catalog, wire=wire), ctx)

    @staticmethod
    def _registered(name: str) -> Query:
        if name not in IR_QUERIES:
            raise UnknownPlanError(
                f"unknown query {name!r}; the port lowers "
                f"{sorted(IR_QUERIES)}")
        return IR_QUERIES[name]

    def compile_ir(self, name: str):
        """Bound lowered plan of a registered IR query (cached)."""
        if name not in self._compiled:
            self._compiled[name] = self.compile_query(self._registered(name))
        return self._compiled[name]

    def run_ir(self, name: str) -> dict:
        """Run a registered IR query: the plan's dict of device tensors
        (``value``, or the top-k fields; ``overflow`` where the plan has a
        request exchange)."""
        return self.compile_ir(name)(self.columns())

    def query(self, q, *, wire: str | None = None,
              backend: str | None = None) -> QueryAnswer:
        """Run an IR ``Query`` with literal predicates (or a registered
        name) through the lowering, under ``wire`` and ``backend``
        (default: the driver's).  The answer's value is the plan's
        ``value`` (a ``GroupAgg`` root) or its dict of top-k fields."""
        source = q if isinstance(q, str) else q.name or "<lowered-ir>"
        if isinstance(q, str) and wire is None and backend is None:
            fn = self.compile_ir(q)
        else:
            fn = self.compile_query(
                self._registered(q) if isinstance(q, str) else q,
                wire=wire, backend=backend)
        out = fn(self.columns())
        overflow = bool(out.pop("overflow", False))
        value = out["value"] if "value" in out else out
        return QueryAnswer(value, source=source, overflow=overflow)

    def oracle(self, name: str, **kw):
        """Float64 numpy reference for a registered query or a forced
        exchange variant (``q14_promo_request``, ``q4_sj_request``, ...)."""
        oracle, component = oracle_binding(name)
        out = reference.ALL[oracle](self.tables, **kw)
        return out if component is None else out[component]
