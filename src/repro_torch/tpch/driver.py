"""TPC-H driver: generate, place, lower and run queries on the node-stacked
cluster.

Counterpart of the constructor, ``compile``, ``run``, ``run_ir``,
``query`` and ``oracle`` of ``repro.tpch.driver.TPCHDriver``.  The
constructor generates the tables (packed by default), builds the catalog
with each packed column's encoding, derives the hand plans' exchange
capacities and wire formats (``tpch.capacities``), and places the tables
on the device once.  ``run(name)`` runs a registered query
(``core.plans.REGISTRY``): its hand-written plan where it has one, else
its lowered IR; ``run_ir`` always lowers.  The exchange settings
(``capacities`` overrides, the all-to-all ``backend``, the ``wire``
format) are threaded into the plan context.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import plans
from repro_torch.core.columnar import PackedColumn, Table
from repro_torch.core.engine import Cluster
from repro_torch.query.ir import (
    LoweringError,
    PackedInfo,
    Query,
    build_catalog,
)
from repro_torch.query.lower import lower
from repro_torch.tpch import capacities as tpch_capacities
from repro_torch.tpch import dbgen, reference

# name prefix -> (oracle, component): the exchange queries and their
# forced variants; q14_promo answers the promo revenue, component 1 of q14
ORACLE_PREFIXES = {"q14_promo": ("q14", 1), "q4_sj_": ("q4", None),
                   "q18_sj_": ("q18_sj", None)}


def oracle_binding(name: str) -> tuple:
    """(oracle, component or None) that answers the registered or forced
    query ``name``: the registry's explicit binding first."""
    entry = plans.REGISTRY.get(name)
    if entry is not None and entry.oracle is not None:
        return entry.oracle, None
    for prefix, binding in ORACLE_PREFIXES.items():
        if name.startswith(prefix):
            return binding
    raise LoweringError(f"{name!r} has no oracle binding")


def _split_overflow(out):
    """Surface a plan's exchange-overflow flag instead of leaving it buried
    in the raw result: hand plans return either a dict with an
    ``overflow`` entry or a ``(value, overflow)`` pair."""
    if isinstance(out, dict):
        return out, bool(out.pop("overflow", False))
    if (isinstance(out, tuple) and len(out) == 2
            and isinstance(out[1], torch.Tensor) and out[1].ndim == 0
            and out[1].dtype == torch.bool):
        return out[0], bool(out[1])
    return out, False


@dataclasses.dataclass
class QueryAnswer:
    """Result of :meth:`TPCHDriver.query`: the value, the query that
    produced it (a lowered plan, or a hand plan for a registered name
    without IR), and whether an exchange buffer overflowed (the answer is
    then incomplete)."""

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
        # q3_repl's remote join attribute, replicated at load time (the
        # paper's 'repl' variant): one 1-D column on every node
        seg = self.tables["customer"].columns["c_mktsegment"]
        self.tables["customer_seg_repl"] = Table(
            "customer_seg_repl", {"c_mktsegment": seg}, replicated=True)
        self.resident["customer_seg_repl"] = Table(
            "customer_seg_repl", {"c_mktsegment": torch.from_numpy(seg)},
            replicated=True)
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
        # §3.2.2-derived capacities for the hand plans; overrides win
        self.capacities = tpch_capacities.derive(sf, num_nodes)
        self.capacities.update(capacities or {})
        self.ctx = self.cluster.context(
            self.placed, self.capacities, backend=backend, scale_factor=sf,
            wire=wire,
            wires=tpch_capacities.wire_formats(self.tables, num_nodes))
        self._compiled = {}   # registry name -> bound plan (hand or IR)
        self._lowered = {}    # registry name -> bound lowered IR plan

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
        entry = plans.get(name)
        if entry.ir is None:
            raise LoweringError(
                f"{name!r} has no IR definition — only the hand-written "
                f"plan; run it with run({name!r})")
        return entry.ir

    # -- physical layer (hand plans / lowered IR by registry name) ---------
    def compile(self, name: str):
        """Bound plan of a registered query: its hand-written plan when it
        has one, else its lowered IR (cached)."""
        if name not in self._compiled:
            entry = plans.get(name)
            if entry.plan is not None:
                self._compiled[name] = self.cluster.compile(entry.plan,
                                                            self.ctx)
            else:
                self._compiled[name] = self.compile_ir(name)
        return self._compiled[name]

    def run(self, name: str):
        """Run a registered query through :meth:`compile`: the plan's raw
        result (a dict, a tensor, a TopK, or a (value, overflow) pair)."""
        return self.compile(name)(self.columns())

    def compile_ir(self, name: str):
        """Bound LOWERED plan of a registered query's IR (cached), even
        when a hand plan exists."""
        if name not in self._lowered:
            self._lowered[name] = self.compile_query(self._registered(name))
        return self._lowered[name]

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
        ``value`` (a ``GroupAgg`` root) or its dict of top-k fields.  A
        registered name without IR runs its hand plan, whose overflow flag
        is split off the result."""
        source = q if isinstance(q, str) else q.name or "<lowered-ir>"
        if isinstance(q, str) and plans.get(q).ir is None:
            if (wire, backend) != (None, None):
                raise LoweringError(
                    f"{q!r} is a hand-written plan: its wire and backend "
                    f"are the driver's")
            value, overflow = _split_overflow(self.run(q))
            return QueryAnswer(value, source=source, overflow=overflow)
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
        if oracle == "q11":
            kw.setdefault("sf", self.sf)
        out = reference.ALL[oracle](self.tables, **kw)
        return out if component is None else out[component]
