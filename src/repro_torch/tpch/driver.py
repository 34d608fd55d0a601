"""TPC-H driver: generate, place, route, lower and run queries on the
node-stacked cluster.

Counterpart of ``repro.tpch.driver.TPCHDriver``.  The constructor
generates the tables (packed by default), holds them to the resident
budget, builds the catalog with each packed column's encoding, derives the
hand plans' exchange capacities and wire formats (``tpch.capacities``),
and places the tables on the device once.  ``run(name)`` runs a
registered query (``core.plans.REGISTRY``): its hand-written plan where it
has one, else its lowered IR; ``run_ir`` always lowers.  The exchange
settings (``capacities`` overrides, the all-to-all ``backend``, the
``wire`` format) are threaded into the plan context.

Two tiers: ``query()`` takes ONE type (an IR ``Query``, or a registered
name as sugar for its definition) and routes it

  Tier 1  to the coarsest covering rollup cube (``build_cubes()``; the
          router matches the ``GroupAgg`` root structurally), answered
          from host memory, else
  Tier 2  to the plan LOWERED from the IR itself.

One ``Observer`` (``driver.obs``) records the spans of each query (route,
lowering, execute) and the metrics of the driver, the plan cache, the
router and the storage.

Across processes: with a process group of W ranks (``group=``, the
default group, or torchrun's environment; see ``core.engine.Cluster``)
every rank generates the same host tables and catalog, so every rank
chooses the same plans, capacities and wire formats and issues the same
collectives in the same order; each places only its L = P / W nodes.  The
constructor all-gathers a fingerprint of the data and raises when a rank's
differs from rank 0's (``dbgen`` seeds with ``hash(table)``: the ranks
need one ``PYTHONHASHSEED``).  Every rank answers every query, the same
answer; so with ``build_cubes``, ``execute_batch`` and
``explain_analyze``, which every rank calls in the same order (lockstep):
every rank holds the same cubes, so every rank's router decides alike.
The serving engine's batches follow rank 0's host timing instead: rank
0's ``OLAPEngine`` leads (``lead``), publishing each tier-2 dispatch at
the dispatch gate over the group's gloo side group, and every other rank
runs ``follow()``, the same plan with the same lanes, until rank 0
publishes the stop (``stop_followers``).  Every rank holds the whole host
data at generation, so the host's memory then grows W-fold (per-node
generation waits in ROADMAP item 9).

Static checks and EXPLAIN: ``check(q)`` runs the static plan verifier
(``query.verify``) over the prepared shape, nothing lowered or run;
``explain(q)`` renders the route, the cost model's per-operator
predictions (with the roofline's codec and wire times under the port's
wire calibration, ``driver.wire_cal``) and the verifier's diagnostics;
``explain_analyze(q)`` adds one measured run: tier, lowering and execute
ms, overflow, counters, and the all-to-all bytes of the run's collective
record attributed to its request semi-joins.

Prepared statements (the paper's §2/§3.1 compile-once model): every IR
query is canonicalized into a parameterized SHAPE plus a literal binding
(``query.params.parameterize``), and the plan cache keys on the shape (and
the wire and backend) alone, so two queries differing only in predicate
literals share ONE lowered plan.  ``prepare(q).execute(binding)`` re-runs
that plan for any literals; ``execute_batch`` runs many bindings as one
batched plan with a leading lane axis.  The capacities of a prepared shape
are sized from the prepare-time binding (auto-parameterized literals) or
the worst binding in each parameter's declared range; the ``overflow``
flag surfaces any binding that exceeds them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core import exchange, plans, wirecal
from repro_torch.core.columnar import PackedColumn, Table
from repro_torch.core.engine import Cluster, all_gather, descriptor
from repro_torch.cube import CubeRouter, build_cube
from repro_torch.obs import (
    ExplainReport,
    Observer,
    SemiJoinInfo,
    attribute_semijoin_bytes,
)
from repro_torch.query.ir import (
    LoweringError,
    PackedInfo,
    Query,
    QueryError,
    UnboundParamError,
    UncoveredQueryError,
    build_catalog,
    query_params,
    same_query,
    validate,
)
from repro_torch.query.lower import explain_chain, lower
from repro_torch.query.params import parameterize
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


class ResidentBudgetError(MemoryError):
    """The resident dataset exceeds the node memory budget
    (``REPRO_RESIDENT_BUDGET_BYTES`` / ``resident_budget=``) — the cluster
    cannot hold this scale factor in the chosen storage format.  The
    message reports both formats' footprints; switching to
    ``storage="packed"`` is the usual fix."""


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
    """Result of :meth:`TPCHDriver.query` and of a prepared query: the
    value, which tier served it (1: a rollup cube, 2: a plan), its source
    (the cube's name at tier 1; at tier 2 the lowered query, or a hand
    plan for a registered name without IR), and whether an exchange
    buffer overflowed (the answer is then incomplete).  ``overflow`` is a
    bool for one execution and a ``(B,)`` bool tensor on the host for
    ``execute_batch``, one flag a lane.  A tier-1 value is a float64
    numpy array of ``(groups, measures)``."""

    value: object
    source: str
    overflow: object = False
    tier: int = 2


class _PlanEntry:
    """One cached prepared SHAPE under one wire and backend: the
    parameterized query, its ordered parameter signature, and the lazily
    lowered plans (scalar and batched), shared by every query that
    canonicalizes to this shape.  ``lock`` makes the first lowering of
    each happen once when threads race into it."""

    def __init__(self, shape: Query, stats_binding: dict, wire: str,
                 backend: str):
        self.shape = shape
        self.params = query_params(shape.root)
        self.stats_binding = dict(stats_binding)
        self.wire = wire
        self.backend = backend
        self.fn = None          # bound scalar plan
        self.batched_fn = None  # bound batched plan (any lane count)
        self.bound = {}         # binding key -> fn(columns) closure (LRU)
        self.route = (None, None)  # (router identity, Match|None) memo
        self.scans = ()         # the lowered plan's per-column scans
        self.published = None   # (leading session, number) on rank 0
        self.lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class Dispatch:
    """One tier-2 dispatch as rank 0 publishes it to the followers: a
    portable name of its entry (a number of rank 0's leading session:
    ``shape_key`` is an address in rank 0's process), the kind, the
    bindings as host values and the batch's ``pad_to``.  The first
    dispatch of an entry also carries what a follower builds it from:
    the shape, its stats binding (the capacities follow it), the wire
    and the backend."""

    key: int
    batched: bool             # execute_batch, else a scalar execute
    bindings: tuple           # one full binding, or one a lane (unpadded)
    pad_to: Optional[int] = None
    entry: Optional[tuple] = None  # (shape, stats_binding, wire, backend)


@dataclasses.dataclass(frozen=True)
class KeepAlive:
    """What an idle leader publishes so that its followers, waiting for
    the next :class:`Dispatch`, do not reach the side group's timeout;
    a follower skips it."""


def _pad_lanes(rows: list, pad_to: Optional[int]) -> list:
    """A batch's bindings padded to ``pad_to`` lanes by repeating the
    last one."""
    if pad_to is not None and pad_to > len(rows):
        return rows + [rows[-1]] * (pad_to - len(rows))
    return rows


def _device_params(entry: _PlanEntry, b: dict, device) -> dict:
    """Binding -> the plan's parameters: a 0-d tensor of each parameter's
    dtype on ``device`` (a (B,) tensor where the binding holds B values
    of each)."""
    return {p.name: torch.as_tensor(
                np.asarray(b[p.name], np.dtype(p.dtype))).to(device)
            for p in entry.params}


class PreparedQuery:
    """A query prepared against one driver: lowered once, executed for any
    parameter binding (``execute``), or for many bindings as one batched
    plan (``execute_batch``).

    ``params`` is the ordered parameter signature; ``defaults`` carries
    the literal values that auto-parameterization extracted, so a prepared
    literal query executes with no arguments and any subset can be
    overridden per call."""

    def __init__(self, driver: "TPCHDriver", entry: _PlanEntry,
                 defaults: dict, source: str, cache_hit: bool = False):
        self.driver = driver
        self.entry = entry
        self.defaults = dict(defaults)
        self.source = source
        self.cache_hit = cache_hit  # the shape's entry was reused

    @property
    def params(self) -> tuple:
        return self.entry.params

    @property
    def query(self) -> Query:
        return self.entry.shape

    @property
    def shape_key(self) -> int:
        """Identity of the prepared shape: two handles carry the same key
        iff they share one ``_PlanEntry`` (and so one lowered plan).  The
        serving engine coalesces submissions by this key: same key means
        their bindings stack into one ``execute_batch``.  It is an address
        in this process and names nothing on another rank (a published
        :class:`Dispatch` names its entry by number)."""
        return id(self.entry)

    def binding(self, params=None) -> dict:
        """Defaults merged with per-call overrides; raises
        :class:`UnboundParamError` for missing or unknown names and for a
        value that does not cast to its parameter's dtype."""
        b = dict(self.defaults)
        if params:
            b.update(params)
        names = {p.name for p in self.entry.params}
        missing = sorted(names - set(b))
        if missing:
            raise UnboundParamError(
                f"missing binding(s) {missing} for prepared query "
                f"{self.source!r} (parameters: {sorted(names)})")
        unknown = sorted(set(b) - names)
        if unknown:
            raise UnboundParamError(
                f"unknown parameter(s) {unknown} for prepared query "
                f"{self.source!r} (parameters: {sorted(names)})")
        # a bad value fails HERE, naming the key, not inside the plan
        for p in self.entry.params:
            try:
                np.asarray(b[p.name], np.dtype(p.dtype))
            except (TypeError, ValueError) as e:
                raise UnboundParamError(
                    f"binding {p.name}={b[p.name]!r} for prepared query "
                    f"{self.source!r} is not castable to {p.dtype}: {e}"
                ) from None
        return b

    def _cast(self, b: dict) -> dict:
        """Binding -> the plan's parameters on the cluster's device."""
        return _device_params(self.entry, b, self.driver.cluster.device)

    def answer_tier1(self, b: dict) -> Optional[QueryAnswer]:
        """Tier-1 (rollup cube) answer for a FULL binding ``b``, or None
        when no cube covers this shape or the binding is off-edge or out
        of range.  Host-side numpy only, nothing on the device; the route
        match is memoized on the entry (per router)."""
        router = self.driver.router
        if router is None:
            return None
        if self.entry.route[0] is not router:
            self.entry.route = (router, router.route_query(self.entry.shape))
        match = self.entry.route[1]
        if match is None:
            return None
        value = router.answer_bound(match, b)
        if value is None:  # off-edge / out-of-range binding -> Tier 2
            return None
        value = np.asarray(value).reshape(-1, value.shape[-1])
        return QueryAnswer(value, tier=1, source=match.route.cube.spec.name)

    def _tier2(self, ensure):
        """The bound plan from ``ensure`` (lowered on first use); a query
        that cannot lower raises :class:`UncoveredQueryError`."""
        try:
            return ensure(self.entry)
        except LoweringError as e:
            raise UncoveredQueryError(
                f"no rollup cube covers query {self.source} for this "
                f"binding and it has no lowerable Tier-2 form: {e}"
            ) from e

    def execute(self, params=None) -> QueryAnswer:
        """Answer for the defaults overridden by ``params``: from a rollup
        cube where one covers this binding exactly (tier 1), else from the
        prepared plan (tier 2), complete on the card when it returns."""
        driver = self.driver
        obs = driver.obs
        mreg = obs.metrics
        t_start = time.perf_counter()
        with obs.span("query", source=self.source,
                      cache="hit" if self.cache_hit else "miss") as sp:
            b = self.binding(params)
            with obs.span("route", cat="route"):
                ans = self.answer_tier1(b)
            if ans is not None:
                sp.set(tier=1, route=ans.source)
                mreg.counter("driver.tier1").inc()
                mreg.histogram("query.tier1_us").record(
                    (time.perf_counter() - t_start) * 1e6)
                return ans
            fn = self._tier2(driver._ensure_compiled)
            cols = driver.columns()
            args = (cols, self._cast(b)) if self.entry.params else (cols,)
            with obs.span("execute", cat="exec"):
                out = driver._guarded_call(
                    fn, *args, publish=(self.entry, False, (b,), None))
            overflow = bool(out.pop("overflow", False))
            value = out["value"] if set(out) == {"value"} else out
            sp.set(tier=2, route=self.source, overflow=overflow)
            mreg.counter("driver.tier2").inc()
            driver._count_scan_bytes(self.entry)
            if overflow:
                mreg.counter("exchange.overflow").inc()
            mreg.histogram("query.tier2_us").record(
                (time.perf_counter() - t_start) * 1e6)
            return QueryAnswer(value, source=self.source, overflow=overflow)

    def execute_batch(self, param_table, pad_to: Optional[int] = None
                      ) -> QueryAnswer:
        """Run many bindings of this prepared shape as ONE batched plan.
        ``param_table`` is a mapping name -> length-B sequence (missing
        names take the defaults) or a sequence of B binding dicts.  Every
        output gains a leading lane axis, and ``overflow`` comes back a
        lane.  ``pad_to`` pads the batch to a fixed lane count by
        repeating the last binding (counted in ``driver.batch_pad_lanes``);
        the outputs are cut back to B.  A batch always runs the plan
        (tier 2): a cube's exactness is decided binding by binding."""
        if not self.entry.params:
            raise QueryError(
                f"prepared query {self.source!r} has no parameters — "
                f"execute_batch needs a parameterized shape")
        if isinstance(param_table, Mapping):
            seqs = {k: list(v) for k, v in param_table.items()}
            sizes = {len(v) for v in seqs.values()}
            if len(sizes) != 1:
                raise QueryError(
                    f"ragged param_table: column lengths {sorted(sizes)}")
            B = sizes.pop()
            rows = [{k: seqs[k][i] for k in seqs} for i in range(B)]
        else:
            rows = [dict(r) for r in param_table]
            B = len(rows)
        if B == 0:
            raise QueryError("execute_batch needs at least one binding")
        merged = [self.binding(r) for r in rows]
        driver = self.driver
        obs = driver.obs
        mreg = obs.metrics
        padded = _pad_lanes(merged, pad_to)
        lanes = len(padded)
        if lanes != B:
            mreg.counter("driver.batch_pad_lanes").inc(lanes - B)
        stacked = self._cast({p.name: [m[p.name] for m in padded]
                              for p in self.entry.params})
        with obs.span("query.batch", source=self.source, lanes=B,
                      padded=lanes) as sp:
            fn = self._tier2(driver._ensure_batched)
            with obs.span("execute", cat="exec"):
                out = driver._guarded_call(
                    fn, driver.columns(), stacked,
                    publish=(self.entry, True, tuple(merged), pad_to))
            overflow = out.pop("overflow", None)
            overflow = (torch.zeros(lanes, dtype=torch.bool)
                        if overflow is None else overflow.cpu())
            if lanes != B:  # drop the padding lanes from every output
                out = {k: v[:B] for k, v in out.items()}
                overflow = overflow[:B]
            value = out["value"] if set(out) == {"value"} else out
            n_ovf = int(overflow.sum())
            sp.set(tier=2, overflow_lanes=n_ovf)
            mreg.counter("driver.batch").inc()
            mreg.counter("driver.batch_lanes").inc(B)
            driver._count_scan_bytes(self.entry, lanes=B)
            if n_ovf:
                mreg.counter("exchange.overflow").inc(n_ovf)
            return QueryAnswer(value, source=self.source, overflow=overflow)


def _resident_bytes(t: Table) -> int:
    """Resident footprint of one table (packed columns at their packed
    size, raw columns at tensor size)."""
    return sum(c.nbytes if isinstance(c, PackedColumn)
               else c.numel() * c.element_size()
               for c in t.columns.values())


def _raw_bytes(t: Table) -> int:
    """What the same table would occupy fully decoded."""
    return sum(c.raw_nbytes if isinstance(c, PackedColumn)
               else c.numel() * c.element_size()
               for c in t.columns.values())


class TPCHDriver:
    """TPC-H at scale factor ``sf`` on ``num_nodes`` stacked nodes.

    ``device=None`` means ``cuda`` and raises without it; pass
    ``device="cpu"`` to run on the CPU (kernels then use their plain
    PyTorch versions).  ``obs`` is the observability hub (a fresh
    always-on ``Observer`` by default; ``Observer(enabled=False)`` drops
    the spans, the metrics stay).  ``resident_budget`` (else
    ``REPRO_RESIDENT_BUDGET_BYTES``) caps the resident bytes: above it
    the constructor raises :class:`ResidentBudgetError` before placing
    anything on the device.  ``group`` is the process group the cluster
    spans (see the module docstring; by default the initialised default
    group, or none)."""

    def __init__(self, sf: float, num_nodes: int = 8, seed: int = 0,
                 storage: str = "packed", device=None, capacities=None,
                 backend: str = "xla", wire: str = "packed",
                 obs: Optional[Observer] = None,
                 resident_budget: Optional[int] = None, group=None):
        self.cluster = Cluster(num_nodes, device=device, group=group)
        self.obs = obs if obs is not None else Observer()
        self.sf = sf
        self.seed = seed
        self.storage = storage
        self.backend = backend
        self.wire = wire
        # the wire calibration for EXPLAIN's roofline predictions (saved by
        # ``python -m repro_torch.core.wirecal``; builtin rates otherwise)
        self.wire_cal = wirecal.load()
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
        if self.cluster.topology.distributed:
            self._check_same_data()
        # resident footprint and the node memory budget: exceeding it is
        # the out-of-memory the packed format pushes out by about the
        # compression ratio
        if resident_budget is None:
            env = os.environ.get("REPRO_RESIDENT_BUDGET_BYTES")
            resident_budget = int(env) if env else None
        mreg = self.obs.metrics
        total = 0
        for n, t in self.resident.items():
            b = _resident_bytes(t)
            total += b
            mreg.gauge(f"storage.bytes_resident.{n}").set(b)
        mreg.gauge("storage.bytes_resident").set(total)
        self.resident_bytes = total
        if resident_budget is not None and total > resident_budget:
            raw = sum(_raw_bytes(t) for t in self.resident.values())
            raise ResidentBudgetError(
                f"resident dataset at sf={sf} needs {total} bytes in "
                f"{storage!r} storage but the node budget is "
                f"{resident_budget} bytes (fully decoded it would be "
                f"{raw}); use storage='packed' or a smaller scale factor")
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
        # (shape, wire, backend) -> _PlanEntry, least recently used first
        self._prepared = {}
        # one lock for the caches (_compiled, _prepared and its LRU order,
        # the entries' bound-closure LRUs): two threads preparing one
        # shape converge on one entry.  Reentrant: compile() reaches
        # prepare() through compile_query()
        self._lock = threading.RLock()
        # One plan call from the host at a time: the serving tier's
        # concurrency comes from lanes in one dispatch, never from
        # interleaved dispatches, and the kernels' launch counters and the
        # host reads inside plans must not interleave between threads.
        self._dispatch_gate = threading.Lock()
        self.compile_events = []  # one label per lowering of a prepared
                                  # shape ("<name>" / "<name>@batch")
        # leader/follower serving (rank 0 of a process group): whether the
        # gate publishes its dispatches, the leading session (entries
        # published in an earlier one are new again) and the next number
        self._leading = False
        self._session = 0
        self._next_key = 0
        # the keep-alive thread of a leading session, its stop, and the
        # host clock of the last descriptor published
        self._keepalive: Optional[threading.Thread] = None
        self._keepalive_stop = threading.Event()
        self._last_publish = 0.0
        self.cubes = {}
        self.router: Optional[CubeRouter] = None

    def _fingerprint(self) -> int:
        """63 bits of a digest of the catalog (every column's bounds and
        encoding), the replicated tables and a strided sample of every
        partitioned column."""
        h = hashlib.sha256(repr(self.catalog).encode())
        for name in sorted(self.tables):
            t = self.tables[name]
            for cname in sorted(t.columns):
                col = np.ascontiguousarray(t.columns[cname])
                if not t.replicated:
                    col = np.ascontiguousarray(
                        col[::max(1, col.size // 4096)])
                h.update(col.tobytes())
        return int.from_bytes(h.digest()[:8], "little") >> 1

    def _check_same_data(self) -> None:
        """All-gather every rank's fingerprint of the data; every rank
        raises when any differs from rank 0's."""
        topo = self.cluster.topology
        mine = torch.tensor([self._fingerprint()], dtype=torch.int64,
                            device=self.cluster.device)
        every = torch.empty(topo.world, dtype=torch.int64,
                            device=self.cluster.device)
        all_gather(every, mine, topo.group)
        every = every.tolist()
        bad = [r for r, f in enumerate(every) if f != every[0]]
        if bad:
            raise ValueError(
                f"ranks {bad} generated other data than rank 0 (data "
                f"fingerprints {every}): tpch/dbgen seeds with "
                f"hash(table), so every rank needs the same PYTHONHASHSEED "
                f"(this rank's: "
                f"{os.environ.get('PYTHONHASHSEED', 'unset')})")

    @staticmethod
    def _host_column(col) -> np.ndarray:
        if isinstance(col, PackedColumn):
            col = col.decode()
        return col.reshape(-1).numpy()

    def columns(self) -> dict:
        """The placed column dicts (table name -> column name -> column)
        that a bound plan runs over."""
        return {n: t.columns for n, t in self.placed.items()}

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
        with self._lock:
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
        """Bound LOWERED plan of a registered query's IR, even when a hand
        plan exists (through :meth:`compile_query`)."""
        return self.compile_query(self._registered(name))

    def run_ir(self, name: str) -> dict:
        """Run a registered IR query: the plan's dict of device tensors
        (``value``, or the top-k fields; ``overflow`` where the plan has a
        request exchange)."""
        return self.compile_ir(name)(self.columns())

    IR_CACHE_MAX = 32    # prepared-shape LRU bound
    BOUND_CACHE_MAX = 8  # per-shape LRU bound of literal-bound closures

    # -- prepared statements (lower once, execute for any literals) --------
    def prepare(self, q, *, wire: str | None = None,
                backend: str | None = None) -> PreparedQuery:
        """Prepare an IR query (or a registered name) under ``wire`` and
        ``backend`` (default: the driver's): canonicalize it into a
        parameterized shape + default binding and return the (possibly
        cached) :class:`PreparedQuery`.  The cache keys on the shape, so
        queries differing only in predicate literals share one plan; the
        lowering is lazy, on the first execution."""
        if isinstance(q, str):
            q = self._registered(q)
        if not isinstance(q, Query):
            raise TypeError(f"prepare() takes a repro_torch.query Query "
                            f"(or a registered plan name), got {type(q)}")
        validate(q.root, self.catalog)  # typed errors at prepare time
        shape, defaults = parameterize(q, obs=self.obs)
        source = q.name or "<lowered-ir>"
        wire = self.wire if wire is None else wire
        backend = self.backend if backend is None else backend
        key = (repr(shape.root), wire, backend)  # same_query guards it
        with self._lock:
            hit = self._prepared.get(key)
            if hit is not None and same_query(hit.shape, shape):
                self._prepared[key] = self._prepared.pop(key)  # LRU touch
                self.obs.metrics.counter("plan_cache.hit").inc()
                return PreparedQuery(self, hit, defaults, source,
                                     cache_hit=True)
            entry = _PlanEntry(shape, defaults, wire, backend)
            self._prepared[key] = entry
            while len(self._prepared) > self.IR_CACHE_MAX:
                self._prepared.pop(next(iter(self._prepared)))
            self.obs.metrics.counter("plan_cache.miss").inc()
            return PreparedQuery(self, entry, defaults, source)

    def _context(self, entry: _PlanEntry):
        if (entry.wire, entry.backend) == (self.wire, self.backend):
            return self.ctx
        return dataclasses.replace(self.ctx, wire=entry.wire,
                                   backend=entry.backend)

    def _bind(self, entry: _PlanEntry, batched: bool):
        """Lower the shape (one ``compile_events`` label and one
        ``plan.compile_events`` count each time, inside a ``lower`` span)
        and bind it to the entry's context."""
        label = entry.shape.name or "<lowered-ir>"
        label = f"{label}@batch" if batched else label
        with self.obs.span("lower", cat="plan", label=label):
            plan = lower(entry.shape, self.catalog, wire=entry.wire,
                         binding=entry.stats_binding, batched=batched,
                         obs=self.obs)
            entry.scans = plan.scans
            self.compile_events.append(label)
            self.obs.metrics.counter("plan.compile_events").inc()
            return self.cluster.compile(plan, self._context(entry),
                                        batch=batched)

    def _guarded_call(self, fn, *args, publish=None):
        """One device dispatch of a prepared plan under the dispatch gate,
        its answer complete when this returns.  While this rank leads
        (:meth:`lead`), ``publish`` — (entry, batched, bindings, pad_to) —
        goes to the followers first, inside the gate: the gate's order is
        the order in which the leader issues its collectives, so it is the
        order the followers replay.  On CUDA a plan's answer may
        still be computing when ``fn`` returns (q6 reads nothing back), so
        an event is recorded after the dispatch, inside the gate, and
        waited on outside it: ``Event.synchronize`` lets go of the
        interpreter lock, so the next dispatch's host work overlaps this
        one's device work.  (The reference also holds the entry's lock on
        the first call of each specialization, its ``entry.warm``: the
        port's batched plan takes any lane count, so there is nothing to
        specialize; ``entry.lock`` only guards the lowering.)"""
        with self._dispatch_gate:
            if self._leading and publish is not None:
                self._publish(*publish)
            out = fn(*args)
            done = None
            if self.cluster.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
        if done is not None:
            done.synchronize()
        return out

    # -- leader/follower serving across the ranks of a process group ---------
    def lead(self) -> None:
        """Rank 0 leads the ranks' serving from here: every dispatch at
        the gate (a tier-2 ``execute`` or ``execute_batch``) is published
        to the other ranks, which run :meth:`follow`, until
        :meth:`stop_followers`.  While leading, run plans only through
        prepared queries (``execute``, ``execute_batch``, ``query``,
        ``explain_analyze``): a plan called any other way is not
        published, and the ranks' collectives part.  While leading, a
        thread publishes a :class:`KeepAlive` whenever no descriptor has
        gone out for a quarter of the side group's timeout, so an idle
        leader keeps its followers.  A no-op without a process group;
        raises on another rank."""
        topo = self.cluster.topology
        if not topo.distributed:
            return
        if topo.rank != 0:
            raise ValueError(f"rank {topo.rank} cannot lead: rank 0 leads "
                             f"and the other ranks call follow()")
        from repro_torch.launch import mesh

        with self._dispatch_gate:
            if self._leading:
                return
            self._leading = True
            self._session += 1
            self._last_publish = time.monotonic()
            self._keepalive_stop = threading.Event()
            self._keepalive = threading.Thread(
                target=self._keep_alive,
                args=(self._keepalive_stop,
                      mesh.group_timeout(topo.control) / 4),
                name="repro-keepalive", daemon=True)
            self._keepalive.start()

    def _keep_alive(self, stop: threading.Event, interval: float) -> None:
        """The keep-alive thread of one leading session: a
        :class:`KeepAlive` under the gate whenever ``interval`` seconds
        have passed since the last descriptor, until ``stop``."""
        while True:
            wait = self._last_publish + interval - time.monotonic()
            if wait > 0:
                if stop.wait(wait):
                    return
                continue
            with self._dispatch_gate:
                if stop.is_set():
                    return
                if time.monotonic() - self._last_publish >= interval:
                    descriptor(KeepAlive(), self.cluster.topology)
                    self._last_publish = time.monotonic()
                    self.obs.metrics.counter("driver.keepalives").inc()

    def stop_followers(self) -> None:
        """Publish the stop that ends every follower's loop, once a
        leading session (a no-op when this rank does not lead), and end
        the session's keep-alive thread."""
        with self._dispatch_gate:
            if not self._leading:
                return
            self._leading = False
            self._keepalive_stop.set()
            descriptor(None, self.cluster.topology)
        self._keepalive.join()
        self._keepalive = None

    def _publish(self, entry: _PlanEntry, batched: bool, bindings: tuple,
                 pad_to) -> None:
        """Send one dispatch's :class:`Dispatch` (under the gate)."""
        first = (entry.published is None
                 or entry.published[0] != self._session)
        if first:
            entry.published = (self._session, self._next_key)
            self._next_key += 1
        descriptor(Dispatch(
            entry.published[1], batched, bindings, pad_to,
            (entry.shape, entry.stats_binding, entry.wire, entry.backend)
            if first else None), self.cluster.topology)
        self._last_publish = time.monotonic()
        self.obs.metrics.counter("driver.published").inc()

    def follow(self) -> int:
        """Follow rank 0's serving (every rank but 0, while rank 0 leads):
        receive each dispatch rank 0 publishes and run the same plan with
        the same lanes, dropping the answer, until rank 0 publishes the
        stop, skipping its keep-alives.  Returns the dispatches run.  A
        dispatch that raises ends the loop and re-raises; the other ranks
        then fail at the group's timeout, as every follower does once the
        leader has died (no dispatch, keep-alive or stop for that long)."""
        topo = self.cluster.topology
        if not topo.distributed or topo.rank == 0:
            raise ValueError("follow() runs on the ranks other than 0 of a "
                             "process group; rank 0 leads")
        entries = {}   # Dispatch.key -> this rank's entry
        done = 0
        while True:
            d = descriptor(None, topo)
            if d is None:
                return done
            if isinstance(d, KeepAlive):
                continue
            if d.entry is not None:
                entries[d.key] = _PlanEntry(*d.entry)
            entry = entries[d.key]
            if d.batched:
                fn = self._ensure_batched(entry)
                lanes = _pad_lanes(list(d.bindings), d.pad_to)
                b = {p.name: [r[p.name] for r in lanes]
                     for p in entry.params}
            else:
                fn = self._ensure_compiled(entry)
                b = d.bindings[0]
            params = _device_params(entry, b, self.cluster.device)
            args = ((self.columns(), params) if entry.params
                    else (self.columns(),))
            self._guarded_call(fn, *args)
            done += 1

    def _count_scan_bytes(self, entry: _PlanEntry, lanes: int = 1) -> None:
        """Account one execution's predicted scan traffic against the
        ``storage.bytes_scanned`` counters (cluster-wide bytes: per-node
        prediction x nodes x batch lanes)."""
        if not entry.scans:
            return
        mreg = self.obs.metrics
        nn = max(self.cluster.num_nodes, 1)
        total = 0
        for d in entry.scans:
            b = d.scan_bytes * nn * lanes
            mreg.counter(f"storage.bytes_scanned.{d.table}").inc(b)
            total += b
        mreg.counter("storage.bytes_scanned").inc(total)

    def _ensure_compiled(self, entry: _PlanEntry):
        if entry.fn is None:
            with entry.lock:  # double-checked: lower once
                if entry.fn is None:
                    entry.fn = self._bind(entry, batched=False)
        return entry.fn

    def _ensure_batched(self, entry: _PlanEntry):
        if entry.batched_fn is None:
            with entry.lock:
                if entry.batched_fn is None:
                    entry.batched_fn = self._bind(entry, batched=True)
        return entry.batched_fn

    def compile_query(self, q: Query, *, wire: str | None = None,
                      backend: str | None = None):
        """Lower + bind an IR query under ``wire`` and ``backend``
        (default: the driver's; they set both the lowering's wire, which
        the semi-join decision reads, and the context's, which the
        exchange ships): returns ``fn(columns)`` with the query's own
        literals bound, its lowered plan as ``fn.plan``.  The prepared
        plan is shared by shape, and the closure is memoized per binding
        (an LRU of ``BOUND_CACHE_MAX``)."""
        if not isinstance(q, Query):
            raise TypeError(f"compile_query() takes a repro_torch.query "
                            f"Query, got {type(q)}")
        prep = self.prepare(q, wire=wire, backend=backend)
        entry = prep.entry
        fn = self._ensure_compiled(entry)
        if not entry.params:
            return fn
        b = prep.binding()
        key = tuple(sorted(b.items()))
        with self._lock:
            if key in entry.bound:
                entry.bound[key] = entry.bound.pop(key)  # LRU touch
            else:
                pvals = prep._cast(b)

                def bound(columns, _fn=fn, _pv=pvals):
                    return _fn(columns, _pv)

                bound.plan = fn.plan
                entry.bound[key] = bound
                # closures hold device scalars: a stream of new literals
                # must not grow this without bound (the plan is shared)
                while len(entry.bound) > self.BOUND_CACHE_MAX:
                    entry.bound.pop(next(iter(entry.bound)))
            return entry.bound[key]

    # -- two-tier execution (cube) -------------------------------------------
    def build_cubes(self, specs=None):
        """Materialize Tier-1 rollup cubes (one scan per spec) and install
        the query router.  Defaults to the TPC-H presets
        (``tpch.cubes.default_specs``).  Under a process group every rank
        builds every cube (lockstep) and holds the whole of it."""
        if specs is None:
            from repro_torch.tpch import cubes as tpch_cubes

            specs = tpch_cubes.default_specs()
        for spec in specs:
            with self.obs.span("cube.build", cat="plan", cube=spec.name):
                self.cubes[spec.name] = build_cube(
                    self.cluster, self.ctx, self.placed, spec)
        self.obs.metrics.gauge("router.cubes").set(len(self.cubes))
        self.router = CubeRouter(list(self.cubes.values()), obs=self.obs)
        return self.cubes

    def query(self, q, params=None, *, wire: str | None = None,
              backend: str | None = None) -> QueryAnswer:
        """Router-first execution of an IR ``Query`` (or a registered
        name): a ``GroupAgg`` root that a rollup covers exactly for this
        call's binding is answered from the cube (tier 1); anything else
        runs its prepared plan under ``wire`` and ``backend`` (default:
        the driver's; tier 2).  ``params`` binds or overrides its runtime
        parameters.  Its literals become parameters (``parameterize``): a
        float literal compares in float32, as through the reference's
        ``query``.  The answer's value is the plan's ``value`` (a
        ``GroupAgg`` root) or its dict of top-k fields.  A registered name
        without IR runs its hand plan (tier 2), whose overflow flag is
        split off the result.  Raises :class:`UncoveredQueryError` when no
        cube covers the query and it cannot lower (min/max measures)."""
        if isinstance(q, str) and plans.get(q).ir is None:
            if params:
                raise UnboundParamError(
                    f"{q!r} is a hand-written plan with no runtime "
                    f"parameters — binding(s) {sorted(params)} cannot be "
                    f"applied; use an IR form or drop params")
            if (wire, backend) != (None, None):
                raise LoweringError(
                    f"{q!r} is a hand-written plan: its wire and backend "
                    f"are the driver's")
            value, overflow = _split_overflow(self.run(q))
            return QueryAnswer(value, source=q, overflow=overflow)
        if not isinstance(q, (str, Query)):
            raise TypeError(f"query() takes a repro_torch.query Query (or "
                            f"a registered plan name), got {type(q)}")
        return self.prepare(q, wire=wire, backend=backend).execute(params)

    # -- static verification (query.verify) ----------------------------------
    def check(self, q, params=None):
        """Statically verify a query (or registered IR name) against this
        driver's catalog, wire format and capacity overrides: nothing is
        lowered or run.  ``params`` overrides the prepared defaults, so a
        binding can be vetted BEFORE ``prepare(q).execute(params)`` (an
        undersized exchange shows up as a ``CAP001`` error naming the
        worst-case binding).  Returns a
        :class:`repro_torch.query.verify.VerifyReport`; the rule catalog
        is ``docs/RULES.md``."""
        from repro_torch.query.verify import verify

        prep = self.prepare(q)
        if params:
            names = {p.name for p in prep.params}
            unknown = sorted(set(params) - names)
            if unknown:
                raise UnboundParamError(
                    f"unknown parameter(s) {unknown} for query "
                    f"{prep.source!r} (parameters: {sorted(names)})")
        binding = dict(prep.defaults)
        binding.update(params or {})
        return verify(
            prep.entry.shape, self.catalog, wire=self.wire,
            binding=binding, stats_binding=prep.entry.stats_binding,
            capacities=self.capacities)

    # -- EXPLAIN / EXPLAIN ANALYZE (obs.explain) ------------------------------
    def _explain(self, q, params=None):
        """Shared front half: prepare, route-match, predicted plan rows."""
        from repro_torch.query.verify import verify

        prep = self.prepare(q)
        entry = prep.entry
        binding = dict(prep.defaults)
        if params:
            binding.update(params)
        match = None
        if self.router is not None:
            if entry.route[0] is not self.router:
                entry.route = (self.router,
                               self.router.route_query(entry.shape))
            match = entry.route[1]
        tier = 1 if match is not None else 2
        source = (match.route.cube.spec.name if match is not None
                  else prep.source)
        rows, sjs, err = [], [], None
        try:
            rows = explain_chain(entry.shape, self.catalog, wire=self.wire,
                                 binding=binding, predict_cal=self.wire_cal)
        except (LoweringError, QueryError) as e:
            err = str(e)
        for r in rows:
            if r["op"] != "SemiJoin":
                continue
            wf = r["wire"]
            kind = "packed" if (self.wire != "raw" and wf.packed) else "raw"
            sjs.append(SemiJoinInfo(
                index=len(sjs), table=r["table"], alt=r["alt"],
                capacity=r["capacity"], capacity_key=r["capacity_key"],
                wire_kind=kind, key_bits=wf.key_bits, gamma=r["gamma"],
                codec_ms=r["codec_ms"], wire_ms=r["wire_ms"]))
        diagnostics = []
        try:
            diagnostics = list(verify(
                entry.shape, self.catalog, wire=self.wire, binding=binding,
                stats_binding=entry.stats_binding,
                capacities=self.capacities).diagnostics)
        except QueryError:
            pass  # plan_error already carries the lowering failure
        report = ExplainReport(
            query=prep.source, route_tier=tier, route_source=source,
            cache="hit" if prep.cache_hit else "miss", params=binding,
            plan_rows=rows, semijoins=sjs, plan_error=err,
            diagnostics=diagnostics)
        return report, prep

    def explain(self, q, params=None) -> ExplainReport:
        """Static EXPLAIN: the route the query WOULD take (a tier-1 cube
        match or the tier-2 plan), the plan cache's state, and the cost
        model's per-operator predictions; nothing is lowered or run."""
        report, _ = self._explain(q, params)
        return report

    def explain_analyze(self, q, params=None) -> ExplainReport:
        """EXPLAIN plus a measured execution: the tier that served it,
        lowering vs execute milliseconds (the query runs cold, and again
        warm when the first run lowered its plan, so the difference is the
        lowering), the run's overflow, the registry counters, and for a
        tier-2 run the collectives of the measured run
        (``exchange.collective_record``, reset before it) with its
        all-to-all bytes attributed to the plan's request semi-joins in
        program order.  An execute returns with the card done (the
        driver's dispatch waits on it), so each time is the whole run.
        Under a process group every rank calls it (lockstep) and reports
        what one process reports: the record's bytes are a node's, and
        the times the rank's own clock (``observed["ranks"]`` is W)."""
        report, prep = self._explain(q, params)
        mreg = self.obs.metrics
        ev0 = len(self.compile_events)
        exchange.reset_collective_record()
        t0 = time.perf_counter()
        ans = prep.execute(params)
        cold_s = time.perf_counter() - t0
        lowerings = len(self.compile_events) - ev0
        observed = {
            "tier": ans.tier,
            "source": ans.source,
            "overflow": bool(np.asarray(ans.overflow).any()),
            "ranks": self.cluster.topology.world,
        }
        if lowerings:
            exchange.reset_collective_record()
            t0 = time.perf_counter()
            ans = prep.execute(params)
            warm_s = time.perf_counter() - t0
            observed["compile_ms"] = max(cold_s - warm_s, 0.0) * 1e3
            observed["lowerings"] = lowerings
            observed["execute_ms"] = warm_s * 1e3
        else:
            observed["compile_ms"] = None
            observed["lowerings"] = 0
            observed["execute_ms"] = cold_s * 1e3
        record = exchange.collective_record()
        observed["overflow_count"] = mreg.value("exchange.overflow")
        observed["compile_events"] = mreg.value("plan.compile_events")
        observed["bytes_scanned"] = mreg.value("storage.bytes_scanned")
        observed["bytes_resident"] = mreg.value("storage.bytes_resident")
        # the codec predictions the exchange layer recorded (one record a
        # request exchange a lowered plan)
        for hname in ("exchange.encode_ms", "exchange.decode_ms"):
            h = mreg.get(hname)
            if h is not None and h.count:
                observed[hname] = h.snapshot()
        if ans.tier == 2 and report.plan_error is None:
            by_op, count_by_op = {}, {}
            for instr in record:
                by_op[instr.kind] = by_op.get(instr.kind, 0) + instr.bytes
                count_by_op[instr.kind] = count_by_op.get(instr.kind, 0) + 1
            observed["collective_bytes_by_op"] = by_op
            observed["collective_count_by_op"] = count_by_op
            attribute_semijoin_bytes(record, report.semijoins)
        report.observed = observed
        return report

    def oracle(self, name: str, **kw):
        """Float64 numpy reference for a registered query or a forced
        exchange variant (``q14_promo_request``, ``q4_sj_request``, ...)."""
        oracle, component = oracle_binding(name)
        if oracle == "q11":
            kw.setdefault("sf", self.sf)
        out = reference.ALL[oracle](self.tables, **kw)
        return out if component is None else out[component]
