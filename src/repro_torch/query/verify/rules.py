"""The analyzers: collective-consistency, capacity soundness,
recompilation hazards, numeric hazards.

Counterpart of ``repro.query.verify.rules``: the same analyzers over the
port's IR, catalog and lowering decisions, giving the same diagnostics.

Each analyzer is ``fn(VerifyContext) -> list[Diagnostic]`` and is purely
static: it reads the IR tree, the catalog statistics, the semi-join
decisions the lowering would make, and (optionally) supplied lowering
artifacts — it never traces, compiles, or executes a plan.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np

from repro_torch.core import wirecal
from repro_torch.query import stats as qstats
from repro_torch.query.lower import (
    ONEHOT_MAX_GROUPS,
    _chain,
    _has_division,
    decide_scans,
    decide_semijoins,
)
from repro_torch.query.ir import (
    Bin,
    BinOp,
    Catalog,
    Col,
    Exists,
    Filter,
    GroupAgg,
    GroupAggByKey,
    Lit,
    Param,
    Project,
    Query,
    Scan,
    SemiJoin,
    TopK,
    UnaryOp,
    _FLIP_CMP,
    conjuncts,
    normalize_comparison,
    query_params,
    validate,
)
from repro_torch.query.params import _param_dtype

from .collectives import collective_script, expected_all_to_alls
from .core import (
    PlanArtifacts,
    VerifyReport,
    make_diagnostic,
    sort_diagnostics,
)
from .hlo import collectives_in_control_flow

_INF = float("inf")
_CMP_OPS = frozenset(_FLIP_CMP)


@dataclasses.dataclass
class VerifyContext:
    """Everything the analyzers see about one query."""

    query: Query
    catalog: Catalog
    wire: str = "packed"
    binding: Mapping = dataclasses.field(default_factory=dict)
    # the binding the PLAN was sized with at prepare time (auto-param
    # defaults); capacity soundness compares against it
    stats_binding: Mapping = dataclasses.field(default_factory=dict)
    # PlanContext capacity overrides keyed "<query>_sj<i>"
    capacities: Mapping = dataclasses.field(default_factory=dict)
    artifacts: Optional[PlanArtifacts] = None
    # machine roofline calibration (core.wirecal.WireCalibration)
    # for the wire-choice audit; None disables WIRE001 so the verdict
    # never depends on whatever calibration file the host happens to have
    calibration: Optional[object] = None

    @property
    def name(self) -> str:
        return self.query.name or "query"


# ---------------------------------------------------------------------------
# shared walks
# ---------------------------------------------------------------------------


def _expr_sites(root, catalog: Catalog):
    """(site label, expression, stats the expression evaluates against),
    chain order.  Semi-join/exists PREDICATES evaluate against the target
    table; everything else against the stream's base table."""
    sites = []
    base = None
    for node in _chain(root):
        if isinstance(node, Scan):
            base = node.table
            continue
        stats = catalog.table(base).stats if base else {}
        if isinstance(node, Filter):
            sites.append(("filter", node.pred, stats))
        elif isinstance(node, Project):
            for n, e in node.cols:
                sites.append((f"project.{n}", e, stats))
        elif isinstance(node, SemiJoin):
            tstats = catalog.table(node.table).stats
            sites.append((f"semijoin[{node.table}].key", node.key, stats))
            sites.append((f"semijoin[{node.table}].pred", node.pred, tstats))
        elif isinstance(node, Exists):
            tstats = catalog.table(node.table).stats
            sites.append((f"exists[{node.table}].pred", node.pred, tstats))
        elif isinstance(node, GroupAggByKey):
            sites.append(("group_by_key.key", node.key, stats))
            for a in node.aggs:
                if a.expr is not None:
                    sites.append((f"group_by_key.{a.name}", a.expr, stats))
            base = node.into
        elif isinstance(node, GroupAgg):
            for k in node.keys:
                sites.append((f"group_agg.key.{k.name}", k.expr, stats))
            for a in node.aggs:
                if a.expr is not None:
                    sites.append((f"group_agg.{a.name}", a.expr, stats))
        elif isinstance(node, TopK):
            sites.append(("topk.value", node.value, stats))
            if node.pred is not None:
                sites.append(("topk.pred", node.pred, stats))
    return sites


def _sane(lo: float, hi: float) -> tuple:
    if math.isnan(lo):
        lo = -_INF
    if math.isnan(hi):
        hi = _INF
    return (lo, hi)


def interval(e, stats, binding=None) -> tuple:
    """Conservative static ``[lo, hi]`` of an expression's value, from
    catalog column stats, Param ranges/bindings, and literals.  Unknown ->
    ``(-inf, inf)``."""
    if isinstance(e, Lit):
        v = e.value
        if isinstance(v, bool):
            return (0.0, 1.0)
        if isinstance(v, (int, float)):
            return (float(v), float(v))
        return (-_INF, _INF)
    if isinstance(e, Col):
        st = stats.get(e.name)
        return (st.lo, st.hi) if st is not None else (-_INF, _INF)
    if isinstance(e, Param):
        if binding and e.name in binding:
            try:
                v = float(binding[e.name])
                return (v, v)
            except (TypeError, ValueError):
                return (-_INF, _INF)
        if e.lo is not None and e.hi is not None:
            return (float(e.lo), float(e.hi))
        return (-_INF, _INF)
    if isinstance(e, UnaryOp):
        lo, hi = interval(e.operand, stats, binding)
        return (-hi, -lo) if e.op == "neg" else (0.0, 1.0)
    if isinstance(e, Bin):
        return (0.0, float(len(e.edges)))
    if isinstance(e, BinOp):
        if e.op in _CMP_OPS or e.op in ("and", "or"):
            return (0.0, 1.0)
        a = interval(e.lhs, stats, binding)
        b = interval(e.rhs, stats, binding)
        if e.op == "+":
            return _sane(a[0] + b[0], a[1] + b[1])
        if e.op == "-":
            return _sane(a[0] - b[1], a[1] - b[0])
        if e.op == "*":
            prods = [x * y for x in a for y in b]
            if any(math.isnan(p) for p in prods):
                return (-_INF, _INF)
            return (min(prods), max(prods))
        if e.op == "/":
            if b[0] <= 0.0 <= b[1]:
                return (-_INF, _INF)
            quots = [x / y for x in a for y in b]
            if any(math.isnan(v) for v in quots):
                return (-_INF, _INF)
            return (min(quots), max(quots))
    return (-_INF, _INF)


def _iter_divisions(e):
    if isinstance(e, BinOp):
        if e.op == "/":
            yield e
        yield from _iter_divisions(e.lhs)
        yield from _iter_divisions(e.rhs)
    elif isinstance(e, UnaryOp):
        yield from _iter_divisions(e.operand)
    elif isinstance(e, Bin):
        yield from _iter_divisions(e.child)


def _iter_comparisons(e):
    """All comparison BinOps inside a predicate tree."""
    if isinstance(e, BinOp):
        if e.op in _CMP_OPS:
            yield e
        else:
            yield from _iter_comparisons(e.lhs)
            yield from _iter_comparisons(e.rhs)
    elif isinstance(e, UnaryOp):
        yield from _iter_comparisons(e.operand)


def worst_case_binding(root, catalog: Catalog, binding=None) -> dict:
    """A concrete binding that maximizes estimated selectivity: bound
    params keep their value; unbound ranged params are pinned to the
    declared endpoint with the larger range fraction (the same endpoint
    ``stats.estimate_selectivity`` assumes when sizing capacities)."""
    witness = dict(binding or {})
    base = None
    for node in _chain(root):
        if isinstance(node, Scan):
            base = node.table
            continue
        if isinstance(node, GroupAggByKey):
            base = node.into
            continue
        if isinstance(node, Filter):
            stats = catalog.table(base).stats
            preds = conjuncts(node.pred)
        elif isinstance(node, (SemiJoin, Exists)):
            stats = catalog.table(node.table).stats
            preds = conjuncts(node.pred)
        else:
            continue
        for pred in preds:
            norm = normalize_comparison(pred)
            if norm is None:
                continue
            col, op, v = norm
            if not isinstance(v, Param) or v.name in witness:
                continue
            if v.lo is None or v.hi is None:
                continue
            st = stats.get(col)
            if st is None or op in ("==", "!="):
                pick = v.lo
            else:
                at_lo = qstats._range_fraction(st, op, float(v.lo))
                at_hi = qstats._range_fraction(st, op, float(v.hi))
                pick = v.lo if at_lo >= at_hi else v.hi
            witness[v.name] = np.dtype(v.dtype).type(pick).item()
    return witness


# ---------------------------------------------------------------------------
# analyzer 1: collective consistency (SPMD001-004)
# ---------------------------------------------------------------------------


def check_collectives(ctx: VerifyContext):
    out = []
    script = collective_script(ctx.query, ctx.catalog, wire=ctx.wire,
                               binding=dict(ctx.stats_binding) or None)
    scripts = {"<derived>": script}
    art = ctx.artifacts

    if art is not None and art.shard_scripts:
        shard = {k: tuple(v) for k, v in art.shard_scripts.items()}
        ranks = sorted(shard)
        ref_rank, ref = ranks[0], shard[ranks[0]]
        for rank in ranks[1:]:
            s = shard[rank]
            for i in range(max(len(ref), len(s))):
                a = ref[i].describe() if i < len(ref) else "<end of program>"
                b = s[i].describe() if i < len(s) else "<end of program>"
                same = (i < len(ref) and i < len(s)
                        and ref[i].signature() == s[i].signature())
                if not same:
                    out.append(make_diagnostic(
                        "SPMD001",
                        f"shards {ref_rank} and {rank} issue different "
                        f"collective sequences — first divergence at "
                        f"collective #{i}: {a} vs {b}; the program "
                        f"deadlocks at the earlier of the two",
                        query=ctx.name, site=f"collective#{i}",
                        shards=(ref_rank, rank), index=i))
                    break
            else:
                continue
            break
        scripts.update({f"shard{r}": s for r, s in shard.items()})

    reported = set()
    for s in scripts.values():
        for op in s:
            if op.guard is not None and ("guard", op.source) not in reported:
                reported.add(("guard", op.source))
                out.append(make_diagnostic(
                    "SPMD002",
                    f"collective {op.describe()} is gated by the "
                    f"data-dependent predicate {op.guard!r}; a shard whose "
                    f"data skips the branch hangs every peer inside it",
                    query=ctx.name, site=op.source, guard=op.guard))
            elif op.in_loop and ("loop", op.source) not in reported:
                reported.add(("loop", op.source))
                out.append(make_diagnostic(
                    "SPMD003",
                    f"collective {op.describe()} executes inside a "
                    f"data-dependent loop; safe only if every shard runs "
                    f"the identical trip count",
                    query=ctx.name, site=op.source))

    if art is not None and art.hlo:
        for f in collectives_in_control_flow(art.hlo):
            kinds = ", ".join(f"{k} x{c}" for k, c in f.kinds)
            if f.region == "conditional":
                out.append(make_diagnostic(
                    "SPMD002",
                    f"HLO conditional branch {f.computation!r} executes "
                    f"collectives ({kinds}); shards taking different "
                    f"branches deadlock",
                    query=ctx.name, site=f.computation, kinds=f.kinds))
            else:
                out.append(make_diagnostic(
                    "SPMD003",
                    f"HLO while computation {f.computation!r} executes "
                    f"collectives ({kinds}) — safe only if every shard "
                    f"runs the same trip count",
                    query=ctx.name, site=f.computation, kinds=f.kinds))

    if art is not None and art.instructions is not None:
        expected = expected_all_to_alls(script)
        actual = sum(1 for i in art.instructions if i.kind == "all-to-all")
        if actual != expected:
            out.append(make_diagnostic(
                "SPMD004",
                f"the plan's collectives hold {actual} all-to-all(s) but "
                f"the static model expects {expected} (2 per packed "
                f"request semi-join, 3 per raw)",
                query=ctx.name, site="all-to-all",
                expected=expected, actual=actual))
    return out


# ---------------------------------------------------------------------------
# analyzer 2: capacity soundness (CAP001)
# ---------------------------------------------------------------------------


def check_capacity(ctx: VerifyContext):
    out = []
    root = ctx.query.root
    prepared = decide_semijoins(
        root, ctx.catalog, query_name=ctx.query.name, wire=ctx.wire,
        binding=dict(ctx.stats_binding) or None)
    requests = {nid: p for nid, p in prepared.items() if p.alt == "request"}
    if not requests:
        return out
    witness = worst_case_binding(root, ctx.catalog, ctx.binding)
    required = decide_semijoins(
        root, ctx.catalog, query_name=ctx.query.name, wire=ctx.wire,
        binding=witness or None)
    for nid, plan in requests.items():
        effective = int(ctx.capacities.get(plan.key, plan.capacity))
        need = int(required[nid].derived_capacity)
        if need > effective:
            shown = {k: witness[k] for k in sorted(witness)}
            out.append(make_diagnostic(
                "CAP001",
                f"request semi-join {plan.key} against {plan.table!r} has "
                f"buffer capacity {effective} but binding {shown} needs "
                f"{need}; executing it would overflow the exchange",
                query=ctx.name, site=plan.key, table=plan.table,
                capacity=effective, required=need, binding=shown))
    return out


# ---------------------------------------------------------------------------
# analyzer 3: recompilation hazards (RCP001-003)
# ---------------------------------------------------------------------------


def check_recompilation(ctx: VerifyContext):
    out = []
    root = ctx.query.root
    if isinstance(root, GroupAgg) and root.method == "kernel":
        n_lits = sum(
            1
            for node in _chain(root)
            if isinstance(node, (Filter, SemiJoin))
            or (isinstance(node, TopK) and node.pred is not None)
            for cmp_ in _iter_comparisons(node.pred)
            for side in (cmp_.lhs, cmp_.rhs)
            if isinstance(side, Lit))
        if n_lits:
            out.append(make_diagnostic(
                "RCP002",
                f"method='kernel' grouped aggregation skips "
                f"auto-parameterization; {n_lits} predicate literal(s) "
                f"are baked into the fused kernel and any new value "
                f"compiles a fresh executable",
                query=ctx.name, site="group_agg", literals=n_lits))
        return out

    for node in _chain(root):
        if isinstance(node, Filter):
            site, pred, canonicalized = "filter", node.pred, True
        elif isinstance(node, SemiJoin):
            site, pred, canonicalized = f"semijoin[{node.table}]", node.pred, True
        elif isinstance(node, TopK) and node.pred is not None:
            site, pred, canonicalized = "topk", node.pred, True
        elif isinstance(node, Exists):
            site, pred, canonicalized = f"exists[{node.table}]", node.pred, False
        else:
            continue
        for cmp_ in _iter_comparisons(pred):
            lhs_lit = isinstance(cmp_.lhs, Lit)
            rhs_lit = isinstance(cmp_.rhs, Lit)
            if lhs_lit and rhs_lit:
                out.append(make_diagnostic(
                    "RCP003",
                    f"{site} compares two literals "
                    f"({cmp_.lhs.value!r} {cmp_.op} {cmp_.rhs.value!r}); "
                    f"the constant is baked into the plan shape, so "
                    f"distinct constants compile distinct plans",
                    query=ctx.name, site=site))
                continue
            for lit in ((cmp_.lhs,) if lhs_lit else ()) + (
                    (cmp_.rhs,) if rhs_lit else ()):
                if not canonicalized:
                    out.append(make_diagnostic(
                        "RCP001",
                        f"{site} predicate literal {lit.value!r} is not "
                        f"auto-parameterized (parameterize does not "
                        f"rewrite this operator); every distinct value "
                        f"compiles a fresh plan",
                        query=ctx.name, site=site, value=lit.value))
                elif _param_dtype(lit.value) is None:
                    out.append(make_diagnostic(
                        "RCP001",
                        f"{site} compares against literal {lit.value!r} "
                        f"of unparameterizable type "
                        f"{type(lit.value).__name__}; every distinct "
                        f"value compiles a fresh plan and pollutes the "
                        f"shape cache",
                        query=ctx.name, site=site, value=lit.value))
    return out


# ---------------------------------------------------------------------------
# analyzer 4: numeric hazards (NUM001-004)
# ---------------------------------------------------------------------------


def check_numeric(ctx: VerifyContext):
    out = []
    root = ctx.query.root
    catalog = ctx.catalog
    binding = dict(ctx.binding) or None

    for site, expr, stats in _expr_sites(root, catalog):
        for div in _iter_divisions(expr):
            lo, hi = interval(div.rhs, stats, binding)
            if lo <= 0.0 <= hi:
                out.append(make_diagnostic(
                    "NUM001",
                    f"denominator of the division at {site} has static "
                    f"range [{lo}, {hi}], which contains 0 — NaN/Inf can "
                    f"enter masked lanes and poison downstream sums",
                    query=ctx.name, site=site, lo=lo, hi=hi))

    if isinstance(root, GroupAgg):
        groups = 1
        for k in root.keys:
            groups *= k.cardinality
        exprs = [k.expr for k in root.keys]
        exprs += [a.expr for a in root.aggs if a.expr is not None]
        for node in _chain(root)[:-1]:
            if isinstance(node, Project):
                exprs += [e for _, e in node.cols]
        if (1 < groups <= ONEHOT_MAX_GROUPS
                and any(_has_division(e) for e in exprs)):
            out.append(make_diagnostic(
                "NUM002",
                "division feeds the grouped aggregation's keys/measures; "
                "the vmap-batched mask@GEMM lowering is disabled (NaN "
                "guard) and execute_batch falls back to per-lane "
                "pipelines",
                query=ctx.name, site="group_agg", groups=groups))

    prepared = decide_semijoins(
        root, catalog, query_name=ctx.query.name, wire=ctx.wire,
        binding=dict(ctx.stats_binding) or None)
    base = None
    for node in _chain(root):
        if isinstance(node, Scan):
            base = node.table
            continue
        if isinstance(node, GroupAggByKey):
            base = node.into
            continue
        if not isinstance(node, SemiJoin):
            continue
        plan = prepared[id(node)]
        stats = catalog.table(base).stats
        if plan.alt != "local" and isinstance(node.key, Col):
            st = stats.get(node.key.name)
            if st is not None and st.n_distinct == 0:
                out.append(make_diagnostic(
                    "NUM004",
                    f"semi-join {plan.key} key column "
                    f"{node.key.name!r} has float stats (n_distinct=0); "
                    f"Elias-Fano key packing and owner routing assume an "
                    f"integral key domain",
                    query=ctx.name, site=plan.key, column=node.key.name))
        if plan.alt == "request" and plan.wire.packed:
            span = plan.wire.domain * max(catalog.num_nodes, 1)
            lo, hi = interval(node.key, stats, binding)
            if lo < 0.0 or hi > span - 1:
                out.append(make_diagnostic(
                    "NUM003",
                    f"semi-join {plan.key} key range [{lo}, {hi}] exceeds "
                    f"the packed wire key space [0, {span - 1}] (domain "
                    f"{plan.wire.domain} x {catalog.num_nodes} nodes); "
                    f"encode_key_buckets clips out-of-domain offsets, "
                    f"silently corrupting the lookup",
                    query=ctx.name, site=plan.key, lo=lo, hi=hi,
                    domain=plan.wire.domain))
    return out


# ---------------------------------------------------------------------------
# analyzer 5: binding vs declared Param ranges (PRM001)
# ---------------------------------------------------------------------------


def check_param_ranges(ctx: VerifyContext):
    out = []
    for p in query_params(ctx.query.root):
        if (p.lo is None and p.hi is None) or p.name not in ctx.binding:
            continue
        v = ctx.binding[p.name]
        try:
            fv = float(v)
        except (TypeError, ValueError):
            continue  # castability is the driver's eager binding check
        lo = -_INF if p.lo is None else float(p.lo)
        hi = _INF if p.hi is None else float(p.hi)
        if math.isnan(fv) or fv < lo or fv > hi:
            out.append(make_diagnostic(
                "PRM001",
                f"binding {p.name}={v!r} lies outside the declared range "
                f"[{p.lo}, {p.hi}]; exchange capacities were sized for "
                f"in-range bindings only",
                query=ctx.name, site=p.name, value=v, lo=p.lo, hi=p.hi))
    return out


# ---------------------------------------------------------------------------
# analyzer 6: wire-choice audit under a machine calibration (WIRE001)
# ---------------------------------------------------------------------------


def check_wire_choice(ctx: VerifyContext):
    """Audit forced-packed request exchanges against the roofline latency
    model.  Only runs when the caller supplies an explicit calibration —
    the prediction depends on measured codec/link throughputs, and a
    verifier must not change verdicts because of a stray calibration file
    on the host."""
    out = []
    cal = ctx.calibration
    if cal is None or ctx.wire != "packed":
        return out
    prepared = decide_semijoins(
        ctx.query.root, ctx.catalog, query_name=ctx.query.name,
        wire=ctx.wire, binding=dict(ctx.stats_binding) or None)
    P = max(ctx.catalog.num_nodes, 1)
    for plan in prepared.values():
        if plan.alt != "request" or not plan.wire.packed:
            continue
        cap = int(ctx.capacities.get(plan.key, plan.capacity))
        pc, pw = wirecal.predict_alt1_ms(cap, P, plan.wire.domain,
                                         packed=True, cal=cal)
        rc, rw = wirecal.predict_alt1_ms(cap, P, plan.wire.domain,
                                         packed=False, cal=cal)
        if pc + pw > rc + rw:
            out.append(make_diagnostic(
                "WIRE001",
                f"request semi-join {plan.key} is forced onto the packed "
                f"wire, but the calibration predicts it at "
                f"{pc + pw:.3g} ms (codec {pc:.3g} + wire {pw:.3g}) vs "
                f"{rc + rw:.3g} ms raw — the codec costs more than the "
                f"link saves; use wire='raw' or recalibrate",
                query=ctx.name, site=plan.key, table=plan.table,
                packed_ms=pc + pw, raw_ms=rc + rw,
                codec_ms=pc, wire_ms=pw))
    return out


# ---------------------------------------------------------------------------
# analyzer 7: compressed-residency scan audit (SCAN001)
# ---------------------------------------------------------------------------


def check_scan(ctx: VerifyContext):
    """SCAN001: a filter over a packed base-table column whose shape the
    code-space rewrite (``query.stats.scan_rewrite``) cannot serve —
    column-vs-column, arithmetic on the column, non-comparison — forces a
    full decode of the compressed column before the predicate runs.  Only
    Filter conjuncts over the scan stream are in scope: semi-join/exists
    TARGET predicates evaluate on the probe path, not the scan kernel, so
    they decode by design and are not reported."""
    out = []
    for per in decide_scans(ctx.query.root, ctx.catalog).values():
        for conj, ds in per:
            for d in ds:
                if d.rewritable:
                    continue
                out.append(make_diagnostic(
                    "SCAN001",
                    f"filter conjunct over packed column {d.column!r} of "
                    f"{d.table!r} (width {d.width}) is not rewritable into "
                    f"a code-space range test; the scan decodes the full "
                    f"column ({d.scan_bytes} B/node instead of a packed "
                    f"scan) — restructure the predicate as "
                    f"<col> <op> <scalar> to keep it on packed words",
                    query=ctx.name, site=f"scan[{d.table}.{d.column}]",
                    table=d.table, column=d.column, width=d.width))
    return out


ANALYZERS = (
    check_collectives,
    check_capacity,
    check_recompilation,
    check_numeric,
    check_param_ranges,
    check_wire_choice,
    check_scan,
)


def verify(query, catalog: Catalog, *, wire: str = "packed", binding=None,
           stats_binding=None, capacities=None,
           artifacts: Optional[PlanArtifacts] = None,
           calibration=None) -> VerifyReport:
    """Statically verify one query against ``catalog``: run every
    registered analyzer and return a :class:`VerifyReport`.

    ``binding`` is the execute-time binding under scrutiny (may be partial
    or empty — unbound ranged params are analyzed at their worst declared
    endpoint); ``stats_binding`` is the prepare-time binding the plan's
    capacities were derived from (the auto-parameterization defaults);
    ``capacities`` are the driver's PlanContext overrides; ``artifacts``
    optionally supplies lowering outputs (per-shard collective scripts,
    HLO text, the collective record of a run) for the SPMD analyzers;
    ``calibration`` (a :class:`repro_torch.core.wirecal.WireCalibration`)
    enables the WIRE001 wire-choice audit against that machine's
    roofline model.
    """
    if not isinstance(query, Query):
        query = Query(root=query)
    validate(query.root, catalog)
    ctx = VerifyContext(
        query=query,
        catalog=catalog,
        wire=wire,
        binding=dict(binding or {}),
        stats_binding=dict(stats_binding or {}),
        capacities=dict(capacities or {}),
        artifacts=artifacts,
        calibration=calibration,
    )
    diags = []
    for analyzer in ANALYZERS:
        diags.extend(analyzer(ctx))
    return VerifyReport(query=query.name or "",
                        diagnostics=sort_diagnostics(diags))
