"""EXPLAIN / EXPLAIN ANALYZE: render a query's plan with the cost model's
predictions next to what a run actually observed.

Counterpart of ``repro.obs.explain``.  ``TPCHDriver.explain(q)`` asks the
planning layer what it WOULD do — route tier, per-operator predicted
selectivities, the chosen semi-join alternative / wire format / derived
exchange capacity — without running anything.
``TPCHDriver.explain_analyze(q)`` also executes the query and fills the
observed side: the tier that served it, plan-cache hit/miss, lowering vs
execute milliseconds, the run's overflow, and per-semijoin all-to-all
bytes from the run's collective record (``core.exchange.
collective_record``, where the JAX package parses its compiled HLO),
attributed here to the plan's request exchanges in program order.
Under a process group every rank analyses the query together (lockstep)
and each reports what one process reports: the record holds a node's
bytes, whatever the rank count; the times are the rank's own clock.

This module is the pure rendering/attribution half; the driver owns the
execution and supplies the raw fields.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.query.ir import (
    Bin,
    BinOp,
    Col,
    Lit,
    Param,
    UnaryOp,
)


def fmt_expr(e) -> str:
    """Compact one-line rendering of an IR expression (params as ``:name``)."""
    if e is None:
        return "—"
    if isinstance(e, Col):
        return e.name
    if isinstance(e, Lit):
        return repr(e.value)
    if isinstance(e, Param):
        return f":{e.name}"
    if isinstance(e, BinOp):
        return f"({fmt_expr(e.lhs)} {e.op} {fmt_expr(e.rhs)})"
    if isinstance(e, UnaryOp):
        return f"{e.op} {fmt_expr(e.operand)}" if e.op == "not" \
            else f"-{fmt_expr(e.operand)}"
    if isinstance(e, Bin):
        return f"bin({fmt_expr(e.child)}, {len(e.edges) + 1} bins)"
    return str(e)


@dataclasses.dataclass
class SemiJoinInfo:
    """One semi-join's predicted plan plus (after analyze) observed bytes."""

    index: int
    table: str
    alt: str                    # local | request | bitset
    capacity: int
    capacity_key: str
    wire_kind: str              # raw | packed
    key_bits: int
    gamma: float                # predicted target-predicate selectivity
    codec_ms: Optional[float] = None     # roofline: predicted codec time
    wire_ms: Optional[float] = None      # roofline: link volume + msg latency
    a2a_bytes: Optional[int] = None      # observed, per device
    a2a_count: Optional[int] = None

    def describe(self) -> str:
        s = f"alt={self.alt}"
        if self.alt == "request":
            s += f" cap={self.capacity} wire={self.wire_kind}"
            if self.wire_kind == "packed":
                s += f"/{self.key_bits}b"
        s += f" gamma={self.gamma:.3g}"
        if self.codec_ms is not None and self.alt != "local":
            s += (f" predict codec {self.codec_ms:.3g}ms"
                  f"+wire {self.wire_ms:.3g}ms")
        if self.a2a_bytes is not None:
            s += (f" | observed all-to-all {_fmt_bytes(self.a2a_bytes)}"
                  f" in {self.a2a_count} collectives")
        return s


def attribute_semijoin_bytes(instructions, semijoins: list) -> bool:
    """Attribute a run's all-to-alls (program-ordered records with
    ``.kind`` and ``.bytes``) to its request semi-joins, in place on
    ``semijoins``.

    A request exchange is 2 all-to-alls on packed wire (fused request,
    bitset reply) and 3 on raw (key buckets, mask, reply); bitset/local
    semi-joins use none.  Returns False — leaving the infos untouched —
    when the count doesn't match that accounting (a plan with other
    all-to-alls): the caller then reports totals only instead of
    guessing.
    """
    a2a = [i for i in instructions if i.kind == "all-to-all"]
    expected = [(2 if sj.wire_kind == "packed" else 3)
                if sj.alt == "request" else 0
                for sj in semijoins]
    if sum(expected) != len(a2a):
        return False
    pos = 0
    for sj, n in zip(semijoins, expected):
        chunk = a2a[pos:pos + n]
        pos += n
        if sj.alt == "request":
            sj.a2a_bytes = sum(i.bytes for i in chunk)
            sj.a2a_count = n
    return True


@dataclasses.dataclass
class ExplainReport:
    """Everything ``explain``/``explain_analyze`` knows about one query.

    ``plan_rows`` is the scan-first per-operator annotation list from
    ``repro_torch.query.lower.explain_chain``; ``observed`` is None for a
    plain EXPLAIN and a dict of measured fields after EXPLAIN ANALYZE.
    """

    query: str
    route_tier: int                 # 1 = cube-covered, 2 = compiled plan
    route_source: str               # cube name / plan name
    cache: str                      # "hit" | "miss" (structural plan cache)
    params: dict                    # binding the run would use
    plan_rows: list = dataclasses.field(default_factory=list)
    semijoins: list = dataclasses.field(default_factory=list)
    plan_error: Optional[str] = None   # unlowerable Tier-2 form
    observed: Optional[dict] = None
    # static-verifier findings (query.verify Diagnostic objects),
    # most-severe first; empty for a clean plan
    diagnostics: list = dataclasses.field(default_factory=list)

    @property
    def analyzed(self) -> bool:
        return self.observed is not None

    # -- rendering ----------------------------------------------------------
    def _plan_lines(self) -> list:
        lines = []
        sj_seen = 0
        for depth, row in enumerate(reversed(self.plan_rows)):
            pad = "  " * depth
            op = row["op"]
            extra = []
            if op == "Scan":
                body = f"Scan[{row['table']} rows={row['rows']}]"
                pc = row.get("packed_cols")
                if pc:
                    body += f" packed={len(pc)} cols"
            elif op == "Filter":
                body = (f"Filter[{fmt_expr(row['pred'])}] "
                        f"sel={row['sel']:.3g}")
                for d in row.get("scans") or []:
                    # one line per packed column the filter touches: the
                    # roofline's packed-vs-decode choice and its predicted
                    # per-node scan bytes (vs the raw-resident footprint)
                    extra.append(
                        pad + f"  scan {d.column}: {d.mode} w={d.width} "
                        f"bytes={_fmt_bytes(d.scan_bytes)}/node "
                        f"(raw {_fmt_bytes(d.raw_bytes)}) — {d.reason}")
            elif op == "Project":
                body = f"Project[{', '.join(row['cols'])}]"
            elif op == "SemiJoin":
                info = self.semijoins[len(self.semijoins) - 1 - sj_seen] \
                    if self.semijoins else None
                sj_seen += 1
                body = f"SemiJoin[{row['table']} key={fmt_expr(row['key'])}"
                if info is not None:
                    body += f" {info.describe()}"
                body += "]"
            elif op == "Exists":
                body = f"Exists[{row['table']} sel={row['sel']:.3g}]"
            elif op == "GroupAggByKey":
                body = f"GroupAggByKey[into={row['into']}]"
            elif op == "GroupAgg":
                body = (f"GroupAgg[groups={row['groups']} "
                        f"method={row['method']} "
                        f"aggs={', '.join(row['aggs'])}]")
            elif op == "TopK":
                body = f"TopK[k={row['k']}]"
            else:  # pragma: no cover — exhaustive over the algebra
                body = op
            lines.append(pad + body)
            lines.extend(extra)
        return lines

    def text(self) -> str:
        obs = self.observed
        head = "EXPLAIN ANALYZE" if self.analyzed else "EXPLAIN"
        tier = obs["tier"] if obs else self.route_tier
        source = obs["source"] if obs else self.route_source
        tier_desc = ("rollup cube" if tier == 1 else "compiled SPMD plan")
        lines = [
            f"{head} {self.query}",
            f"route: tier {tier} ({tier_desc}: {source}) | "
            f"plan cache {self.cache.upper()}",
        ]
        if self.params:
            body = " ".join(f"{k}={v}" for k, v in sorted(self.params.items()))
            lines.append(f"parameters: {body}")
        if self.plan_error:
            lines.append(f"tier-2 plan: unlowerable — {self.plan_error}")
        elif self.plan_rows:
            lines.append("plan (cost-model predictions"
                         + (" | observed bytes):" if self.analyzed else "):"))
            lines.extend("  " + l for l in self._plan_lines())
        if self.diagnostics:
            lines.append("diagnostics:")
            lines.extend("  " + d.format() for d in self.diagnostics)
        if obs:
            if obs.get("compile_ms") is not None:
                lines.append(
                    f"timings: compile {obs['compile_ms']:.2f} ms "
                    f"({obs['lowerings']} lowering"
                    f"{'s' if obs['lowerings'] != 1 else ''}) | "
                    f"execute {obs['execute_ms']:.3f} ms warm"
                )
            else:
                lines.append(f"timings: execute {obs['execute_ms']:.3f} ms "
                             f"(no compile — {obs['source']})")
            if obs.get("ranks", 1) > 1:
                lines.append(f"ranks: {obs['ranks']} (bytes a node, as in "
                             f"one process; times this rank's clock)")
            coll = obs.get("collective_bytes_by_op") or {}
            if coll:
                body = ", ".join(
                    f"{k} {_fmt_bytes(v)} x{obs['collective_count_by_op'][k]}"
                    for k, v in sorted(coll.items()))
                lines.append(f"collectives/device: {body}")
            enc = obs.get("exchange.encode_ms")
            dec = obs.get("exchange.decode_ms")
            if enc or dec:
                parts = []
                for tag, h in (("encode", enc), ("decode", dec)):
                    if h:
                        parts.append(f"{tag} mean {h['mean']:.3g} ms "
                                     f"(n={h['count']})")
                lines.append("codec predicted/exchange: " + ", ".join(parts))
            if obs.get("bytes_resident") or obs.get("bytes_scanned"):
                lines.append(
                    f"storage: resident "
                    f"{_fmt_bytes(obs.get('bytes_resident') or 0)} | "
                    f"scanned (cumulative) "
                    f"{_fmt_bytes(obs.get('bytes_scanned') or 0)}")
            lines.append(
                f"counters: exchange.overflow={obs['overflow_count']} "
                f"plan.compile_events={obs['compile_events']} "
                f"(this run overflowed: {obs['overflow']})"
            )
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.text()


def _fmt_bytes(n: int) -> str:
    n = int(n)
    if n >= 1 << 20:
        return f"{n / (1 << 20):.1f} MiB"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f} KiB"
    return f"{n} B"
