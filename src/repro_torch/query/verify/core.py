"""Verifier core: the rule registry, diagnostics, and report types.

Counterpart of ``repro.query.verify.core``.  A *rule* is a stable,
documented property of a lowered plan (``docs/RULES.md`` catalogs them;
the IDs, severities and titles are the JAX package's).  Analyzers in
:mod:`.rules` emit :class:`Diagnostic` instances referencing rules by ID;
the public :func:`repro_torch.query.verify.verify` entry point collects
them into a :class:`VerifyReport`.  Nothing in this module executes a
plan.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

ERROR = "error"
WARN = "warn"
INFO = "info"
SEVERITIES = (ERROR, WARN, INFO)
_SEV_ORDER = {s: i for i, s in enumerate(SEVERITIES)}


@dataclasses.dataclass(frozen=True)
class Rule:
    """A registered static-analysis rule with a stable ID."""

    id: str
    severity: str
    title: str
    summary: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r} for {self.id}")


RULES: dict = {}


def register_rule(id: str, severity: str, title: str, summary: str) -> Rule:
    if id in RULES:
        raise ValueError(f"duplicate rule id {id!r}")
    rule = Rule(id=id, severity=severity, title=title, summary=summary)
    RULES[id] = rule
    return rule


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: a rule violation (or advisory) at a plan site."""

    rule_id: str
    severity: str
    message: str
    query: str = ""
    site: str = ""   # plan construct ("lineitem_sj0", "group_agg", ...)
    data: Mapping = dataclasses.field(default_factory=dict)

    def format(self) -> str:
        where = f" {self.site}:" if self.site else ""
        return f"[{self.rule_id} {self.severity}]{where} {self.message}"


def make_diagnostic(rule_id: str, message: str, *, query: str = "",
                    site: str = "", **data) -> Diagnostic:
    """Diagnostic whose severity comes from the registered rule."""
    rule = RULES[rule_id]
    return Diagnostic(rule_id=rule_id, severity=rule.severity,
                      message=message, query=query, site=site, data=data)


@dataclasses.dataclass(frozen=True)
class PlanArtifacts:
    """Optional lowering/compilation artifacts the analyzers can consume
    beyond the IR + catalog:

    - ``shard_scripts``: per-shard program-ordered collective scripts
      (rank -> tuple of :class:`~.collectives.CollectiveOp`).  Scripts
      derived from one IR tree are identical by construction, so this is
      how divergent/fixture plans reach the SPMD analyzers.
    - ``instructions``: program-ordered collective records, anything with
      ``.kind`` and ``.bytes`` — in the port the collective record of a
      run (``core.exchange.collective_record()``, of
      :class:`repro_torch.core.engine.CollectiveInstr`), for
      cross-checking the static collective model against what ran.
    - ``hlo``: HLO text, scanned for collectives under data-dependent
      control flow (``while`` bodies, ``conditional`` branches); the port
      produces none, the scanner reads any given text.
    """

    shard_scripts: Optional[Mapping] = None
    instructions: Optional[tuple] = None
    hlo: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class VerifyReport:
    """All diagnostics for one query, ordered most-severe first."""

    query: str
    diagnostics: tuple

    @property
    def errors(self) -> tuple:
        return tuple(d for d in self.diagnostics if d.severity == ERROR)

    @property
    def warnings(self) -> tuple:
        return tuple(d for d in self.diagnostics if d.severity == WARN)

    @property
    def infos(self) -> tuple:
        return tuple(d for d in self.diagnostics if d.severity == INFO)

    @property
    def ok(self) -> bool:
        """No errors (warnings and advisories allowed)."""
        return not self.errors

    @property
    def clean(self) -> bool:
        """No errors and no warnings (info advisories allowed)."""
        return not self.errors and not self.warnings

    def rule_ids(self) -> frozenset:
        return frozenset(d.rule_id for d in self.diagnostics)

    def text(self) -> str:
        head = f"VERIFY {self.query or '<anonymous>'}: " + (
            "clean" if self.clean else
            f"{len(self.errors)} error(s), {len(self.warnings)} warning(s), "
            f"{len(self.infos)} advisory(ies)")
        lines = [head]
        lines.extend("  " + d.format() for d in self.diagnostics)
        return "\n".join(lines)


def sort_diagnostics(diags: Sequence[Diagnostic]) -> tuple:
    return tuple(sorted(
        diags, key=lambda d: (_SEV_ORDER[d.severity], d.rule_id, d.site)
    ))


# ---------------------------------------------------------------------------
# the rule catalog (docs/RULES.md mirrors this, one section per ID)
# ---------------------------------------------------------------------------

register_rule(
    "SPMD001", ERROR, "Divergent collective sequence",
    "Shards issue different collective sequences; the SPMD program "
    "deadlocks at the first mismatched collective.")
register_rule(
    "SPMD002", ERROR, "Data-dependent collective guard",
    "A collective is gated by data-dependent control flow; shards that "
    "branch differently hang their peers.")
register_rule(
    "SPMD003", WARN, "Collective inside data-dependent loop",
    "A collective executes inside a loop whose trip count can depend on "
    "data; all shards must iterate in lockstep for it to be safe.")
register_rule(
    "SPMD004", WARN, "Collective count mismatch vs static model",
    "The all-to-all count of the plan's collectives (the JAX package's "
    "lowered HLO; the port's collective record) disagrees with its static "
    "collective model (2 per packed request semi-join, 3 per raw).")
register_rule(
    "CAP001", ERROR, "Exchange capacity unsound for declared bindings",
    "A worst-case parameter binding drives a request exchange past its "
    "derived buffer capacity; execution would raise the overflow flag.")
register_rule(
    "PRM001", ERROR, "Binding outside declared Param range",
    "A bound parameter value lies outside the Param's declared lo/hi "
    "range; capacities were only proven for in-range bindings.")
register_rule(
    "RCP001", WARN, "Unparameterizable comparison literal",
    "A predicate compares against a literal params.parameterize cannot "
    "canonicalize (non-numeric dtype); every distinct value compiles a "
    "fresh executable and pollutes the plan cache.")
register_rule(
    "RCP002", INFO, "Kernel plan skips auto-parameterization",
    "method='kernel' grouped aggregation bakes predicate literals into "
    "the fused filter+aggregate kernel (the CUDA B2 in the port); "
    "re-running with different literals lowers a new plan.")
register_rule(
    "RCP003", WARN, "Constant comparison baked into plan shape",
    "A literal-vs-literal comparison is constant-foldable but still part "
    "of the cached plan shape; distinct constants compile distinct plans.")
register_rule(
    "NUM001", WARN, "Division by possibly-zero denominator",
    "A division's denominator interval (from catalog stats and Param "
    "ranges) contains zero; NaN/Inf can enter masked lanes.")
register_rule(
    "NUM002", INFO, "Division disables batched GEMM lowering",
    "Division feeding a grouped aggregation disables the batched "
    "lane-mask product (mask @ (onehot x measures), a NaN guard); batched "
    "lanes fall back to per-lane pipelines.")
register_rule(
    "NUM003", ERROR, "Semi-join key can exceed packed wire domain",
    "A request semi-join key's static range exceeds the packed wire "
    "format's P*domain key space; encode_key_buckets clips out-of-domain "
    "offsets, silently corrupting lookups.")
register_rule(
    "NUM004", WARN, "Non-integral semi-join key",
    "A semi-join key column has float (n_distinct=0) catalog stats; "
    "Elias-Fano key packing and owner routing assume integral keys.")
register_rule(
    "SCAN001", WARN, "Packed column scanned outside code space",
    "A filter references a compressed-resident (packed) column with a "
    "predicate that cannot be rewritten into a code-space range test "
    "(column-vs-column, arithmetic on the column, non-comparison shape); "
    "the column is fully decoded before the predicate runs, forfeiting "
    "the predicate-on-packed bandwidth savings.")
register_rule(
    "WIRE001", INFO, "Forced packed wire predicted slower than raw",
    "The wire= override forces the packed codec on a request exchange, "
    "but the supplied machine calibration's roofline model predicts the "
    "codec time exceeds the raw link-time savings; raw would be faster.")
