"""HLO control-flow scan: find collectives executing under data-dependent
control flow (``while`` bodies, ``conditional`` branches) in HLO text.

Works on both pre-optimization (``lowered.as_text(dialect="hlo")``) and
post-optimization (``compiled.as_text()``) HLO — the textual syntax is the
same: named computations with brace-delimited bodies, ``while``
instructions naming ``condition=``/``body=`` computations, and
``conditional`` instructions naming branch computations.  Collectives are
attributed transitively: a collective inside a fusion/call reached from a
while body counts as inside the loop.

Counterpart of ``repro.query.verify.hlo``: pure text parsing, so rules
SPMD002 and SPMD003 fire on HLO text given as ``PlanArtifacts(hlo=...)``.
The port's eager plans produce no HLO of their own.
"""
from __future__ import annotations

import dataclasses
import re
from collections import Counter

# the collective kinds of an HLO module (``repro.launch.roofline``'s list)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_COMMENT_RE = re.compile(r"/\*.*?\*/", re.S)
_COMP_HEAD_RE = re.compile(
    r"^\s*(?:ENTRY\s+)?%?(?P<name>[\w.\-]+)\s*(?:\([^)]*\))?"
    r"\s*(?:->\s*[^{]*)?\{\s*$")
_OPCODE_RE = re.compile(r"=\s*\S+\s+([\w-]+)\(")
_REF_RE = re.compile(
    r"(?:condition|body|to_apply|true_computation|false_computation)"
    r"=%?([\w.\-]+)")
_REF_SET_RE = re.compile(
    r"(?:branch_computations|called_computations|calls)=\{([^}]*)\}")
_WHILE_RE = re.compile(
    r"\bwhile\(.*?condition=%?([\w.\-]+).*?body=%?([\w.\-]+)", re.S)
_COND_RE = re.compile(r"\bconditional\(")


def _collective_kind(opcode: str):
    for kind in COLLECTIVES:
        if opcode == kind or opcode.startswith(kind + "-"):
            return kind
    return None


@dataclasses.dataclass(frozen=True)
class ControlFlowCollective:
    """Collectives found (transitively) inside one control-flow region."""

    region: str       # "while" | "conditional"
    computation: str  # the body/branch computation containing them
    kinds: tuple      # ((collective kind, count), ...) sorted by kind


def _parse_computations(text: str):
    """computation name -> (direct collective Counter, referenced comps,
    raw body text)."""
    comps = {}
    current = None
    for line in text.splitlines():
        head = _COMP_HEAD_RE.match(line)
        if head is not None and "=" not in line.split("{")[0]:
            current = head.group("name")
            comps[current] = (Counter(), set(), [])
            continue
        if current is None:
            continue
        if line.strip() == "}":
            current = None
            continue
        direct, refs, body = comps[current]
        body.append(line)
        m = _OPCODE_RE.search(line)
        if m is not None:
            kind = _collective_kind(m.group(1))
            if kind is not None:
                direct[kind] += 1
        for ref in _REF_RE.findall(line):
            refs.add(ref)
        for group in _REF_SET_RE.findall(line):
            for ref in re.findall(r"%?([\w.\-]+)", group):
                refs.add(ref)
    return comps


def _transitive_collectives(name, comps, memo, stack=()):
    if name in memo:
        return memo[name]
    if name not in comps or name in stack:
        return Counter()
    direct, refs, _ = comps[name]
    total = Counter(direct)
    for ref in refs:
        total.update(_transitive_collectives(ref, comps, memo,
                                             stack + (name,)))
    memo[name] = total
    return total


def collectives_in_control_flow(hlo_text: str) -> tuple:
    """All ``while`` bodies/conditions and ``conditional`` branches that
    (transitively) execute a collective, as
    :class:`ControlFlowCollective` findings."""
    text = _COMMENT_RE.sub("", hlo_text)
    comps = _parse_computations(text)
    memo = {}
    findings = []
    seen = set()

    def _report(region, comp_name):
        if (region, comp_name) in seen:
            return
        seen.add((region, comp_name))
        kinds = _transitive_collectives(comp_name, comps, memo)
        if kinds:
            findings.append(ControlFlowCollective(
                region=region, computation=comp_name,
                kinds=tuple(sorted(kinds.items()))))

    for name, (_, _, body) in comps.items():
        body_text = "\n".join(body)
        for cond_name, body_name in _WHILE_RE.findall(body_text):
            _report("while", body_name)
            _report("while", cond_name)
        for line in body:
            if _COND_RE.search(line):
                for ref in _REF_RE.findall(line):
                    _report("conditional", ref)
                for group in _REF_SET_RE.findall(line):
                    for ref in re.findall(r"%?([\w.\-]+)", group):
                        _report("conditional", ref)
    return tuple(findings)
