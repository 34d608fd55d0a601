"""The port's static plan verifier (``repro_torch.query.verify``) against
the JAX package's: the rule registry, the seeded bad-plan corpus, the
driver's ``check`` on every ``--lint`` target, CAP001's witness binding
overflowing at run time, the HLO control-flow scanner, and the
launcher's ``--lint``.

The JAX side reads ``tests/fixtures/bad_plans.py`` as it is; the port's
corpus is the same plans rebuilt from the port's own types (IR, catalog,
``CollectiveOp``, ``PlanArtifacts``, ``WireCalibration``, and its
collective record type for the HLO count).  Both drivers are made here,
in one process, so their generated tables agree (SF 0.01, seed 0, 8
nodes; the port on the CPU); neither builds cubes, so no query routes to
tier 1 on one side only.
"""
from __future__ import annotations

import dataclasses
import importlib

import pytest

from fixtures.bad_plans import BAD_PLANS
from repro.core.plans import REGISTRY as JREGISTRY
from repro.launch import serve_olap as jserve_olap
from repro.query.verify import RULES as JRULES
from repro.query.verify import collectives_in_control_flow as jscan
from repro.query.verify import verify as jverify
from repro.tpch import queries as jq
from repro.tpch.driver import TPCHDriver as JTPCHDriver
from repro.tpch.schema import day
from repro_torch.core.engine import CollectiveInstr
from repro_torch.launch import serve_olap
from repro_torch.query.verify import RULES, collectives_in_control_flow, verify
from repro_torch.tpch import queries as tq
from repro_torch.tpch.driver import TPCHDriver

SF = 0.01


@pytest.fixture(scope="module")
def jax_drv(cluster):
    return JTPCHDriver(sf=SF, cluster=cluster, seed=0)


@pytest.fixture(scope="module")
def port_drv():
    return TPCHDriver(SF, num_nodes=8, seed=0, device="cpu")


def _port(x):
    """The port's counterpart of a JAX-package object of the corpus: each
    dataclass rebuilt as the same-named class of ``repro_torch`` (the
    HLO's ``CollectiveInstr`` as the port's collective record type) from
    its converted fields."""
    if isinstance(x, (list, tuple)):
        return type(x)(_port(v) for v in x)
    if isinstance(x, dict):
        return {k: _port(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        name = type(x).__name__
        if name == "CollectiveInstr":
            cls = CollectiveInstr
        else:
            module = type(x).__module__.replace("repro.", "repro_torch.", 1)
            cls = getattr(importlib.import_module(module), name)
        return cls(**{f.name: _port(getattr(x, f.name))
                      for f in dataclasses.fields(x) if f.init})
    return x


def _modules(x) -> set:
    """The top-level packages of every dataclass inside ``x``."""
    if isinstance(x, (list, tuple)):
        return set().union(*(_modules(v) for v in x)) if x else set()
    if isinstance(x, dict):
        return _modules(list(x.values()))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {type(x).__module__.split(".")[0]} | _modules(
            [getattr(x, f.name) for f in dataclasses.fields(x)])
    return set()


def _findings(rep) -> list:
    return [(d.rule_id, d.severity, d.site, dict(d.data))
            for d in rep.diagnostics]


def test_rule_registry_matches_jax():
    assert list(RULES) == list(JRULES)
    for rid, rule in RULES.items():
        theirs = JRULES[rid]
        assert (rule.id, rule.severity, rule.title) == (
            theirs.id, theirs.severity, theirs.title)
        assert rule.summary


@pytest.mark.parametrize("case", BAD_PLANS, ids=[c.name for c in BAD_PLANS])
def test_bad_plan_fires_as_in_jax(case):
    query, catalog, kwargs = (_port(case.query), _port(case.catalog),
                              _port(case.kwargs))
    assert _modules([query, catalog, kwargs]) <= {"repro_torch"}
    mine = verify(query, catalog, **kwargs)
    theirs = jverify(case.query, case.catalog, **case.kwargs)
    assert case.expected_rule in mine.rule_ids(), mine.text()
    assert case.expected_rule in theirs.rule_ids(), theirs.text()
    assert _findings(mine) == _findings(theirs)


def _lint_targets(registry, queries) -> list:
    targets = [(name, qd.ir) for name, qd in registry.items()
               if qd.ir is not None]
    targets += [(f"{name}_param", make())
                for name, make in queries.PARAM_QUERIES.items()]
    targets += [(name, make())
                for name, make in queries.SERVING_QUERIES.items()]
    return targets


def test_check_matches_jax_on_every_lint_target(jax_drv, port_drv):
    from repro_torch.core.plans import REGISTRY

    mine = _lint_targets(REGISTRY, tq)
    theirs = _lint_targets(JREGISTRY, jq)
    assert [n for n, _ in mine] == [n for n, _ in theirs]
    assert len(mine) == 12
    for (name, q), (_, jqry) in zip(mine, theirs):
        a, b = port_drv.check(q), jax_drv.check(jqry)
        assert _findings(a) == _findings(b), name
        assert a.text() == b.text(), name


def test_capacity_diagnostic_reproduces_runtime_overflow(jax_drv, port_drv):
    q, jqry = tq.q14_promo_ir(alt="request"), jq.q14_promo_ir(alt="request")
    assert port_drv.check(q).clean
    wide = {"_p0": day(1992, 1, 1), "_p1": day(1998, 12, 1)}
    rep = port_drv.check(q, params=wide)
    assert _findings(rep) == _findings(jax_drv.check(jqry, params=wide))
    cap = [d for d in rep.errors if d.rule_id == "CAP001"]
    assert cap, rep.text()
    assert cap[0].data["required"] > cap[0].data["capacity"]
    ans = port_drv.prepare(q).execute(cap[0].data["binding"])
    assert ans.overflow, "CAP001's witness binding did not overflow"


_HLO_WHILE = """
HloModule m

%body (p: s32[8]) -> s32[8] {
  %p = s32[8] parameter(0)
  ROOT %ar = s32[8] all-reduce(%p), to_apply=%add
}

%cond (p: s32[8]) -> pred[] {
  %p = s32[8] parameter(0)
  ROOT %lt = pred[] constant(true)
}

ENTRY %main (x: s32[8]) -> s32[8] {
  %x = s32[8] parameter(0)
  ROOT %w = s32[8] while(%x), condition=%cond, body=%body
}
"""

_HLO_STRAIGHT = """
HloModule m

ENTRY %main (x: s32[8]) -> s32[8] {
  %x = s32[8] parameter(0)
  ROOT %ar = s32[8] all-reduce(%x), to_apply=%add
}
"""


@pytest.mark.parametrize("text,hits", [(_HLO_WHILE, True),
                                       (_HLO_STRAIGHT, False)],
                         ids=["while", "straight"])
def test_hlo_scanner_matches_jax(text, hits):
    mine = [dataclasses.astuple(f) for f in collectives_in_control_flow(text)]
    assert mine == [dataclasses.astuple(f) for f in jscan(text)]
    assert bool(mine) == hits


def test_lint_matches_jax(jax_drv, port_drv, capsys):
    assert serve_olap._lint(port_drv) == 0
    mine = capsys.readouterr().out
    assert jserve_olap._lint(jax_drv) == 0
    theirs = capsys.readouterr().out
    assert mine == theirs
    assert "12 plans verified, 0 with errors/warnings" in mine
