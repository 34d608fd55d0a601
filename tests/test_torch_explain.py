"""The port's wire and scan calibrations (``core.wirecal``,
``core.scancal``), the latency-model wire choice (``wire="auto"``), and
EXPLAIN / EXPLAIN ANALYZE against the JAX package's.

The predictors are pure arithmetic, so both packages must give the same
floats; a calibration saved by either loads in the other.  Both drivers
are made here, in one process, so their generated tables agree (SF 0.01,
seed 0, 8 nodes; the port on the CPU); neither builds cubes.  Each test
points the port's calibration variables at builtin-rate files of its own,
so no calibration file in the checkout changes a plan.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re

import numpy as np
import pytest

from repro.core import scancal as jscancal
from repro.core import wirecal as jwirecal
from repro.core.plans import REGISTRY as JREGISTRY
from repro.query.lower import decide_semijoins as jdecide
from repro.tpch import queries as jq
from repro.tpch.driver import TPCHDriver as JTPCHDriver
from repro_torch.core import scancal, wirecal
from repro_torch.core.plans import REGISTRY
from repro_torch.query.lower import decide_semijoins, lower
from repro_torch.tpch import queries as tq
from repro_torch.tpch.driver import TPCHDriver

SF = 0.01

# a machine whose link far outruns the codec (codec-bound: raw wins) and
# one whose codec far outruns the link (link-bound: packed wins)
CALS = {
    "codec_bound": dict(encode_gbps=0.002, decode_gbps=0.003,
                        link_gbps=200.0, msg_ms=0.0, source="test"),
    "link_bound": dict(encode_gbps=300.0, decode_gbps=250.0,
                       link_gbps=0.01, msg_ms=0.5, source="test"),
}


@pytest.fixture(autouse=True)
def _builtin_calibrations(tmp_path, monkeypatch):
    for var, cal in ((wirecal.ENV_VAR, wirecal.BUILTIN),
                     (scancal.ENV_VAR, scancal.BUILTIN)):
        path = tmp_path / f"{var}.json"
        path.write_text(json.dumps(cal.to_json()))
        monkeypatch.setenv(var, str(path))


@pytest.fixture(scope="module")
def jax_drv(cluster):
    d = JTPCHDriver(sf=SF, cluster=cluster, seed=0)
    d.wire_cal = jwirecal.BUILTIN
    return d


@pytest.fixture(scope="module")
def port_drv():
    d = TPCHDriver(SF, num_nodes=8, seed=0, device="cpu")
    d.wire_cal = wirecal.BUILTIN
    return d


def _predictions(wc, sc, wcal, scal) -> list:
    out = []
    for cap in (1, 64, 4096, 262_144):
        for P in (1, 2, 8):
            for domain in (0, 1, 3750, 1_875_000):
                out.append((wc.alt1_codec_bytes(cap, P, domain),
                            wc.predict_codec_ms(cap, P, domain, cal=wcal),
                            wc.predict_alt1_ms(cap, P, domain, packed=True,
                                               cal=wcal),
                            wc.predict_alt1_ms(cap, P, domain, packed=False,
                                               cal=wcal),
                            wc.choose_wire_kind(cap, P, domain, cal=wcal)))
            out.append(wc.predict_alt2_ms(cap * 100.0, P, cal=wcal))
    for rows in (1, 1000, 7_500_000):
        for width in (1, 7, 12, 30):
            out.append((sc.predict_packed_ms(rows, width, cal=scal),
                        sc.predict_decode_ms(rows, width, cal=scal),
                        sc.choose_scan_mode(rows, width, cal=scal)))
    return out


@pytest.mark.parametrize("which", ["builtin", "calibrated"])
def test_predictors_match_jax(which):
    if which == "builtin":
        mine = (wirecal.BUILTIN, scancal.BUILTIN)
        theirs = (jwirecal.BUILTIN, jscancal.BUILTIN)
    else:
        scan = dict(mem_gbps=3000.0, scan_gvps=150.0, unpack_gvps=20.0,
                    source="test")
        mine = (wirecal.WireCalibration(**CALS["link_bound"]),
                scancal.ScanCalibration(**scan))
        theirs = (jwirecal.WireCalibration(**CALS["link_bound"]),
                  jscancal.ScanCalibration(**scan))
    assert (_predictions(wirecal, scancal, *mine)
            == _predictions(jwirecal, jscancal, *theirs))


def test_calibration_files_load_across_packages(tmp_path):
    theirs = jwirecal.WireCalibration(**CALS["codec_bound"])
    mine = wirecal.WireCalibration.from_json(theirs.to_json())
    assert mine.to_json() == theirs.to_json()
    args = (4096, 8, 3750)
    assert (wirecal.predict_alt1_ms(*args, packed=True, cal=mine)
            == jwirecal.predict_alt1_ms(*args, packed=True, cal=theirs))
    assert wirecal.choose_wire_kind(*args, cal=mine) == "raw"
    # a file either package saves, the other loads
    path = str(tmp_path / "wire.json")
    jwirecal.save(theirs, path)
    assert wirecal.load(path) == mine
    scan = scancal.ScanCalibration(mem_gbps=1.5, scan_gvps=2.5,
                                   unpack_gvps=0.5, source="test")
    scancal.save(scan, str(tmp_path / "scan.json"))
    assert (jscancal.load(str(tmp_path / "scan.json")).to_json()
            == scan.to_json())


@pytest.mark.parametrize("mod", [wirecal, scancal],
                         ids=["wirecal", "scancal"])
def test_load_raises_for_an_explicit_file_only(mod, tmp_path, monkeypatch):
    error = mod.WireCalError if mod is wirecal else mod.ScanCalError
    missing = str(tmp_path / "missing.json")
    corrupt = tmp_path / "corrupt.json"
    corrupt.write_text("[1, 2")
    for path in (missing, str(corrupt)):
        with pytest.raises(error):
            mod.load(path)
        monkeypatch.setenv(mod.ENV_VAR, path)
        with pytest.raises(error):
            mod.load()
    # the implicit default location falls back to the builtin rates
    monkeypatch.delenv(mod.ENV_VAR)
    monkeypatch.chdir(tmp_path)
    assert mod.load() == mod.BUILTIN
    assert mod.load(missing, strict=False) == mod.BUILTIN
    # ... and is the port's own file, never the JAX package's
    assert mod.DEFAULT_PATH.endswith(
        "torch_wire_calibration.json" if mod is wirecal
        else "torch_scan_calibration.json")
    assert mod.ENV_VAR.startswith("REPRO_TORCH_")
    written = mod.save(dataclasses.replace(mod.BUILTIN, source="saved"))
    assert written == mod.DEFAULT_PATH and mod.load().source == "saved"


def test_calibrate_on_the_cpu_gives_positive_rates():
    wc = wirecal.calibrate(capacity=256, domain=300, nodes=2, repeat=2,
                           device="cpu")
    sc = scancal.calibrate(rows=4096, width=7, repeat=2, device="cpu")
    rates = (wc.encode_gbps, wc.decode_gbps, sc.mem_gbps, sc.scan_gvps,
             sc.unpack_gvps)
    assert all(math.isfinite(r) and r > 0 for r in rates), rates
    # the link knobs are inherited, not measured
    assert (wc.link_gbps, wc.msg_ms) == (wirecal.BUILTIN.link_gbps,
                                         wirecal.BUILTIN.msg_ms)
    assert "device=cpu" in wc.source and "device=cpu" in sc.source


def _decisions(decide, q, catalog, cal) -> list:
    plans = decide(q.root, catalog, query_name=q.name, wire="auto", cal=cal)
    return [(p.alt, p.capacity, p.wire.kind, p.wire.domain, p.wire.key_bits,
             p.codec_ms, p.wire_ms) for p in plans.values()]


@pytest.mark.parametrize("name", ["q4_sj", "q18_sj"])
def test_wire_auto_chooses_as_jax(name, jax_drv, port_drv, tmp_path,
                                  monkeypatch):
    q, jqry = getattr(tq, f"{name}_ir")(), getattr(jq, f"{name}_ir")()
    chosen = {}
    for label, rates in CALS.items():
        mine = _decisions(decide_semijoins, q, port_drv.catalog,
                          wirecal.WireCalibration(**rates))
        theirs = _decisions(jdecide, jqry, jax_drv.catalog,
                            jwirecal.WireCalibration(**rates))
        assert mine == theirs, label
        chosen[label] = mine[0][2]
    assert chosen == {"codec_bound": "raw", "link_bound": "packed"}
    # lowered under wire="auto" with the calibration saved as the port's
    # file, the plan takes the chosen wire and answers as that fixed wire
    for label, rates in CALS.items():
        path = tmp_path / f"{label}.json"
        wirecal.save(wirecal.WireCalibration(**rates), str(path))
        monkeypatch.setenv(wirecal.ENV_VAR, str(path))
        plan = lower(q, port_drv.catalog, wire="auto")
        assert [sj.wire.kind for sj in plan.semijoins] == [chosen[label]]
        ctx = dataclasses.replace(port_drv.ctx, wire="auto")
        out = port_drv.cluster.compile(plan, ctx)(port_drv.columns())
        fixed = port_drv.query(q, wire=chosen[label])
        assert not bool(out["overflow"]) and not fixed.overflow
        np.testing.assert_array_equal(out["value"].numpy(),
                                      fixed.value.numpy())


def _route_word(text: str) -> str:
    return re.sub(r"plan cache (HIT|MISS)", "plan cache <cache>", text)


def test_explain_matches_jax_on_every_lint_target(jax_drv, port_drv):
    targets = [(REGISTRY[n].ir, qd.ir) for n, qd in JREGISTRY.items()
               if qd.ir is not None]
    targets += [(tq.PARAM_QUERIES[n](), make())
                for n, make in jq.PARAM_QUERIES.items()]
    targets += [(tq.SERVING_QUERIES[n](), make())
                for n, make in jq.SERVING_QUERIES.items()]
    assert len(targets) == 12
    for q, jqry in targets:
        mine = port_drv.explain(q)
        theirs = jax_drv.explain(jqry)
        assert _route_word(mine.text()) == _route_word(theirs.text())
        assert not mine.analyzed


@pytest.mark.parametrize("name", ["q4_sj", "q18_sj"])
def test_explain_analyze_attributes_bytes_as_jax(name, jax_drv, port_drv):
    mine = port_drv.explain_analyze(getattr(tq, f"{name}_ir")())
    theirs = jax_drv.explain_analyze(getattr(jq, f"{name}_ir")())

    def per_semijoin(rep):
        return [(s.alt, s.wire_kind, s.a2a_bytes, s.a2a_count)
                for s in rep.semijoins]

    assert per_semijoin(mine) == per_semijoin(theirs)
    assert all(s.a2a_bytes for s in mine.semijoins if s.alt == "request")
    for kind in ("all-to-all", "all-reduce"):
        assert (mine.observed["collective_bytes_by_op"][kind]
                == theirs.observed["collective_bytes_by_op"][kind])
        assert (mine.observed["collective_count_by_op"][kind]
                == theirs.observed["collective_count_by_op"][kind])
    assert mine.observed["overflow"] is False
    assert mine.observed["tier"] == 2 and mine.observed["execute_ms"] > 0
    text = mine.text()
    assert "timings: " in text and "XLA" not in text
    assert "observed all-to-all" in text
