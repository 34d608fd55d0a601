"""The port's serving tier against the JAX package: the driver's thread
safety and dispatch gate, the continuous-batching engine (coalescing,
tier-1 inline, admission, padding, stop, failed dispatches), the workload
and its generators, and the serving launcher.

Both packages generate the tables in this one process (SF 0.005, seed 0,
8 nodes; the port on the CPU), where their seeding agrees, so their data
is identical.  The port's engine is held to ``sequential_baseline`` byte
for byte (a coalesced q1_offedge lane, the batched plan's lane-mask
product, within rtol 1e-5) and to the JAX engine within rtol 1e-5 for f32
values, counts exactly.  Every ``asyncio.run`` body is bounded by
``asyncio.wait_for`` and every thread join by a timeout, so a hang fails
its test instead of stalling a worker.
"""
from __future__ import annotations

import asyncio
import json
import sys
import threading

import numpy as np
import pytest
import torch

from repro.serve import workload as jwl
from repro.serve.olap_engine import OLAPEngine as JOLAPEngine
from repro.tpch import queries as jq
from repro.tpch.driver import TPCHDriver as JTPCHDriver
from repro_torch.launch import serve_olap
from repro_torch.serve import workload as wl
from repro_torch.serve.olap_engine import AdmissionError, OLAPEngine, _bucket
from repro_torch.tpch import queries as tq
from repro_torch.tpch.driver import PreparedQuery, TPCHDriver

SF = 0.005
WAIT_S = 120      # bound of every asyncio.run body and thread join


def _run(make_coro):
    async def bounded():
        return await asyncio.wait_for(make_coro(), WAIT_S)

    return asyncio.run(bounded())


def _threads(n, target):
    threads = [threading.Thread(target=target, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads), "a worker thread hung"


@pytest.fixture(scope="module")
def port_drv():
    d = TPCHDriver(SF, num_nodes=8, seed=0, device="cpu")
    d.build_cubes()
    return d


@pytest.fixture(scope="module")
def jax_drv(cluster):
    d = JTPCHDriver(sf=SF, cluster=cluster, seed=0)
    d.build_cubes()
    return d


def _off_edge_bindings(prep, n, seed=7, also=None):
    """q6 bindings that MISS the cube router (so they queue and batch),
    on ``also``'s router too where given."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        b = tq.random_binding("q6", rng)
        if prep.answer_tier1(prep.binding(b)) is None and (
                also is None or also.answer_tier1(also.binding(b)) is None):
            out.append(b)
    return out


def _value(ans):
    v = ans.value
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ---------------------------------------------------------------------------
# the driver under threads
# ---------------------------------------------------------------------------


def test_concurrent_prepare_execute_single_compile():
    """8 threads racing prepare() + execute() of one shape: one cache miss,
    7 hits, ONE lowering, and every thread gets the same bits."""
    d = TPCHDriver(0.002, device="cpu")
    n = 8
    binding = tq.default_binding("q6")
    barrier = threading.Barrier(n, timeout=WAIT_S)
    outs, errs = [None] * n, []

    def worker(i):
        try:
            barrier.wait()
            prep = d.prepare(tq.q6_param_ir())
            outs[i] = _value(prep.execute(binding))
        except Exception as e:  # pragma: no cover - the failure we test for
            errs.append(e)

    _threads(n, worker)
    assert not errs
    assert d.compile_events == ["q6_param"]
    assert d.obs.metrics.value("plan_cache.miss") == 1
    assert d.obs.metrics.value("plan_cache.hit") == n - 1
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


def test_concurrent_query_threads_consistent_counters():
    """query() from 12 threads (more than the cores, the switch interval
    shortened) on one literal tree: the cache counters add up to the calls
    and the plan lowers once."""
    d = TPCHDriver(0.002, device="cpu")
    n = 12
    barrier = threading.Barrier(n, timeout=WAIT_S)
    outs, errs = [None] * n, []

    def worker(i):
        try:
            barrier.wait()
            outs[i] = _value(d.query(tq.q6_ir()))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _threads(n, worker)
    finally:
        sys.setswitchinterval(interval)
    assert not errs
    mreg = d.obs.metrics
    assert mreg.value("plan_cache.hit") + mreg.value("plan_cache.miss") == n
    assert mreg.value("plan_cache.miss") == 1
    assert len(d.compile_events) == 1
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


# ---------------------------------------------------------------------------
# the continuous-batching engine
# ---------------------------------------------------------------------------


def test_engine_coalesced_batches_bit_identical_to_sequential(port_drv):
    d = port_drv
    prep = d.prepare(tq.q6_param_ir())
    bindings = _off_edge_bindings(prep, 12)
    expected = [_value(prep.execute(b)) for b in bindings]
    mreg = d.obs.metrics
    batches0 = mreg.value("serve.batches")
    lanes0 = mreg.value("serve.coalesced_lanes")

    async def go():
        async with OLAPEngine(d, max_batch=8, max_wait_us=50000) as eng:
            return await asyncio.gather(
                *[eng.submit(prep, b) for b in bindings])

    answers = _run(go)
    for got, want in zip(answers, expected):
        assert got.tier == 2 and got.overflow is False
        assert _value(got).tobytes() == want.tobytes()
    # all 12 queued before the window closed: sealed as 8 + 4, not 12 solos
    assert mreg.value("serve.batches") - batches0 == 2
    assert mreg.value("serve.coalesced_lanes") - lanes0 == 12


def test_engine_tier1_inline_never_queued(port_drv):
    d = port_drv
    prep = next(p for p in (d.prepare(make())
                            for make in tq.SERVING_QUERIES.values())
                if p.answer_tier1(p.binding()) is not None)
    mreg = d.obs.metrics
    before = (mreg.value("serve.batches"), mreg.value("serve.solo"))

    async def go():
        async with OLAPEngine(d) as eng:
            return await eng.submit(prep)

    ans = _run(go)
    assert ans.tier == 1
    assert (mreg.value("serve.batches"), mreg.value("serve.solo")) == before


def test_engine_admission_bound_rejects_past_max_queue(port_drv):
    d = port_drv
    prep = d.prepare(tq.q6_param_ir())
    bindings = _off_edge_bindings(prep, 6, seed=11)
    rejected0 = d.obs.metrics.value("serve.rejected")

    async def go():
        async with OLAPEngine(d, max_batch=16, max_wait_us=50000,
                              max_queue=3) as eng:
            tasks = [asyncio.ensure_future(eng.submit(prep, b))
                     for b in bindings]
            return await asyncio.gather(*tasks, return_exceptions=True)

    res = _run(go)
    rejected = [r for r in res if isinstance(r, AdmissionError)]
    served = [r for r in res if not isinstance(r, BaseException)]
    assert len(rejected) == 3 and len(served) == 3
    assert d.obs.metrics.value("serve.rejected") - rejected0 == 3


def test_engine_submit_when_stopped_rejected(port_drv):
    eng = OLAPEngine(port_drv)
    prep = port_drv.prepare(tq.q6_param_ir())
    with pytest.raises(AdmissionError, match="not running"):
        _run(lambda: eng.submit(prep))


def test_engine_stop_without_drain_fails_queued_requests(port_drv):
    """stop(drain=False) fails what is still queued with AdmissionError
    and dispatches nothing."""
    d = port_drv
    prep = d.prepare(tq.q6_param_ir())
    bindings = _off_edge_bindings(prep, 4, seed=17)
    batches0 = d.obs.metrics.value("serve.batches")

    async def go():
        eng = OLAPEngine(d, max_batch=16, max_wait_us=60e6)
        await eng.start()
        tasks = [asyncio.ensure_future(eng.submit(prep, b))
                 for b in bindings]
        while eng.stats()["queue_depth"] < len(bindings):
            await asyncio.sleep(0.001)
        await eng.stop(drain=False)
        return await asyncio.gather(*tasks, return_exceptions=True)

    res = _run(go)
    assert all(isinstance(r, AdmissionError) and "queued" in str(r)
               for r in res)
    assert d.obs.metrics.value("serve.batches") == batches0
    assert d.obs.metrics.value("serve.queue_depth") == 0


def test_engine_failed_dispatch_fails_its_requests(port_drv, monkeypatch):
    """A dispatch that raises fails every request of its batch with that
    error, once: nothing reruns them."""
    d = port_drv
    prep = d.prepare(tq.q6_param_ir())
    bindings = _off_edge_bindings(prep, 5, seed=19)
    calls = []

    def broken(self, rows, pad_to=None):
        calls.append(len(rows))
        raise RuntimeError("device lost")

    monkeypatch.setattr(PreparedQuery, "execute_batch", broken)

    async def go():
        async with OLAPEngine(d, max_batch=8, max_wait_us=50000) as eng:
            return await asyncio.gather(
                *[eng.submit(prep, b) for b in bindings],
                return_exceptions=True)

    res = _run(go)
    assert calls == [5]
    assert all(isinstance(r, RuntimeError) and str(r) == "device lost"
               for r in res)


def test_batch_padding_reuses_the_batched_plan(port_drv):
    """Odd batch sizes pad to the power-of-two bucket: one batched plan
    serves every lane count, the padding lanes are counted and the
    outputs are cut back to the real B."""
    d = port_drv
    prep = d.prepare(tq.q6_param_ir())
    bindings = _off_edge_bindings(prep, 3, seed=13)
    expected = [_value(prep.execute(b)) for b in bindings]

    first = prep.execute_batch(bindings, pad_to=4)
    n_lowerings = len(d.compile_events)
    pads0 = d.obs.metrics.value("driver.batch_pad_lanes")
    again = prep.execute_batch(bindings[:2], pad_to=4)
    assert len(d.compile_events) == n_lowerings
    assert d.compile_events.count("q6_param@batch") == 1
    assert d.obs.metrics.value("driver.batch_pad_lanes") - pads0 == 2
    assert first.value.shape[0] == 3 and again.value.shape[0] == 2
    assert first.overflow.shape == (3,) and again.overflow.shape == (2,)
    for lane, want in enumerate(expected):
        assert first.value[lane].numpy().tobytes() == want.tobytes()
    assert [_bucket(n, 16) for n in (1, 2, 3, 5, 9, 16, 17)] == [
        1, 2, 4, 8, 16, 16, 16]


def test_engine_lanes_and_tier1_match_jax_engine(jax_drv, port_drv):
    """The same off-edge q6 bindings coalesced by both engines, and a
    tier-1 answer from both."""
    jprep = jax_drv.prepare(jq.q6_param_ir())
    prep = port_drv.prepare(tq.q6_param_ir())
    bindings = _off_edge_bindings(prep, 10, seed=23, also=jprep)
    jserving = jax_drv.prepare(jq.SERVING_QUERIES["q1_cube"]())
    serving = port_drv.prepare(tq.SERVING_QUERIES["q1_cube"]())

    def serve(engine_cls, drv, p, s):
        async def go():
            async with engine_cls(drv, max_batch=8,
                                  max_wait_us=50000) as eng:
                lanes = await asyncio.gather(
                    *[eng.submit(p, b) for b in bindings])
                return lanes, await eng.submit(s)
        return _run(go)

    jlanes, jt1 = serve(JOLAPEngine, jax_drv, jprep, jserving)
    lanes, t1 = serve(OLAPEngine, port_drv, prep, serving)
    assert port_drv.obs.metrics.value("serve.coalesced_lanes") >= 10
    for got, want in zip(lanes, jlanes):
        assert got.tier == want.tier == 2
        np.testing.assert_allclose(_value(got), np.asarray(want.value),
                                   rtol=1e-5, atol=0)
    assert t1.tier == jt1.tier == 1 and t1.source == jt1.source
    got, want = _value(t1), np.asarray(jt1.value)
    np.testing.assert_allclose(got[:, :-1], want[:, :-1], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(got[:, -1], want[:, -1])  # count_order


# ---------------------------------------------------------------------------
# the workload and its generators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5])
def test_mixed_workload_matches_jax(jax_drv, port_drv, seed):
    items = wl.mixed_workload(port_drv, 96, seed=seed)
    jitems = jwl.mixed_workload(jax_drv, 96, seed=seed)
    assert [(i.kind, i.name, i.binding) for i in items] == [
        (i.kind, i.name, i.binding) for i in jitems]
    assert {i.kind for i in items} == {"tier1", "param", "tier2"}


def test_reports_match_jax():
    lat = [0.004, 0.001, 0.009, 0.002, 0.05, 0.003, 0.0005]
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert wl.percentile(lat, q) == jwl.percentile(lat, q)
    kinds = ["param", "tier1", "param", "tier2", "param", "tier1", "param"]

    def completions(mod):
        return [mod.Completion(mod.WorkItem(k, k, None, None), t, None,
                               ok=(i != 3))
                for i, (k, t) in enumerate(zip(kinds, lat))]

    assert wl.summarize(completions(wl), 0.25) == jwl.summarize(
        completions(jwl), 0.25)


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_load_generators_answer_as_the_sequential_baseline(port_drv, loop):
    d = port_drv
    items = wl.mixed_workload(d, 48, seed=1)
    wl.warm_workload(d, items, batch_sizes=(2, 4, 8))
    seq = wl.sequential_baseline(d, items)
    mreg = d.obs.metrics
    tier1_0 = mreg.value("serve.tier1")
    solo0 = mreg.value("serve.solo")

    async def go():
        async with OLAPEngine(d, max_batch=8, max_wait_us=2000) as eng:
            if loop == "closed":
                return await wl.run_closed_loop(eng, items, clients=6)
            return await wl.run_open_loop(eng, items, rate_qps=400.0,
                                          seed=1)

    res = _run(go)
    assert [c.item for c in res] == items
    assert all(c.ok for c in res)
    for c, b in zip(res, seq):
        assert c.answer.tier == b.answer.tier
        got, want = _value(c.answer), _value(b.answer)
        if c.item.kind == "tier2":
            # a coalesced lane is the lane-mask product: another order
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        else:
            assert got.tobytes() == want.tobytes(), c.item
    n_tier1 = sum(i.kind == "tier1" for i in items)
    assert mreg.value("serve.tier1") - tier1_0 == n_tier1
    # every shape of the mix has parameters: tier-2 items queue by shape
    # as the param ones do, none runs solo (as in the reference)
    assert mreg.value("serve.solo") == solo0
    rep = wl.summarize(res, 1.0)
    assert rep["failed"] == 0 and sum(
        k["n"] for k in rep["kinds"].values()) == len(items)


# ---------------------------------------------------------------------------
# the serving launcher
# ---------------------------------------------------------------------------


def test_cli_unknown_query_names_exit_2(capsys):
    rc = serve_olap.main(["--queries", "q6", "nope", "q999", "--sf", "0.005",
                          "--device", "cpu"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "nope" in err and "q999" in err
    assert "valid --queries names" in err and "q6" in err


def test_cli_speedup_str_handles_zero_tier1_time():
    assert serve_olap._speedup_str(0.0, 0.0).strip() == "--"
    assert serve_olap._speedup_str(1.0, 0.0).strip() == "infx"
    assert serve_olap._speedup_str(2.0, 1.0).strip() == "2x"


@pytest.mark.parametrize("mode", ["default", "cubes", "serve"])
def test_cli_modes_on_the_cpu(mode, tmp_path, capsys):
    trace = tmp_path / "trace.json"
    argv = {"default": ["--queries", "q6", "q1_kernel", "--repeat", "1"],
            "cubes": ["--cubes", "--repeat", "1"],
            "serve": ["--serve", "--requests", "32", "--clients", "4",
                      "--metrics", "--trace", str(trace)]}[mode]
    rc = serve_olap.main(["--sf", "0.002", "--device", "cpu"] + argv)
    assert rc == 0
    out = capsys.readouterr().out
    if mode == "default":
        assert "q6" in out and "q1_kernel" in out
    elif mode == "cubes":
        for name in tq.SERVING_QUERIES:
            assert name in out
    else:
        assert "sustained:" in out and "(0 failed)" in out
        assert "serve.requests" in out  # the --metrics report
        events = json.loads(trace.read_text())["traceEvents"]
        assert any(e["name"] == "serve.request" for e in events)
