"""One rank of the port's cluster across processes, for
``tests/test_torch_distributed.py``.

    python tests/fixtures/torch_dist_worker.py SPAWN RANK WORLD STORE OUT

joins a gloo group of WORLD ranks through the file store STORE, runs the
SPAWN's tasks and pickles what it saw to ``OUT/rank{RANK}.pkl``:

- ``collectives``: every case of :data:`CASES` on the rank's L = P / W
  rows of inputs made from a numpy seed, over the default group (and,
  in spawn ``w2``, over a group of one rank, its own), with the
  collective record and ``wire_bytes()`` of each;
- ``queries``: every query of :data:`QUERIES` through a ``TPCHDriver``
  over the group (SF 0.01, P = 8), with the same records;
- ``errors``: what must raise under W > 1 (P % W != 0, a gloo group on
  CUDA);
- ``olap``: the OLAP tier on the same driver (:func:`olap`): the default
  cubes, the batches of :data:`BATCHES`, EXPLAIN ANALYZE of
  :data:`EXPLAINED`, the serving engine over ``mixed_workload`` (rank 0
  leads, the other ranks follow), and ``serve_olap.main`` in each mode of
  :data:`LAUNCHER` with its standard output;
- ``reference`` (rank 0 of ``w2``, after the group is gone): the same
  queries and OLAP tasks through the one-process port driver (the
  engine's requests each a sequential ``execute``), the queries, the
  cubes and q6_param's batch through the JAX driver in this process, and
  the float64 oracle;
- ``mismatch``: a ``TPCHDriver`` whose ranks have different
  ``PYTHONHASHSEED`` values (the caller sets them) must raise;
- ``keepalive`` (:func:`run_keepalive`): a driver over a gloo group with
  a 3 s timeout, rank 0's engine idle for 10 s before it serves one
  request, the other ranks following.

Every rank of a spawn shares the caller's ``PYTHONHASHSEED`` (except in
``mismatch``), so every rank, and the reference, see the same tables.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import datetime
import io
import pickle
import sys
import traceback

import numpy as np
import torch

P = 8
SF = 0.01

# case -> (function of the local operands, input makers (P, ...) of a
# numpy generator); every case runs over the node axis, the same function
# the test runs over all P nodes in one process


def _topk(v, k):
    from repro_torch.core import topk

    local = topk.local_topk(v, k, 5, v > 0.2)
    return topk.topk_allreduce(local)


def _cases():
    from repro_torch.core import exchange
    from repro_torch.core.engine import psum

    f32 = (lambda shape: lambda g: g.standard_normal(shape).astype(
        np.float32))
    i32 = (lambda shape: lambda g: g.integers(-1000, 1000, shape,
                                              dtype=np.int32))
    return {
        "psum_f32": (psum, [f32((P, 6, 6))]),
        "psum_i64": (psum, [lambda g: g.integers(0, 1 << 40, (P, 5))]),
        "all_to_all_xla": (exchange.all_to_all, [i32((P, P, 7))]),
        "all_to_all_one_factor": (
            lambda x: exchange.all_to_all(x, backend="one_factor"),
            [f32((P, P, 3))]),
        "all_to_all_bool": (exchange.all_to_all,
                            [lambda g: g.random((P, P, 33)) < 0.5]),
        "allgather": (exchange.allgather, [i32((P, 40))]),
        "allreduce_max": (exchange.allreduce_max, [f32((P, 10))]),
        "allreduce_min": (exchange.allreduce_min, [f32((P, 10))]),
        "broadcast_from": (lambda x: exchange.broadcast_from(x, 5),
                           [f32((P, 4))]),
        "butterfly_topk": (_topk, [lambda g: g.random((P, 64), np.float32),
                                   lambda g: g.permutation(P * 64).reshape(
                                       P, 64)]),
    }


CASE_NAMES = ("psum_f32", "psum_i64", "all_to_all_xla",
              "all_to_all_one_factor", "all_to_all_bool", "allgather",
              "allreduce_max", "allreduce_min", "broadcast_from",
              "butterfly_topk")


def case_inputs(name: str) -> list:
    """The case's global (P, ...) inputs, from its own numpy seed."""
    g = np.random.default_rng(CASE_NAMES.index(name))
    return [np.asarray(make(g)) for make in _cases()[name][1]]


def run_case(name: str, inputs) -> tuple:
    """(flattened output, wire bytes, collective record) of one case over
    the given stacked operands, under whatever topology is active."""
    from repro_torch.core import exchange

    exchange.reset_wire_bytes()
    exchange.reset_collective_record()
    out = _cases()[name][0](*(torch.from_numpy(a) for a in inputs))
    return (flat(out), exchange.wire_bytes(),
            list(exchange.collective_record()))


# q18's quantity with winners at SF 0.01 (none pass the default 300)
Q18_QUANTITY = 150.0

# query -> (how it runs, registry or IR name, wire, backend, oracle)
QUERIES = {
    "q6": ("ir", "q6", None, None, "q6"),
    "q1": ("ir", "q1", None, None, "q1"),
    "q1_kernel": ("ir", "q1_kernel", None, None, "q1"),
    "q4_sj/packed/xla": ("sj", "q4_sj", "packed", "xla", "q4_sj_request"),
    "q4_sj/packed/one_factor": ("sj", "q4_sj", "packed", "one_factor",
                                "q4_sj_request"),
    "q4_sj/raw/xla": ("sj", "q4_sj", "raw", "xla", "q4_sj_request"),
    "q18_sj": ("sj", "q18_sj", "packed", "xla", "q18_sj_request"),
    "q14_promo": ("ir", "q14_promo", None, None, "q14_promo"),
    "q4": ("ir", "q4", None, None, "q4"),
    "q18": ("q18", "q18", None, None, "q18"),
    "q3_lazy": ("hand", "q3_lazy", None, None, "q3_lazy"),
    "q15_approx": ("hand", "q15_approx", None, None, "q15_approx"),
    "q21": ("hand", "q21", None, None, "q21"),
}


def flat(tree, key: str = "out") -> dict:
    """Tensors (in dicts, tuples and NamedTuples) -> {path: numpy}."""
    if hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {key: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{key}.{k}"))
    return out


def _q18_params():
    from repro_torch.tpch.schema import DEFAULT_PARAMS as DP

    return dataclasses.replace(DP, q18_quantity=Q18_QUANTITY)


def oracle(drv, name: str):
    """The float64 oracle of one query of :data:`QUERIES`."""
    kw = {"p": _q18_params()} if QUERIES[name][0] == "q18" else {}
    return drv.oracle(QUERIES[name][4], **kw)


def run_port_query(drv, name: str) -> tuple:
    """(flattened answer, wire bytes, collective record) of one query."""
    from repro_torch.core import exchange
    from repro_torch.tpch import queries as tq

    how, what, wire, backend, _ = QUERIES[name]
    exchange.reset_wire_bytes()
    exchange.reset_collective_record()
    if how == "ir":
        out = drv.run_ir(what)
    elif how == "q18":
        out = drv.compile_query(tq.q18_ir(p=_q18_params()))(drv.columns())
    elif how == "sj":
        q = getattr(tq, f"{what}_ir")()
        out = drv.compile_query(q, wire=wire, backend=backend)(drv.columns())
    else:
        out = drv.run(what)
    return (flat(out), exchange.wire_bytes(),
            list(exchange.collective_record()))


def run_jax_query(jd, name: str) -> dict:
    """The JAX driver's answer, prepared as its ``query`` prepares it and
    lowered under the query's wire (the backend does not change it)."""
    import jax.numpy as jnp
    from repro.query import parameterize
    from repro.query.lower import lower
    from repro.tpch import queries as jq
    from repro.tpch.schema import DEFAULT_PARAMS as JDP

    how, what, wire, _, _ = QUERIES[name]
    if how == "ir":
        return flat(jd.run_ir(what))
    if how == "hand":
        return flat(jd.run(what))
    if how == "q18":
        q = jq.q18_ir(p=dataclasses.replace(JDP, q18_quantity=Q18_QUANTITY))
        return flat(jd.compile_query(q)(jd._columns()))

    shape, binding = parameterize(getattr(jq, f"{what}_ir")())
    plan = lower(shape, jd.catalog, wire=wire, binding=binding)
    ctx = dataclasses.replace(jd.ctx, wire=wire, backend="xla")
    cols = {n: t.columns for n, t in jd.placed.items()}
    fn = jd.cluster.compile(plan, ctx, jd.placed)
    pv = {p.name: jnp.asarray(np.asarray(binding[p.name], np.dtype(p.dtype)))
          for p in plan.params}
    return flat(fn(cols, pv))


# -- the OLAP tier across ranks ------------------------------------------------

# batch -> (its prepared query, its PARAM_QUERIES name), run at
# BATCH_LANES random bindings padded to BATCH_PAD lanes
BATCHES = {"q1_param": ("q1_param_ir", {}, "q1"),
           "q6_param": ("q6_param_ir", {}, "q6"),
           "q14_promo_param_request": ("q14_promo_param_ir",
                                       {"alt": "request"}, "q14_promo")}
BATCH_LANES, BATCH_PAD = 3, 4
EXPLAINED = ("q4_sj", "q18_sj")      # EXPLAIN ANALYZE, the packed wire
ENGINE_ITEMS, ENGINE_CLIENTS = 32, 4
ENGINE_TIMEOUT_S = 120.0
LAUNCHER = {"--serve": ["--serve", "--requests", "16", "--clients", "4",
                        "--max-batch", "4"],
            "--cubes": ["--cubes", "--repeat", "1"],
            "--lint": ["--lint"]}


def batch_bindings(name: str) -> list:
    """BATCH_LANES random §2.4 bindings of a batch, from its own seed."""
    from repro_torch.tpch import queries as tq

    rng = np.random.default_rng(list(BATCHES).index(name))
    return [tq.random_binding(BATCHES[name][2], rng)
            for _ in range(BATCH_LANES)]


def batch_query(q, name: str):
    """A batch's query from a queries module (the port's or JAX's)."""
    make, kw, _ = BATCHES[name]
    return getattr(q, make)(**kw)


def cube_rollups(cubes) -> dict:
    """{cube: (rows scanned, {dims: {measure: numpy}})} of built cubes."""
    return {name: (c.rows_scanned,
                   {dims: {m: np.asarray(a) for m, a in arrays.items()}
                    for dims, arrays in c.rollups.items()})
            for name, c in cubes.items()}


def run_batches(drv) -> dict:
    """Each batch's (flattened answer, overflow lanes)."""
    from repro_torch.tpch import queries as tq

    out = {}
    for name in BATCHES:
        ans = drv.prepare(batch_query(tq, name)).execute_batch(
            batch_bindings(name), pad_to=BATCH_PAD)
        out[name] = (flat(ans.value), np.asarray(ans.overflow))
    return out


def run_explains(drv) -> dict:
    """Each EXPLAIN ANALYZE's (tier, overflow, the all-to-all bytes of its
    request semi-joins)."""
    from repro_torch.tpch import queries as tq

    out = {}
    for name in EXPLAINED:
        rep = drv.explain_analyze(getattr(tq, f"{name}_ir")())
        out[name] = (rep.observed["tier"], rep.observed["overflow"],
                     [sj.a2a_bytes for sj in rep.semijoins
                      if sj.alt == "request"])
    return out


def _answer(ans) -> tuple:
    """(tier, flattened value, overflow) of one served answer."""
    return ans.tier, flat(np.asarray(ans.value)), bool(ans.overflow)


def run_engine(drv) -> dict:
    """The engine over ``mixed_workload`` in a closed loop: rank 0 leads
    and keeps each request's kind and answer, the other ranks follow and
    count their dispatches; every rank's ``dist_calls()`` of the run.
    Then every rank executes each request alike (lockstep), and rank 0
    keeps those answers too."""
    from repro_torch.core import engine
    from repro_torch.serve import workload as wl
    from repro_torch.serve.olap_engine import OLAPEngine

    items = wl.mixed_workload(drv, ENGINE_ITEMS, seed=0)
    engine.reset_dist_calls()
    if drv.cluster.topology.rank != 0:
        followed = drv.follow()
        calls = engine.dist_calls()
        sequential_answers(drv, items)
        return {"followed": followed, "dist_calls": calls}

    async def go():
        async with OLAPEngine(drv, max_batch=4) as e:
            return await wl.run_closed_loop(e, items,
                                            clients=ENGINE_CLIENTS)

    published = drv.obs.metrics.value("driver.published") or 0
    res = asyncio.run(asyncio.wait_for(go(), ENGINE_TIMEOUT_S))
    return {"answers": [(c.item.kind, c.item.name) + _answer(c.answer)
                        if c.ok else (c.item.kind, c.item.name, repr(c.answer))
                        for c in res],
            "failed": sum(not c.ok for c in res),
            "published": (drv.obs.metrics.value("driver.published")
                          - published),
            "dist_calls": engine.dist_calls(),
            "sequential": sequential_answers(drv, items)}


def run_launcher() -> dict:
    """``serve_olap.main`` in each mode: (exit code, standard output)."""
    from repro_torch.launch import serve_olap

    out = {}
    for mode, argv in LAUNCHER.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = serve_olap.main(["--device", "cpu", "--sf", str(SF)]
                                 + argv)
        out[mode] = (rc, buf.getvalue())
    return out


def olap(drv) -> dict:
    """The OLAP tier's tasks, in the order every rank runs them."""
    drv.build_cubes()
    return {"cubes": cube_rollups(drv.cubes), "batches": run_batches(drv),
            "explain": run_explains(drv), "engine": run_engine(drv),
            "launcher": run_launcher()}


def sequential_answers(drv, items=None) -> list:
    """Each request of the engine's workload as one ``execute``."""
    from repro_torch.serve import workload as wl

    if items is None:
        items = wl.mixed_workload(drv, ENGINE_ITEMS, seed=0)
    return [_answer(it.prep.execute(it.binding)) for it in items]


# the keep-alive spawn: the group's timeout (the side group's too) and how
# long rank 0's engine idles before its one request
KEEPALIVE_TIMEOUT_S = 3.0
KEEPALIVE_IDLE_S = 10.0


def run_keepalive(world: int) -> dict:
    """A driver over a new gloo group of the ranks whose timeout is
    ``KEEPALIVE_TIMEOUT_S``; every rank executes q6_param once in lockstep
    (the answer kept), then rank 0 runs the engine, idles
    ``KEEPALIVE_IDLE_S`` (longer than the timeout) and serves the same
    request, while the other ranks follow.  Each rank returns what it
    saw: its dispatches followed or its answer, the keep-alives it
    published, its ``dist_calls()``."""
    import torch.distributed as dist

    from repro_torch.core import engine
    from repro_torch.launch import mesh
    from repro_torch.serve.olap_engine import OLAPEngine
    from repro_torch.tpch import queries
    from repro_torch.tpch.driver import TPCHDriver

    group = dist.new_group(list(range(world)), backend="gloo",
                           timeout=datetime.timedelta(
                               seconds=KEEPALIVE_TIMEOUT_S))
    dist.barrier()  # the default group's timeout: start together
    drv = TPCHDriver(SF, num_nodes=P, device="cpu", group=group)
    prep = drv.prepare(queries.q6_param_ir())
    binding = queries.default_binding("q6")
    out = {"timeout_s": mesh.group_timeout(drv.cluster.topology.control),
           "sequential": _answer(prep.execute(binding))}
    engine.reset_dist_calls()
    if drv.cluster.topology.rank != 0:
        out["followed"] = drv.follow()
        out["dist_calls"] = engine.dist_calls()
        return out

    async def go():
        async with OLAPEngine(drv) as e:
            await asyncio.sleep(KEEPALIVE_IDLE_S)
            return await e.submit(prep, binding)

    published = drv.obs.metrics.value("driver.published") or 0
    out["answer"] = _answer(asyncio.run(asyncio.wait_for(
        go(), KEEPALIVE_IDLE_S + ENGINE_TIMEOUT_S)))
    out["published"] = drv.obs.metrics.value("driver.published") - published
    out["keepalives"] = drv.obs.metrics.value("driver.keepalives") or 0
    out["dist_calls"] = engine.dist_calls()
    return out


def _raises(fn) -> str:
    """The message of what ``fn()`` raised, '' if it returned."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test reads the type
        return f"{type(e).__name__}: {e}"
    return ""


def _errors() -> dict:
    from repro_torch.core.engine import Cluster

    return {
        "p_mod_w": _raises(lambda: Cluster(P + 1, device="cpu")),
        "gloo_on_cuda": _raises(lambda: Cluster(P, device="cuda")),
    }


def main(spawn: str, rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    res = {"rank": rank, "world": world}
    try:
        from repro_torch.core.engine import Cluster, running_on
        from repro_torch.tpch.driver import TPCHDriver

        if spawn == "mismatch":
            res["mismatch"] = _raises(
                lambda: TPCHDriver(SF, num_nodes=P, device="cpu"))
            return
        if spawn == "keepalive":
            res["keepalive"] = run_keepalive(world)
            return
        # collectives over the default group, and over a group of one rank
        groups = {"default": None}
        if spawn == "w2":
            singles = [dist.new_group([r]) for r in range(world)]
            groups = {"single": singles[rank]}
        res["collectives"] = {}
        for label, group in groups.items():
            topo = Cluster(P, device="cpu", group=group).topology
            lo, hi = topo.node_offset, topo.node_offset + topo.local_nodes
            with running_on(topo):
                res["collectives"][label] = {
                    name: run_case(name, [a[lo:hi]
                                          for a in case_inputs(name)])
                    for name in CASE_NAMES}
        drv = TPCHDriver(SF, num_nodes=P, device="cpu")
        res["local_nodes"] = drv.cluster.topology.local_nodes
        res["queries"] = {name: run_port_query(drv, name)
                          for name in QUERIES}
        res["errors"] = _errors()
        res["olap"] = olap(drv)
        dist.barrier()
    except Exception:  # noqa: BLE001 - reported to the test
        res["error"] = traceback.format_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if spawn == "w2" and rank == 0 and "error" not in res:
            try:
                res["reference"] = reference()
            except Exception:  # noqa: BLE001
                res["error"] = traceback.format_exc()
        with open(f"{out}/rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)


def reference() -> dict:
    """The one-process port driver, the JAX driver and the oracle, in
    this process (the same ``PYTHONHASHSEED`` as the ranks)."""
    from repro.core import Cluster as JaxCluster
    from repro.tpch.driver import TPCHDriver as JaxDriver
    from repro_torch.tpch.driver import TPCHDriver

    from repro.tpch import queries as jq

    drv = TPCHDriver(SF, num_nodes=P, device="cpu")
    assert drv.cluster.topology.world == 1
    jd = JaxDriver(sf=SF, cluster=JaxCluster(), seed=0)
    out = {"port": {n: run_port_query(drv, n) for n in QUERIES},
           "jax": {n: run_jax_query(jd, n) for n in QUERIES},
           "oracle": {n: oracle(drv, n) for n in QUERIES}}
    drv.build_cubes()
    jd.build_cubes()
    jax_q6 = jd.prepare(batch_query(jq, "q6_param")).execute_batch(
        batch_bindings("q6_param"), pad_to=BATCH_PAD)
    out["olap"] = {"cubes": cube_rollups(drv.cubes),
                   "batches": run_batches(drv),
                   "explain": run_explains(drv),
                   "sequential": sequential_answers(drv),
                   "jax_cubes": cube_rollups(jd.cubes),
                   "jax_q6_param": flat(np.asarray(jax_q6.value))}
    return out


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
