"""OLAP serving launcher (counterpart of ``repro.launch.serve_olap``): load
a TPC-H instance onto the card and serve queries, one by one or under a
concurrent load.

  PYTHONPATH=src python -m repro_torch.launch.serve_olap --sf 0.05 \\
      --queries q1 q3 q15_approx --repeat 3 [--device cuda]

The default mode runs each named hand plan (every registered one without
``--queries``; ``q4_sj`` and ``q18_sj`` name the lowered exchange shapes)
once to warm it, then ``--repeat`` times, the card synchronized around
each run, and prints its best time.

--cubes enables two-tier serving: the tier-1 rollup cubes are built up
front (one scan each) and every serving query is reported with its
tier-1 (rollup slice) and tier-2 (lowered plan) latency, trimmed medians
beside their p99 tails (``cube.serving.measure_query``).

--serve runs the continuous-batching engine (``serve.olap_engine``) under
a concurrent load generator: cubes are built, a mixed tier-1 / tier-2 /
parameterized request stream is generated (``serve.workload``), and the
report shows per-class p50/p95/p99 latency, sustained q/s and the
engine's batching stats.  ``--clients N`` picks a closed loop (N clients
back to back); ``--rate QPS`` an open loop (Poisson arrivals).

--lint statically verifies every registry IR query, parameterized TPC-H
form and cube serving query against the generated catalog
(``query.verify``; rule catalog ``docs/RULES.md``) and exits nonzero on
any error or warning; nothing is lowered or run.

--metrics dumps the driver's metrics registry on exit; --trace PATH
writes the structured trace as Chrome-trace JSON (Perfetto).

The P = 8 nodes are stacked on one device (``--device``, ``cuda`` by
default; ``cpu`` runs the kernels' plain PyTorch versions).  Under
torchrun the W ranks hold P / W nodes each (NCCL on ``cuda:LOCAL_RANK``,
gloo with ``--device cpu``; ``launch/mesh.py``) and rank 0 alone
prints, the same lines as one process; every rank exits with the same
code.  The queries, ``--cubes`` and ``--lint`` run on every rank alike
(lockstep), as does ``--serve``'s set-up (the cubes, the workload, the
warm-up); then rank 0 runs the engine and leads, and the other ranks
follow it (``TPCHDriver.follow``) until it publishes the stop, which
this launcher also publishes on its way out.  The ranks need one
``PYTHONHASHSEED`` (the driver checks their data)::

    PYTHONHASHSEED=0 PYTHONPATH=src python -m torch.distributed.run \
        --standalone --nproc-per-node 2 -m repro_torch.launch.serve_olap \
        --device cpu --sf 0.01 --serve --requests 64 --clients 8
"""
from __future__ import annotations

import argparse
import sys
import time


def _lint(d, say=print) -> int:
    """--lint: statically verify every registry IR query, parameterized
    TPC-H form and cube serving query against the generated catalog
    (``query.verify``); nothing is lowered or run.  Exit nonzero on any
    error or warning; info advisories are allowed.  ``say`` prints a line
    (under a process group: on rank 0 alone)."""
    from repro_torch.core.plans import REGISTRY
    from repro_torch.query.ir import QueryError
    from repro_torch.tpch import queries as tq

    targets = [(name, qd.ir) for name, qd in REGISTRY.items()
               if qd.ir is not None]
    targets += [(f"{name}_param", make()) for name, make
                in tq.PARAM_QUERIES.items()]
    targets += [(name, make()) for name, make in tq.SERVING_QUERIES.items()]
    failed = 0
    for label, q in targets:
        try:
            rep = d.check(q)
        except QueryError as e:
            say(f"{label:>22s}  ERROR  verify failed: {e}")
            failed += 1
            continue
        status = "clean" if rep.clean else ("WARN" if rep.ok else "FAIL")
        say(f"{label:>22s}  {status}")
        for x in rep.diagnostics:
            say(f"{'':>24s}{x.format()}")
        if not rep.clean:
            failed += 1
    say(f"\n{len(targets)} plans verified, {failed} with errors/warnings")
    return 1 if failed else 0


def _speedup_str(tier2_s: float, tier1_s: float) -> str:
    """Tier-2/tier-1 ratio for the --cubes table.  A trimmed-median tier-1
    time can underflow to 0.0 (clock granularity against a sub-microsecond
    rollup slice): report ``inf`` then, and ``--`` when BOTH are 0."""
    if tier1_s <= 0.0:
        return f"{'--':>7s} " if tier2_s <= 0.0 else f"{'inf':>7s}x"
    return f"{tier2_s / tier1_s:7.0f}x"


def _serve_cubes(d, repeat: int, say=print):
    from repro_torch.cube.serving import measure_query
    from repro_torch.tpch import cubes as tpch_cubes

    t0 = time.monotonic()
    d.build_cubes()
    build_s = time.monotonic() - t0
    for name, cube in d.cubes.items():
        say(f"cube {name}: {cube.num_values} values from "
            f"{cube.rows_scanned} rows in {cube.build_seconds:.2f}s")
    say(f"tier-1 materialization total: {build_s:.2f}s\n")

    say(f"{'query':>22s} {'tier1[us]':>10s} {'p99[us]':>9s} "
        f"{'tier2[ms]':>10s} {'p99[ms]':>9s} {'speedup':>8s}  tier2 plan")
    for name, make_query in tpch_cubes.SERVING_QUERIES.items():
        m = measure_query(d, make_query(), repeat=repeat)
        if m is None:
            say(f"{name:>22s} {'--':>10s} (not cube-covered; tier 2 only)")
            continue
        say(f"{name:>22s} {m['tier1_s']*1e6:10.1f} "
            f"{m['tier1_p99_s']*1e6:9.1f} {m['tier2_s']*1e3:10.2f} "
            f"{m['tier2_p99_s']*1e3:9.2f} "
            f"{_speedup_str(m['tier2_s'], m['tier1_s'])}  {m['plan']}")
    return 0


def _serve_engine(d, args, say=print):
    """--serve: drive the continuous-batching engine under concurrent
    load and report per-class latency, throughput and batching stats.
    Under a process group every rank sets up alike; rank 0 then leads the
    engine and the other ranks follow it."""
    import asyncio

    from repro_torch.serve import workload as wl
    from repro_torch.serve.olap_engine import OLAPEngine

    t0 = time.monotonic()
    d.build_cubes()
    say(f"tier-1 cubes built in {time.monotonic() - t0:.2f}s")
    items = wl.mixed_workload(d, args.requests, seed=args.seed)
    sizes = sorted({2 ** i for i in range(args.max_batch.bit_length())
                    if 2 ** i <= args.max_batch} | {args.max_batch})
    t0 = time.monotonic()
    wl.warm_workload(d, items, batch_sizes=sizes)
    n_kind = {k: sum(1 for i in items if i.kind == k)
              for k in ("tier1", "param", "tier2")}
    say(f"warmed {len({i.prep.shape_key for i in items})} shapes "
        f"(batch lanes {sizes}) in {time.monotonic() - t0:.2f}s")
    say(f"workload: {len(items)} requests "
        f"(tier1 {n_kind['tier1']} / param {n_kind['param']} / "
        f"tier2 {n_kind['tier2']}), "
        f"{'open loop @ %g q/s' % args.rate if args.rate else 'closed loop, %d clients' % args.clients}")
    topo = d.cluster.topology
    if topo.distributed and topo.rank != 0:
        d.follow()
        return 0
    d.lead()  # main's finally publishes the stop whatever happens

    async def go():
        engine = OLAPEngine(d, max_batch=args.max_batch,
                            max_wait_us=args.max_wait_us)
        async with engine:
            t0 = time.perf_counter()
            if args.rate:
                res = await wl.run_open_loop(engine, items,
                                             rate_qps=args.rate,
                                             seed=args.seed)
            else:
                res = await wl.run_closed_loop(engine, items,
                                               clients=args.clients)
            wall = time.perf_counter() - t0
        return res, wall, engine.stats()

    res, wall, stats = asyncio.run(go())
    rep = wl.summarize(res, wall)
    print(f"\n{'class':>8s} {'n':>6s} {'p50[ms]':>9s} {'p95[ms]':>9s} "
          f"{'p99[ms]':>9s} {'mean[ms]':>9s}")
    for kind, s in rep["kinds"].items():
        print(f"{kind:>8s} {s['n']:6d} {s['p50_ms']:9.2f} "
              f"{s['p95_ms']:9.2f} {s['p99_ms']:9.2f} {s['mean_ms']:9.2f}")
    bs = stats.get("serve.batch_size", {})
    print(f"\nsustained: {rep['qps']:.0f} q/s over {wall:.2f}s "
          f"({rep['failed']} failed)")
    print(f"batches: {stats['batches']} "
          f"({stats['coalesced_lanes']} coalesced lanes, "
          f"mean size {bs.get('mean', 0):.1f}, p95 {bs.get('p95', 0):.0f}); "
          f"tier1 inline {stats['tier1']}, solo {stats['solo']}, "
          f"rejected {stats['rejected']}")
    return 0


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sf", type=float, default=0.05)
    p.add_argument("--queries", nargs="*", default=None)
    p.add_argument("--repeat", type=int, default=3)
    p.add_argument("--backend", choices=["xla", "one_factor"], default="xla")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="device the cluster runs on (default: cuda)")
    p.add_argument("--lint", action="store_true",
                   help="statically verify every registry IR query + cube "
                        "serving preset (query.verify rule catalog: "
                        "docs/RULES.md); exit nonzero on errors/warnings")
    p.add_argument("--cubes", action="store_true",
                   help="two-tier mode: build rollup cubes, report tier-1 vs "
                        "tier-2 latency per serving query")
    p.add_argument("--serve", action="store_true",
                   help="continuous-batching mode: build cubes, run the "
                        "async serving engine under a concurrent "
                        "mixed-workload load generator")
    p.add_argument("--requests", type=int, default=256,
                   help="--serve: number of requests in the load run")
    p.add_argument("--clients", type=int, default=16,
                   help="--serve: closed-loop client count")
    p.add_argument("--rate", type=float, default=None,
                   help="--serve: open-loop Poisson arrival rate (q/s); "
                        "overrides --clients")
    p.add_argument("--max-batch", type=int, default=16,
                   help="--serve: continuous-batching lane cap")
    p.add_argument("--max-wait-us", type=float, default=2000.0,
                   help="--serve: batching window: a batch launches at "
                        "max-batch lanes or when its oldest request has "
                        "waited this long")
    p.add_argument("--metrics", action="store_true",
                   help="print the driver's metrics-registry report on exit")
    p.add_argument("--trace", metavar="PATH", default=None,
                   help="write the structured trace as Chrome-trace JSON "
                        "(loadable in Perfetto) on exit")
    args = p.parse_args(argv)

    from repro_torch.core.engine import resolve_device
    from repro_torch.core.plans import PLANS
    from repro_torch.tpch import queries as tq
    from repro_torch.tpch.driver import TPCHDriver

    # the lowered exchange shapes, beside the registry's hand plans
    exchange_queries = {"q4_sj": tq.q4_sj_ir, "q18_sj": tq.q18_sj_ir}
    # validate query names BEFORE paying for data generation + placement
    if args.queries:
        valid = set(PLANS) | set(exchange_queries)
        unknown = sorted(set(args.queries) - valid)
        if unknown:
            print(f"unknown query name(s): {', '.join(unknown)}",
                  file=sys.stderr)
            print(f"valid --queries names: {', '.join(sorted(valid))}",
                  file=sys.stderr)
            return 2
    d = TPCHDriver(sf=args.sf, seed=args.seed, backend=args.backend,
                   device=args.device)
    nodes = d.cluster.num_nodes
    rank = d.cluster.topology.rank

    def say(*a, **kw):
        if rank == 0:
            print(*a, **kw)

    try:
        if args.lint:
            say(f"cluster: {nodes} nodes | SF {args.sf} | "
                f"static plan verify")
            return _lint(d, say)
        if args.serve:
            say(f"cluster: {nodes} nodes | SF {args.sf} | "
                f"continuous-batching serving")
            return _serve_engine(d, args, say)
        if args.cubes:
            say(f"cluster: {nodes} nodes | SF {args.sf} | two-tier serving")
            if args.queries:
                say("note: --queries is ignored with --cubes (the fixed "
                    "tpch.cubes.SERVING_QUERIES set is measured)")
            return _serve_cubes(d, args.repeat, say)
        names = args.queries or list(PLANS)
        device = d.cluster.device
        # the device as one process names it (a rank's carries its index)
        shown = resolve_device(args.device)
        say(f"cluster: {nodes} nodes on {shown} | SF {args.sf} | "
            f"backend {args.backend}")
        say(f"{'query':>14s} {'compile[s]':>10s} {'run[ms]':>9s}")
        run_hist = d.obs.metrics.histogram("serve.run_us")
        for name in names:
            with d.obs.span("serve", cat="serve", query=name) as sp:
                t0 = time.monotonic()
                fn = (d.compile(name) if name in PLANS
                      else d.compile_query(exchange_queries[name]()))
                compile_s = time.monotonic() - t0
                cols = d.columns()
                with d.obs.span("warmup", cat="exec"):
                    fn(cols)  # first execute
                    _sync(device)
                times = []
                for _ in range(args.repeat):
                    with d.obs.span("execute", cat="exec"):
                        t0 = time.monotonic()
                        fn(cols)
                        _sync(device)
                        times.append(time.monotonic() - t0)
                    run_hist.record(times[-1] * 1e6)
                sp.set(compile_s=compile_s, best_ms=min(times) * 1e3)
            say(f"{name:>14s} {compile_s:10.2f} {min(times)*1e3:9.2f}")
        return 0
    finally:
        d.stop_followers()  # --serve's leader: the followers' stop
        if args.metrics:
            say("\n" + d.obs.metrics.report())
        if args.trace and rank == 0:
            print(f"\ntrace written to {d.obs.save_chrome_trace(args.trace)}")


if __name__ == "__main__":
    sys.exit(main())
