"""Serving workload and load generators for the continuous-batching tier
(counterpart of ``repro.serve.workload``).

One definition of "a mixed tier-1 / tier-2 / parameterized request
stream", shared by ``launch/serve_olap.py --serve`` and the card's smoke
run:

- ``tier1``  cube-covered serving queries on their on-edge default
  bindings (``tpch.queries.SERVING_QUERIES``): the router path in host
  microseconds;
- ``param``  TPC-H §2.4 substitution draws of the parameterized forms
  (``PARAM_QUERIES``; q6 and q14_promo by default), each request a
  distinct binding of a shared prepared shape;
- ``tier2``  the off-edge q1 variant (``uncovered_query``), which misses
  every cube and runs its lowered plan.

Every item carries a PREPARED handle (one per distinct shape), so a
request is "submit this binding", not "re-canonicalize this tree".  The
same seed gives the same items as the reference's generator.

Two generator disciplines:

- ``run_closed_loop``: N clients, each submitting its next request the
  moment its previous answer lands: saturated throughput;
- ``run_open_loop``: Poisson arrivals at a target rate, independent of
  completion: latency at a controlled load (a closed loop cannot observe
  queueing collapse).

``sequential_baseline`` replays the same items on one synchronous client
(a prepared ``execute`` a request): the engine's yardstick.

Under a process group every rank calls ``mixed_workload`` and
``warm_workload`` alike (lockstep): the items come from the seed alone,
and the warm-up walks the shapes in item order, so every rank prepares,
lowers and runs the same plans in the same order before rank 0's engine
leads.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.tpch import queries as tq
from repro_torch.tpch.driver import PreparedQuery

DEFAULT_MIX = {"param": 0.6, "tier1": 0.3, "tier2": 0.1}
PARAM_NAMES = ("q6", "q14_promo")  # dispatch-bound shapes: batching wins


@dataclasses.dataclass
class WorkItem:
    """One request of the stream: a prepared handle plus its binding."""

    kind: str                  # "tier1" | "param" | "tier2"
    name: str                  # query label for reporting
    prep: PreparedQuery
    binding: Optional[dict]    # None -> the prepared defaults


@dataclasses.dataclass
class Completion:
    """One served request: the answer and its client-observed latency."""

    item: WorkItem
    latency_s: float
    answer: object             # QueryAnswer (or the raised exception)
    ok: bool = True


def mixed_workload(driver, n: int, *, seed: int = 0, mix=None,
                   param_names: Sequence[str] = PARAM_NAMES) -> list:
    """``n`` work items in the given kind mix (shuffled, seeded).

    Shapes are prepared once up front; ``param`` items draw random §2.4
    substitution bindings (one per request), ``tier1``/``tier2`` items
    run their query's default binding.  Needs ``driver.build_cubes()``.
    """
    rng = np.random.default_rng(seed)
    mix = dict(DEFAULT_MIX if mix is None else mix)
    total = sum(mix.values())

    tier1 = [(name, driver.prepare(make()))
             for name, make in tq.SERVING_QUERIES.items()]
    # only the shapes the router covers on their defaults: the tier1 class
    # must measure the router path, not a mislabel
    tier1 = [(name, prep) for name, prep in tier1
             if prep.answer_tier1(prep.binding()) is not None]
    if not tier1:
        raise RuntimeError("no cube-covered serving query: call "
                           "driver.build_cubes() before mixed_workload()")
    params = {name: driver.prepare(tq.PARAM_QUERIES[name]())
              for name in param_names}
    tier2 = driver.prepare(tq.uncovered_query())

    kinds = list(mix)
    probs = np.asarray([mix[k] / total for k in kinds])
    items = []
    for _ in range(n):
        kind = kinds[int(rng.choice(len(kinds), p=probs))]
        if kind == "tier1":
            name, prep = tier1[int(rng.integers(len(tier1)))]
            items.append(WorkItem("tier1", name, prep, None))
        elif kind == "param":
            name = param_names[int(rng.integers(len(param_names)))]
            items.append(WorkItem("param", name, params[name],
                                  tq.random_binding(name, rng)))
        elif kind == "tier2":
            items.append(WorkItem("tier2", "q1_offedge", tier2, None))
        else:
            raise ValueError(f"unknown workload kind {kind!r}")
    return items


def warm_workload(driver, items, *, batch_sizes=()) -> None:
    """Pay the lowerings and the allocator's first requests up front so a
    load run measures steady-state serving: one scalar execute per
    distinct shape, plus one batched execute per (parameterized shape,
    lane count) in ``batch_sizes``, the padded sizes the engine will
    dispatch."""
    seen = {}
    for it in items:
        seen.setdefault(it.prep.shape_key, it)
    for it in seen.values():
        it.prep.execute(it.binding)
        if it.prep.params:
            for b in batch_sizes:
                if b > 1:
                    rows = [it.binding or {}] * b
                    it.prep.execute_batch(rows)


# -- generators -------------------------------------------------------------


async def run_closed_loop(engine, items, *, clients: int = 8) -> list:
    """N clients, each submitting its next item as soon as the previous
    completes.  Returns one :class:`Completion` per item, in item order."""
    results = [None] * len(items)
    queue = list(enumerate(items))
    pos = 0

    async def client():
        nonlocal pos
        while pos < len(queue):
            idx, item = queue[pos]
            pos += 1
            results[idx] = await _submit_one(engine, item)

    await asyncio.gather(*[client() for _ in range(max(1, clients))])
    return results


async def run_open_loop(engine, items, *, rate_qps: float,
                        seed: int = 0) -> list:
    """Poisson arrivals at ``rate_qps``: each item is launched at its
    arrival time whether or not earlier requests finished."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_qps, size=len(items))
    tasks = []
    for item, gap in zip(items, gaps):
        tasks.append(asyncio.ensure_future(_submit_one(engine, item)))
        await asyncio.sleep(float(gap))
    return list(await asyncio.gather(*tasks))


async def _submit_one(engine, item) -> Completion:
    t0 = time.perf_counter()
    try:
        ans = await engine.submit(item.prep, item.binding)
    except Exception as e:  # admission rejects land in the report, not up
        return Completion(item, time.perf_counter() - t0, e, ok=False)
    return Completion(item, time.perf_counter() - t0, ans)


def sequential_baseline(driver, items) -> list:
    """ONE synchronous client, a prepared ``execute`` a request (complete
    on the card when it returns), no coalescing.  The same Completion
    schema as the generators, so reports and parity checks share code."""
    out = []
    for item in items:
        t0 = time.perf_counter()
        ans = item.prep.execute(item.binding)
        out.append(Completion(item, time.perf_counter() - t0, ans))
    return out


# -- reporting --------------------------------------------------------------


def percentile(xs, q: float) -> float:
    """Exact order-statistic percentile (no log-bucket approximation:
    the load reports read tails)."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def summarize(completions, wall_s: float) -> dict:
    """Per-kind latency percentiles + overall sustained q/s."""
    ok = [c for c in completions if c.ok]
    by_kind = {}
    for c in ok:
        by_kind.setdefault(c.item.kind, []).append(c.latency_s)
    out = {
        "requests": len(completions),
        "failed": len(completions) - len(ok),
        "wall_s": wall_s,
        "qps": len(ok) / wall_s if wall_s > 0 else 0.0,
        "kinds": {},
    }
    for kind, lats in sorted(by_kind.items()):
        out["kinds"][kind] = {
            "n": len(lats),
            "p50_ms": percentile(lats, 0.50) * 1e3,
            "p95_ms": percentile(lats, 0.95) * 1e3,
            "p99_ms": percentile(lats, 0.99) * 1e3,
            "mean_ms": sum(lats) / len(lats) * 1e3,
        }
    return out
