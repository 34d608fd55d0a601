"""Continuous-batching OLAP serving engine: the concurrent-load tier
(counterpart of ``repro.serve.olap_engine``).

The engine accepts an async stream of query submissions and drives what
the driver already has (tier-1 cube answers in host microseconds,
prepared plans lowered once, and ``execute_batch`` with a lane axis)
under a continuous-batching policy:

- **Tier 1 first, inline, never queued.**  ``submit`` probes the cube
  router synchronously on the event loop (``PreparedQuery.answer_tier1``
  is host numpy only); a covered, on-edge binding is answered without
  entering a queue, so dashboard traffic never waits behind a tier-2 scan.

- **Shape-keyed admission queues.**  Everything else joins the queue of
  its shape (``PreparedQuery.shape_key``: same key, the bindings stack
  into one batched plan).  Admission is bounded (``max_queue``): past it
  ``submit`` raises :class:`AdmissionError`.

- **Dynamic batches.**  A dispatcher task per shape seals a batch when
  the queue reaches ``max_batch`` or the oldest request has waited
  ``max_wait_us``, whichever comes first, and runs it as ONE
  ``execute_batch``; late arrivals join the next batch.  Batches are
  padded to power-of-two lane counts (``pad_batches``), as in the
  reference, whose jitted plan specializes per lane count; the port's
  batched plan takes any lane count, so here the padding lanes are pure
  extra work (counted in ``driver.batch_pad_lanes``).  A batch of one
  runs the scalar plan.

- **Bounded dispatch pipelining.**  At most ``max_inflight`` tier-2
  dispatches are in flight, each on a thread-pool worker.  Plan calls
  serialize at the driver's dispatch gate (``TPCHDriver._guarded_call``);
  a worker waits for its answer on the card outside the gate, with the
  interpreter lock released, so the next batch's host work (binding
  casts, lane stacking, launches) overlaps this batch's device work.  A
  request's future resolves only once its answer is complete on the card.

Across the W ranks of a process group (any ``Topology.distributed``, a
group of one rank too) the engine runs on rank 0 and leads: its batches
follow rank 0's host timing, so the ranks cannot reach them in lockstep.
``start`` makes the driver lead (``TPCHDriver.lead``): every tier-2
dispatch is published at the dispatch gate, and every other rank runs
``driver.follow()``, the same plan with the same lanes, until ``stop``
publishes the stop (under either ``drain``).  Tier 1 is answered on rank
0 alone: host numpy, no collective.  A follower that fails fails the
leader's next dispatch, and so its requests: no answer comes from rank 0
alone.

Observability: a detached ``serve.request`` span per request, a
``serve.queue_depth`` gauge, the ``serve.batch_size`` / ``serve.queue_us``
/ ``serve.tier1_us`` / ``serve.e2e_us`` histograms and the ``serve.*``
counters, all in the driver's metrics registry.

Usage::

    engine = OLAPEngine(driver, max_batch=16, max_wait_us=2000)
    async with engine:
        ans = await engine.submit(query_or_prepared, params)
"""
from __future__ import annotations

import asyncio
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from repro_torch.tpch.driver import PreparedQuery, QueryAnswer


class AdmissionError(RuntimeError):
    """The engine refused a submission (queue bound exceeded, or the
    engine is not running)."""


class _Pending:
    """One queued tier-2 request: its full binding, the future its client
    awaits, and the enqueue time the batching window runs on."""

    __slots__ = ("binding", "future", "t_enq")

    def __init__(self, binding, future, t_enq):
        self.binding = binding
        self.future = future
        self.t_enq = t_enq


class _ShapeLane:
    """Per-shape queue + wakeup event; one dispatcher task drains it."""

    __slots__ = ("prep", "pending", "event", "task")

    def __init__(self, prep: PreparedQuery):
        self.prep = prep            # canonical handle for this shape
        self.pending: deque = deque()
        self.event: asyncio.Event = asyncio.Event()
        self.task: Optional[asyncio.Task] = None


def _lane_view(value, i: int):
    """Lane ``i`` of a batched answer value (a tensor or a dict of them;
    every output of ``execute_batch`` has a leading lane axis), left on
    its device."""
    if isinstance(value, dict):
        return {k: v[i] for k, v in value.items()}
    return value[i]


def _use_device(device) -> None:
    """A pool thread's initializer: make the cluster's card its current
    one.  The current CUDA device is a thread's own and starts at cuda:0
    in a new thread, but rank r's plans and collectives belong on
    cuda:r (NCCL binds a communicator to the current device); on a
    machine with one card the two agree, so only several cards show it.
    A device without an index (a cluster without a group) is whichever
    card is current, and stays so."""
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)


def _bucket(n: int, cap: int) -> int:
    """Next power of two >= n, capped at ``cap``: the lane counts batches
    are padded to."""
    b = 1
    while b < n and b < cap:
        b <<= 1
    return min(b, cap)


class OLAPEngine:
    """Async serving loop over one :class:`~repro_torch.tpch.driver.TPCHDriver`.

    Construct, then ``async with engine:`` (or ``await engine.start()`` /
    ``await engine.stop()``).  ``submit`` may be called from any task on
    the engine's event loop; the driver's caches and dispatch gate are
    thread-safe, so a synchronous client may share the driver.  Under a
    process group only rank 0 constructs one (the others follow).
    """

    def __init__(self, driver, *, max_batch: int = 16,
                 max_wait_us: float = 2000.0, max_queue: int = 4096,
                 max_inflight: int = 2, pad_batches: bool = True):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        topo = driver.cluster.topology
        if topo.distributed and topo.rank != 0:
            raise ValueError(
                f"the serving engine runs on rank 0, which leads; rank "
                f"{topo.rank} follows it with driver.follow()")
        self.driver = driver
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_us) * 1e-6
        self.max_queue = int(max_queue)
        self.max_inflight = int(max_inflight)
        self.pad_batches = bool(pad_batches)
        self.obs = driver.obs
        self._lanes: dict = {}      # shape_key -> _ShapeLane
        self._depth = 0             # queued tier-2 requests, all lanes
        self._active = 0            # tier-2 dispatches in flight
        self._running = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._sem: Optional[asyncio.Semaphore] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._batches: set = set()  # the loop holds tasks weakly

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> "OLAPEngine":
        if self._running:
            return self
        self._loop = asyncio.get_running_loop()
        self._sem = asyncio.Semaphore(self.max_inflight)
        self._pool = ThreadPoolExecutor(
            max_workers=self.max_inflight + 1,
            thread_name_prefix="olap-serve", initializer=_use_device,
            initargs=(self.driver.cluster.device,))
        self.driver.lead()  # a no-op without a process group
        # the tier-1 inline path is ~100 us of numpy on the event loop; at
        # the interpreter's default 5 ms switch interval one busy worker
        # (lane stacking, launches) may hold the lock ~50x that long:
        # bound the hold while serving, restore it on stop
        self._switch_interval = sys.getswitchinterval()
        sys.setswitchinterval(2e-4)
        self._running = True
        return self

    async def stop(self, drain: bool = True) -> None:
        """Stop the engine.  ``drain=True`` (default) first waits for every
        queued request and in-flight batch to complete; ``drain=False``
        fails queued requests with :class:`AdmissionError`.  Either way
        the followers get the stop once the last dispatch has run."""
        if not self._running:
            return
        try:
            await self._stop(drain)
        finally:
            self.driver.stop_followers()

    async def _stop(self, drain: bool) -> None:
        if drain:
            while self._depth or self._active:
                await asyncio.sleep(0.0005)
        self._running = False
        for lane in self._lanes.values():
            if lane.task is not None:
                lane.task.cancel()
            lane.event.set()
        for lane in self._lanes.values():
            if lane.task is not None:
                try:
                    await lane.task
                except asyncio.CancelledError:
                    pass
                lane.task = None
            while lane.pending:
                p = lane.pending.popleft()
                self._depth -= 1
                if not p.future.done():
                    p.future.set_exception(
                        AdmissionError("engine stopped with request queued"))
        self._gauge_depth()
        self._pool.shutdown(wait=True)
        self._pool = None
        sys.setswitchinterval(self._switch_interval)

    async def __aenter__(self) -> "OLAPEngine":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop(drain=exc == (None, None, None))

    # -- submission ---------------------------------------------------------
    def prepare(self, q) -> PreparedQuery:
        """Prepare once, submit many: the returned handle skips per-submit
        canonicalization and is the coalescing key."""
        return self.driver.prepare(q)

    async def submit(self, q, params: Optional[dict] = None) -> QueryAnswer:
        """Serve one query: a :class:`~repro_torch.query.ir.Query`
        (prepared here) or a :class:`PreparedQuery` handle, plus an
        optional binding.

        Cube-covered on-edge bindings return synchronously (tier 1);
        everything else resolves when its (possibly coalesced) tier-2
        dispatch is complete on the card.  Raises :class:`AdmissionError`
        when the engine is stopped or the queues hold ``max_queue``.
        """
        if not self._running:
            raise AdmissionError("engine is not running (use 'async with')")
        mreg = self.obs.metrics
        mreg.counter("serve.requests").inc()
        t0 = time.perf_counter()
        prep = q if isinstance(q, PreparedQuery) else self.driver.prepare(q)
        sp = self.obs.open_span("serve.request", cat="serve",
                                source=prep.source)
        try:
            b = prep.binding(params)
            ans = prep.answer_tier1(b)
            if ans is not None:
                dt_us = (time.perf_counter() - t0) * 1e6
                mreg.counter("serve.tier1").inc()
                mreg.histogram("serve.tier1_us").record(dt_us)
                sp.set(tier=1, route=ans.source)
                return ans
            if not prep.params:
                # literal shape: nothing to stack on, dispatch solo
                ans = await self._run_solo(prep, sp)
            else:
                ans = await self._enqueue(prep, b, t0, sp)
            mreg.histogram("serve.e2e_us").record(
                (time.perf_counter() - t0) * 1e6)
            return ans
        except BaseException:
            sp.set(error=True)
            raise
        finally:
            self.obs.close_span(sp)

    # -- internals ----------------------------------------------------------
    def _gauge_depth(self) -> None:
        self.obs.metrics.gauge("serve.queue_depth").set(self._depth)

    async def _run_solo(self, prep: PreparedQuery, sp) -> QueryAnswer:
        self.obs.metrics.counter("serve.solo").inc()
        await self._sem.acquire()
        self._active += 1
        try:
            ans = await self._loop.run_in_executor(self._pool, prep.execute)
        finally:
            self._active -= 1
            self._sem.release()
        sp.set(tier=ans.tier, route=ans.source)
        return ans

    async def _enqueue(self, prep: PreparedQuery, binding: dict,
                       t0: float, sp) -> QueryAnswer:
        if self._depth >= self.max_queue:
            self.obs.metrics.counter("serve.rejected").inc()
            raise AdmissionError(
                f"admission queue full ({self._depth} >= {self.max_queue})")
        lane = self._lanes.get(prep.shape_key)
        if lane is None:
            lane = self._lanes[prep.shape_key] = _ShapeLane(prep)
            lane.task = self._loop.create_task(self._dispatch_loop(lane))
        p = _Pending(binding, self._loop.create_future(), t0)
        lane.pending.append(p)
        self._depth += 1
        self._gauge_depth()
        lane.event.set()
        ans = await p.future
        sp.set(tier=ans.tier, route=ans.source,
               queue_us=(p.t_enq and (time.perf_counter() - p.t_enq) * 1e6))
        return ans

    async def _dispatch_loop(self, lane: _ShapeLane) -> None:
        """One shape's continuous-batching loop: wait for work, hold the
        batching window open until ``max_batch`` or ``max_wait_us``, seal,
        dispatch without awaiting (late arrivals gather for the next batch
        while this one runs)."""
        while self._running:
            if not lane.pending:
                lane.event.clear()
                await lane.event.wait()
                continue
            deadline = lane.pending[0].t_enq + self.max_wait_s
            while len(lane.pending) < self.max_batch:
                delay = deadline - time.perf_counter()
                if delay <= 0:
                    break
                lane.event.clear()
                try:
                    await asyncio.wait_for(lane.event.wait(), delay)
                except asyncio.TimeoutError:
                    break
            n = min(len(lane.pending), self.max_batch)
            batch = [lane.pending.popleft() for _ in range(n)]
            await self._sem.acquire()  # bounds the dispatches in flight
            self._active += 1
            self._depth -= n
            self._gauge_depth()
            # fire and continue: the loop seals the next batch while this
            # one runs (_run_batch releases the semaphore)
            task = self._loop.create_task(self._run_batch(lane, batch))
            self._batches.add(task)
            task.add_done_callback(self._batches.discard)

    async def _run_batch(self, lane: _ShapeLane, batch: list) -> None:
        mreg = self.obs.metrics
        try:
            t_disp = time.perf_counter()
            for p in batch:
                mreg.histogram("serve.queue_us").record(
                    (t_disp - p.t_enq) * 1e6)
            mreg.histogram("serve.batch_size").record(len(batch))
            mreg.counter("serve.batches").inc()
            prep, rows = lane.prep, [p.binding for p in batch]
            pad = (_bucket(len(rows), self.max_batch)
                   if self.pad_batches else None)

            def work():
                if len(rows) == 1:
                    return prep.execute(rows[0])
                return prep.execute_batch(rows, pad_to=pad)

            try:
                ans = await self._loop.run_in_executor(self._pool, work)
            except BaseException as e:
                # a failed dispatch fails its requests; nothing reruns them
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(e)
                return
            if len(batch) == 1:
                if not batch[0].future.done():
                    batch[0].future.set_result(ans)
                return
            mreg.counter("serve.coalesced_lanes").inc(len(batch))
            for i, p in enumerate(batch):
                if p.future.done():
                    continue
                p.future.set_result(QueryAnswer(
                    _lane_view(ans.value, i), tier=ans.tier,
                    source=ans.source, overflow=bool(ans.overflow[i])))
        finally:
            self._active -= 1
            self._sem.release()

    # -- introspection ------------------------------------------------------
    def stats(self) -> dict:
        """Live snapshot of the serving metrics (plain data)."""
        mreg = self.obs.metrics
        out = {
            "requests": mreg.value("serve.requests"),
            "tier1": mreg.value("serve.tier1"),
            "solo": mreg.value("serve.solo"),
            "batches": mreg.value("serve.batches"),
            "coalesced_lanes": mreg.value("serve.coalesced_lanes"),
            "rejected": mreg.value("serve.rejected"),
            "queue_depth": self._depth,
            "lanes": len(self._lanes),
        }
        for h in ("serve.batch_size", "serve.queue_us", "serve.tier1_us",
                  "serve.e2e_us"):
            m = mreg.get(h)
            if m is not None and m.count:
                out[h] = m.snapshot()
        return out
