"""Elastic scaling + straggler mitigation policy: a copy of
``repro.train.elastic`` (pure Python; the port keeps its own copy so that
it imports nothing of ``repro``).  The paper's 'Future Work: fault
tolerance ... introduce some redundancy without excessive cost', built into
this framework as first-class machinery.

The mechanism rests on three properties the substrates already have:
1. deterministic sharded data (data/synthetic.py, tpch/dbgen): shard i of
   step t is a pure function of (seed, t, i) — any node can regenerate any
   shard, so a replacement node needs NO state transfer beyond the
   checkpoint,
2. mesh-agnostic checkpoints (train/checkpoint.py): saved per logical
   leaf, restorable onto any mesh whose axes divide the shapes,
3. jit re-lowering: the train step recompiles for the new mesh (the cost
   is one compile, ~minutes, amortized over hours of training).

`plan_restart` chooses the largest valid mesh from the surviving device
count; `StragglerMonitor` implements step-time-based detection: a node
whose step time exceeds `threshold x median` over a window is flagged for
eviction (on TPU pods the symptom is usually host-side input stalls —
which deterministic on-device data generation already minimizes).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple
    axes: tuple
    devices_used: int


def plan_restart(num_devices: int, *, model_parallel: int = 16,
                 want_pods: int | None = None) -> MeshPlan:
    """Largest (pod, data, model) mesh embeddable in the surviving devices.
    model parallelism is pinned (param shards must divide); data/pod axes
    absorb the loss — e.g. 512 -> 496 survivors restarts as (1, 31, 16)."""
    assert num_devices >= model_parallel, "fewer devices than model shards"
    rows = num_devices // model_parallel
    if want_pods and rows % want_pods == 0 and rows // want_pods > 0:
        return MeshPlan((want_pods, rows // want_pods, model_parallel),
                        ("pod", "data", "model"),
                        want_pods * (rows // want_pods) * model_parallel)
    return MeshPlan((rows, model_parallel), ("data", "model"),
                    rows * model_parallel)


def rebalance_batch(global_batch: int, data_shards: int) -> int:
    """Per-shard batch after a re-mesh; keeps the GLOBAL batch stable by
    rounding the shard batch up and truncating the final shard (documented
    drop <1/shards)."""
    return -(-global_batch // data_shards)


class StragglerMonitor:
    """Step-time watchdog: flags ranks whose rolling step time exceeds
    threshold x the cluster median (the classic TPU-pod straggler signal)."""

    def __init__(self, window: int = 16, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self.times: dict[int, deque] = {}

    def record(self, rank: int, step_seconds: float):
        self.times.setdefault(rank, deque(maxlen=self.window)).append(step_seconds)

    def medians(self) -> dict[int, float]:
        out = {}
        for r, d in self.times.items():
            s = sorted(d)
            out[r] = s[len(s) // 2]
        return out

    def stragglers(self) -> list[int]:
        med = self.medians()
        if not med:
            return []
        cluster = sorted(med.values())[len(med) // 2]
        return [r for r, m in med.items() if m > self.threshold * cluster]


class Heartbeat:
    """Step-level liveness: the trainer calls beat() every step; a deadline
    miss marks the run for checkpoint-restart (the launcher polls is_alive).
    On a real cluster this is the coordinator RPC; here it is the same
    policy object the tests drive."""

    def __init__(self, deadline_seconds: float = 300.0, clock=time.monotonic):
        self.deadline = deadline_seconds
        self._clock = clock
        self.last = clock()

    def beat(self):
        self.last = self._clock()

    def is_alive(self) -> bool:
        return (self._clock() - self.last) < self.deadline
