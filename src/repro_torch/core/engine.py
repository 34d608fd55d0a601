"""Query execution driver, node-stacked.

Counterpart of ``repro.core.engine``.  The paper's runtime is "a
precompiled function per query, run on every node, synchronized by
collectives".  In the port the P nodes of the cluster are stacked on the
leading axis of every partitioned tensor on ONE device: a plan is a Python
function ``plan(ctx, tables)`` whose body works on all nodes at once (one
kernel launch covers every node; the node index is a grid dimension), and
a collective is an operation over the node axis — ``psum(x)`` is
``x.sum(0)``, the exchanges are in :mod:`repro_torch.core.exchange`.
PyTorch runs eagerly, so ``Cluster.compile`` only binds the plan to its
context and returns a callable.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Mapping

import torch

from repro_torch.core.columnar import Table, decode_columns
from repro_torch.core.partitioning import RangePartitioning


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Without a device and without CUDA this raises rather than
    carrying on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU (plain PyTorch versions of the kernels)")
        device = "cuda"
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class CollectiveInstr:
    """One collective a plan issued, in program order: what the JAX
    package parses out of its compiled HLO (``repro.launch.roofline.
    CollectiveInstr``), recorded here as the collective runs."""

    name: str   # what issued it ("psum", "request_reply:q4_sj_sj0", ...)
    kind: str   # all-to-all | all-reduce | all-gather | collective-permute
    bytes: int  # operand bytes a node injects


# The program-ordered collective record of every collective since the last
# reset (the per-kind byte totals of ``exchange.wire_bytes`` sit beside
# it).  It lives here, not in ``exchange``, so ``psum`` writes it without
# importing the exchange layer (which imports this module).  Bounded: a
# long-running server keeps the newest RECORD_MAX entries.
RECORD_MAX = 1 << 16
_RECORD: collections.deque = collections.deque(maxlen=RECORD_MAX)


def record_collective(kind: str, x: torch.Tensor, name: str = "") -> None:
    """Append one collective over the node-stacked operand ``x`` (P, ...)
    to the record: its bytes per node are the operand's bytes over P."""
    nodes = max(int(x.shape[0]), 1) if x.ndim else 1
    _RECORD.append(CollectiveInstr(name or kind, kind,
                                   x.numel() * x.element_size() // nodes))


def collective_record() -> tuple:
    """The collectives since the last :func:`reset_collective_record`,
    program-ordered :class:`CollectiveInstr` records."""
    return tuple(_RECORD)


def reset_collective_record() -> None:
    _RECORD.clear()


def psum(x: torch.Tensor) -> torch.Tensor:
    """All-reduce (sum) of per-node partials: (P, ...) -> (...), summed in
    node order; recorded as one all-reduce."""
    record_collective("all-reduce", x, "psum")
    return x.sum(0)


@dataclasses.dataclass(frozen=True)
class PlanContext:
    """Static execution context threaded through every plan."""

    num_nodes: int
    parts: Mapping[str, RangePartitioning]  # table name -> partitioning
    capacities: Mapping[str, int]            # plan-specific buffer capacities
    device: torch.device
    scale_factor: float = 1.0
    backend: str = "xla"      # all-to-all backend: "xla" | "one_factor"
    wire: str = "packed"      # exchange wire format: "packed" | "raw"
    # hand-plan exchange name -> exchange.WireFormat (tpch.capacities)
    wires: Mapping[str, object] = dataclasses.field(default_factory=dict)

    def part(self, table: str) -> RangePartitioning:
        return self.parts[table]

    def cap(self, name: str, default: int = 4096) -> int:
        return int(self.capacities.get(name, default))

    def wire_fmt(self, name: str):
        """Wire format of the named hand-plan exchange; raw when the
        context disables packing or no format was derived for it."""
        from repro_torch.core.exchange import WireFormat  # imports engine

        if self.wire != "packed":
            return WireFormat.raw()
        return self.wires.get(name, WireFormat.raw())


class Cluster:
    """A shared-nothing cluster of ``num_nodes`` nodes, stacked on the
    leading axis of tensors on one ``device``.

    Constructing a ``Cluster`` turns TF32 off for the whole process
    (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` set to False), which every other
    float32 matmul and convolution in the process then sees."""

    def __init__(self, num_nodes: int = 8, device=None):
        if num_nodes < 1:
            raise ValueError(f"num_nodes must be >= 1, got {num_nodes}")
        self.num_nodes = num_nodes
        self.device = resolve_device(device)
        # f32 aggregates must not run in TF32 (about three decimal digits):
        # the q1 sums would miss the float64 oracle's 2e-4 tolerance
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # -- data placement ----------------------------------------------------
    def load(self, table: Table) -> Table:
        """Place a node-stacked host table on the cluster's device."""
        if not table.replicated:
            for name, col in table.columns.items():
                if col.shape[0] != self.num_nodes:
                    raise ValueError(
                        f"column {table.name}.{name} is stacked over "
                        f"{col.shape[0]} nodes, the cluster has "
                        f"{self.num_nodes}")
        return table.to(self.device)

    def context(self, tables: Mapping[str, Table], capacities=None, *,
                backend: str = "xla", scale_factor: float = 1.0,
                wire: str = "packed", wires=None) -> PlanContext:
        parts = {
            name: RangePartitioning(t.num_rows,
                                    1 if t.replicated else self.num_nodes)
            for name, t in tables.items()
        }
        return PlanContext(num_nodes=self.num_nodes, parts=parts,
                           capacities=dict(capacities or {}),
                           device=self.device, scale_factor=scale_factor,
                           backend=backend, wire=wire,
                           wires=dict(wires or {}))

    # -- compilation -------------------------------------------------------
    def compile(self, plan: Callable, ctx: PlanContext, *,
                batch: bool = False) -> Callable:
        """Bind a plan to its context: returns ``fn(columns)`` over the
        placed column dicts (table name -> column name -> column), with
        the plan as ``fn.plan``.

        A PARAMETERIZED plan (``plan.params`` non-empty, the lowered form
        of a query with ``Param`` placeholders) binds to ``fn(columns,
        params)``, ``params`` mapping each name to a 0-d tensor on the
        cluster's device: the compile-once / execute-many model, one plan
        for every binding.  With ``batch=True`` (a plan lowered with
        ``batched=True``) each value is a ``(B,)`` tensor, one binding a
        lane, and every output gains a leading lane axis.

        Compressed residency: tables may hold PackedColumn entries.  A plan
        that declares ``handles_packed`` (the IR lowering) receives them
        as-is and scans the packed words directly; every other plan gets
        its columns decoded at plan entry, each when the plan first reads
        it (``columnar.decode_columns``)."""
        params = tuple(getattr(plan, "params", ()) or ())
        if batch and not params:
            raise ValueError("batch=True requires a parameterized plan")
        if batch != bool(getattr(plan, "batched", False)):
            raise ValueError(f"batch={batch} binds only a plan lowered "
                             f"with batched={batch}")
        if getattr(plan, "handles_packed", False):
            def entry(columns):
                return columns
        else:
            def entry(columns):
                return {t: decode_columns(c) for t, c in columns.items()}

        if params:
            def run(columns, pvals):
                return plan(ctx, entry(columns), pvals)
        else:
            def run(columns):
                return plan(ctx, entry(columns))

        run.plan = plan
        return run

    def run(self, plan: Callable, tables: Mapping[str, Table],
            capacities=None, *, backend: str = "xla",
            scale_factor: float = 1.0, wire: str = "packed", wires=None):
        """Convenience: place, compile, execute.  ``wires`` maps a hand
        plan's named exchanges to their wire formats
        (``tpch.capacities.wire_formats``); without it they ship raw."""
        placed = {name: self.load(t) for name, t in tables.items()}
        ctx = self.context(placed, capacities, backend=backend,
                           scale_factor=scale_factor, wire=wire, wires=wires)
        fn = self.compile(plan, ctx)
        return fn({name: t.columns for name, t in placed.items()})
