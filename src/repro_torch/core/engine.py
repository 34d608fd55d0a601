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


def psum(x: torch.Tensor) -> torch.Tensor:
    """All-reduce (sum) of per-node partials: (P, ...) -> (...), summed in
    node order."""
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

    def part(self, table: str) -> RangePartitioning:
        return self.parts[table]

    def cap(self, name: str, default: int = 4096) -> int:
        return int(self.capacities.get(name, default))


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
                wire: str = "packed") -> PlanContext:
        parts = {
            name: RangePartitioning(t.num_rows,
                                    1 if t.replicated else self.num_nodes)
            for name, t in tables.items()
        }
        return PlanContext(num_nodes=self.num_nodes, parts=parts,
                           capacities=dict(capacities or {}),
                           device=self.device, scale_factor=scale_factor,
                           backend=backend, wire=wire)

    # -- compilation -------------------------------------------------------
    def compile(self, plan: Callable, ctx: PlanContext) -> Callable:
        """Bind a plan to its context: returns ``fn(columns)`` over the
        placed column dicts (table name -> column name -> column), with
        the plan as ``fn.plan``.

        Compressed residency: tables may hold PackedColumn entries.  A plan
        that declares ``handles_packed`` (the IR lowering) receives them
        as-is and scans the packed words directly; every other plan gets a
        full decode at plan entry."""
        if getattr(plan, "handles_packed", False):
            def entry(columns):
                return columns
        else:
            def entry(columns):
                return {t: decode_columns(c) for t, c in columns.items()}

        def run(columns):
            return plan(ctx, entry(columns))

        run.plan = plan
        return run

    def run(self, plan: Callable, tables: Mapping[str, Table],
            capacities=None, *, backend: str = "xla",
            scale_factor: float = 1.0, wire: str = "packed"):
        """Convenience: place, compile, execute."""
        placed = {name: self.load(t) for name, t in tables.items()}
        ctx = self.context(placed, capacities, backend=backend,
                           scale_factor=scale_factor, wire=wire)
        fn = self.compile(plan, ctx)
        return fn({name: t.columns for name, t in placed.items()})
