"""Query execution driver, node-stacked, in one process or across W.

Counterpart of ``repro.core.engine``.  The paper's runtime is "a
precompiled function per query, run on every node, synchronized by
collectives".  In the port the nodes a process holds are stacked on the
leading axis of every partitioned tensor on ONE device: a plan is a Python
function ``plan(ctx, tables)`` whose body works on all of them at once
(one kernel launch covers every node; the node index is a grid
dimension).  PyTorch runs eagerly, so ``Cluster.compile`` only binds the
plan to its context and returns a callable.

Without a process group one process holds all P nodes and a collective is
an operation over the node axis: ``psum(x)`` is ``x.sum(0)``, the
exchanges are in :mod:`repro_torch.core.exchange`.  With a
``torch.distributed`` group of W ranks (NCCL on CUDA, gloo on the CPU)
rank r holds the ``L = P / W`` nodes ``[r*L, (r+1)*L)`` on its own device
(:class:`Topology`); a collective reduces or exchanges over the local
axis first and then across the ranks, and ``node_ids`` stands for
``lax.axis_index``.  While a bound plan runs, its cluster's topology is
the active one (:func:`active_topology`), which the collectives and the
partitionings read.

Beside the group its collectives cross, a distributed topology holds a
gloo side group over the same ranks (``control``, made once a group by
``launch.mesh.control_group``): the descriptor channel of the serving
engine, rank 0 leading and the others following (:func:`descriptor`), and
the ranks' host barrier (:func:`barrier`).  It carries host objects only,
so a descriptor costs the card nothing (a broadcast of Python objects
over NCCL would read each one's size back from the card).
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Mapping, Optional

import torch
import torch.distributed as dist

from repro_torch.core.columnar import PackedColumn, Table, decode_columns
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


# ---------------------------------------------------------------------------
# topology: which of the P nodes this process holds
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Topology:
    """W ranks of a process group together hold P nodes; rank r holds the
    ``local_nodes = P / W`` nodes from ``node_offset = r * L``.  Without a
    group (``group`` None, W = 1) the process holds all P nodes."""

    num_nodes: int          # P, the cluster's nodes
    world: int = 1          # W, the ranks of the group
    rank: int = 0           # this process's rank in the group
    group: Any = None       # torch.distributed ProcessGroup, None in-process
    control: Any = None     # the gloo side group over the same ranks

    def __post_init__(self):
        if self.num_nodes % self.world:
            raise ValueError(
                f"{self.num_nodes} nodes do not split evenly over "
                f"{self.world} ranks (P % W != 0)")

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def local_nodes(self) -> int:
        return self.num_nodes // self.world

    @property
    def node_offset(self) -> int:
        return self.rank * self.local_nodes

    def node_ids(self, device=None) -> torch.Tensor:
        """Global ids of the nodes this process holds: (L,) int64."""
        return self.node_offset + torch.arange(self.local_nodes,
                                               device=device)

    def rank_of(self, node: int) -> int:
        """The group rank that holds global node ``node``."""
        return node // self.local_nodes

    def global_rank(self, group_rank: int) -> int:
        """``group_rank``'s rank in the default group (what the
        point-to-point and broadcast calls name)."""
        return dist.get_global_rank(self.group, group_rank)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_topology", default=None)


def active_topology() -> Optional[Topology]:
    """The distributed topology of the plan running in this context; None
    in-process (the collectives then reduce over the node axis only)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def running_on(topology: Topology):
    """Make ``topology`` the active one for the body (a no-op for an
    in-process topology)."""
    token = _ACTIVE.set(topology if topology.distributed else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def node_ids(num_nodes: int, device=None) -> torch.Tensor:
    """Global ids of the nodes this process holds of a ``num_nodes``-node
    partitioning: the counterpart of ``lax.axis_index``.  The active
    topology's ids where it has ``num_nodes`` nodes, else all of them
    (in-process, or a replicated table's single partition)."""
    topo = _ACTIVE.get()
    if topo is not None and topo.num_nodes == num_nodes:
        return topo.node_ids(device)
    return torch.arange(num_nodes, device=device)


def local_topology(local: int) -> Optional[Topology]:
    """The active topology of a collective over ``local`` stacked nodes
    (None in-process, where ``local`` is P); raises when the operand does
    not hold the rank's L nodes."""
    topo = _ACTIVE.get()
    if topo is not None and local != topo.local_nodes:
        raise ValueError(
            f"a collective over {local} stacked nodes on rank {topo.rank}, "
            f"which holds {topo.local_nodes} of {topo.num_nodes}")
    return topo


def cluster_nodes(local: int) -> int:
    """P for an operand over ``local`` stacked nodes."""
    topo = local_topology(local)
    return local if topo is None else topo.num_nodes


# torch.distributed calls the collectives made, by kind, since the last
# reset (0 in-process): what shows that a run crossed the process group
_DIST_CALLS: collections.Counter = collections.Counter()


def dist_calls() -> dict:
    """Kind -> torch.distributed calls since :func:`reset_dist_calls`."""
    return dict(_DIST_CALLS)


def reset_dist_calls() -> None:
    _DIST_CALLS.clear()


def descriptor(obj, topo: Topology):
    """Rank 0's ``obj`` (any picklable host object) on every rank of the
    topology: one broadcast over its gloo side group, so nothing is read
    back from the card.  Counted in :func:`dist_calls` as "descriptor";
    not a plan's collective, so not in the collective record."""
    _DIST_CALLS["descriptor"] += 1
    box = [obj]
    dist.broadcast_object_list(box, src=topo.global_rank(0),
                               group=topo.control)
    return box[0]


def barrier(topo: Topology) -> None:
    """Wait until every rank of the topology reaches this call (over the
    side group, on the host; counted as "barrier")."""
    _DIST_CALLS["barrier"] += 1
    dist.barrier(group=topo.control)


def wire_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the process group ships it: bools as bytes (gloo has no
    bool type), everything else as it is."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def all_reduce(t: torch.Tensor, op: str, topo: Topology) -> torch.Tensor:
    """In-place all-reduce (``op`` "sum", "max" or "min") of ``t`` over
    the topology's group; bools reduce as bytes."""
    _DIST_CALLS["all_reduce"] += 1
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    dist.all_reduce(wire_view(t), op=red, group=topo.group)
    return t


def all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``out`` (W * n,) = every rank's ``inp`` (n,) in rank order:
    ``all_gather_single`` where this torch has it, else its older name
    ``all_gather_into_tensor``; bools as bytes."""
    _DIST_CALLS["all_gather"] += 1
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(wire_view(out), wire_view(inp), group=group)


def any_across(flag: torch.Tensor) -> torch.Tensor:
    """A 0-d bool flag, True where any rank of the active topology has it
    (an overflow or go-on flag; not a plan's collective, so not recorded).
    In-process it is the flag itself."""
    topo = _ACTIVE.get()
    if topo is None:
        return flag
    t = flag.reshape(1).to(torch.int32)
    return all_reduce(t, "max", topo)[0].bool()


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
    """Append one collective over the node-stacked operand ``x`` (L, ...)
    to the record: its bytes per node are the operand's bytes over L, so
    a rank of a group records what one process records."""
    nodes = max(int(x.shape[0]), 1) if x.ndim else 1
    _RECORD.append(CollectiveInstr(name or kind, kind,
                                   x.numel() * x.element_size() // nodes))


def collective_record() -> tuple:
    """The collectives since the last :func:`reset_collective_record`,
    program-ordered :class:`CollectiveInstr` records."""
    return tuple(_RECORD)


def reset_collective_record() -> None:
    _RECORD.clear()


def sum_across(t: torch.Tensor, topo: Topology) -> torch.Tensor:
    """Every rank's ``t`` summed, the same bytes on every rank.  A float
    ``t`` is all-gathered into (W, ...) in rank order and folded left to
    right (``acc = g[0]``, then ``acc + g[r]``), so an element's sum does
    not depend on where it lies in the buffer: a ring all-reduce sums
    each chunk from another rank, and a lane of a batch would then differ
    from the same request run alone.  Integer and bool sums are exact and
    keep the all-reduce."""
    if not t.is_floating_point():
        return all_reduce(t, "sum", topo)
    t = t.contiguous()
    g = torch.empty((topo.world, *t.shape), dtype=t.dtype, device=t.device)
    all_gather(g.view(-1), t.view(-1), topo.group)
    acc = g[0]
    for r in range(1, topo.world):
        acc = acc + g[r]
    return acc


def psum(x: torch.Tensor, name: str = "psum") -> torch.Tensor:
    """All-reduce (sum) of per-node partials: (L, ...) -> (...), summed in
    node order on each rank, then across the ranks in rank order
    (:func:`sum_across`); recorded as one all-reduce under ``name``, the
    JAX plan's collective."""
    record_collective("all-reduce", x, name)
    out = x.sum(0)
    topo = local_topology(x.shape[0])
    if topo is not None:
        out = sum_across(out, topo)
    return out


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
    # which nodes this process holds (None: all of them, in-process)
    topology: Optional[Topology] = None

    @property
    def local_nodes(self) -> int:
        """L, the nodes stacked on this process's device."""
        return (self.num_nodes if self.topology is None
                else self.topology.local_nodes)

    def node_ids(self, device=None) -> torch.Tensor:
        """Global ids of the local nodes (``lax.axis_index``): (L,)."""
        if self.topology is None:
            return torch.arange(self.num_nodes, device=device)
        return self.topology.node_ids(device)

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


def _default_group(group, device: torch.device):
    """The group a cluster spans: the one given, else the default group
    when ``torch.distributed`` is initialised, else one formed from
    torchrun's environment (``launch.mesh.init_from_env``), else None."""
    if group is not None or not dist.is_available():
        return group
    if dist.is_initialized():
        return dist.group.WORLD
    from repro_torch.launch import mesh  # launch imports the core

    if mesh.under_torchrun():
        return mesh.init_from_env(device)
    return None


def _group_topology(num_nodes: int, group, device: torch.device
                    ) -> Topology:
    """The topology of a ``num_nodes``-node cluster over ``group`` and its
    side group: raises when the group's backend cannot serve ``device``
    (NCCL for CUDA, gloo for the CPU), when the ranks disagree on P, or
    when P % W != 0."""
    backend = str(dist.get_backend(group))
    need = "nccl" if device.type == "cuda" else "gloo"
    if need not in backend:
        raise ValueError(
            f"a {backend!r} process group cannot serve a cluster on "
            f"{device}: its collectives need {need}")
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    # every rank must agree on P before any plan runs (this first call
    # also opens the group's communicator on every rank)
    mine = torch.tensor([num_nodes], dtype=torch.int64, device=device)
    every = torch.empty(world, dtype=torch.int64, device=device)
    all_gather(every, mine, group)
    if (every != num_nodes).any():
        raise ValueError(f"the ranks disagree on the cluster's nodes: "
                         f"{every.tolist()}")
    topo = Topology(num_nodes, world, rank, group)
    from repro_torch.launch import mesh  # launch imports the core

    return dataclasses.replace(topo, control=mesh.control_group(group))


def _rows_per_node(t: Table) -> int:
    col = next(iter(t.columns.values()))
    return col.rows if isinstance(col, PackedColumn) else int(col.shape[1])


class Cluster:
    """A shared-nothing cluster of ``num_nodes`` nodes, stacked on the
    leading axis of tensors on ``device``: all of them in one process, or,
    with a process ``group`` of W ranks (the default group when
    ``torch.distributed`` is initialised, or one formed from torchrun's
    environment), the rank's L = P / W of them on each rank's device.

    Constructing a ``Cluster`` turns TF32 off for the whole process
    (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` set to False), which every other
    float32 matmul and convolution in the process then sees."""

    def __init__(self, num_nodes: int = 8, device=None, group=None):
        if num_nodes < 1:
            raise ValueError(f"num_nodes must be >= 1, got {num_nodes}")
        self.num_nodes = num_nodes
        device = resolve_device(device)
        group = _default_group(group, device)
        if group is None:
            self.topology = Topology(num_nodes)
        else:
            self.topology = _group_topology(num_nodes, group, device)
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        # f32 aggregates must not run in TF32 (about three decimal digits):
        # the q1 sums would miss the float64 oracle's 2e-4 tolerance
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # -- data placement ----------------------------------------------------
    def load(self, table: Table) -> Table:
        """Place a node-stacked host table (all P nodes) on the cluster's
        device: a replicated table whole, a partitioned one's L rows of
        this rank."""
        if table.replicated:
            return table.to(self.device)
        for name, col in table.columns.items():
            if col.shape[0] != self.num_nodes:
                raise ValueError(
                    f"column {table.name}.{name} is stacked over "
                    f"{col.shape[0]} nodes, the cluster has "
                    f"{self.num_nodes}")
        topo = self.topology
        if topo.distributed:
            lo, hi = topo.node_offset, topo.node_offset + topo.local_nodes
            cols = {n: (dataclasses.replace(c, words=c.words[lo:hi],
                                            num_nodes=hi - lo)
                        if isinstance(c, PackedColumn) else c[lo:hi])
                    for n, c in table.columns.items()}
            table = Table(table.name, cols, table.dictionaries)
        return table.to(self.device)

    def context(self, tables: Mapping[str, Table], capacities=None, *,
                backend: str = "xla", scale_factor: float = 1.0,
                wire: str = "packed", wires=None) -> PlanContext:
        """The plan context over placed ``tables`` (each rank's own rows;
        the partitionings are global)."""
        parts = {
            name: (RangePartitioning(t.num_rows, 1) if t.replicated else
                   RangePartitioning(_rows_per_node(t) * self.num_nodes,
                                     self.num_nodes))
            for name, t in tables.items()
        }
        return PlanContext(num_nodes=self.num_nodes, parts=parts,
                           capacities=dict(capacities or {}),
                           device=self.device, scale_factor=scale_factor,
                           backend=backend, wire=wire,
                           wires=dict(wires or {}),
                           topology=self.topology)

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
        it (``columnar.decode_columns``).

        The returned function runs under the cluster's topology: with a
        process group every rank calls it, in the same order as every
        other bound plan, and the collectives cross the group."""
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

        topo = self.topology
        if params:
            def run(columns, pvals):
                with running_on(topo):
                    return plan(ctx, entry(columns), pvals)
        else:
            def run(columns):
                with running_on(topo):
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
