"""The process groups and meshes of the port (counterpart of
``repro.launch.mesh``): the OLAP cluster's group (``olap_cluster``), the
LM meshes (:func:`make_production_mesh`, :func:`make_test_mesh`,
:func:`parse_mesh`) and the card's :func:`hardware_constants`.

The JAX package views its chips as a flat P-way ``nodes`` mesh.  The
port's cluster spans the W ranks of a ``torch.distributed`` process
group, rank r holding the L = P / W nodes ``[r*L, (r+1)*L)`` on its own
device (``core.engine.Topology``); without a group one process holds all
P.  Under ``python -m torch.distributed.run`` (torchrun) the entry points
(``Cluster``, ``TPCHDriver``, ``launch/serve_olap``) form the default
group themselves through :func:`init_from_env`: NCCL on
``cuda:LOCAL_RANK``, gloo on the CPU, a bounded timeout, the group
destroyed at exit.  Beside each group a cluster spans,
:func:`control_group` makes a gloo side group over the same ranks, once a
group and with the group's timeout: the channel of the serving engine's descriptors (rank 0's
``OLAPEngine`` leads, every other rank runs ``TPCHDriver.follow``) and
of the ranks' host barriers.  It is gloo on the card too: a descriptor is
a host object, and NCCL would read each one's size back from the card.

Every rank generates the same tables, and ``tpch/dbgen`` seeds with
``hash(table)``, so every rank needs the same ``PYTHONHASHSEED``
(``TPCHDriver`` checks the data and raises on a mismatch); torchrun
passes its own environment on to the ranks::

    PYTHONHASHSEED=0 PYTHONPATH=src python -m torch.distributed.run \\
        --standalone --nproc-per-node 4 -m repro_torch.launch.serve_olap \\
        --device cpu --sf 0.01 --queries q6 q1 q4_sj q18

Every OLAP path runs across the ranks: the queries, the cubes, prepared
batches, EXPLAIN ANALYZE and ``serve_olap --serve``, ``--cubes`` and
``--lint``.  Per-node generation (each rank making only its own nodes'
rows) waits in ROADMAP item 9.

The LM meshes are ``DeviceMesh``es over the default group with the
reference's axes, ``(data, model)`` or ``(pod, data, model)`` (the
decode-opt layout's ``(data, model_kv, model_b)``, ``launch/cells.py``),
on ``cuda`` under NCCL (one rank a card) or on ``cpu`` under gloo; the
sharded trainer (``train/trainer.py``) and the serve step
(``serve/engine.py``) lay their state out on them::

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --arch qwen2.5-3b \
        --smoke --mesh 2x2 --device cpu
"""
from __future__ import annotations

import atexit
import datetime
import os

import torch
import torch.distributed as dist

# how long a collective may wait for the other ranks: generation at SF 10
# takes about a minute a rank before the first one
TIMEOUT_S = 600.0

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


def under_torchrun() -> bool:
    """True in a process that torchrun started (its rendezvous variables
    are all set)."""
    return all(k in os.environ for k in _TORCHRUN_ENV)


# (a group's ranks, its timeout) -> (the default group it was made under,
# its gloo side group): one side group for every group over the same ranks
# with the same timeout, made anew once the default group is
_CONTROL: dict = {}


def group_timeout(group) -> float:
    """The seconds a collective of ``group`` waits for the other ranks:
    the timeout the group was made with (its backend's options; NCCL's on
    a CUDA group), ``TIMEOUT_S`` where this torch does not say."""
    dev = torch.device("cuda" if dist.get_backend(group) == "nccl"
                       else "cpu")
    try:
        timeout = group._get_backend(dev).options._timeout
    except (AttributeError, RuntimeError):
        return TIMEOUT_S
    return timeout.total_seconds()


def control_group(group):
    """The gloo side group over ``group``'s ranks, made on first use and
    kept while the default group lives, with ``group``'s timeout
    (:func:`group_timeout`).  Only the group's own ranks make it (local
    synchronization), so a group that is a part of the world, as a group
    of one rank, gets one too."""
    ranks = tuple(dist.get_process_group_ranks(group))
    world = dist.group.WORLD
    timeout = group_timeout(group)
    hit = _CONTROL.get((ranks, timeout))
    if hit is None or hit[0] is not world:
        hit = _CONTROL[ranks, timeout] = (world, dist.new_group(
            list(ranks), backend="gloo",
            timeout=datetime.timedelta(seconds=timeout),
            use_local_synchronization=True))
    return hit[1]


def destroy() -> None:
    """Tear the default group down, the side groups with it."""
    _CONTROL.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def init_from_env(device=None, timeout_s: float = TIMEOUT_S):
    """Form the default process group from torchrun's environment and
    return it: NCCL for a CUDA ``device`` (the current device set to
    ``cuda:LOCAL_RANK`` first), gloo for the CPU.  The group is destroyed
    at exit, so the process ends cleanly.  A process whose default group
    exists already gets that group."""
    if dist.is_initialized():
        return dist.group.WORLD
    if not under_torchrun():
        raise RuntimeError(
            f"no torchrun environment: set {', '.join(_TORCHRUN_ENV)} or "
            f"launch with python -m torch.distributed.run")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method="env://",
        timeout=datetime.timedelta(seconds=timeout_s))
    atexit.register(destroy)
    return dist.group.WORLD


_AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def _lm_mesh(shape: tuple, device_type: str, names: tuple | None = None):
    """A ``DeviceMesh`` of ``shape`` over the default group, which must
    hold exactly prod(shape) ranks, its dims named ``names``: by default
    the reference's axes for its rank (``data``; ``data, model``; ``pod,
    data, model``), or others such as the decode-opt layout's ``("data",
    "model_kv", "model_b")`` (``launch.cells.decode_opt_layout``)."""
    from torch.distributed.device_mesh import init_device_mesh

    names = _AXES[len(shape)] if names is None else tuple(names)
    if len(names) != len(shape):
        raise ValueError(f"a mesh of {shape} needs {len(shape)} dim names, "
                         f"got {names}")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise ValueError(
            f"a mesh of {shape} needs a process group of {n} ranks, this "
            f"process has {world or 'none'}: launch with python -m "
            f"torch.distributed.run (torchrun) --nproc-per-node {n}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def parse_mesh(spec: str, device_type: str = "cuda"):
    """``D``, ``DxM`` or ``PxDxM`` -> the mesh of that shape over the
    default group (``data``; ``data, model``; ``pod, data, model``)."""
    shape = tuple(int(x) for x in spec.split("x"))
    if len(shape) not in _AXES or min(shape) < 1:
        raise ValueError(f"--mesh {spec!r}: give D, DxM or PxDxM")
    return _lm_mesh(shape, device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) over (data, model), or (2, 16, 16) over (pod, data, model):
    256 or 512 ranks."""
    return _lm_mesh((2, 16, 16) if multi_pod else (16, 16), device_type)


def make_test_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """The scaled-down mesh of the reference's tests: (2, 2, 2) or (4, 2),
    8 ranks."""
    return _lm_mesh((2, 2, 2) if multi_pod else (4, 2), device_type)


# NVIDIA H100 SXM5 80GB: dense bf16 tensor-core peak, HBM3 rate, NVLink 4
# (18 links of 25 GB/s each way a card)
H100 = {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0,
        "peak_flops_bf16": 989e12, "hbm_bandwidth": 3.35e12,
        "nvlink_link_bandwidth": 25e9, "nvlink_links": 18,
        "hbm_bytes": 80 * 10**9}


def hardware_constants(device=None) -> dict:
    """The card's roofline constants under the reference's keys
    (``peak_flops_bf16`` FLOP/s, ``hbm_bandwidth`` B/s,
    ``ici_link_bandwidth`` B/s a link: NVLink 4's, ``hbm_bytes``), with
    its name and power limit beside them.  The H100's datasheet numbers;
    ``hbm_bytes`` and the name from the card when one is present."""
    out = {"peak_flops_bf16": H100["peak_flops_bf16"],
           "hbm_bandwidth": H100["hbm_bandwidth"],
           "ici_link_bandwidth": H100["nvlink_link_bandwidth"],
           "hbm_bytes": H100["hbm_bytes"],
           "links": H100["nvlink_links"],
           "device": H100["name"], "power_limit_w": H100["power_limit_w"]}
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(device or 0)
        out.update(hbm_bytes=props.total_memory, device=props.name)
    return out


def olap_cluster(num_nodes: int = 8, device=None, group=None):
    """The paper's P-node shared-nothing cluster over ``group`` (the
    default group when ``torch.distributed`` is initialised, one formed
    from torchrun's environment, else none: one process)."""
    from repro_torch.core.engine import Cluster

    return Cluster(num_nodes, device=device, group=group)
