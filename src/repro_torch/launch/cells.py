"""Cells: (architecture x input shape x mesh) -> the built model, its
parameters and decode state laid out on the mesh, and its step
(counterpart of ``repro.launch.cells``, for serving).

The reference lowers and compiles each cell through XLA and reads its
roofline terms.  The port runs eagerly, so a cell here is what that
lowering takes in: :func:`build_cell` returns a :class:`Cell` whose
``step`` runs on this rank's blocks.  The layout math is the reference's
and pure (:func:`pick_microbatches`, :func:`choose_decode_layout`);
:func:`decode_opt_layout` builds the decode-optimized mesh ``(data,
model_kv, model_b)`` over the default group.  The train kind, the
reference's ``CellResult`` and :func:`run_cell` wait for
``launch/{flops, roofline}.py`` (ROADMAP.md queue A, item 11.6).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.registry import (SHAPES, ShapeCell, cell_runnable,
                                          get_arch)
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import runtime
from repro_torch.models import sharding as SH
from repro_torch.models.model import Model, build
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import check_mesh_family, make_serve_step

_WAITS = ("waits for launch/{flops, roofline}.py: ROADMAP.md queue A, "
          "item 11.6")
DECODE_OPT_AXES = ("data", "model_kv", "model_b")


def pick_microbatches(cfg, shape: ShapeCell, mesh,
                      target_tokens_per_device: int = 8192) -> int:
    """Microbatches of a train cell: about ``target_tokens_per_device``
    tokens a data shard each, dividing the global batch with at least one
    row a shard; 1 for any other kind.  ``mesh``: a ``DeviceMesh`` or a
    ``sharding.MeshShape``."""
    if shape.kind != "train":
        return 1
    shards = SH.batch_shards(mesh)
    tokens_per_device = shape.global_batch * shape.seq_len // shards
    mb = max(1, tokens_per_device // target_tokens_per_device)
    while mb > 1 and (shape.global_batch % mb
                      or (shape.global_batch // mb) % shards):
        mb -= 1
    return mb


def choose_decode_layout(cfg, shape: ShapeCell, *, chips: int = 256,
                         data: int = 16):
    """The decode layout's pure selection math: the kv shard degree is the
    power of two with the least kv-head padding (then the largest) whose
    freed ranks still divide the batch.  Returns (mesh shape, kv_shard,
    model_b); raises where no degree fits."""
    model = chips // data
    kv = max(cfg.n_kv_heads, 1)
    best = None
    ks = 1
    while ks <= model:
        model_b = model // ks
        if shape.global_batch % (data * model_b) == 0:
            pad = (ks - kv % ks) % ks if kv % ks else 0
            score = (pad, -ks)
            if best is None or score < best[0]:
                best = (score, ks, model_b)
        ks *= 2
    if best is None:
        raise ValueError(f"no valid decode layout of {chips} chips with "
                         f"data {data} for a batch of {shape.global_batch}")
    _, kv_shard, model_b = best
    return (data, kv_shard, model_b), kv_shard, model_b


def decode_opt_rules() -> dict:
    """The decode-opt layout's rules: the reference's, with the batch over
    ``(data, model_b)`` and the weights' tensor-parallel dims over
    ``model_kv`` only (activations hold ``model_b`` with their batch rows,
    so weights split there would be gathered every step)."""
    rules = dict(SH.DEFAULT_RULES)
    rules.update({"batch": ("data", "model_b"), "kv_heads": "model_kv",
                  "heads": "model_kv", "vocab": "model_kv",
                  "mlp": "model_kv", "expert": ("model_kv", "model_b"),
                  "embed": "data"})
    return rules


def decode_opt_layout(cfg, shape: ShapeCell, *, chips: int = 256,
                      data: int = 16, device_type: str = "cuda"):
    """The decode layout: the ``model`` ranks split into ``(model_kv,
    model_b)`` so the kv heads shard at their natural degree and the freed
    ranks take batch rows instead of reading padded cache copies.
    Returns (the ``DeviceMesh`` ``(data, model_kv, model_b)`` over the
    default group, which must hold ``chips`` ranks, the rules, tp,
    tp_kv)."""
    mesh_shape, kv_shard, _ = choose_decode_layout(cfg, shape, chips=chips,
                                                   data=data)
    mesh = launch_mesh._lm_mesh(mesh_shape, device_type, DECODE_OPT_AXES)
    return mesh, decode_opt_rules(), chips // data, kv_shard


@dataclasses.dataclass
class Cell:
    """A built cell.  ``params`` are DTensors laid out on ``mesh`` by
    ``rules``; ``state`` is this rank's blocks of the decode state
    (``decode_state_axes``); ``step`` is ``prefill(params, batch,
    **fwd_kw) -> (logits, state)`` for a prefill cell, filling ``state``,
    or the serve step ``(params, state, token) -> (token, state)`` for a
    decode cell, each on this rank's batch rows (:meth:`local`).
    ``reduced`` lists the cuts of the shape."""

    shape: ShapeCell
    model: Model
    mesh: object
    rules: dict
    params: Transformer
    state: object
    step: Callable
    reduced: tuple

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x`` (the global batch first)."""
        axes = ("batch",) + (None,) * (x.ndim - 1)
        return SH.local_block(x, SH.Sharding(
            self.mesh, SH.resolve(axes, self.mesh, self.rules)))


def _device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _placed(model, params, mesh, rules, device) -> Transformer:
    """``params`` laid out on the mesh (DTensors already there are kept),
    or random ones from seed 0 cast for serving."""
    from torch.distributed.tensor import DTensor

    if params is None:
        params = model.cast(model.init(0, device=device))
    elif all(isinstance(p, DTensor) and p.device_mesh == mesh
             for p in params.parameters()):
        return params
    return Transformer(SH.shard_tree(params.tree(), SH.sharding_tree(
        model.param_axes(), mesh, rules)))


def build_cell(arch: str, shape_name: str, mesh, *, layout: str = "default",
               cache_quant: bool = False, batch: int | None = None,
               smoke: bool = False, seq_len: int | None = None,
               params: Transformer | None = None) -> Cell:
    """One serving cell on ``mesh`` (a ``DeviceMesh`` over the default
    group): the counterpart of the reference's ``lower_cell`` for the
    prefill and decode kinds, without the XLA lowering.

    ``layout="decode_opt"`` (decode cells) builds the mesh of
    :func:`decode_opt_layout` over as many ranks as ``mesh`` holds, with
    its ``data`` size (the reference takes 16, which needs 16 chips or
    more), and the model with its ``tp`` and ``tp_kv``; the default layout
    pads the heads to ``mesh``'s ``model`` size and degrades the batch
    rule where the batch does not divide the data shards.
    ``batch`` and ``seq_len`` cut the shape's global batch and positions
    so that the cell fits; each cut is listed in ``Cell.reduced``.
    ``params``: full values on every rank, laid out here, or parameters
    laid out on this mesh already; by default random ones from seed 0.
    The state is made in the compute dtype (int8 codes with
    ``cache_quant``) as this rank's blocks only."""
    cfg = get_arch(arch, smoke=smoke)
    shape = SHAPES[shape_name]
    ok, why = cell_runnable(cfg, shape)
    if not ok:
        raise ValueError(f"cell skipped: {why}")
    if shape.kind == "train":
        raise NotImplementedError(f"the train kind of build_cell {_WAITS}")
    reduced = []
    for field, value in (("global_batch", batch), ("seq_len", seq_len)):
        if value is not None and value != getattr(shape, field):
            reduced.append(f"{field} {getattr(shape, field)} -> {value}")
            shape = dataclasses.replace(shape, **{field: value})
    if layout == "decode_opt":
        if shape.kind != "decode":
            raise ValueError(f"the decode_opt layout is for decode cells, "
                             f"{shape_name} is a {shape.kind} cell")
        mesh, rules, tp, tp_kv = decode_opt_layout(
            cfg, shape, chips=mesh.size(),
            data=SH.mesh_shape(mesh).get("data", 1),
            device_type=mesh.device_type)
        model = build(cfg, tp=tp, tp_kv=tp_kv, cache_quant=cache_quant)
    elif layout == "default":
        model = build(cfg, tp=SH.mesh_shape(mesh).get("model", 1),
                      cache_quant=cache_quant)
        rules = SH.DEFAULT_RULES
    else:
        raise ValueError(f"unknown layout {layout!r}")
    check_mesh_family(model, mesh)
    rules = SH.rules_for(mesh, shape.global_batch, rules)
    device = _device(mesh)
    placed = _placed(model, params, mesh, rules, device)
    state = SH.place_state(
        model.init_decode_state(shape.global_batch, shape.seq_len,
                                getattr(torch, cfg.compute_dtype),
                                device="meta"),
        SH.sharding_tree(model.decode_state_axes(), mesh, rules), device)
    if shape.kind == "prefill":
        def step(params, batch, **fwd_kw):
            with runtime.mesh_rules(mesh, rules):
                return model.prefill(params, batch, state, **fwd_kw)
    else:
        step = make_serve_step(model, mesh, k=8, rules=rules)
    return Cell(shape, model, mesh, rules, placed, state, step,
                tuple(reduced))


def run_cell(arch: str, shape_name: str, mesh, mesh_desc: str, **kw):
    """The reference's lowering + roofline of one cell."""
    raise NotImplementedError(f"run_cell {_WAITS}")
