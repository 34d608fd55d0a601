"""The training loop (counterpart of ``repro.train.trainer``): train step
+ checkpoint/restart + heartbeat + straggler hooks.  This is the piece
``launch/train.py`` drives.

``Trainer(model, data, mesh_or_device, ...)``:

- a ``DeviceMesh`` (``launch/mesh.py``) shards the state by
  ``sharding_tree(train_state_axes(model), mesh)`` (parameters and AdamW
  moments as DTensors: each rank holds its blocks only) and the batch by
  ``("batch", "seq")``, as the reference's ``in_shardings`` do; each rank
  takes its rows of ``data.device_batch(step)``, and the step runs under
  the mesh (``models.runtime``), its kernels on local blocks.  The rules
  are ``sharding.rules_for(mesh, global_batch)``: a batch that does not
  divide the data-parallel shards is replicated.  The dense family runs
  on a mesh of any size; another family only on a mesh of one rank;
- a device (``cuda`` unless the caller names another) keeps the
  one-device path: the step runs eagerly there.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.engine import resolve_device
from repro_torch.models import runtime
from repro_torch.models import sharding as SH
from repro_torch.models.transformer import Transformer
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.elastic import Heartbeat, StragglerMonitor
from repro_torch.train.train_step import (TrainState, make_train_step,
                                          train_state_axes)


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    microbatches: int = 1
    seed: int = 0
    fwd_kw: Optional[dict] = None   # Model.loss's keywords (attn_impl, ...)


class Trainer:
    def __init__(self, model, data, mesh_or_device, opt_cfg: AdamWConfig,
                 tc: TrainerConfig):
        self.model = model
        self.data = data
        self.opt_cfg = opt_cfg
        self.tc = tc
        self.heartbeat = Heartbeat()
        self.stragglers = StragglerMonitor()
        self.mesh = self.state_shardings = self.batch_sharding = None
        if isinstance(mesh_or_device, DeviceMesh):
            mesh = self.mesh = mesh_or_device
            if model.cfg.family != "dense" and mesh.size() > 1:
                raise ValueError(
                    f"the sharded trainer runs the dense family; "
                    f"{model.cfg.family!r} over a mesh of {mesh.size()} "
                    f"ranks waits for ROADMAP.md queue A, item 11.4")
            self.device = (torch.device("cuda", torch.cuda.current_device())
                           if mesh.device_type == "cuda"
                           else torch.device(mesh.device_type))
            self.rules = SH.rules_for(mesh, data.global_batch)
            self.state_shardings = SH.sharding_tree(train_state_axes(model),
                                                    mesh, self.rules)
            self.batch_sharding = SH.Sharding(
                mesh, SH.resolve(("batch", "seq"), mesh, self.rules))
        else:
            self.device = resolve_device(mesh_or_device)
        self.step_fn = make_train_step(model, opt_cfg,
                                       microbatches=tc.microbatches,
                                       fwd_kw=tc.fwd_kw)

    def shard_params(self, params: Transformer) -> Transformer:
        """Trainable parameters laid out by the state's shardings (each
        rank keeps a copy of its blocks of ``params``, the same on every
        rank); ``params`` as they are without a mesh."""
        if self.mesh is None:
            return params
        return Transformer(SH.shard_tree(params.tree(),
                                         self.state_shardings.params), True)

    def init_or_restore(self) -> tuple[TrainState, int]:
        tc = self.tc
        params = self.shard_params(self.model.init(
            tc.seed, device=self.device, trainable=True))
        state = TrainState(params, adamw_init(params))
        if tc.checkpoint_dir and ckpt.latest_step(tc.checkpoint_dir) is not None:
            state, step, _ = ckpt.restore(tc.checkpoint_dir, state)
            return state, step
        return state, 0

    def local_batch(self, step: int) -> dict:
        """This rank's rows of ``data.device_batch(step)`` (all of them
        without a mesh)."""
        batch = self.data.device_batch(step, device=self.device)
        if self.mesh is None:
            return batch
        return {k: SH.local_block(v, self.batch_sharding)
                for k, v in batch.items()}

    def _under_mesh(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        return runtime.mesh_rules(self.mesh, self.rules)

    def run(self, state=None, start_step: int = 0):
        tc = self.tc
        if state is None:
            state, start_step = self.init_or_restore()
        history = []
        pending_save = None
        for step in range(start_step, tc.steps):
            batch = self.local_batch(step)
            t0 = time.monotonic()
            with self._under_mesh():
                state, metrics = self.step_fn(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            self.heartbeat.beat()
            self.stragglers.record(0, dt)
            history.append({"step": step + 1, "sec": dt, **metrics})
            if (step + 1) % tc.log_every == 0:
                print(f"step {step+1:5d}  loss {metrics['loss']:.4f}  "
                      f"gnorm {metrics['grad_norm']:.3f}  {dt*1e3:.0f} ms")
            if tc.checkpoint_dir and (step + 1) % tc.checkpoint_every == 0:
                if pending_save is not None:
                    pending_save.join()
                pending_save = ckpt.save(
                    tc.checkpoint_dir, state, step + 1,
                    data_state={"seed": self.data.seed, "next_step": step + 1},
                    blocking=False,
                )
        if pending_save is not None:
            pending_save.join()
        return state, history
