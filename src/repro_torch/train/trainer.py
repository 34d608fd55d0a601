"""The training loop (counterpart of ``repro.train.trainer``): train step
+ checkpoint/restart + heartbeat + straggler hooks, on one device.  This
is the piece ``launch/train.py`` drives.

Where the JAX trainer takes a mesh and jits the step with the state's
shardings, the port's takes a device (``cuda`` unless the caller names
another) and runs the step eagerly there; sharding waits for ROADMAP.md
queue A, item 9.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

from repro_torch.core.engine import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.elastic import Heartbeat, StragglerMonitor
from repro_torch.train.train_step import (TrainState, init_train_state,
                                          make_train_step)


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    microbatches: int = 1
    seed: int = 0


class Trainer:
    def __init__(self, model, data, device, opt_cfg: AdamWConfig,
                 tc: TrainerConfig):
        self.model = model
        self.data = data
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg
        self.tc = tc
        self.heartbeat = Heartbeat()
        self.stragglers = StragglerMonitor()
        self.step_fn = make_train_step(model, opt_cfg,
                                       microbatches=tc.microbatches)

    def init_or_restore(self) -> tuple[TrainState, int]:
        tc = self.tc
        state = init_train_state(self.model, tc.seed, device=self.device)
        if tc.checkpoint_dir and ckpt.latest_step(tc.checkpoint_dir) is not None:
            state, step, _ = ckpt.restore(tc.checkpoint_dir, state)
            return state, step
        return state, 0

    def run(self, state=None, start_step: int = 0):
        tc = self.tc
        if state is None:
            state, start_step = self.init_or_restore()
        history = []
        pending_save = None
        for step in range(start_step, tc.steps):
            batch = self.data.device_batch(step, device=self.device)
            t0 = time.monotonic()
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
