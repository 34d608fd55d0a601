"""Model facade (counterpart of ``repro.models.model``): one object per
architecture exposing init / hidden / prefill / decode for the server.

The port serves the dense family; the others, and the training loss,
wait for ``ROADMAP.md`` queue A, item 11.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

_NOT_PORTED = {
    "moe": "the MoE family (models/moe.py, moe_dispatch.py)",
    "ssm": "the SSM family (models/ssm.py)",
    "hybrid": "the hybrid family (models/hybrid.py)",
    "encdec": "the encoder-decoder family (models/encdec.py)",
    "vlm": "the VLM family (models/vlm.py)",
}


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    tp: int = 1                    # head-shard degree: pads the heads
    cache_quant: bool = False      # int8 KV cache through the B9 kernel

    def __post_init__(self):
        if self.cfg.family in _NOT_PORTED:
            raise NotImplementedError(
                f"{self.cfg.name}: {_NOT_PORTED[self.cfg.family]} is not "
                f"ported yet (ROADMAP.md queue A, item 11)")
        if self.cfg.family != "dense":
            raise ValueError(f"unknown family {self.cfg.family!r}")

    # ---- parameters -------------------------------------------------------
    def init(self, seed: int = 0, *, device=None) -> T.Transformer:
        """Random parameters in ``cfg.param_dtype``, drawn on the device
        (``cuda`` unless the caller names another) from a
        ``torch.Generator`` seeded with ``seed``."""
        gen = torch.Generator(resolve_device(device)).manual_seed(seed)
        return T.init_transformer(self.cfg, gen, self.tp)

    def cast(self, params: T.Transformer) -> T.Transformer:
        """The parameters in ``cfg.compute_dtype``, for serving.  The JAX
        package casts each weight at every use; casting once when serving
        starts gives the same numbers (the cast is deterministic) without
        reading the f32 copy at every step."""
        return params.cast(getattr(torch, self.cfg.compute_dtype))

    # ---- forward -------------------------------------------------------------
    def hidden(self, params, batch, *, chunk_q=1024, chunk_k=1024,
               attn_impl="xla"):
        with torch.no_grad():
            return T.forward(params, batch["tokens"], self.cfg,
                             chunk_q=chunk_q, chunk_k=chunk_k,
                             attn_impl=attn_impl)

    # ---- serving -----------------------------------------------------------
    def init_decode_state(self, batch: int, max_len: int,
                          dtype=torch.bfloat16, *, device=None):
        """An empty cache: int8 codes and scales with ``cache_quant``, else
        ``dtype``; on ``cuda`` unless the caller names another device."""
        device = resolve_device(device)
        if self.cache_quant:
            return T.init_quant_cache(self.cfg, batch, max_len, device,
                                      self.tp)
        return T.init_cache(self.cfg, batch, max_len, device, self.tp, dtype)

    def decode_step(self, params, state, token):
        """token (B, 1) -> (logits (B, padded vocab), state); the state's
        tensors are updated in place."""
        with torch.no_grad():
            return T.decode_step(params, state, token, self.cfg)

    def prefill(self, params, batch, state, *, chunk_q=1024, chunk_k=1024,
                attn_impl="xla"):
        """Prompt ``batch["tokens"]`` (B, S) into a float cache ->
        (last-position logits, state)."""
        with torch.no_grad():
            return T.prefill(params, batch["tokens"], self.cfg, state,
                             chunk_q=chunk_q, chunk_k=chunk_k,
                             attn_impl=attn_impl)


def build(cfg: ModelConfig, tp: int = 1, **kw) -> Model:
    return Model(cfg, tp, **kw)
