"""Model configuration: a copy of ``repro.models.config`` (which imports no
JAX; the port keeps its own copy so that it imports nothing of ``repro``).
The port serves the dense and MoE families so far; the other sub-configs
are kept so that every configuration of the JAX package can be
described."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma block pattern: `period` layers per cycle, attention at
    positions where (layer % period) in attn_positions."""
    lru_width: int = 0            # 0 -> d_model
    period: int = 3
    attn_position: int = 2        # (rec, rec, attn) cycles
    window: int = 2048


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int
    enc_seq: int = 1500           # whisper: 30 s of audio at 50 Hz after conv


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    num_patches: int = 256        # SigLIP 224px/14 -> 16x16 patches
    patch_dim: int = 1152         # frontend embedding width (stub input)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    act: str = "swiglu"           # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0    # chatglm3 "2d rope": 0.5
    tie_embeddings: bool = False
    attn_window: Optional[int] = None
    max_seq: int = 4096
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    # numerics / scale
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # whether decode state is bounded (sub-quadratic long-context decode)
    # -> eligible for the long_500k shape cell
    sub_quadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def padded_heads(self, tp: int, tp_kv: int | None = None) -> Tuple[int, int]:
        """(q heads, kv heads) padded up to their shard degrees.  tp shards
        q heads (and is the default for kv); a smaller tp_kv (the decode-
        optimized layout's `model_kv` axis) avoids the kv-padding waste the
        §Roofline table shows for GQA/MQA decode cells."""
        tp_kv = tp if tp_kv is None else tp_kv
        hp = math.ceil(self.n_heads / tp) * tp
        kvp = math.ceil(self.n_kv_heads / tp_kv) * tp_kv if self.n_kv_heads else 0
        # GQA requires q-heads divisible by kv-heads after padding
        while kvp and hp % kvp:
            hp += tp
        return hp, kvp

    def padded_vocab(self, multiple: int = 2048) -> int:
        return math.ceil(self.vocab_size / multiple) * multiple

    def num_params(self, include_embeddings: bool = True) -> int:
        """Analytic parameter count (logical, unpadded) for MODEL_FLOPS.
        include_embeddings=False gives the matmul-participating count the
        roofline charges per token (embedding lookups are gathers; the LM
        head runs once per SEQUENCE at prefill) — the MaxText convention."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kv = self.n_heads, self.n_kv_heads
        emb = (v * d * (1 if self.tie_embeddings else 2)
               if include_embeddings else 0)
        if self.family == "ssm":
            s = self.ssm
            di = s.expand * d
            nh = di // s.head_dim
            per_layer = (
                d * (2 * di + 2 * s.d_state + nh)   # in_proj (z,x,B,C,dt)
                + s.conv_width * (di + 2 * s.d_state)
                + nh + nh                            # A_log, D
                + di                                 # gated norm
                + di * d                             # out_proj
            )
            return emb + self.n_layers * per_layer  # (tied embedding)
        hd = self.resolved_head_dim
        att = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.act in ("swiglu", "geglu"):
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.family == "moe":
            m = self.moe
            mlp = m.num_experts * 3 * d * m.d_ff_expert + d * m.num_experts
        per_layer = att + mlp + 2 * d
        if self.family == "hybrid":
            hy = self.hybrid
            lw = hy.lru_width or d
            n_attn = sum(
                1 for i in range(self.n_layers) if i % hy.period == hy.attn_position
            )
            n_rec = self.n_layers - n_attn
            rec_layer = d * lw * 2 + lw * d + hy.window * 0 + 3 * lw + mlp + 2 * d
            return emb + n_attn * per_layer + n_rec * rec_layer
        if self.family == "encdec":
            cross = att  # cross-attention block per decoder layer
            return (
                emb
                + self.encdec.n_enc_layers * per_layer
                + self.n_layers * (per_layer + cross)
            )
        return emb + self.n_layers * per_layer

    def active_params(self, include_embeddings: bool = True) -> int:
        """Activated parameters per token (MoE: only top_k experts)."""
        if self.family != "moe":
            return self.num_params(include_embeddings)
        m = self.moe
        d = self.d_model
        dense_per_layer = (
            d * self.n_heads * self.resolved_head_dim
            + 2 * d * self.n_kv_heads * self.resolved_head_dim
            + self.n_heads * self.resolved_head_dim * d
            + m.top_k * 3 * d * m.d_ff_expert
            + d * m.num_experts
            + 2 * d
        )
        emb = 2 * self.vocab_size * d if include_embeddings else 0
        return emb + self.n_layers * dense_per_layer
