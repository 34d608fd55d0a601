"""Architecture and input-shape registry of the port (counterpart of
``repro.configs.registry``).

It names only the architectures the port serves: qwen2.5-3b (dense),
qwen3-moe-30b-a3b and phi3.5-moe-42b-a6.6b (MoE), mamba2-2.7b (SSM),
recurrentgemma-2b (hybrid), whisper-medium (encoder-decoder) and
paligemma-3b (VLM).  The JAX package's other three, dense, wait for their
configs (``ROADMAP.md`` queue A, item 11); asking for one raises an error
that says so.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

_MODULES = {
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe_42b_a6_6b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
}

# architectures of the JAX package the port does not serve yet
_NOT_PORTED = ("yi-34b", "chatglm3-6b", "mistral-nemo-12b")

ARCHS = tuple(_MODULES)


def cell_runnable(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    """(runnable, reason if skipped) for one (arch, shape) cell: the
    reference's rule, long_500k only for a sub-quadratic decode state."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention KV state at 524288 tokens is not "
                       "sub-quadratic; skipped as in the reference")
    return True, ""


def get_arch(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        known = "not ported yet" if name in _NOT_PORTED else "unknown"
        raise KeyError(
            f"architecture {name!r} is {known}: the port serves {ARCHS}; "
            f"the others wait for ROADMAP.md queue A, item 11")
    mod = importlib.import_module(_MODULES[name])
    return mod.SMOKE if smoke else mod.CONFIG
