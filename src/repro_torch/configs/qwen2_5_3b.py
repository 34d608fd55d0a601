"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA with QKV bias [hf:Qwen/Qwen2.5-3B; hf].  Counterpart
of ``repro.configs.qwen2_5_3b``, field for field."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab_size=151936,
    norm="rmsnorm", act="swiglu", qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2.5-3b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab_size=256,
    norm="rmsnorm", act="swiglu", qkv_bias=True, compute_dtype="float32",
)
