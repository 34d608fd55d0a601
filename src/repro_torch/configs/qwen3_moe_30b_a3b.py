"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff_expert=768
vocab=151936, 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].  Counterpart of
``repro.configs.qwen3_moe_30b_a3b``, field for field."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    norm="rmsnorm", act="swiglu", rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab_size=256, head_dim=16,
    norm="rmsnorm", act="swiglu",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32),
    compute_dtype="float32",
)
