"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400,
16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct].  Counterpart of
``repro.configs.phi3_5_moe_42b_a6_6b``, field for field."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab_size=32064,
    norm="layernorm", act="swiglu",
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400),
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=48, vocab_size=256,
    norm="layernorm", act="swiglu",
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=48),
    compute_dtype="float32",
)
