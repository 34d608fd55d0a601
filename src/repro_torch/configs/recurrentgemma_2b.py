"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680 —
RG-LRU + local attention in a (rec, rec, attn) pattern, window 2048
[arXiv:2402.19427; hf:google/recurrentgemma-2b].  Counterpart of
``repro.configs.recurrentgemma_2b``, field for field."""
from repro_torch.models.config import HybridConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    norm="rmsnorm", act="geglu", tie_embeddings=True,
    attn_window=2048,
    hybrid=HybridConfig(lru_width=2560, period=3, attn_position=2, window=2048),
    sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke", family="hybrid",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=96, vocab_size=256, head_dim=16,
    norm="rmsnorm", act="geglu", tie_embeddings=True,
    attn_window=16,
    hybrid=HybridConfig(lru_width=64, period=3, attn_position=2, window=16),
    sub_quadratic=True, compute_dtype="float32",
)
