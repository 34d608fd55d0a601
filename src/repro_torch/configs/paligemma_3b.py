"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216 — SigLIP frontend STUB + gemma decoder, bidirectional image
prefix [arXiv:2407.07726; hf:google/paligemma-3b-pt-224].  Counterpart
of ``repro.configs.paligemma_3b``, field for field."""
from repro_torch.models.config import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab_size=257216, head_dim=256,
    norm="rmsnorm", act="geglu", tie_embeddings=True,
    vlm=VLMConfig(num_patches=256, patch_dim=1152),
)

SMOKE = ModelConfig(
    name="paligemma-3b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=96, vocab_size=256, head_dim=16,
    norm="rmsnorm", act="geglu", tie_embeddings=True,
    vlm=VLMConfig(num_patches=8, patch_dim=24),
    compute_dtype="float32",
)
