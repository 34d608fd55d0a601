"""mamba2-2.7b [ssm]: 64L d_model=2560 attn-free, ssm_state=128 — SSD
(state-space duality) [arXiv:2405.21060].  Counterpart of
``repro.configs.mamba2_2_7b``, field for field."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280, tie_embeddings=True,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, conv_width=4, chunk=256),
    sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="mamba2-2.7b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=256, tie_embeddings=True,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=16, conv_width=4, chunk=16),
    sub_quadratic=True, compute_dtype="float32",
)
