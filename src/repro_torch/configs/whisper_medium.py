"""whisper-medium [audio]: 24+24L d_model=1024 16H d_ff=4096 vocab=51865 —
enc-dec; the conv/mel frontend is a STUB (the input holds precomputed
frame embeddings) [arXiv:2212.04356; hf:openai/whisper-medium].
Counterpart of ``repro.configs.whisper_medium``, field for field."""
from repro_torch.models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    norm="layernorm", act="gelu", tie_embeddings=True,
    encdec=EncDecConfig(n_enc_layers=24, enc_seq=1500),
    max_seq=32768,
)

SMOKE = ModelConfig(
    name="whisper-medium-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab_size=256,
    norm="layernorm", act="gelu", tie_embeddings=True,
    encdec=EncDecConfig(n_enc_layers=2, enc_seq=32),
    max_seq=128, compute_dtype="float32",
)
