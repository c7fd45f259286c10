"""seamless-m4t-large-v2 — enc-dec multimodal backbone; audio frontend is a
stub supplying precomputed frame embeddings [arXiv:2308.11596]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206, head_dim=64,
    encoder_layers=24, frontend="audio", tie_embeddings=True,
)
