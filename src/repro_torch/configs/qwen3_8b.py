"""qwen3-8b — qk-norm GQA dense [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=False,
)
