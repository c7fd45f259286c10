"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab_size=32000, head_dim=80,
    sliding_window=4096, rope_theta=10_000.0, tie_embeddings=False,
)
