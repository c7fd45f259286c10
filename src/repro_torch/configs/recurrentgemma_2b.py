"""recurrentgemma-2b — Griffin: RG-LRU + local attention, (rec,rec,attn)
pattern, 26 = 8*3 + 2 layers [arXiv:2402.19427]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    local_window=2048, layer_pattern="rra", tie_embeddings=True,
)
