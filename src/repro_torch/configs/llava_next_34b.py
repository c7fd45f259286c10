"""llava-next-34b — VLM decoder backbone; anyres vision frontend is a stub
supplying precomputed patch embeddings [hf:llava-hf/llava-v1.6]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128,
    frontend="vision", n_prefix_embeds=576, tie_embeddings=False,
)
