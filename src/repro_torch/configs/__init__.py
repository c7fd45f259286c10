"""repro_torch.configs — one module per assigned architecture + base dataclasses."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, SHAPES

ARCH_IDS = [
    "smollm_360m", "h2o_danube_1_8b", "phi3_medium_14b", "qwen3_8b",
    "arctic_480b", "deepseek_moe_16b", "mamba2_780m",
    "seamless_m4t_large_v2", "llava_next_34b", "recurrentgemma_2b",
]


def get_config(name: str) -> ModelConfig:
    """Load the ModelConfig for an architecture id (dashes or underscores)."""
    mod_name = name.replace("-", "_")
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "SHAPES", "ARCH_IDS", "get_config"]
