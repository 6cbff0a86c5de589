"""Architecture registry: ``--arch <id>`` resolves here (the reference's
eleven configs, in its order)."""
from repro_torch.configs import (
    gemma3_1b,
    granite_moe_1b,
    internlm2_20b,
    kimi_k2_1t,
    mamba2_130m,
    mistral_large_123b,
    musicgen_medium,
    qwen2_vl_7b,
    qwen3_1_7b,
    vit_b16,
    zamba2_7b,
)
from repro_torch.configs.base import ArchConfig, ShapeConfig, SparsityConfig  # noqa: F401
from repro_torch.configs.shapes import ALL_SHAPES, SHAPES, shapes_for  # noqa: F401

_MODULES = {
    "mamba2-130m": mamba2_130m,
    "granite-moe-1b-a400m": granite_moe_1b,
    "kimi-k2-1t-a32b": kimi_k2_1t,
    "mistral-large-123b": mistral_large_123b,
    "qwen3-1.7b": qwen3_1_7b,
    "gemma3-1b": gemma3_1b,
    "internlm2-20b": internlm2_20b,
    "qwen2-vl-7b": qwen2_vl_7b,
    "musicgen-medium": musicgen_medium,
    "zamba2-7b": zamba2_7b,
    "vit-b16": vit_b16,
}

ALL_ARCHS = tuple(_MODULES)


def get_config(name: str) -> "ArchConfig":
    return _MODULES[name].config()


def get_smoke_config(name: str) -> "ArchConfig":
    return _MODULES[name].smoke()
