"""Architecture registry: ``--arch <id>`` resolves here.

Only the architectures the port serves so far are listed.
"""
from repro_torch.configs import (
    gemma3_1b,
    granite_moe_1b,
    internlm2_20b,
    kimi_k2_1t,
    mamba2_130m,
    mistral_large_123b,
    qwen2_vl_7b,
    qwen3_1_7b,
    zamba2_7b,
)
from repro_torch.configs.base import ArchConfig, ShapeConfig, SparsityConfig  # noqa: F401
from repro_torch.configs.shapes import ALL_SHAPES, SHAPES, shapes_for  # noqa: F401

_MODULES = {
    "mistral-large-123b": mistral_large_123b,
    "qwen3-1.7b": qwen3_1_7b,
    "gemma3-1b": gemma3_1b,
    "internlm2-20b": internlm2_20b,
    "qwen2-vl-7b": qwen2_vl_7b,
    "granite-moe-1b-a400m": granite_moe_1b,
    "kimi-k2-1t-a32b": kimi_k2_1t,
    "mamba2-130m": mamba2_130m,
    "zamba2-7b": zamba2_7b,
}

ALL_ARCHS = tuple(_MODULES)


def get_config(name: str) -> "ArchConfig":
    return _MODULES[name].config()


def get_smoke_config(name: str) -> "ArchConfig":
    return _MODULES[name].smoke()
