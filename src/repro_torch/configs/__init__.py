"""Architecture registry: ``--arch <id>`` resolves here.

Only the architectures the port serves so far are listed.
"""
from repro_torch.configs import qwen3_1_7b
from repro_torch.configs.base import ArchConfig, SparsityConfig  # noqa: F401

_MODULES = {
    "qwen3-1.7b": qwen3_1_7b,
}

ALL_ARCHS = tuple(_MODULES)


def get_config(name: str) -> "ArchConfig":
    return _MODULES[name].config()


def get_smoke_config(name: str) -> "ArchConfig":
    return _MODULES[name].smoke()
