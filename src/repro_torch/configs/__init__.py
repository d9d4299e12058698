"""Config registry: ``get_config('<arch-id>')``.

Only the architectures the port runs so far are registered; the others
arrive with the slices that port their model families.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCHS = {
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b",
}

ARCH_NAMES = tuple(_ARCHS)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCHS)}")
    return importlib.import_module(_ARCHS[name]).CONFIG


__all__ = ["ARCH_NAMES", "ModelConfig", "get_config"]
