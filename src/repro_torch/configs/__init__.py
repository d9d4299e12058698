"""Config registry: ``get_config('<arch-id>')``.

The same ten architectures as the reference's registry, in its order.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCHS = {
    "whisper-small": "repro_torch.configs.whisper_small",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
}

ARCH_NAMES = tuple(_ARCHS)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCHS)}")
    return importlib.import_module(_ARCHS[name]).CONFIG


__all__ = ["ARCH_NAMES", "ModelConfig", "get_config"]
