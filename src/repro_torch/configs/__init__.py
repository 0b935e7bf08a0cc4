"""Architecture registry: ``--arch <id>`` resolution."""

import importlib

from .base import (ModelConfig, MoEConfig, SSMConfig, PCILTConfig,
                   ShapeConfig, SHAPES)

_MODULES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen1.5-4b": "qwen15_4b",
    "qwen2.5-3b": "qwen25_3b",
    "qwen3-0.6b": "qwen3_06b",
    "whisper-medium": "whisper_medium",
    "mamba2-130m": "mamba2_130m",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "zamba2-7b": "zamba2_7b",
}

ARCHS = tuple(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _mod(name).config()


def get_smoke_config(name: str):
    return _mod(name).smoke_config()
