"""Architecture registry: ``get_config(arch_id)`` / ``ARCH_IDS``.

Port of ``repro/configs/__init__.py``: the same architectures, each
config file a copy of the reference's.
"""

from importlib import import_module
from typing import Tuple

from repro_torch.configs.base import ModelConfig, ShapeSpec  # noqa: F401

_MODULES = {
    "olmo-1b": "olmo_1b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen2.5-3b": "qwen2_5_3b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "rwkv6-3b": "rwkv6_3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).SMOKE_CONFIG


def get_shapes(arch_id: str) -> Tuple[ShapeSpec, ...]:
    return _mod(arch_id).SHAPES
