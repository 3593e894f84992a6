"""Architecture registry: ``get_config(arch_id)`` / ``ARCH_IDS``.

Port of ``repro/configs/__init__.py`` for the families the port runs: the
dense decoders, RWKV6 and the Zamba2 hybrid.  The other architectures of
the JAX package are known by name and raise ``NotImplementedError`` until
their family is ported (``ROADMAP.md``, Queue 1 item 5).
"""

from importlib import import_module
from typing import Tuple

from repro_torch.configs.base import ModelConfig, ShapeSpec  # noqa: F401

_MODULES = {
    "olmo-1b": "olmo_1b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen2.5-3b": "qwen2_5_3b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "rwkv6-3b": "rwkv6_3b",
    "zamba2-2.7b": "zamba2_2_7b",
}

# Architectures of the JAX package whose family the port does not run yet.
_NOT_PORTED = {
    "deepseek-v2-lite-16b": "moe_mla",
    "deepseek-v3-671b": "moe_mla",
    "llama-3.2-vision-11b": "vlm",
    "seamless-m4t-large-v2": "encdec",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id!r} is a {_NOT_PORTED[arch_id]} model; the port runs "
            "the dense, rwkv6 and hybrid families so far (ROADMAP.md, Queue 1 "
            "item 5)"
        )
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).SMOKE_CONFIG


def get_shapes(arch_id: str) -> Tuple[ShapeSpec, ...]:
    return _mod(arch_id).SHAPES
