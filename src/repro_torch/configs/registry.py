"""Architecture registry: ``--arch <id>`` lookup for all assigned configs."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, ShapeSpec, SHAPES, \
    applicable_shapes

ARCH_IDS = (
    "internlm2-20b",
    "glm4-9b",
    "starcoder2-7b",
    "minicpm-2b",
    "qwen2-moe-a2.7b",
    "arctic-480b",
    "seamless-m4t-large-v2",
    "mamba2-1.3b",
    "pixtral-12b",
    "zamba2-1.2b",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
