"""Architecture registry: ``get_config(arch_id)`` / ``--arch <id>``."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (
    SHAPES,
    SHAPES_BY_NAME,
    ModelConfig,
    ShapeSpec,
    reduce_config,
    supported_shapes,
)

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name.endswith("-reduced"):
        return reduce_config(get_config(name[: -len("-reduced")]))
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


ASSIGNED_ARCHS = [
    "qwen3-4b", "gemma2-9b", "granite-20b", "minicpm-2b", "jamba-v0.1-52b",
    "whisper-small", "qwen2-vl-72b", "llama4-scout-17b-a16e",
    "deepseek-moe-16b", "falcon-mamba-7b",
]


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    from repro_torch.configs import archs  # noqa: F401  (registers everything)


__all__ = [
    "ModelConfig", "ShapeSpec", "SHAPES", "SHAPES_BY_NAME", "get_config",
    "list_archs", "register", "reduce_config", "supported_shapes",
    "ASSIGNED_ARCHS",
]
