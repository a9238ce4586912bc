"""Architecture registry: --arch <id> → ModelConfig."""

from __future__ import annotations

from typing import Dict, List

from .base import ModelConfig, SHAPES, ShapeConfig, reduced

from .granite_34b import CONFIG as granite_34b
from .gemma3_12b import CONFIG as gemma3_12b
from .h2o_danube_1_8b import CONFIG as h2o_danube_1_8b
from .gemma3_1b import CONFIG as gemma3_1b
from .granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from .qwen3_moe_30b_a3b import CONFIG as qwen3_moe_30b_a3b
from .zamba2_1_2b import CONFIG as zamba2_1_2b
from .whisper_large_v3 import CONFIG as whisper_large_v3
from .llava_next_mistral_7b import CONFIG as llava_next_mistral_7b
from .mamba2_370m import CONFIG as mamba2_370m

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        granite_34b,
        gemma3_12b,
        h2o_danube_1_8b,
        gemma3_1b,
        granite_moe_3b_a800m,
        qwen3_moe_30b_a3b,
        zamba2_1_2b,
        whisper_large_v3,
        llava_next_mistral_7b,
        mamba2_370m,
    )
}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced(get_config(name[: -len("-smoke")]))
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def list_archs() -> List[str]:
    return sorted(ARCHS)


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """The assignment's skip rule: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True
