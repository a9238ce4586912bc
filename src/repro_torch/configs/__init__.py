"""Model and shape configurations: a copy of ``repro.configs``.

The port keeps its own copy so that it imports nothing of the JAX package;
the two copies describe the same architectures and must stay in step.
"""

from .base import (
    EncDecConfig,
    ModelConfig,
    MoEConfig,
    SHAPES,
    SMOKE_SHAPE,
    ShapeConfig,
    SSMConfig,
    VLMConfig,
    reduced,
)
from .registry import ARCHS, cell_is_applicable, get_config, get_shape, list_archs

__all__ = [
    "EncDecConfig", "ModelConfig", "MoEConfig", "SHAPES", "SMOKE_SHAPE",
    "ShapeConfig", "SSMConfig", "VLMConfig", "reduced",
    "ARCHS", "cell_is_applicable", "get_config", "get_shape", "list_archs",
]
