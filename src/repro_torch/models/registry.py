"""Model registry: the counterpart of ``repro.models.registry``.

``build_model(cfg, device=...)`` returns a :class:`ModelApi` of plain
functions bound to the config and the device.  The port covers the dense
and VLM families; the others raise ``NotImplementedError``.  (The training
members of the JAX API, ``loss_fn`` and ``batch_spec``, come with the
training slice.)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Tuple, Union

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Dict]  # init(seed=0) -> params on device
    forward: Callable[..., torch.Tensor]
    init_cache: Callable[[int, int], Dict]  # init_cache(batch, max_len)
    decode_step: Callable[..., Tuple[torch.Tensor, Dict]]


def build_model(cfg: ModelConfig, device: Union[str, torch.device] = "cuda") -> ModelApi:
    """The model's functions on ``device``; raises if it is CUDA and there is
    none, or if the config's family is not ported yet."""
    dev = resolve_device(device)
    transformer.check_supported(cfg)
    return ModelApi(
        cfg=cfg,
        device=dev,
        init=functools.partial(transformer.init_lm, cfg, dev),
        forward=functools.partial(transformer.forward, cfg=cfg),
        init_cache=functools.partial(transformer.init_lm_cache, cfg, device=dev),
        decode_step=functools.partial(transformer.decode_step, cfg=cfg),
    )
