"""Model registry: the counterpart of ``repro.models.registry``.

``build_model(cfg, device=...)`` returns a :class:`ModelApi` of plain
functions bound to the config and the device.  The port covers the dense,
VLM, SSM (mamba2) and hybrid (zamba2) families; MoE and the
encoder-decoder family raise ``NotImplementedError``.  ``batch_spec``
describes the model inputs per shape kind (train / prefill / decode) as
(shape, torch dtype) pairs, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple, Union

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from . import transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Dict]  # init(seed=0) -> params on device
    forward: Callable[..., torch.Tensor]
    loss_fn: Callable[..., Tuple[torch.Tensor, Dict]]  # loss_fn(params, batch, remat=)
    init_cache: Callable[[int, int], Dict]  # init_cache(batch, max_len)
    decode_step: Callable[..., Tuple[torch.Tensor, Dict]]
    batch_spec: Callable[[ShapeConfig], Dict[str, Tuple[Tuple[int, ...], Any]]]


def _lm_batch_spec(cfg: ModelConfig, shape: ShapeConfig):
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((b, 1), torch.int32)}
    spec = {"tokens": ((b, s), torch.int32)}
    if cfg.family == "vlm":
        p = cfg.vlm.n_patches
        spec = {
            "tokens": ((b, s - p), torch.int32),
            "prefix_embeds": ((b, p, cfg.d_model), getattr(torch, cfg.compute_dtype)),
        }
    if shape.kind == "train":
        spec["labels"] = (spec["tokens"][0], torch.int32)
    return spec


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
        loss_fn=functools.partial(transformer.loss_fn, cfg=cfg),
        init_cache=functools.partial(transformer.init_lm_cache, cfg, device=dev),
        decode_step=functools.partial(transformer.decode_step, cfg=cfg),
        batch_spec=functools.partial(_lm_batch_spec, cfg),
    )
