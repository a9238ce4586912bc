"""Model registry: the counterpart of ``repro.models.registry``.

``build_model(cfg, device=...)`` returns a :class:`ModelApi` of plain
functions bound to the config and the device: every family of the JAX
package, the dense, VLM, MoE, SSM (mamba2), hybrid (zamba2) and
encoder-decoder (whisper) ones.  A decoder-only model's ``init_cache`` keeps
the KV cache in ``cfg.kv_cache_dtype`` (the compute dtype, or int8 with
scales); whisper's, like the JAX package's, in the compute dtype.  ``batch_spec``
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
from . import transformer, whisper


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
    cdt = getattr(torch, cfg.compute_dtype)
    if shape.kind == "decode":
        return {"tokens": ((b, 1), torch.int32)}
    spec = {"tokens": ((b, s), torch.int32)}
    if cfg.family == "vlm":
        p = cfg.vlm.n_patches
        spec = {
            "tokens": ((b, s - p), torch.int32),
            "prefix_embeds": ((b, p, cfg.d_model), cdt),
        }
    if cfg.family == "encdec":
        spec["frames"] = ((b, cfg.encdec.n_frames, cfg.d_model), cdt)
    if shape.kind == "train":
        spec["labels"] = (spec["tokens"][0], torch.int32)
    return spec


def build_model(
    cfg: ModelConfig, device: Union[str, torch.device] = "cuda", ep: int = 1
) -> ModelApi:
    """The model's functions on ``device``; raises if it is CUDA and there is
    none, or if a block kind of the config is not ported yet.  ``ep``: the
    expert-parallel width that ``init`` pads the MoE experts for, as the
    JAX ``build_model(cfg, ep=...)``.  ``device="meta"`` gives ``init`` the
    tree's shapes and dtypes only (what the sharding rules read)."""
    dev = resolve_device(device)
    transformer.check_supported(cfg)
    if cfg.family == "encdec":
        model, init, init_cache = whisper, whisper.init_encdec, whisper.init_encdec_cache
        init = functools.partial(init, cfg, dev)
    else:
        model, init, init_cache = transformer, transformer.init_lm, transformer.init_lm_cache
        init = functools.partial(init, cfg, dev, ep=ep)
    return ModelApi(
        cfg=cfg,
        device=dev,
        init=init,
        forward=functools.partial(model.forward, cfg=cfg),
        loss_fn=functools.partial(model.loss_fn, cfg=cfg),
        init_cache=functools.partial(init_cache, cfg, device=dev),
        decode_step=functools.partial(model.decode_step, cfg=cfg),
        batch_spec=functools.partial(_lm_batch_spec, cfg),
    )
