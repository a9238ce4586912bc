"""Batched greedy decode engine: the counterpart of ``repro.serving.engine``.

``serve_step`` -- one new token for every sequence of the batch against the
KV/SSM cache -- is the serving hot path: each step runs every attention
layer through the decode-attention kernel, every mamba layer through its
O(1) state update, every MoE layer through its router and sort-based
dispatch, and every norm through the rmsnorm kernel.  The cache's dtype
comes from the config (``kv_cache_dtype``: bf16, or int8 with scales), as in
the JAX engine.  The prompt is
fed token by token, as the JAX engine does, so serving never runs the SSD
chunk scan; the teacher-forced ``forward`` (and its ``last_only`` prefill
form) does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Union

import torch

from ..bridge import params_from_files
from ..checkpoint import decode_array, unflatten_tree
from ..device import resolve_device
from ..models.registry import ModelApi


def params_from_input(
    cu_ctx, weights_du: str, device: Union[str, torch.device] = "cuda"
) -> Any:
    """Model params on ``device`` from a checkpoint DU staged as a CU
    *input*: the serving cold-start path of ``repro.serving.engine``.

    Every serve CU declares the weights DU in ``input_data``, so each
    replica's stage-in goes through the transfer service (and, with the
    Session's tier cache on, promotes the DU into the site's mem-tier cache
    after ``promote_after`` loads).  Each ``params/<path>.npy`` entry is read
    from the CU's sandbox, decoded and moved to ``device`` one leaf at a
    time.  Raises if ``device`` asks for CUDA and there is none.
    """
    dev = resolve_device(device)
    items = {}
    for rel in cu_ctx.input_manifest(weights_du):
        if rel.startswith("params/") and rel.endswith(".npy"):
            items[rel[7:-4]] = decode_array(cu_ctx.read_input(weights_du, rel)).to(dev)
    return unflatten_tree(items)


def make_serve_step(api: ModelApi) -> Callable:
    """serve_step(params, cache, tokens [B,1], pos) -> (next_tokens [B,1], cache)."""

    def serve_step(params, cache, tokens, pos_index: int):
        logits, cache = api.decode_step(params, cache, tokens, pos_index)
        # torch.argmax, like jnp.argmax, returns the first maximum
        return torch.argmax(logits[:, -1], dim=-1)[:, None], cache

    return serve_step


@dataclasses.dataclass
class DecodeRequest:
    prompt: torch.Tensor  # [S] int
    max_new_tokens: int = 16


class DecodeEngine:
    """Minimal batched engine: static batch, greedy sampling, the KV/SSM
    cache on the model's device and updated in place."""

    def __init__(self, api: ModelApi, params: Any, batch: int, max_len: int):
        self.api = api
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.cache = api.init_cache(batch, max_len)
        self._step = make_serve_step(api)
        self._pos = 0

    @classmethod
    def from_files(
        cls, api: ModelApi, files: Mapping[str, bytes], batch: int, max_len: int
    ) -> "DecodeEngine":
        """An engine whose weights are read from a checkpoint DU file-set, as
        a serve CU loads the weights DU it declares as input."""
        return cls(api, params_from_files(files, api.device), batch, max_len)

    @classmethod
    def from_cu_context(
        cls, api: ModelApi, cu_ctx, weights_du: str, batch: int, max_len: int
    ) -> "DecodeEngine":
        """A replica engine inside a serve CU, its weights loaded onto the
        model's device from the checkpoint DU declared as the CU's input."""
        return cls(api, params_from_input(cu_ctx, weights_du, api.device), batch, max_len)

    def _advance(self, tokens: torch.Tensor) -> torch.Tensor:
        if self._pos >= self.max_len:
            raise ValueError(f"decode position {self._pos} is past max_len={self.max_len}")
        nxt, self.cache = self._step(self.params, self.cache, tokens, self._pos)
        self._pos += 1
        return nxt

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        """Feed prompt tokens [B, S] one step at a time, as the JAX engine
        does; returns the greedy next token [B, 1]."""
        b, s = tokens.shape
        if b != self.batch:
            raise ValueError(f"prompt batch {b} != engine batch {self.batch}")
        tokens = tokens.to(self.api.device)
        last = None
        for i in range(s):
            last = self._advance(tokens[:, i : i + 1])
        return last

    @torch.no_grad()
    def generate(self, tokens: torch.Tensor, max_new_tokens: int) -> torch.Tensor:
        """Greedy-decode continuation; returns [B, max_new_tokens]."""
        cur = self.prefill(tokens)
        out = [cur]
        for _ in range(max_new_tokens - 1):
            cur = self._advance(cur)
            out.append(cur)
        return torch.cat(out, dim=1)
