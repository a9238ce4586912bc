"""Config system: architecture + shape + run configuration.

Every assigned architecture is a :class:`ModelConfig` in its own module
(``repro.configs.<arch>``); shapes are :class:`ShapeConfig` (assignment's
train_4k / prefill_32k / decode_32k / long_500k).  ``reduced()`` derives the
CPU-smoke-test variant of any config (same family/block pattern, tiny
dims).

This module is dependency-light (no jax import) so launchers can read
configs before touching jax.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 0
    n_frames: int = 1500  # precomputed frame embeddings (conv frontend stub)


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    n_patches: int = 576  # precomputed patch embeddings (vision tower stub)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // n_heads
    #: per-layer block pattern, cycled over the depth.  Entries:
    #:   "attn"    — full causal attention + dense MLP
    #:   "swa"     — sliding-window attention + dense MLP
    #:   "global"  — full attention (gemma local:global naming) + dense MLP
    #:   "moe"     — full attention + MoE MLP
    #:   "swa_moe" — sliding-window attention + MoE MLP
    #:   "mamba"   — Mamba2 SSD mixer (no MLP)
    #:   "shared_attn" — attention block with weights SHARED across all
    #:                   occurrences (zamba2-style)
    pattern: Tuple[str, ...] = ("attn",)
    sliding_window: int = 1024
    rope_theta: float = 10000.0
    #: RoPE base for sliding-window ("swa") blocks; gemma3 uses 10k local
    #: vs 1M global.  0.0 → same as rope_theta.
    rope_theta_local: float = 0.0
    #: "swiglu" (3 matrices) or "gelu" (2 matrices, whisper-style)
    mlp_type: str = "swiglu"
    #: KV cache storage dtype: "bfloat16" or "int8" (per-token-per-head
    #: symmetric quantization; §Perf decode lever)
    kv_cache_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    #: does any block attend with an unbounded (full) window?
    #: (drives the long_500k applicability rule)
    source: str = ""

    # ------------------------------------------------------------ derived
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return all(p == "mamba" for p in self.pattern)

    @property
    def is_pure_full_attention(self) -> bool:
        """True if every attention block is full/unwindowed (assignment's
        long_500k skip rule)."""
        att = {p for p in self.pattern if p != "mamba"}
        return bool(att) and att <= {"attn", "global", "moe"}

    @property
    def supports_long_context(self) -> bool:
        return not self.is_pure_full_attention

    def layer_kinds(self) -> Tuple[str, ...]:
        """The concrete per-layer kinds for the full depth."""
        reps = math.ceil(self.n_layers / len(self.pattern))
        return (self.pattern * reps)[: self.n_layers]

    # -------------------------------------------------------- param counts
    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.head_dim_
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        attn = q + kv + o
        mlp_mats = 3 if self.mlp_type == "swiglu" else 2
        mlp_dense = mlp_mats * d * self.d_ff
        total = 0
        if self.encdec is not None and self.encdec.n_enc_layers:
            # encoder stack + per-decoder-layer cross-attention
            total += self.encdec.n_enc_layers * (attn + mlp_dense + 2 * d)
            total += self.n_layers * (attn + d)
        shared_counted = False
        for kind in self.layer_kinds():
            if kind == "mamba":
                total += self._mamba_params()
            elif kind == "shared_attn":
                if not shared_counted:
                    total += attn + mlp_dense + 2 * d
                    shared_counted = True
            elif kind in ("moe", "swa_moe"):
                assert self.moe is not None
                total += attn + 2 * d
                total += self.moe.n_experts * 3 * d * self.moe.d_ff_expert
                total += d * self.moe.n_experts  # router
            else:
                total += attn + mlp_dense + 2 * d
        total += self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        inactive = (
            (self.moe.n_experts - self.moe.top_k)
            * 3
            * d
            * self.moe.d_ff_expert
        )
        n_moe_layers = sum(1 for k in self.layer_kinds() if k in ("moe", "swa_moe"))
        return total - n_moe_layers * inactive

    def _mamba_params(self) -> int:
        assert self.ssm is not None
        d = self.d_model
        s = self.ssm
        d_in = s.d_inner(d)
        nh = s.n_heads(d)
        in_proj = d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
        conv = s.conv_width * (d_in + 2 * s.n_groups * s.d_state)
        out_proj = d_in * d
        extras = nh * 3 + d_in + 2 * d  # A, D, dt_bias, gate-norm, norms
        return in_proj + conv + out_proj + extras


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


#: the assignment's four shapes (shared by every LM arch)
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Derive a tiny same-family config for CPU smoke tests."""
    pattern_len = len(cfg.pattern)
    small = dict(
        n_layers=max(pattern_len, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 1,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        sliding_window=32,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.moe is not None:
        small["moe"] = MoEConfig(
            n_experts=min(cfg.moe.n_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=32,
        )
    if cfg.ssm is not None:
        small["ssm"] = SSMConfig(
            d_state=16, head_dim=16, expand=2, n_groups=1, conv_width=4, chunk=16
        )
    if cfg.encdec is not None:
        small["encdec"] = EncDecConfig(n_enc_layers=2, n_frames=16)
    if cfg.vlm is not None:
        small["vlm"] = VLMConfig(n_patches=8)
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)


SMOKE_SHAPE = ShapeConfig("smoke", seq_len=64, global_batch=2, kind="train")
