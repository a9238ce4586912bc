"""Kernel sites of a cell and what the plain versions would move there: the
counterpart of ``repro.launch.kernel_substitution``.

The JAX dry run lowers the pure-JAX blocked attention / SSD scan (Pallas
cannot lower on the CPU host) and then swaps their modelled traffic for the
Pallas kernels'.  The port's dry run needs no swap: its kernel wrappers
report each launch at its own ``cost(...)`` (:mod:`.op_analysis`), so the
cell's totals already count the kernels.  This module keeps the JAX
site model and its numbers, as a comparison:

  * :func:`_tp_split`, :func:`_attention_sites` and :func:`_ssd_sites`:
    the per-device attention and SSD workloads of a cell, as the JAX ones;
  * :func:`_measure_attention` / :func:`_measure_ssd`: the port's *plain*
    versions (``flash_attention_ref``, ``ssd_ref``; their autograd for
    train cells) run on meta tensors at a site's shapes under the op
    analyser: what a step would move and compute without the kernels (the
    counterpart of lowering the blocked scan);
  * :func:`_attn_kernel_analytic` / :func:`_ssd_kernel_analytic`: the JAX
    package's analytic kernel model, unchanged;
  * :func:`substitution_for_cell`: the JAX keys; ``derive_terms`` does not
    subtract them (the dry run counted the kernels already).  The dry run
    adds the per-launch ``cost`` totals beside them.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig

BF16 = 2
F32 = 4


def _tp_split(hq: int, hkv: int, sq: int, tp: int) -> Tuple[int, int, int]:
    """How the model axis divides one attention layer's work per device:
    heads when they divide (Megatron TP), otherwise q rows (SP: tokens
    sharded, K/V gathered)."""
    if hq % tp == 0:
        hq_l = hq // tp
        # each device's q-head group only touches its own kv heads
        hkv_l = hkv // tp if hkv % tp == 0 else max(1, min(hkv, hq_l))
        return hq_l, hkv_l, sq
    return hq, hkv, max(1, sq // tp)


def _attention_sites(
    cfg: ModelConfig, shape: ShapeConfig, dp: int, tp: int, mb: int
) -> List[Dict]:
    """Per-device attention workloads in this cell (one entry per distinct
    layer geometry; 'count' = how many layers share it)."""
    if shape.kind == "decode":
        return []  # decode attention streams the cache once: the model is fair
    b_l = max(1, shape.global_batch // dp) // (mb if shape.kind == "train" else 1)
    b_l = max(1, b_l)
    hd = cfg.head_dim_
    sites = []

    def site(count, sq, skv, causal, window):
        hq_l, hkv_l, sq_l = _tp_split(cfg.n_heads, cfg.n_kv_heads, sq, tp)
        return dict(count=count, b=b_l, sq=sq_l, skv=skv, hq=hq_l,
                    hkv=hkv_l, hd=hd, causal=causal, window=window)

    if cfg.family == "encdec":
        e = cfg.encdec
        sites.append(site(e.n_enc_layers, e.n_frames, e.n_frames, False, None))
        sites.append(site(cfg.n_layers, shape.seq_len, shape.seq_len, True, None))
        sites.append(site(cfg.n_layers, shape.seq_len, e.n_frames, False, None))
        return sites
    kinds = cfg.layer_kinds()
    n_full = sum(1 for k in kinds if k in ("attn", "global", "moe", "shared_attn"))
    n_swa = sum(1 for k in kinds if k in ("swa", "swa_moe"))
    s = shape.seq_len
    if n_full:
        sites.append(site(n_full, s, s, True, None))
    if n_swa:
        sites.append(site(n_swa, s, s, True, cfg.sliding_window))
    return sites


def _ssd_sites(
    cfg: ModelConfig, shape: ShapeConfig, dp: int, mb: int, tp: int = 16
) -> List[Dict]:
    if cfg.ssm is None or shape.kind == "decode":
        return []
    from ..models.mamba2 import mamba_dims

    dims = mamba_dims(cfg)
    b_l = max(1, shape.global_batch // dp) // (mb if shape.kind == "train" else 1)
    b_l = max(1, b_l)
    h = dims["n_heads"]
    h_l = h // tp if h % tp == 0 else h  # SSD heads shard over the TP axis
    n_mamba = sum(1 for k in cfg.layer_kinds() if k == "mamba")
    return [
        dict(count=n_mamba, b=b_l, s=shape.seq_len, h=h_l,
             p=dims["head_dim"], n=dims["d_state"], chunk=cfg.ssm.chunk)
    ]


def _analysed(fn, *args) -> Tuple[float, float]:
    from .op_analysis import OpAnalysis

    with OpAnalysis() as a:
        fn(*args)
    r = a.result()
    return r["hbm_bytes"], r["flops"]


@functools.lru_cache(maxsize=256)
def _measure_attention(
    b: int, sq: int, skv: int, hq: int, hkv: int, hd: int,
    causal: bool, window: Optional[int], train: bool,
) -> Tuple[float, float]:
    """(hbm_bytes, flops) of the plain attention at a site's shapes, on meta
    tensors, under the op analyser (with its autograd for a train cell)."""
    from ..kernels.flash_attention.ref import flash_attention_ref

    m = dict(dtype=torch.bfloat16, device="meta", requires_grad=train)
    q = torch.empty((b, sq, hq, hd), **m)
    k = torch.empty((b, skv, hkv, hd), **m)
    v = torch.empty((b, skv, hkv, hd), **m)

    def fn():
        out = flash_attention_ref(q, k, v, causal=causal, window=window)[0]
        if train:
            torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))

    return _analysed(fn)


@functools.lru_cache(maxsize=64)
def _measure_ssd(
    b: int, s: int, h: int, p: int, n: int, chunk: int, train: bool
) -> Tuple[float, float]:
    """(hbm_bytes, flops) of the plain SSD scan (B and C per head, as the
    JAX measurement takes them) on meta tensors, under the op analyser."""
    from ..kernels.ssd_scan.ref import ssd_ref

    m = dict(dtype=torch.float32, device="meta")
    x = torch.empty((b, s, h, p), **m, requires_grad=train)
    da = torch.empty((b, s, h), **m)
    bb = torch.empty((b, s, h, n), **m, requires_grad=train)
    cc = torch.empty((b, s, h, n), **m, requires_grad=train)
    q = min(chunk, s)

    def fn():
        y, _ = ssd_ref(x, da, bb, cc, q)
        if train:
            torch.autograd.grad((y**2).sum(), (x, bb, cc))

    return _analysed(fn)


def _attn_kernel_analytic(site: Dict, train: bool) -> Tuple[float, float]:
    """The JAX package's flash-kernel model: stream q,k,v once, write o
    (fwd); backward re-reads q,k,v,o,do and writes dq,dk,dv."""
    qb = site["b"] * site["sq"] * site["hq"] * site["hd"] * BF16
    kb = site["b"] * site["skv"] * site["hkv"] * site["hd"] * BF16
    io_fwd = qb + 2 * kb + qb  # q + k + v + o
    io = io_fwd * 3 if train else io_fwd
    skv_eff = min(site["skv"], site["window"]) if site["window"] else site["skv"]
    causal_f = 0.5 if site["causal"] and not site["window"] else 1.0
    flops = (
        4.0 * site["b"] * site["hq"] * site["sq"] * skv_eff * site["hd"] * causal_f
    )
    flops = flops * 3.5 if train else flops  # bwd ≈ 2.5× fwd dots
    return io, flops


def _ssd_kernel_analytic(site: Dict, train: bool) -> Tuple[float, float]:
    xb = site["b"] * site["s"] * site["h"] * site["p"] * F32
    bcb = site["b"] * site["s"] * site["h"] * site["n"] * F32
    dab = site["b"] * site["s"] * site["h"] * F32
    io_fwd = 2 * xb + 2 * bcb + dab  # x, y, B, C, dA
    io = io_fwd * 3 if train else io_fwd
    q = min(site["chunk"], site["s"])
    nc = site["s"] // q
    flops = (
        site["b"] * site["h"] * nc
        * (2 * q * q * site["n"] + 2 * q * q * site["p"] + 4 * q * site["p"] * site["n"])
    )
    flops = flops * 3.5 if train else flops
    return io, flops


def substitution_for_cell(
    cfg: ModelConfig, shape: ShapeConfig, dp: int, tp: int, mb: int
) -> Dict:
    """The JAX record's keys: the plain versions' measured bytes and FLOPs
    over the cell's sites (``measured_scan_*``), the analytic kernel
    model's (``kernel_*``) and their difference."""
    train = shape.kind == "train"
    sub_bytes = sub_flops = kernel_bytes = kernel_flops = 0.0
    for site in _attention_sites(cfg, shape, dp, tp, mb):
        mult = site["count"] * (mb if train else 1)
        mb_, mf_ = _measure_attention(
            site["b"], site["sq"], site["skv"], site["hq"], site["hkv"],
            site["hd"], site["causal"], site["window"], train,
        )
        kb_, kf_ = _attn_kernel_analytic(site, train)
        sub_bytes += mult * mb_
        sub_flops += mult * mf_
        kernel_bytes += mult * kb_
        kernel_flops += mult * kf_
    for site in _ssd_sites(cfg, shape, dp, mb, tp):
        mult = site["count"] * (mb if train else 1)
        mb_, mf_ = _measure_ssd(
            site["b"], site["s"], site["h"], site["p"], site["n"],
            site["chunk"], train,
        )
        kb_, kf_ = _ssd_kernel_analytic(site, train)
        sub_bytes += mult * mb_
        sub_flops += mult * mf_
        kernel_bytes += mult * kb_
        kernel_flops += mult * kf_
    return {
        "measured_scan_bytes": sub_bytes,
        "measured_scan_flops": sub_flops,
        "kernel_bytes": kernel_bytes,
        "kernel_flops": kernel_flops,
        "bytes_delta": sub_bytes - kernel_bytes,
        "flops_delta": sub_flops - kernel_flops,
    }
