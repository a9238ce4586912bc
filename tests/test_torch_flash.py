"""The port's flash attention and RMSNorm backward (plain versions, on the
CPU) against the JAX package on the same inputs, made with numpy from a seed:

* the forward against the Pallas kernel in interpret mode (as
  ``tests/test_kernels.py`` runs it), over D {64, 80}, G {1, 4}, causal on and
  off, window {None, 16}, fp32 and bf16, at G 3 (granite-moe-3b-a800m)
  with S 100, no multiple of the kernel's 42-position tiles at G 3, and at
  G 48 (granite-34b's MQA, 2 positions a 128-row tile) with S 101;
* the plain backward against ``jax.vjp`` of ``blocked_attention`` (whose
  custom VJP is the rule the port copies) and against torch autograd through
  the port's own ``gqa_attention``;
* the RMSNorm plain backward against ``jax.grad`` of JAX ``rms_norm``;
* the plain versions' ``p_dtype`` rounding, and the bf16 kernels' gate
  (``rounding_ratios``) failing on faults planted into a stand-in kernel at
  the training shape's statistics.

Tolerances (max |port - JAX| over max(1, max |JAX|)): 1e-4 in fp32 for
outputs, 2e-4 for gradients (sums over the sequence in another order);
2e-2 in bf16 (one bf16 ulp is 2^-8..2^-7 of the value, and the two
frameworks round intermediate values at different places)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.models.blocked_attention import blocked_attention
from repro.models.layers import rms_norm as jax_rms_norm
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref,
    flash_attention_ref,
    kernel_key_tile,
    rounding_ratios,
)
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref
from repro_torch.models.attention import gqa_attention

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _maxerr(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = max(1.0, float(np.abs(b).max()))
    return float(np.abs(a - b).max()) / scale


def _pair(arr, dtype):
    j = jnp.asarray(arr, jnp.float32).astype(JNP[dtype])
    t = torch.from_numpy(np.asarray(arr, np.float32)).to(TORCH[dtype])
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(rng, b, s, hkv, g, d, dtype):
    return [_pair(rng.standard_normal((b, s, h, d)), dtype) for h in (hkv * g, hkv, hkv)]


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_forward_matches_pallas_interpret(d, g, causal, window, dtype):
    rng = np.random.default_rng(d + 10 * g + 100 * causal + (window or 0))
    (q, qt), (k, kt), (v, vt) = _qkv(rng, 2, 40, 2, g, d, dtype)
    ref = jax_flash_attention(q, k, v, causal=causal, window=window, interpret=True)
    out = flash_attention(qt, kt, vt, causal=causal, window=window)
    assert out.shape == qt.shape and out.dtype == TORCH[dtype]
    assert _maxerr(_f32(out), _f32(ref)) < TOL[dtype]


@pytest.mark.parametrize("causal,window", [(True, None), (True, 16), (False, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_forward_at_group_3_matches_pallas_interpret(causal, window, dtype):
    """granite-moe-3b-a800m's GQA group of 3 (6/2 heads here) at S 100, no
    multiple of the 42 positions a 128-row tile of the kernel holds at G 3,
    against the Pallas forward (interpret mode) and, lse included, the plain
    version in the kernel's key tiles."""
    rng = np.random.default_rng(100 + causal + (window or 0))
    (q, qt), (k, kt), (v, vt) = _qkv(rng, 1, 100, 2, 3, 64, dtype)
    ref = jax_flash_attention(q, k, v, causal=causal, window=window, interpret=True)
    out = flash_attention(qt, kt, vt, causal=causal, window=window)
    assert out.shape == qt.shape and out.dtype == TORCH[dtype]
    assert _maxerr(_f32(out), _f32(ref)) < TOL[dtype]
    tiled, lse = flash_attention_ref(qt, kt, vt, causal=causal, window=window,
                                     block_k=kernel_key_tile(64))
    _, lse_full = flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    assert _maxerr(_f32(tiled), _f32(ref)) < TOL[dtype]
    assert _maxerr(lse.numpy(), lse_full.numpy()) < 1e-5


@pytest.mark.parametrize("causal,window", [(True, None), (True, 16), (False, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_forward_at_group_48_matches_pallas_interpret(causal, window, dtype):
    """granite-34b's MQA group of 48 at D 128 (96/2 heads here) at S 101,
    an odd number of positions for the kernel's 2-position 128-row tiles,
    against the Pallas forward (interpret mode) and, lse included, the plain
    version in the kernel's key tiles."""
    rng = np.random.default_rng(48 + causal + (window or 0))
    (q, qt), (k, kt), (v, vt) = _qkv(rng, 1, 101, 2, 48, 128, dtype)
    ref = jax_flash_attention(q, k, v, causal=causal, window=window, interpret=True)
    out = flash_attention(qt, kt, vt, causal=causal, window=window)
    assert out.shape == qt.shape and out.dtype == TORCH[dtype]
    assert _maxerr(_f32(out), _f32(ref)) < TOL[dtype]
    tiled, lse = flash_attention_ref(qt, kt, vt, causal=causal, window=window,
                                     block_k=kernel_key_tile(128))
    _, lse_full = flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    assert _maxerr(_f32(tiled), _f32(ref)) < TOL[dtype]
    assert _maxerr(lse.numpy(), lse_full.numpy()) < 1e-5


def test_flash_forward_lse_is_the_log_sum_exp():
    rng = np.random.default_rng(5)
    (_, q), (_, k), (_, v) = _qkv(rng, 1, 33, 2, 2, 16, "float32")
    _, lse = flash_attention_ref(q, k, v, causal=True, window=8, block_k=8)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(2, dim=2)) * 16**-0.5
    i = torch.arange(33)
    mask = (i[None] <= i[:, None]) & (i[:, None] - i[None] < 8)
    ref = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    assert _maxerr(lse.numpy(), ref.numpy()) < 1e-5


# G 3 and 48: granite-moe-3b-a800m's and granite-34b's groups
@pytest.mark.parametrize("g", [1, 3, 4, 48])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 16), (False, 16)])
@pytest.mark.parametrize("block_k", [16, 1024])
def test_flash_backward_matches_blocked_attention_vjp(g, causal, window, block_k):
    rng = np.random.default_rng(g + 7 * (window or 0) + block_k)
    b, s, hkv, d = 2, 40, 2, 16
    (q, qt), (k, kt), (v, vt) = _qkv(rng, b, s, hkv, g, d, "float32")
    dout_np = rng.standard_normal((b, s, hkv * g, d)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    out, vjp = jax.vjp(
        lambda q, k, v: blocked_attention(q, k, v, pos, pos, causal, window, 16, False), q, k, v
    )
    ref = vjp(jnp.asarray(dout_np))
    out_t, lse = flash_attention_ref(qt, kt, vt, causal=causal, window=window, block_k=block_k)
    assert _maxerr(_f32(out_t), _f32(out)) < TOL["float32"]
    grads = flash_attention_bwd_ref(
        qt, kt, vt, out_t, lse, torch.from_numpy(dout_np), causal=causal, window=window,
        block_k=block_k,
    )
    for got, want in zip(grads, ref):
        assert _maxerr(_f32(got), _f32(want)) < GRAD_TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 16), (False, None)])
def test_flash_autograd_matches_gqa_autograd(dtype, causal, window):
    """Through the autograd Function (the path the model takes) against
    torch autograd through the port's reference attention."""
    rng = np.random.default_rng(3 + (window or 0))
    b, s, hkv, g, d = 2, 40, 2, 4, 16
    qkv = [_pair(a, dtype)[1].requires_grad_() for a in (
        rng.standard_normal((b, s, hkv * g, d)), rng.standard_normal((b, s, hkv, d)),
        rng.standard_normal((b, s, hkv, d)))]
    dout = _pair(rng.standard_normal((b, s, hkv * g, d)), dtype)[1]
    pos = torch.arange(s)[None].expand(b, s)
    out = flash_attention(*qkv, causal=causal, window=window)
    grads = torch.autograd.grad(out, qkv, dout)
    ref = gqa_attention(*qkv, pos, pos, causal=causal, window=window)
    ref_grads = torch.autograd.grad(ref, qkv, dout)
    assert _maxerr(_f32(out), _f32(ref)) < TOL[dtype]
    for got, want in zip(grads, ref_grads):
        assert got.dtype == TORCH[dtype]
        assert _maxerr(_f32(got), _f32(want)) < GRAD_TOL[dtype]


@pytest.mark.parametrize("d", [64, 1152])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_backward_matches_jax_grad(d, dtype):
    rng = np.random.default_rng(d)
    x, xt = _pair(rng.standard_normal((3, 5, d)) * 3, dtype)
    w, wt = _pair(rng.standard_normal(d) * 0.1, dtype)
    dy, dyt = _pair(rng.standard_normal((3, 5, d)), dtype)
    _, vjp = jax.vjp(lambda x, w: jax_rms_norm(x, {"scale": w}, 1e-6), x, w)
    ref_dx, ref_dw = vjp(dy)
    dx, dw = rmsnorm_bwd_ref(dyt, xt, wt, 1e-6)
    assert dx.dtype == TORCH[dtype] and dw.dtype == TORCH[dtype]
    assert _maxerr(_f32(dx), _f32(ref_dx)) < GRAD_TOL[dtype]
    assert _maxerr(_f32(dw), _f32(ref_dw)) < GRAD_TOL[dtype]
    # and through the autograd Function, as the model differentiates it
    xg, wg = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    gx, gw = torch.autograd.grad(rmsnorm(xg, wg, 1e-6), (xg, wg), dyt)
    assert torch.equal(gx, dx) and torch.equal(gw, dw)


FLASH_REF_MASKS = [(True, None), (True, 16), (False, None), (False, 16)]


@pytest.mark.parametrize("causal,window", FLASH_REF_MASKS)
def test_flash_ref_p_dtype_none_is_the_fp32_plain_version(causal, window):
    """``p_dtype=None`` leaves the plain versions bit for bit as they are
    without the argument, forward and backward."""
    rng = np.random.default_rng(11 + (window or 0))
    (_, q), (_, k), (_, v) = _qkv(rng, 2, 40, 2, 4, 16, "float32")
    dout = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    out, lse = flash_attention_ref(q, k, v, causal=causal, window=window, block_k=16)
    out_n, lse_n = flash_attention_ref(q, k, v, causal=causal, window=window, block_k=16,
                                       p_dtype=None)
    assert torch.equal(out, out_n) and torch.equal(lse, lse_n)
    grads = flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window,
                                    block_k=16)
    grads_n = flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window,
                                      block_k=16, p_dtype=None)
    for got, want in zip(grads_n, grads):
        assert torch.equal(got, want)


@pytest.mark.parametrize("causal,window", FLASH_REF_MASKS)
@pytest.mark.parametrize("block_k", [16, 1024])
def test_flash_ref_p_dtype_bf16_rounds_p_only(causal, window, block_k):
    """With ``p_dtype=torch.bfloat16`` (where the tensor-core kernels round P
    and dS) on fp32 inputs, the output moves from the fp32 plain version by
    a non-zero amount within 2^-8 x max|v| (P is a convex weight, each
    rounded by at most 2^-9 of itself); lse does not move, and the
    gradients move by a non-zero amount."""
    rng = np.random.default_rng(29 + block_k + (window or 0))
    (_, q), (_, k), (_, v) = _qkv(rng, 2, 40, 2, 4, 16, "float32")
    dout = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    kw = dict(causal=causal, window=window, block_k=block_k)
    out, lse = flash_attention_ref(q, k, v, **kw)
    out_p, lse_p = flash_attention_ref(q, k, v, p_dtype=torch.bfloat16, **kw)
    assert out_p.dtype == torch.float32 and torch.equal(lse_p, lse)
    err = (out_p - out).abs().max().item()
    assert 0 < err <= 2.0**-8 * v.abs().max().item()
    grads = flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    grads_p = flash_attention_bwd_ref(q, k, v, out, lse, dout, p_dtype=torch.bfloat16, **kw)
    for got, want in zip(grads_p, grads):
        assert got.dtype == torch.float32
        gerr = (got - want).abs().max().item()
        assert 0 < gerr <= 2.0**-7 * want.abs().max().item()


# The bf16 kernels' gate (``rounding_ratios``) at the statistics of the
# training shape [2, 8192, 32/8, 80], window 4096: D 80, G 4, rows of up to
# 4096 keys (batch and kv heads cut to 1, S to 4608).  A kernel is stood in
# for by the plain version rounding where the bf16 kernels round (P and dS
# to bf16, the kernel's key tile), its outputs rounded to bf16, with a fault
# planted into it.
GATE_B, GATE_S, GATE_G, GATE_D, GATE_W = 1, 4608, 4, 80, 4096
ALL_GRADS = {"out", "dq", "dk", "dv"}
# fault -> the outputs whose gate must fail
GATE_FAULTS = {
    "none": set(),
    "window one key wider": ALL_GRADS,
    "window one key narrower": ALL_GRADS,
    "one 64-key tile skipped by one 128-row q tile": ALL_GRADS,
    "dV without the diagonal key": {"dv"},
    "dV with P left in fp32": set(),  # more exact than the kernel, not a fault
}


@functools.lru_cache(maxsize=1)
def _gate_case():
    rng = np.random.default_rng(41)
    shapes = [(GATE_B, GATE_S, h, GATE_D) for h in (GATE_G, 1, 1, GATE_G)]
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                     .to(torch.bfloat16).float() for s in shapes)
    kw = dict(causal=True, window=GATE_W)
    kw_p = dict(kw, p_dtype=torch.bfloat16, block_k=kernel_key_tile(GATE_D))
    ref, _ = flash_attention_ref(q, k, v, **kw)
    ref_p, _ = flash_attention_ref(q, k, v, **kw_p)
    out, lse = ref_p.to(torch.bfloat16), flash_attention_ref(q, k, v, **kw_p)[1]
    grads = flash_attention_bwd_ref(q, k, v, out.float(), lse, dout, **kw)
    grads_p = flash_attention_bwd_ref(q, k, v, out.float(), lse, dout, **kw_p)
    return (q, k, v, dout, out, lse), dict(zip(["out", "dq", "dk", "dv"], zip(
        (ref, *grads), (ref_p, *grads_p))))


def _plant(fault, monkeypatch):
    """The outputs of a bf16 kernel with ``fault``: out from the forward, dq,
    dk and dv from the backward given the sound out and lse."""
    from repro_torch.kernels.flash_attention import ref as ref_mod

    (q, k, v, dout, out, lse), _ = _gate_case()
    sound_mask = ref_mod._mask
    window = GATE_W + {"window one key wider": 1, "window one key narrower": -1}.get(fault, 0)
    if fault == "one 64-key tile skipped by one 128-row q tile":
        p0, t0 = 3456, 1408  # a q tile in the bulk, a K tile well inside its window

        def mask(sq, k0, k1, sk, causal, w, device):
            qpos = torch.arange(sq, device=device)[:, None]
            kpos = torch.arange(k0, k1, device=device)[None, :]
            hole = (qpos >= p0) & (qpos < p0 + 128 // GATE_G) & (kpos >= t0) & (kpos < t0 + 64)
            return sound_mask(sq, k0, k1, sk, causal, w, device) & ~hole

        monkeypatch.setattr(ref_mod, "_mask", mask)
    kw = dict(causal=True, window=window, p_dtype=torch.bfloat16, block_k=kernel_key_tile(GATE_D))
    got = {"out": flash_attention_ref(q, k, v, **kw)[0]}
    got.update(zip(["dq", "dk", "dv"], flash_attention_bwd_ref(q, k, v, out.float(), lse, dout, **kw)))
    if fault == "dV without the diagonal key":
        monkeypatch.setattr(ref_mod, "_mask", lambda sq, k0, k1, *a: sound_mask(sq, k0, k1, *a) & (
            torch.arange(sq)[:, None] != torch.arange(k0, k1)[None, :]))
        got["dv"] = flash_attention_bwd_ref(q, k, v, out.float(), lse, dout, **kw)[2]
    elif fault == "dV with P left in fp32":
        got["dv"] = flash_attention_bwd_ref(q, k, v, out.float(), lse, dout, **dict(kw, p_dtype=None))[2]
    return {n: x.to(torch.bfloat16) for n, x in got.items()}


@pytest.mark.parametrize("fault", list(GATE_FAULTS))
def test_flash_bf16_gate_rejects_planted_faults(fault, monkeypatch):
    """Each planted fault fails the gate on the outputs it reaches, by row or
    by mean (the readings print with ``-s``), and the sound outputs pass."""
    _, refs = _gate_case()
    got = _plant(fault, monkeypatch)
    failed = set()
    for name, (ref, ref_p) in refs.items():
        row, mean = rounding_ratios(got[name], ref, ref_p)
        print(f"gate {fault!r} {name}: row ratio {row:.3f}, mean ratio {mean:.3f}")
        if row > 1 or mean > 1:
            failed.add(name)
    assert failed == GATE_FAULTS[fault]
