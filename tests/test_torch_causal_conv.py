"""C1, the Mamba2 mixer's causal conv, bias and SiLU
(``repro_torch.kernels.causal_conv``), on the CPU:

* the plain forward: its pre-activation bit for bit the JAX package's
  ``_causal_conv``, its output that followed by SiLU within a few fp32
  ulps (PyTorch's SiLU is x / (1 + exp(-x)), JAX's x * sigmoid(x));
* the plain backward against autograd of the plain forward (fp32 1e-5 of
  each gradient's largest value; bf16 dx within one bf16 ulp);
* the autograd Function's gradients equal the plain backward's, and it
  saves nothing but its inputs;
* on meta tensors: the kernel's output shapes and dtypes, its instance
  checks, each launch reported with ``cost`` / ``bwd_cost``;
* ``mamba_block`` gives the output the mixer gave with the plain chain.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro.models.mamba2 import _causal_conv as jax_causal_conv  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.causal_conv import ops  # noqa: E402
from repro_torch.kernels.causal_conv.ref import (  # noqa: E402
    causal_conv_ref, causal_conv_silu_bwd_ref, causal_conv_silu_ref)
from repro_torch.models import build_model, mamba2  # noqa: E402
from repro_torch.models.transformer import _group_slice  # noqa: E402

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(b, s, c, width, seed=0):
    """x, w, b and dy as fp32 numpy arrays."""
    rng = np.random.default_rng(seed + s * 31 + c + width)
    return (rng.standard_normal((b, s, c)).astype(np.float32),
            (rng.standard_normal((width, c)) * width**-0.5).astype(np.float32),
            (rng.standard_normal(c) * 0.1).astype(np.float32),
            rng.standard_normal((b, s, c)).astype(np.float32))


def _inputs(b, s, c, width, dtype, seed=0):
    """x, w and b as torch tensors of ``dtype``, dy fp32, each with storage
    of its own."""
    *xwb, dy = (torch.tensor(a) for a in _arrays(b, s, c, width, seed))
    return [t.to(TORCH[dtype]) for t in xwb] + [dy]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [2, 3, 4])
@pytest.mark.parametrize("c", [128, 4096, 99])
@pytest.mark.parametrize("s", [2, 37])
def test_plain_forward_matches_jax(dtype, width, c, s):
    x, w, b, _ = _inputs(2, s, c, width, dtype)
    # JAX gets arrays of its own (never a view of a torch tensor's storage)
    jx, jw, jb = (jnp.asarray(a).astype(dtype) for a in _arrays(2, s, c, width)[:3])
    want = jax_causal_conv(jx, jw, jb)
    assert np.array_equal(causal_conv_ref(x, w, b).numpy(), np.asarray(want))
    got, want = causal_conv_silu_ref(x, w, b).numpy(), np.asarray(jax.nn.silu(want))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=1e-7)


def _autograd_of_plain(x, w, b, dy):
    leaves = [t.detach().requires_grad_() for t in (x, w, b)]
    return torch.autograd.grad(causal_conv_silu_ref(*leaves), leaves, dy)


@pytest.mark.parametrize("width", [2, 3, 4])
@pytest.mark.parametrize("c,s", [(128, 37), (99, 2), (256, 64)])
def test_plain_backward_matches_autograd(width, c, s):
    x, w, b, dy = _inputs(3, s, c, width, "float32")
    for got, want in zip(causal_conv_silu_bwd_ref(x, w, b, dy), _autograd_of_plain(x, w, b, dy)):
        assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


def test_plain_backward_in_bf16_rounds_once():
    """bf16 x, w and b: dx, dw and db come in bf16, each within one bf16 ulp
    of the fp32 plain backward on the same values."""
    x, w, b, dy = _inputs(2, 40, 128, 4, "bfloat16")
    got = causal_conv_silu_bwd_ref(x, w, b, dy)
    want = causal_conv_silu_bwd_ref(x.float(), w.float(), b.float(), dy)
    for g, r in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), r, rtol=2.0**-8, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [256, 32])  # the x conv and the B/C conv, scaled down
def test_function_gradients_equal_plain_backward(dtype, c):
    x, w, b, dy = _inputs(2, 64, c, 4, dtype)
    leaves = [t.detach().requires_grad_() for t in (x, w, b)]
    before = (ops.causal_conv_silu.launches, ops.causal_conv_silu.backward_launches)
    y = ops.causal_conv_silu(*leaves)
    assert torch.equal(y, causal_conv_silu_ref(x, w, b))
    assert {t.data_ptr() for t in y.grad_fn.saved_tensors} == {t.data_ptr() for t in leaves}
    grads = torch.autograd.grad(y, leaves, dy)
    for got, want in zip(grads, causal_conv_silu_bwd_ref(x, w, b, dy)):
        assert torch.equal(got, want)
    # the plain versions do not count as launches
    assert (ops.causal_conv_silu.launches, ops.causal_conv_silu.backward_launches) == before


def test_function_rejects_bad_shapes():
    x = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError):
        ops.causal_conv_silu(x, torch.zeros(4, 15), torch.zeros(16))
    with pytest.raises(ValueError):
        ops.causal_conv_silu(x, torch.zeros(4, 16), torch.zeros(15))
    with pytest.raises(ValueError):
        ops.causal_conv_silu(x[0], torch.zeros(4, 16), torch.zeros(16))


class _Observer:
    def __init__(self):
        self.launches = []

    def begin_kernel(self):
        pass

    def end_kernel(self, name, cost):
        self.launches.append((name, cost))


def test_meta_path_shapes_and_cost():
    """The cell's x conv [8, 4096, 4096] in bf16: the forward reads x and
    writes the fp32 output (805 MB), the backward reads x and dy and writes
    dx (1,074 MB), w and b beside them."""
    b, s, c, width = 8, 4096, 4096, 4
    x = torch.empty(b, s, c, dtype=torch.bfloat16, device="meta", requires_grad=True)
    w = torch.empty(width, c, dtype=torch.bfloat16, device="meta", requires_grad=True)
    bias = torch.empty(c, dtype=torch.bfloat16, device="meta", requires_grad=True)
    obs = _Observer()
    kernels.observe(obs)
    try:
        y = ops.causal_conv_silu(x, w, bias)
        dx, dw, db = torch.autograd.grad(y, (x, w, bias), torch.empty_like(y))
    finally:
        kernels.unobserve(obs)
    assert y.shape == x.shape and y.dtype == torch.float32 and y.device.type == "meta"
    assert (dx.shape, dx.dtype) == (x.shape, x.dtype)
    assert (dw.shape, db.shape, dw.dtype, db.dtype) == (w.shape, bias.shape, w.dtype, bias.dtype)
    assert [name for name, _ in obs.launches] == ["causal_conv", "causal_conv_bwd"]
    fwd, bwd = obs.launches[0][1], obs.launches[1][1]
    n = b * s * c
    assert fwd == ops.cost(b, s, c, width) and bwd == ops.bwd_cost(b, s, c, width)
    assert fwd.bytes == n * (2 + 4) + (width + 1) * c * 2
    assert round(n * 6 / 1e6) == 805 and round(n * 8 / 1e6) == 1074
    assert bwd.bytes == n * (2 + 4 + 2) + 2 * (width + 1) * c * 2
    assert fwd.flops == n * (2 * width + 4) and bwd.flops == n * (6 * width + 10)


def test_meta_path_checks_the_instance():
    x = torch.empty(1, 8, 16, device="meta")
    with pytest.raises(NotImplementedError):
        ops.causal_conv_silu(x, torch.empty(5, 16, device="meta"), torch.empty(16, device="meta"))
    with pytest.raises(TypeError):
        ops.causal_conv_silu(x.half(), torch.empty(4, 16, device="meta"),
                             torch.empty(16, device="meta"))
    with pytest.raises(TypeError):  # x, w and b share a dtype
        ops.causal_conv_silu(x.bfloat16(), torch.empty(4, 16, device="meta"),
                             torch.empty(16, device="meta"))
    with pytest.raises(ValueError):
        ops.causal_conv_silu(x.transpose(1, 2), torch.empty(4, 8, device="meta"),
                             torch.empty(8, device="meta"))


@pytest.mark.parametrize("b,s,c", [(8, 4096, 4096), (8, 4096, 128), (1, 3, 99), (2, 100, 8)])
def test_layout_covers_every_channel_and_position(b, s, c):
    """A block is 128 threads of ``tx`` channel groups by 128 / tx tiles;
    the backward's partials are one a block of each row."""
    tile, tx = ops.layout(b, s, c)
    groups = -(-c // ops.CHANNELS)
    assert ops.THREADS % tx == 0 and tx >= min(groups, 32)
    assert ops.MIN_TILE <= tile <= ops.MAX_TILE
    tiles, ty = -(-s // tile), ops.THREADS // tx
    assert ops.parts(b, s, c) == b * -(-tiles // ty)
    if (b, s, c) == (8, 4096, 4096):
        assert (tile, tx, ops.parts(b, s, c)) == (64, 32, 128)


def _old_causal_conv(xbc, w, b):
    """The mixer's conv before C1, as it was."""
    width, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(width):
        out = out + pad[:, i : i + s].float() * w[i].float()
    return out + b.float()


def _layer0(name, dtype):
    cfg = dataclasses.replace(get_config(name + "-smoke"), n_layers=3, param_dtype=dtype,
                              compute_dtype=dtype)
    params = build_model(cfg, device="cpu").init(seed=0)
    lp = _group_slice(params["groups"]["pos0"], 0)["mamba"]
    u = torch.randn(2, 48, cfg.d_model, generator=torch.Generator().manual_seed(1)).to(TORCH[dtype])
    return cfg, lp, u


def _block_grads(lp, u, cfg):
    leaves = {k: lp[k].detach().requires_grad_() for k in ("conv_x_w", "conv_bc_b")}
    ul = u.detach().requires_grad_()
    out, state = mamba2.mamba_block({**lp, **leaves}, ul, cfg)
    grads = torch.autograd.grad(out.float().square().sum(), [ul, *leaves.values()])
    return out, state, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixer_output_as_before(dtype, monkeypatch):
    """``mamba_block`` through C1 gives the output and final state of the
    plain chain bit for bit, and its gradients within fp32 rounding (C1
    sums dx once, the chain at every tap)."""
    cfg, lp, u = _layer0("mamba2-370m", dtype)
    new = _block_grads(lp, u, cfg)
    monkeypatch.setattr(mamba2, "causal_conv_silu",
                        lambda x, w, b: F.silu(_old_causal_conv(x, w, b)))
    old = _block_grads(lp, u, cfg)
    assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])
    tol = 1e-5 if dtype == "float32" else 2.0**-7
    for g, h in zip(new[2], old[2]):
        torch.testing.assert_close(g.float(), h.float(), rtol=tol,
                                   atol=tol * h.float().abs().max().item())
