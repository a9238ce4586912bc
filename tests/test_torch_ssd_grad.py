"""The SSD chunk scan's backward in the port against the JAX package's.

The JAX package has no backward kernel: it differentiates ``ssd_chunked``
by autodiff.  The port's backward is a kernel whose plain version is
``ssd_bwd_ref``, written as one plain function per pass of the kernel.
Here, on CPU tensors, with inputs made with numpy from a seed:

* ``ssd_bwd_ref``, and its six passes composed through ``ops.run_pass`` on
  the forward passes' own scratch (C B^T NaN above the diagonal, where no
  pass may read it), against ``torch.autograd`` of ``ssd_ref`` and against
  ``jax.vjp`` of ``ssd_chunked`` (given B and C repeated to the heads, so
  its dB and dC are summed over each group's heads);
* ``ops.ssd``'s autograd Function on the CPU, which runs ``ssd_bwd_ref``,
  and returns a gradient of the initial state only when one is asked for.

G 1 and G 2, with and without an initial state and a gradient of the final
state, chunks 16 and 64.  Tolerance: every element within 1e-5 x the
gradient's largest |value| + 1e-6 (fp32 sums of up to a chunk of terms in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref, ssd_ref

RTOL, ATOL = 1e-5, 1e-6
NAMES = ("dx", "d_dA", "dB", "dC", "d_initial")

# (b, chunks, h, p, n, g, chunk, initial state, dfinal)
CASES = [
    (2, 3, 4, 16, 8, 1, 16, False, False),
    (1, 2, 4, 8, 16, 2, 16, True, True),
    (2, 2, 2, 16, 16, 1, 64, True, False),
    (1, 2, 4, 16, 8, 2, 64, False, True),
]


def _close(name, got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    bound = RTOL * float(np.abs(want).max()) + ATOL
    err = float(np.abs(got - want).max())
    assert err <= bound, (name, err, bound)


def _inputs(seed, b, s, h, p, n, g, init, dfin):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    da = -np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    bg = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    cg = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32) if init else None
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    df = rng.standard_normal((b, h, p, n)).astype(np.float32) if dfin else None
    return x, da, bg, cg, st, dy, df


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _jax_vjp(x, da, bg, cg, st, dy, df, chunk):
    """(dx, d_dA, dB, dC, d_initial) of ssd_chunked by jax.vjp, dB and dC
    summed over each group's heads."""
    b, s, h, p = x.shape
    g, n = bg.shape[2], bg.shape[3]
    rep = h // g

    def f(x, da, bh, ch, *st):
        return ssd_chunked(x, da, bh, ch, chunk, st[0] if st else None)

    args = [jnp.asarray(x), jnp.asarray(da), jnp.repeat(jnp.asarray(bg), rep, axis=2),
            jnp.repeat(jnp.asarray(cg), rep, axis=2)]
    if st is not None:
        args.append(jnp.asarray(st))
    (y, final), vjp = jax.vjp(f, *args)
    dfin = jnp.asarray(df) if df is not None else jnp.zeros_like(final)
    grads = [np.asarray(t) for t in vjp((jnp.asarray(dy), dfin))]
    for i in (2, 3):
        grads[i] = grads[i].reshape(b, s, g, rep, n).sum(3)
    return grads + ([None] if st is None else [])


def _autograd(x, da, bg, cg, st, dy, df, chunk):
    """The same from torch.autograd of ssd_ref (whose L is exp of a -inf
    masked difference: its gradient is 0 above the diagonal)."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, da, bg, cg)]
    if st is not None:
        leaves.append(torch.from_numpy(st).requires_grad_())
    y, final = ssd_ref(*leaves[:4], chunk, leaves[4] if st is not None else None)
    loss = (y * _t(dy)).sum() + ((final * _t(df)).sum() if df is not None else 0.0)
    grads = torch.autograd.grad(loss, leaves)
    return [g.numpy() for g in grads] + ([None] if st is None else [])


def _through_passes(x, da, bg, cg, st, dy, df, chunk):
    """The same from the plain versions of the forward's five passes and the
    backward's six, each reading what the passes before it wrote."""
    ws = ssd_ops.workspace(_t(x), _t(da), _t(bg), _t(cg), chunk, _t(st))
    ws.cb.fill_(float("nan"))  # above the diagonal no pass may read C B^T
    for name in ssd_ops.PASSES:
        ssd_ops.run_pass(ws, name)
    bw = ssd_ops.bwd_workspace(ws, _t(dy), _t(df))
    for name in ssd_ops.BWD_PASSES:
        ssd_ops.run_pass(bw, name)
    return [t.numpy() for t in (bw.dx, bw.d_dA, bw.dB, bw.dC, bw.d_init)]


@pytest.mark.parametrize("b,nc,h,p,n,g,chunk,init,dfin", CASES)
def test_ssd_bwd_ref_and_its_passes_match_autograd_and_jax_vjp(b, nc, h, p, n, g, chunk, init,
                                                               dfin):
    s = nc * chunk
    args = _inputs(s + h + g + n, b, s, h, p, n, g, init, dfin)
    x, da, bg, cg, st, dy, df = args
    ref = [None if t is None else t.numpy()
           for t in ssd_bwd_ref(*map(_t, (x, da, bg, cg)), chunk, _t(st), _t(dy), _t(df))]
    passes = _through_passes(*args, chunk)
    for want in (_jax_vjp(*args, chunk), _autograd(*args, chunk)):
        for i, name in enumerate(NAMES):
            if want[i] is None:  # no initial state: nothing to compare d_initial with
                continue
            _close(name, ref[i], want[i])
            _close(name + " (passes)", passes[i], want[i])
    assert float(np.abs(ref[1]).max()) > 0 and float(np.abs(ref[2]).max()) > 0


@pytest.mark.parametrize("b,nc,h,p,n,g,chunk,init,dfin", CASES)
def test_ssd_autograd_function_on_cpu_runs_the_plain_backward(b, nc, h, p, n, g, chunk, init,
                                                              dfin):
    """ops.ssd's gradients through its autograd Function, B and C as views of
    one [B, S, 2GN] tensor as the model has them, against jax.vjp; the
    initial state gets a gradient only when it requires one."""
    s = nc * chunk
    x, da, bg, cg, st, dy, df = _inputs(s + h + g + n, b, s, h, p, n, g, init, dfin)
    want = _jax_vjp(x, da, bg, cg, st, dy, df, chunk)
    bc = torch.from_numpy(np.concatenate([bg, cg], axis=2).reshape(b, s, 2 * g * n))
    xt, dat, bct = (torch.from_numpy(x).requires_grad_(), torch.from_numpy(da).requires_grad_(),
                    bc.requires_grad_())
    stt = torch.from_numpy(st) if init else None
    B_, C_ = bct[..., : g * n].view(b, s, g, n), bct[..., g * n :].view(b, s, g, n)
    y, final = ssd_ops.ssd(xt, dat, B_, C_, chunk, stt)
    loss = (y * _t(dy)).sum() + ((final * _t(df)).sum() if dfin else 0.0)
    dx, d_da, dbc = torch.autograd.grad(loss, (xt, dat, bct))
    _close("dx", dx.numpy(), want[0])
    _close("d_dA", d_da.numpy(), want[1])
    dbc = dbc.numpy().reshape(b, s, 2, g, n)
    _close("dB", dbc[:, :, 0], want[2])
    _close("dC", dbc[:, :, 1], want[3])
    if init:
        st_leaf = torch.from_numpy(st).requires_grad_()
        y, final = ssd_ops.ssd(xt.detach(), dat.detach(), B_.detach(), C_.detach(), chunk, st_leaf)
        loss = (y * _t(dy)).sum() + ((final * _t(df)).sum() if dfin else 0.0)
        (d_init,) = torch.autograd.grad(loss, (st_leaf,))
        _close("d_initial", d_init.numpy(), want[4])


def _source_constant(name):
    """A ``constexpr int`` of the backward's CUDA source."""
    import re
    from pathlib import Path

    src = Path(ssd_ops.__file__).parent / "csrc" / "ssd_scan_bwd.cu"
    m = re.search(rf"constexpr int {name} = (\d+);", src.read_text())
    assert m, name
    return int(m.group(1))


@pytest.mark.parametrize("name", ["dprev", "dx", "dc"])
@pytest.mark.parametrize("n", [64, 128])
def test_ssd_backward_shared_memory_fits_two_blocks_an_sm(name, n):
    """ops' mirror of the backward's shared memory (the card test holds it to
    the CUDA source's own figure) per tensor pass and d_state: within the
    227 KB a block may have, and small enough that the design's 2 blocks of
    8 warps (16 warps of tensor work) fit an SM's 228 KB; the threads, stage
    positions and stages it counts with are the source's."""
    assert ssd_ops.BWD_THREADS == _source_constant("kThreads")
    assert ssd_ops.BWD_STEP == _source_constant("kS")
    assert ssd_ops.BWD_STAGES == _source_constant("kStages") >= 2
    smem = ssd_ops.bwd_smem_bytes(name, n)
    assert smem <= ssd_ops.BLOCK_SMEM
    assert ssd_ops.bwd_blocks_per_sm(name, n) >= ssd_ops.BWD_BLOCKS_PER_SM
    assert ssd_ops.BWD_BLOCKS_PER_SM * ssd_ops.BWD_THREADS // 32 >= 16
