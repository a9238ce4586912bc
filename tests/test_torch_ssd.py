"""The port's SSD chunk scan (``repro_torch.kernels.ssd_scan.ops.ssd``) on CPU
tensors, i.e. its plain version, against the JAX package's Pallas ``ssd``
(interpret mode on the CPU) and its jnp ``ssd_chunked``, on the same inputs
made with numpy.  The port takes B and C in their group layout; JAX is given
them repeated to the heads.

The kernel runs as five passes over scratch in its own layouts; their plain
versions (``ref.ssd_*_ref``, run by ``ops.run_pass`` on CPU tensors) are held
composed against ``ssd_ref`` and both JAX functions, which checks the
layouts and the seeding of the state pass.

Tolerances (``_maxerr``: max error over max(1, max |ref|)), as the JAX
package's own kernel tests use: 1e-4 in fp32, 5e-2 with bf16 inputs."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd_scan import ssd as jax_ssd
from repro.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ref import ssd_ref

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _maxerr(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = max(1.0, float(np.abs(b).max()))
    return float(np.abs(a - b).max()) / scale


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(seed, b, s, h, p, g, n):
    """x, dA (< 0, as the model makes it), B and C in the group layout."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    da = -np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    bg = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    cg = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    return x, da, bg, cg


def _jax(arr, dtype="float32"):
    return jnp.asarray(arr, jnp.float32).astype(JNP[dtype])


def _torch(arr, dtype="float32"):
    return torch.from_numpy(np.asarray(arr, np.float32)).to(TORCH[dtype])


# the sizes of the JAX package's own kernel test (b, chunks, h, p, n, chunk)
@pytest.mark.parametrize(
    "b,nc,h,p,n,chunk,dtype",
    [
        (1, 1, 1, 32, 16, 16, "float32"),
        (2, 4, 4, 64, 64, 16, "float32"),
        (1, 2, 4, 32, 64, 64, "float32"),
        (2, 3, 1, 64, 16, 64, "bfloat16"),
        (1, 4, 4, 32, 16, 16, "bfloat16"),
    ],
)
def test_ssd_matches_pallas_kernel_and_ssd_chunked(b, nc, h, p, n, chunk, dtype):
    s = nc * chunk
    x, da, bg, cg = _inputs(s + h + p, b, s, h, p, 1, n)
    bh, ch = np.repeat(bg, h, axis=2), np.repeat(cg, h, axis=2)
    y, st = ssd(_torch(x, dtype), _torch(da), _torch(bg, dtype), _torch(cg, dtype), chunk)
    assert y.dtype == TORCH[dtype] and y.shape == (b, s, h, p)
    assert st.dtype == torch.float32 and st.shape == (b, h, p, n)
    yk, stk = jax_ssd(_jax(x, dtype), _jax(da), _jax(bh, dtype), _jax(ch, dtype), chunk=chunk)
    yr, str_ = ssd_chunked(
        _jax(_f32(_jax(x, dtype))), _jax(da), _jax(_f32(_jax(bh, dtype))),
        _jax(_f32(_jax(ch, dtype))), chunk,
    )
    for ref_y, ref_st in ((yk, stk), (yr, str_)):
        assert _maxerr(_f32(y), _f32(ref_y)) < TOL[dtype]
        assert _maxerr(_f32(st), _f32(ref_st)) < TOL[dtype]


def _through_passes(x, dA, B, C, chunk, initial_state=None):
    """y and the final state from the plain versions of the kernel's five
    passes, each reading what the passes before it wrote."""
    ws = ssd_ops.workspace(x, dA, B, C, chunk, initial_state)
    ws.cb.fill_(float("nan"))  # above the diagonal no pass may read C B^T
    for name in ssd_ops.PASSES:
        ssd_ops.run_pass(ws, name)
    return ws.y, ws.final


# the five sizes above (G 1, no initial state), then an initial state, then G 2
@pytest.mark.parametrize(
    "b,nc,h,p,n,chunk,dtype,g,init",
    [
        (1, 1, 1, 32, 16, 16, "float32", 1, False),
        (2, 4, 4, 64, 64, 16, "float32", 1, False),
        (1, 2, 4, 32, 64, 64, "float32", 1, False),
        (2, 3, 1, 64, 16, 64, "bfloat16", 1, False),
        (1, 4, 4, 32, 16, 16, "bfloat16", 1, False),
        (2, 3, 2, 32, 32, 32, "float32", 1, True),
        (2, 2, 4, 32, 16, 32, "float32", 2, False),
    ],
)
def test_passes_compose_to_ssd_ref_pallas_kernel_and_ssd_chunked(b, nc, h, p, n, chunk, dtype, g,
                                                                 init):
    s = nc * chunk
    x, da, bg, cg = _inputs(s + h + p + g, b, s, h, p, g, n)
    st0 = np.random.default_rng(s).standard_normal((b, h, p, n)).astype(np.float32) if init else None
    st0_t = _torch(st0) if init else None
    xt, bt, ct = _torch(x, dtype), _torch(bg, dtype), _torch(cg, dtype)
    y, st = _through_passes(xt, _torch(da), bt, ct, chunk, st0_t)
    assert y.dtype == TORCH[dtype] and y.shape == (b, s, h, p)
    assert st.dtype == torch.float32 and st.shape == (b, h, p, n)
    yr, str_ = ssd_ref(xt, _torch(da), bt, ct, chunk, st0_t)
    assert _maxerr(_f32(y), _f32(yr)) < TOL[dtype]
    assert _maxerr(_f32(st), _f32(str_)) < TOL[dtype]
    bh, ch = np.repeat(bg, h // g, axis=2), np.repeat(cg, h // g, axis=2)
    init_j = _jax(st0) if init else None
    yk, stk = jax_ssd(_jax(x, dtype), _jax(da), _jax(bh, dtype), _jax(ch, dtype), chunk=chunk,
                      initial_state=init_j)
    yc, stc = ssd_chunked(
        _jax(_f32(_jax(x, dtype))), _jax(da), _jax(_f32(_jax(bh, dtype))),
        _jax(_f32(_jax(ch, dtype))), chunk, initial_state=init_j,
    )
    for ref_y, ref_st in ((yk, stk), (yc, stc)):
        assert _maxerr(_f32(y), _f32(ref_y)) < TOL[dtype]
        assert _maxerr(_f32(st), _f32(ref_st)) < TOL[dtype]


def test_pass_names_are_checked():
    x, da, bg, cg = _inputs(4, 1, 32, 2, 16, 1, 16)
    ws = ssd_ops.workspace(_torch(x), _torch(da), _torch(bg), _torch(cg), 16)
    assert ws.cb.shape == (1, 2, 1, 16, 16) and ws.cum.shape == (1, 2, 2, 16)
    with pytest.raises(ValueError, match="no pass"):
        ssd_ops.run_pass(ws, "scan")
    with pytest.raises(ValueError, match="no pass"):
        ssd_ops.plain_pass(ws, "scan")


def test_group_layout_matches_repeated_heads():
    """G 2 over 4 heads: head h reads group h // 2, as jnp.repeat lays it."""
    b, s, h, p, g, n, chunk = 2, 64, 4, 32, 2, 16, 32
    x, da, bg, cg = _inputs(3, b, s, h, p, g, n)
    y, st = ssd(_torch(x), _torch(da), _torch(bg), _torch(cg), chunk)
    yr, str_ = ssd_chunked(
        _jax(x), _jax(da), _jax(np.repeat(bg, 2, axis=2)), _jax(np.repeat(cg, 2, axis=2)), chunk
    )
    assert _maxerr(_f32(y), _f32(yr)) < TOL["float32"]
    assert _maxerr(_f32(st), _f32(str_)) < TOL["float32"]


def test_initial_state_continuity():
    """Two halves with the first half's final state passed on equal the
    whole sequence (the invariant decode relies on), and a nonzero initial
    state matches JAX's ``ssd`` given the same one."""
    b, s, h, p, n, chunk = 1, 128, 2, 32, 32, 32
    x, da, bg, cg = _inputs(9, b, s, h, p, 1, n)
    xt, dat, bt, ct = _torch(x), _torch(da), _torch(bg), _torch(cg)
    y_full, st_full = ssd(xt, dat, bt, ct, chunk)
    half = s // 2
    y1, st1 = ssd(xt[:, :half], dat[:, :half], bt[:, :half], ct[:, :half], chunk)
    y2, st2 = ssd(xt[:, half:], dat[:, half:], bt[:, half:], ct[:, half:], chunk, initial_state=st1)
    assert _maxerr(torch.cat([y1, y2], dim=1).numpy(), y_full.numpy()) < 1e-4
    assert _maxerr(st2.numpy(), st_full.numpy()) < 1e-4

    init = np.random.default_rng(1).standard_normal((b, h, p, n)).astype(np.float32)
    y, st = ssd(xt, dat, bt, ct, chunk, initial_state=_torch(init))
    bh, ch = np.repeat(bg, h, axis=2), np.repeat(cg, h, axis=2)
    yr, str_ = jax_ssd(_jax(x), _jax(da), _jax(bh), _jax(ch), chunk=chunk, initial_state=_jax(init))
    assert _maxerr(_f32(y), _f32(yr)) < 1e-4
    assert _maxerr(_f32(st), _f32(str_)) < 1e-4


def test_full_chunk_with_model_decay_stays_finite():
    """Over a 256-position chunk cum reaches about -200, so exp(cum)
    underflows to 0 and exp(cum_i - cum_j) above the diagonal would overflow;
    the result stays finite and equal to JAX's."""
    b, s, h, p, n, chunk = 1, 512, 2, 64, 128, 256
    x, da, bg, cg = _inputs(5, b, s, h, p, 1, n)
    assert da.reshape(b, 2, chunk, h).sum(axis=2).max() < -150
    y, st = ssd(_torch(x), _torch(da), _torch(bg), _torch(cg), chunk)
    assert bool(y.isfinite().all()) and bool(st.isfinite().all())
    yr, str_ = ssd_chunked(
        _jax(x), _jax(da), _jax(np.repeat(bg, h, axis=2)), _jax(np.repeat(cg, h, axis=2)), chunk
    )
    assert _maxerr(_f32(y), _f32(yr)) < 1e-4
    assert _maxerr(_f32(st), _f32(str_)) < 1e-4


def test_chunk_rule_and_shape_errors():
    """q = min(chunk, S) must divide S, as in the JAX wrapper; S < chunk runs
    as one chunk."""
    x, da, bg, cg = _inputs(2, 1, 48, 2, 16, 1, 16)
    xt, dat, bt, ct = _torch(x), _torch(da), _torch(bg), _torch(cg)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd(xt, dat, bt, ct, chunk=32)
    y, _ = ssd(xt, dat, bt, ct, chunk=64)  # one chunk of 48
    yr, _ = ssd_chunked(
        _jax(x), _jax(da), _jax(np.repeat(bg, 2, axis=2)), _jax(np.repeat(cg, 2, axis=2)), 48
    )
    assert _maxerr(_f32(y), _f32(yr)) < 1e-4
    with pytest.raises(ValueError, match="dA"):
        ssd(xt, dat[:, :-1], bt, ct, chunk=16)
    with pytest.raises(ValueError, match="groups"):
        ssd(xt[:, :, :1].expand(1, 48, 3, 16), dat[:, :, :1].expand(1, 48, 3),
            bt.expand(1, 48, 2, 16), ct.expand(1, 48, 2, 16), chunk=16)
    with pytest.raises(ValueError, match="initial_state"):
        ssd(xt, dat, bt, ct, chunk=16, initial_state=torch.zeros(1, 2, 16, 8))


def test_unknown_device_raises():
    # meta tensors have a branch (the dry run's): fake tensors on a device
    # with no kernel stand in for an unknown one
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(), pytest.raises(ValueError, match="no kernel"):
        ssd(torch.empty(1, 16, 2, 16, device="ipu"), torch.empty(1, 16, 2, device="ipu"),
            torch.empty(1, 16, 1, 16, device="ipu"), torch.empty(1, 16, 1, 16, device="ipu"),
            chunk=16)
