"""The port's kernel wrappers on CPU tensors (their plain versions) against
the JAX package's Pallas kernels in interpret mode, and decode attention on a
wrapped ring against the JAX reference ``gqa_attention``.

Tolerances: ``_maxerr`` (max error over the reference's magnitude) below
1e-4 in fp32 and 2e-2 in bf16 (bf16 keeps 8 significant bits)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.models.attention import gqa_attention as jax_gqa_attention
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _maxerr(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = max(1.0, float(np.abs(b).max()))
    return float(np.abs(a - b).max()) / scale


def _pair(arr, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    j = jnp.asarray(arr, jnp.float32).astype(JNP[dtype])
    t = torch.from_numpy(np.asarray(arr, np.float32)).to(TORCH[dtype])
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------- decode attention
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("sk", [257, 512])
@pytest.mark.parametrize("window", [None, 64])
def test_decode_attention_matches_pallas_kernel(d, g, sk, window):
    """pos < Sk (no wrap): slot j holds position j, which is what the Pallas
    kernel assumes; both must agree."""
    rng = np.random.default_rng(d * 7 + g * 3 + sk + (window or 0))
    b, hkv = 2, 2
    q, qt = _pair(rng.standard_normal((b, 1, hkv * g, d)), "float32")
    k, kt = _pair(rng.standard_normal((b, sk, hkv, d)), "float32")
    v, vt = _pair(rng.standard_normal((b, sk, hkv, d)), "float32")
    pos = np.array([sk - 1, rng.integers(0, sk)], np.int32)
    ref = jax_decode_attention(q, k, v, jnp.asarray(pos), window=window)
    pos_k = torch.arange(sk, dtype=torch.int32)[None].expand(b, sk)
    out = decode_attention(qt, kt, vt, torch.from_numpy(pos), pos_k, window=window)
    assert out.shape == (b, 1, hkv * g, d)
    assert _maxerr(_f32(out), _f32(ref)) < TOL["float32"]


@pytest.mark.parametrize("pos", [5, 21])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_on_ring_matches_gqa_reference(pos, window, dtype):
    """An 8-slot ring: at pos 5 slots 6-7 were never written, at pos 21 the
    ring has wrapped twice and slot j holds pos - ((pos - j) mod 8)."""
    rng = np.random.default_rng(pos * 10 + (window or 0))
    b, s_cache, hkv, g, d = 2, 8, 1, 4, 64
    q, qt = _pair(rng.standard_normal((b, 1, hkv * g, d)), dtype)
    k, kt = _pair(rng.standard_normal((b, s_cache, hkv, d)), dtype)
    v, vt = _pair(rng.standard_normal((b, s_cache, hkv, d)), dtype)
    slots = np.arange(s_cache)
    pos_k = np.broadcast_to(pos - np.mod(pos - slots, s_cache), (b, s_cache)).astype(np.int32)
    pos_q = np.full((b, 1), pos, np.int32)
    ref = jax_gqa_attention(
        q, k, v, jnp.asarray(pos_q), jnp.asarray(pos_k),
        causal=True, window=window, kv_valid=jnp.asarray(pos_k >= 0),
    )
    out = decode_attention(
        qt, kt, vt, torch.from_numpy(pos_q[:, 0].copy()), torch.from_numpy(pos_k.copy()),
        window=window,
    )
    assert out.dtype == TORCH[dtype]
    assert _maxerr(_f32(out), _f32(ref)) < TOL[dtype]


def test_decode_attention_rejects_bad_shapes():
    q = torch.zeros(2, 1, 4, 64)
    k = torch.zeros(2, 8, 1, 64)
    pos_q = torch.zeros(2, dtype=torch.int32)
    pos_k = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        decode_attention(torch.zeros(2, 2, 4, 64), k, k, pos_q, pos_k)
    with pytest.raises(ValueError):
        decode_attention(q, k, k, pos_q, pos_k[:, :4])
    with pytest.raises(ValueError):
        decode_attention(q, k, k, pos_q, pos_k, window=0)


# ---------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("rows,d", [(8, 64), (6, 1152)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_rmsnorm_matches_pallas_kernel(rows, d, dtype, with_residual):
    """B3a and B3b against the Pallas kernel itself (not its residual oracle,
    which normalizes the sum after rounding it)."""
    rng = np.random.default_rng(rows * d)
    x, xt = _pair(rng.standard_normal((rows, d)) * 3.0, dtype)
    w, wt = _pair(rng.standard_normal((d,)) * 0.1, dtype)
    if with_residual:
        r, rt = _pair(rng.standard_normal((rows, d)), dtype)
        ref, ref_sum = jax_rmsnorm(x, w, residual=r)
        out, out_sum = rmsnorm(xt, wt, residual=rt)
        assert out_sum.dtype == TORCH[dtype]
        assert _maxerr(_f32(out_sum), _f32(ref_sum)) < TOL[dtype]
    else:
        ref = jax_rmsnorm(x, w)
        out = rmsnorm(xt, wt)
    assert out.dtype == TORCH[dtype] and out.shape == (rows, d)
    assert _maxerr(_f32(out), _f32(ref)) < TOL[dtype]


def test_rmsnorm_rejects_bad_shapes():
    with pytest.raises(ValueError):
        rmsnorm(torch.zeros(2, 8), torch.zeros(4))
    with pytest.raises(ValueError):
        rmsnorm(torch.zeros(2, 8), torch.zeros(8), residual=torch.zeros(3, 8))


def test_library_path_hashes_every_file_under_csrc(tmp_path, monkeypatch):
    """A header added or edited beside a source under ``csrc/`` names a new
    library, so the next load rebuilds."""
    import shutil

    from repro_torch.kernels import build

    src = build.KERNELS_DIR / build.SOURCES["flash_attention"]
    csrc = tmp_path / src.relative_to(build.KERNELS_DIR).parent
    csrc.mkdir(parents=True)
    shutil.copy(src, csrc / src.name)
    monkeypatch.setattr(build, "KERNELS_DIR", tmp_path)
    alone = build.library_path("flash_attention")
    assert alone == build.library_path("flash_attention")
    (csrc / "tiles.cuh").write_text("#pragma once\n")
    with_header = build.library_path("flash_attention")
    (csrc / "tiles.cuh").write_text("#pragma once\nconstexpr int kTile = 64;\n")
    edited = build.library_path("flash_attention")
    assert len({alone, with_header, edited}) == 3
    assert all(p.parent == build.BUILD_DIR for p in (alone, with_header, edited))


def test_build_passes_csrc_as_include_dir(tmp_path, monkeypatch):
    """nvcc is given ``-I`` the source's ``csrc/``, so that its headers are
    found (nvcc itself is not run here)."""
    import subprocess

    from repro_torch.kernels import build

    seen = {}

    def fake_run(cmd, **kw):
        seen["cmd"] = cmd
        return subprocess.CompletedProcess(cmd, 1, stdout="refused")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    with pytest.raises(build.KernelBuildError):
        build._build("flash_attention")
    cmd = seen["cmd"]
    csrc = (build.KERNELS_DIR / build.SOURCES["flash_attention"]).parent
    assert cmd[cmd.index("-I") + 1] == str(csrc)
