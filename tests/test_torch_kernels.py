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


PTXAS_LOG = """ptxas info    : Compiling entry function '_Z6kernelILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi64EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z6kernelILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi128EEvv
    48 bytes stack frame, 48 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 48 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z4flatv' for 'sm_90a'
ptxas info    : Function properties for _Z4flatv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers
"""


@pytest.mark.parametrize("fn,want", [
    ("_Z6kernelILi64EEvv", (128, 0, 0)),
    ("_Z6kernelILi128EEvv", (128, 48, 40)),
    ("_Z4flatv", (30, 0, 0)),
])
def test_ptxas_report_reads_registers_and_spills(fn, want):
    """The build log's ptxas report, kernel by kernel, as the spill checks
    of chip_smoke.py and the card tests read it."""
    from repro_torch.kernels import build

    report = build.ptxas_report(PTXAS_LOG)
    assert len(report) == 3
    assert report[fn] == want


def _c_struct_fields(src: str, name: str):
    """The field names of ``struct <name> { ... };`` in a C source, in order
    (comma-separated declarators and array extents included)."""
    import re

    body = src.split(f"struct {name} {{", 1)[1].split("};", 1)[0]
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        decl = re.sub(r"\[\d+\]", "", decl)
        first, *rest = (part.strip() for part in decl.split(","))
        fields += [first.split()[-1].lstrip("*")] + [r.lstrip("*") for r in rest]
    return fields


@pytest.mark.parametrize("kernel,package,struct", [
    ("flash_attention", "flash_attention", "FlashArgs"),
    ("ssd_scan", "ssd_scan", "SsdArgs"),
    ("ssd_scan_bwd", "ssd_scan", "SsdBwdArgs"),
])
def test_ctypes_args_mirror_the_c_struct(kernel, package, struct):
    """The ctypes structure a wrapper passes to a CUDA entry point has the C
    struct's fields in the C struct's order (an added field out of place
    would shift every later one on the card)."""
    import importlib

    from repro_torch.kernels import build

    ops = importlib.import_module(f"repro_torch.kernels.{package}.ops")
    src = (build.KERNELS_DIR / build.SOURCES[kernel]).read_text()
    assert [n for n, _ in getattr(ops, struct)._fields_] == _c_struct_fields(src, struct)


@pytest.mark.parametrize("item", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", [64, 1152, 1536, 2560, 4096, 6144, 8192, 16384])
def test_rmsnorm_backward_pipeline_fits_shared_memory(d, item):
    """The backward's row loop keeps STAGES - 1 tiles of x and dy in shared
    memory: at every width the launch takes as many stages as fit a Hopper
    block (at most BWD_STAGES), so fp32 rows of 6144 (granite-34b's
    d_model), which need 294,944 bytes at 4 stages, run at 3."""
    from repro_torch.kernels.rmsnorm import ops

    stages = ops._bwd_stages(ops.BWD_ROWS, d, item)
    a, bb = ops._blocks(d)
    per_stage = 2 * ops.BWD_ROWS * (a + bb) * item
    assert 1 <= stages <= ops.BWD_STAGES
    assert (stages - 1) * per_stage + 1024 <= ops.SMEM_BYTES
    assert stages == ops.BWD_STAGES or stages * per_stage + 1024 > ops.SMEM_BYTES


def test_rmsnorm_backward_stages_cover_what_triton_asked_for():
    """At fp32 width 6144 and 4 stages Triton asked an H100 for 294,944 bytes
    of shared memory (3 staged tiles of x and dy, 98,304 bytes each, and 32
    more) and the launch was refused: the formula's estimate at 4 stages is
    no smaller than that, and the launch takes 3 stages."""
    from repro_torch.kernels.rmsnorm import ops

    asked_at_4_stages = 294_944
    assert asked_at_4_stages > ops.SMEM_BYTES
    a, bb = ops._blocks(6144)
    per_stage = 2 * ops.BWD_ROWS * (a + bb) * 4
    assert (ops.BWD_STAGES - 1) * per_stage + 1024 >= asked_at_4_stages
    assert ops.BWD_STAGES == 4 and ops._bwd_stages(ops.BWD_ROWS, 6144, 4) == 3
    assert 2 * per_stage + 32 <= ops.SMEM_BYTES  # 3 stages, by Triton's count


# ------------------------------------------- rmsnorm: external statistic
@pytest.mark.parametrize("rows,d,parts", [(8, 64, 2), (6, 2048, 8)])
def test_rmsnorm_external_statistic_is_rmsnorm_both_ways(rows, d, parts):
    """B3a's external-statistic mode, its rows' columns cut into ``parts``
    ranks' shares whose statistics are summed: B3a's forward and backward
    (and with one part and the local statistic, exactly B3a's function),
    and the forward the Pallas kernel's."""
    from repro_torch.kernels.rmsnorm.ref import (rmsnorm_bwd_ref, rmsnorm_ext_bwd_ref,
                                                 rmsnorm_ext_ref, rmsnorm_ref, row_stat_ref)

    rng = np.random.default_rng(rows * d + parts)
    x, xt = _pair(rng.standard_normal((rows, d)) * 3.0, "float32")
    w, wt = _pair(rng.standard_normal((d,)) * 0.1, "float32")
    dyt = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
    n = d // parts
    cols = [slice(i * n, (i + 1) * n) for i in range(parts)]
    ss = sum(row_stat_ref(xt[:, c]) for c in cols)
    c_tot = sum(row_stat_ref(xt[:, c], dyt[:, c], wt[c]) for c in cols)
    out = torch.cat([rmsnorm_ext_ref(xt[:, c], wt[c], ss, d) for c in cols], -1)
    grads = [rmsnorm_ext_bwd_ref(dyt[:, c], xt[:, c], wt[c], ss, c_tot, d) for c in cols]
    dx, dw = torch.cat([g[0] for g in grads], -1), torch.cat([g[1] for g in grads])
    rdx, rdw = rmsnorm_bwd_ref(dyt, xt, wt)
    assert _maxerr(out.numpy(), rmsnorm_ref(xt, wt).numpy()) < 1e-5
    assert _maxerr(out.numpy(), _f32(jax_rmsnorm(x, w))) < TOL["float32"]
    assert _maxerr(dx.numpy(), rdx.numpy()) < 1e-5
    assert _maxerr(dw.numpy(), rdw.numpy()) < 1e-5
    one = rmsnorm_ext_ref(xt, wt, row_stat_ref(xt), d)
    assert _maxerr(one.numpy(), rmsnorm_ref(xt, wt).numpy()) < 1e-6
    # a norm over one rank's columns alone is another function
    alone = torch.cat([rmsnorm_ref(xt[:, c], wt[c]) for c in cols], -1)
    assert _maxerr(alone.numpy(), out.numpy()) > 1e-3


def test_split_rmsnorm_autograd_matches_rmsnorm():
    """``rmsnorm_split`` with one rank (``reduce`` a no-op) is B3a, both
    ways, through autograd."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_split

    g = torch.Generator().manual_seed(3)
    x = (torch.randn(5, 96, generator=g) * 2).requires_grad_(True)
    w = (torch.randn(96, generator=g) * 0.1).requires_grad_(True)
    dy = torch.randn(5, 96, generator=g)
    gx, gw = torch.autograd.grad(rmsnorm_split(x, w, 1e-6, 96, lambda t: None), (x, w), dy)
    x2, w2 = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    rx, rw = torch.autograd.grad(rmsnorm(x2, w2, 1e-6), (x2, w2), dy)
    assert _maxerr(gx.numpy(), rx.numpy()) < 1e-5 and _maxerr(gw.numpy(), rw.numpy()) < 1e-5
