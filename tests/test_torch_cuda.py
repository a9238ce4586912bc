"""The port's kernels on the card against their plain versions, at shapes
and dtypes beyond the serving path's (other head dims and groups, fp32,
strided caches, a partly filled ring).  Marked ``gpu``: they skip without
CUDA and run on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py -q

Tolerances: fp32 outputs within 1e-4 relative + 1e-5 absolute; bf16 outputs
within one bf16 ulp (2^-7 relative) + 1e-5, since both sides accumulate in
fp32 and round once."""

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, dtype):
    rtol = 2.0**-7 if dtype == torch.bfloat16 else 1e-4
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= 1e-5 + rtol * ref.float().abs()).all()), diff.max().item()


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(cuda, d, g, dtype):
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    gen = torch.Generator(device=cuda).manual_seed(d + g)
    b, hkv, sk = 3, 2, 77  # a ragged edge: 77 is no multiple of the split
    # a stacked cache sliced per layer, as the model holds it
    k_all = torch.randn(2, b, sk, hkv, d, generator=gen, device=cuda).to(dtype)
    v_all = torch.randn(2, b, sk, hkv, d, generator=gen, device=cuda).to(dtype)
    k, v = k_all[1], v_all[1]
    q = torch.randn(b, 1, hkv * g, d, generator=gen, device=cuda).to(dtype)
    pos = torch.tensor([3, 76, 200], device=cuda, dtype=torch.int32)
    slots = torch.arange(sk, device=cuda, dtype=torch.int32)
    # per-row ring positions: row 0 partly filled, row 2 wrapped
    pos_k = pos[:, None] - torch.remainder(pos[:, None] - slots[None], sk)
    for window in (None, 40):
        before = ops.decode_attention.launches
        out = ops.decode_attention(q, k, v, pos, pos_k, window=window)
        ref = decode_attention_ref(q[:, 0], k, v, pos, pos_k, window=window)[:, None]
        torch.cuda.synchronize()
        assert ops.decode_attention.launches == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        _close(out, ref, dtype)


def test_decode_kernel_rejects_what_it_has_no_instance_for(cuda):
    from repro_torch.kernels.decode_attention import ops

    q = torch.zeros(1, 1, 3, 80, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 1, 80, device=cuda, dtype=torch.bfloat16)
    pos_q = torch.zeros(1, device=cuda, dtype=torch.int32)
    pos_k = torch.zeros(1, 8, device=cuda, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        ops.decode_attention(q, k, k, pos_q, pos_k)
    with pytest.raises(TypeError):
        ops.decode_attention(q, k, k, pos_q.long(), pos_k)


@pytest.mark.parametrize("rows,d", [(1, 64), (5, 1152), (33, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_residual", [False, True])
def test_rmsnorm_kernel_matches_plain(cuda, rows, d, dtype, with_residual):
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref, rmsnorm_residual_ref

    gen = torch.Generator(device=cuda).manual_seed(rows * d)
    x = (torch.randn(2, rows, d, generator=gen, device=cuda) * 3).to(dtype)
    r = torch.randn(2, rows, d, generator=gen, device=cuda).to(dtype)
    w = (torch.randn(d, generator=gen, device=cuda) * 0.1).to(dtype)
    before = (ops.rmsnorm.launches, ops.rmsnorm.residual_launches)
    if with_residual:
        out, s = ops.rmsnorm(x, w, residual=r)
        ref, ref_s = rmsnorm_residual_ref(x, r, w)
        _close(s, ref_s, dtype)
    else:
        out = ops.rmsnorm(x, w)
        ref = rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    after = (ops.rmsnorm.launches, ops.rmsnorm.residual_launches)
    assert after == (before[0] + (not with_residual), before[1] + with_residual)
    assert out.dtype == dtype and out.shape == x.shape
    _close(out, ref, dtype)


def test_rmsnorm_kernel_rejects_strided_rows(cuda):
    from repro_torch.kernels.rmsnorm import ops

    x = torch.zeros(4, 2, 64, device=cuda)[:, 0]
    with pytest.raises(ValueError, match="contiguous"):
        ops.rmsnorm(x, torch.zeros(64, device=cuda))
