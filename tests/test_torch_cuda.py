"""The port's kernels on the card against their plain versions, at shapes
and dtypes beyond the serving path's (other head dims and groups, fp32,
strided caches, a partly filled ring).  Marked ``gpu``: they skip without
CUDA and run on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py -q

Tolerances: fp32 outputs within 1e-4 relative + 1e-5 absolute; bf16 outputs
within one bf16 ulp (2^-7 relative) + 1e-5, since both sides accumulate in
fp32 and round once.  bf16 flash attention runs on the tensor cores and
rounds P and dS to bf16 inside, so its out, dq, dk and dv are held against
the fp32 plain version by ``ref.rounding_ratios``: row by row and in the
mean, within twice the error of the fp32 plain version that rounds at the
same points (``p_dtype=torch.bfloat16``, the kernel's key tile); its lse
keeps 1e-4.  Gradients (flash attention dq/dk/dv, rmsnorm dx and
d(scale)) and the SSD scan's y and state are sums over many rows whose order
differs between the kernel and the plain version, so their absolute term is
1e-5 times the largest |value| of the tensor (at least 1e-5) instead."""

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


# (label, B, Hkv, G, D, Sk, query position, the split plan on a 132-SM H100)
DECODE_PLANS = [
    ("n_split 1, two position windows", 5, 32, 1, 64, 1500, 1700, (1, 1500)),
    ("largest cluster, empty splits", 1, 1, 4, 256, 1024, 543, (16, 64)),
    ("Sk no multiple of split_len", 2, 1, 8, 128, 1000, 1333, (16, 63)),
]


@pytest.mark.parametrize("case", DECODE_PLANS, ids=[c[0] for c in DECODE_PLANS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_split_plans(cuda, case, dtype):
    """One cluster per (batch, kv head) at the plan's extremes, over a ring
    cache whose slot positions are one row broadcast (batch stride 0); with
    more than one row, the last one's query position precedes every slot,
    so it keeps nothing and gives 0."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    _, b, hkv, g, d, sk, p, plan = case
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if sms == 132:
        assert ops.split_plan(b, hkv, sk, sms) == plan
    n_split, _ = ops.split_plan(b, hkv, sk, sms)
    assert ops.occupancy(dtype, d, g, n_split)[0] >= 1
    gen = torch.Generator(device=cuda).manual_seed(sk + g)
    q = torch.randn(b, 1, hkv * g, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=gen, device=cuda).to(dtype)
    slots = torch.arange(sk, device=cuda, dtype=torch.int32)
    pos_k = (p - torch.remainder(p - slots, sk))[None].expand(b, sk)
    pos = torch.full((b,), p, device=cuda, dtype=torch.int32)
    if b > 1:
        pos[-1] = -1
    for window in (None, sk // 2):
        before = ops.decode_attention.launches
        out = ops.decode_attention(q, k, v, pos, pos_k, window=window)
        ref = decode_attention_ref(q[:, 0], k, v, pos, pos_k, window=window)[:, None]
        torch.cuda.synchronize()
        assert ops.decode_attention.launches == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        _close(out, ref, dtype)
        if b > 1:
            assert bool((out[-1] == 0).all())


def test_decode_kernel_is_one_device_kernel(cuda):
    """A call launches one kernel and nothing else: no scratch, no merge."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attention import ops

    b, sk, hkv, g, d = 4, 1024, 1, 4, 256
    q = torch.randn(b, 1, hkv * g, d, device=cuda, dtype=torch.bfloat16)
    k = torch.randn(b, sk, hkv, d, device=cuda, dtype=torch.bfloat16)
    pos_q = torch.full((b,), 543, device=cuda, dtype=torch.int32)
    pos_k = torch.arange(sk, device=cuda, dtype=torch.int32)[None].expand(b, sk)
    ops.decode_attention(q, k, k, pos_q, pos_k)  # build and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.decode_attention(q, k, k, pos_q, pos_k)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "decode_attention_kernel" in names[0], names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernels_at_train_width_with_a_ragged_tile(cuda, dtype):
    """The training width, forward and backward, with a row count that is no
    multiple of a program's tile of rows."""
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

    rows, d = 16383, 2560  # odd: no multiple of any tile of 2 or more rows
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ops._fwd_launch(rows, d, sms)[0] > 1
    gen = torch.Generator(device=cuda).manual_seed(rows)
    x = (torch.randn(rows, d, generator=gen, device=cuda) * 3).to(dtype)
    w = (torch.randn(d, generator=gen, device=cuda) * 0.1).to(dtype)
    dy = torch.randn(rows, d, generator=gen, device=cuda).to(dtype)
    before = (ops.rmsnorm.launches, ops.rmsnorm.backward_launches)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = ops.rmsnorm(xg, wg)
    dx, dw = torch.autograd.grad(out, (xg, wg), dy)
    torch.cuda.synchronize()
    assert (ops.rmsnorm.launches, ops.rmsnorm.backward_launches) == (before[0] + 1, before[1] + 1)
    _close(out, rmsnorm_ref(x, w), dtype)
    dx_ref, dw_ref = rmsnorm_bwd_ref(dy, x, w)
    _close_grad(dx, dx_ref, dtype)
    _close_grad(dw, dw_ref, dtype)


@pytest.mark.parametrize("rows,d", [(1, 64), (5, 1152), (7, 1024), (1022, 2048), (33, 4096)])
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


def _close_grad(out, ref, dtype):
    rtol = 2.0**-7 if dtype == torch.bfloat16 else 1e-4
    atol = 1e-5 * max(1.0, ref.float().abs().max().item())
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= atol + rtol * ref.float().abs()).all()), diff.max().item()


# windows 24 and 130 are no multiple of the kernels' 64- or 32-key tiles
FLASH_MASKS = [(True, None), (True, 24), (True, 130), (False, None), (False, 24), (False, 130)]


def _close_rounded(out, ref, ref_p):
    """bf16 flash attention rounds P (and dS) to bf16 as tensor-core
    operands: ``rounding_ratios`` against the fp32 plain version ``ref`` and
    the fp32 plain version ``ref_p`` that rounds where the kernel does, both
    at most 1."""
    from repro_torch.kernels.flash_attention.ref import rounding_ratios

    assert bool(out.float().isfinite().all())
    row, mean = rounding_ratios(out, ref, ref_p)
    assert row <= 1 and mean <= 1, (row, mean)


def _flash_inputs(cuda, d, g, dtype, seed, b=2, s=77, hkv=2, sq=None):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if sq is not None:  # queries and keys of different lengths: separate tensors
        q = torch.randn(b, sq, hkv * g, d, generator=gen, device=cuda).to(dtype)
        k, v = (torch.randn(b, s, hkv, d, generator=gen, device=cuda).to(dtype) for _ in "kv")
        return q, k, v
    # q, k, v sliced out of one fused projection, as strided views
    qkv = torch.randn(b, s, hkv * (g + 2), d, generator=gen, device=cuda).to(dtype)
    q, k, v = qkv.split([hkv * g, hkv, hkv], dim=2)
    return q, k, v


def _check_flash(q, k, v, masks):
    """Forward (out, lse) and backward (dq, dk, dv) through the autograd
    Function against the plain versions, launches counted."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
        flash_attention_ref,
        kernel_key_tile,
    )

    dtype = q.dtype
    dout = torch.randn(q.shape, device=q.device).to(dtype)
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, dout))  # the same values in fp32
    for causal, window in masks:
        before = (ops.flash_attention.launches, ops.flash_attention.backward_launches)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = ops.flash_attention(qg, kg, vg, causal=causal, window=window)
        dq, dk, dv = torch.autograd.grad(out, (qg, kg, vg), dout)
        kw = dict(causal=causal, window=window)
        ref, lse_ref = flash_attention_ref(q32, k32, v32, **kw)
        _, lse = ops.flash_attention_fwd(q, k, v, causal, window)
        o32 = out.detach().float()
        grads_ref = flash_attention_bwd_ref(q32, k32, v32, o32, lse, do32, **kw)
        torch.cuda.synchronize()
        assert (ops.flash_attention.launches, ops.flash_attention.backward_launches) == (
            before[0] + 2, before[1] + 1)
        assert out.dtype == dtype and out.shape == q.shape
        # a row with no key in its mask has lse -inf on both sides
        empty = lse_ref == float("-inf")
        assert torch.equal(lse == float("-inf"), empty)
        _close(lse[~empty], lse_ref[~empty], torch.float32)
        if dtype == torch.bfloat16:
            kw_p = dict(kw, p_dtype=torch.bfloat16, block_k=kernel_key_tile(q.shape[-1]))
            ref_p, _ = flash_attention_ref(q32, k32, v32, **kw_p)
            grads_p = flash_attention_bwd_ref(q32, k32, v32, o32, lse, do32, **kw_p)
            _close_rounded(out, ref, ref_p)
        else:
            _close(out, ref, dtype)
        for i, (got, want) in enumerate(zip((dq, dk, dv), grads_ref)):
            assert got.dtype == dtype and got.shape == want.shape
            if dtype == torch.bfloat16:
                _close_rounded(got, want, grads_p[i])
            else:
                _close_grad(got, want, dtype)


@pytest.mark.parametrize("s", [77, 333])
@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(cuda, s, d, g, dtype):
    """Forward (out, lse) and backward (dq, dk, dv) at S 77 and 333 (ragged
    last tiles, several 128-row and 64-key tiles), q/k/v as strided views of
    one fused projection, every mask."""
    q, k, v = _flash_inputs(cuda, d, g, dtype, seed=s + d + g)
    _check_flash(q, k, v, FLASH_MASKS)


@pytest.mark.parametrize("sq,sk", [(1, 1), (1, 77), (77, 20), (50, 90)])
@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain_sq_not_sk(cuda, sq, sk, d, dtype):
    """Queries and keys of other lengths: one causal query (Sq 1), and with a
    window of 24 under no causal mask, Sq 77 over Sk 20 leaves rows 43.. with
    no key (output 0, lse -inf, no gradient)."""
    q, k, v = _flash_inputs(cuda, d, 4, dtype, seed=sq + sk + d, s=sk, sq=sq)
    _check_flash(q, k, v, [(True, None), (False, 24)])


def test_flash_kernel_rejects_what_it_has_no_instance_for(cuda):
    from repro_torch.kernels.flash_attention import ops

    q = torch.zeros(1, 8, 3, 48, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 1, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, k, k)
    with pytest.raises(TypeError):
        ops.flash_attention(q[..., :32].half(), k[..., :32].half(), k[..., :32].half())


@pytest.mark.parametrize("rows,d", [(1, 64), (300, 1152), (4100, 2560)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_kernel_matches_plain(cuda, rows, d, dtype):
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref

    gen = torch.Generator(device=cuda).manual_seed(rows + d)
    x = (torch.randn(rows, d, generator=gen, device=cuda) * 3).to(dtype)
    w = (torch.randn(d, generator=gen, device=cuda) * 0.1).to(dtype)
    dy = torch.randn(rows, d, generator=gen, device=cuda).to(dtype)
    before = ops.rmsnorm.backward_launches
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    dx, dw = torch.autograd.grad(ops.rmsnorm(xg, wg), (xg, wg), dy)
    dx_ref, dw_ref = rmsnorm_bwd_ref(dy, x, w)
    torch.cuda.synchronize()
    assert ops.rmsnorm.backward_launches == before + 1
    assert dx.dtype == dtype and dw.dtype == dtype
    _close_grad(dx, dx_ref, dtype)
    _close_grad(dw, dw_ref, dtype)


def test_train_step_on_card_runs_no_plain_version(cuda, monkeypatch):
    """A smoke-size h2o-danube train step and eval on the card with every
    plain version made to raise: attention and norms, forward and backward,
    go through the kernels, and the launch counters say how often."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.models import build_model
    from repro_torch.optim import init_adamw
    from repro_torch.training import make_eval_step, make_train_step

    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((fa_ops, "flash_attention_ref"), (fa_ops, "flash_attention_bwd_ref"),
                      (norm_ops, "rmsnorm_ref"), (norm_ops, "rmsnorm_bwd_ref"),
                      (norm_ops, "rmsnorm_residual_ref")):
        monkeypatch.setattr(mod, name, boom)
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b-smoke"), head_dim=64, n_layers=3,
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    api = build_model(cfg, device=cuda)
    params = api.init(seed=0)
    opt = init_adamw(params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 80), device=cuda)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    fa_ops.flash_attention.launches = fa_ops.flash_attention.backward_launches = 0
    norm_ops.rmsnorm.launches = norm_ops.rmsnorm.backward_launches = 0
    ev = make_eval_step(api)(params, batch)
    params, opt, m = make_train_step(api, warmup_steps=1)(params, opt, batch)
    torch.cuda.synchronize()
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert abs(m["loss"].item() - ev["loss"].item()) < 1e-2 * max(1.0, ev["loss"].item())
    n = cfg.n_layers
    # eval: n forward; step: n forward, n recomputed, n backward
    assert fa_ops.flash_attention.launches == 3 * n
    assert fa_ops.flash_attention.backward_launches == n
    # eval: 2n+1; step: 2n+1 forward, 2n recomputed, 2n+1 backward
    assert norm_ops.rmsnorm.launches == 3 * (2 * n + 1) - 1
    assert norm_ops.rmsnorm.backward_launches == 2 * n + 1


# SSD chunk scan: (B, S, H, P, N, G, dtype, initial state) -- chip_smoke's
# phase 3 shapes (the mamba2-370m prefill and the two models' forwards) and
# its edge cases: S < chunk, G 2, an initial state, bf16 inputs, and an
# initial state carried across the prefill's 128 chunks
SSD_CASES = [
    (1, 32768, 32, 64, 128, 1, torch.float32, False),
    (4, 512, 32, 64, 128, 1, torch.float32, False),
    (4, 512, 64, 64, 64, 1, torch.float32, False),
    (2, 100, 8, 64, 128, 1, torch.float32, False),
    (2, 512, 8, 64, 64, 2, torch.float32, False),
    (2, 512, 8, 64, 128, 1, torch.float32, True),
    (2, 512, 8, 64, 128, 1, torch.bfloat16, False),
    (1, 32768, 4, 64, 128, 1, torch.float32, True),
]


def _ssd_inputs(cuda, b, s, h, p, n, g, dtype, init):
    import torch.nn.functional as F

    gen = torch.Generator(device=cuda).manual_seed(s + h + n + g)
    x = torch.randn(b, s, h, p, generator=gen, device=cuda).to(dtype)
    dA = -F.softplus(torch.randn(b, s, h, generator=gen, device=cuda))
    # B and C as strided views of one [B, S, 2GN] tensor, as the model has them
    bc = (torch.randn(b, s, 2 * g * n, generator=gen, device=cuda) * 0.5).to(dtype)
    B_, C_ = bc[..., : g * n].view(b, s, g, n), bc[..., g * n :].view(b, s, g, n)
    state = torch.randn(b, h, p, n, generator=gen, device=cuda) if init else None
    return x, dA, B_, C_, state


@pytest.mark.parametrize("b,s,h,p,n,g,dtype,init", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, b, s, h, p, n, g, dtype, init):
    """y within one bf16 ulp (bf16) or 1e-4 relative (fp32), and the fp32
    final state within 1e-4 relative, each plus 1e-5 x the largest value:
    y and the state sum up to a chunk of terms in another order."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_ref

    x, dA, B_, C_, state = _ssd_inputs(cuda, b, s, h, p, n, g, dtype, init)
    before = ops.ssd.launches
    y, final = ops.ssd(x, dA, B_, C_, 256, state)
    ref_y, ref_final = ssd_ref(x, dA, B_, C_, min(256, s), state)
    torch.cuda.synchronize()
    assert ops.ssd.launches == before + 1
    assert y.dtype == dtype and y.shape == x.shape and final.dtype == torch.float32
    _close_grad(y, ref_y, dtype)
    _close_grad(final, ref_final, torch.float32)


@pytest.mark.parametrize("b,s,h,p,n,g,dtype,init", SSD_CASES)
def test_ssd_kernel_passes_match_plain(cuda, b, s, h, p, n, g, dtype, init):
    """Each of B4's five passes against its plain version computed from the
    kernel's own scratch as the pass found it, with y's and the state's
    tolerance; C B^T on and below the diagonal, where the kernel computes it."""
    from repro_torch.kernels.ssd_scan import ops

    x, dA, B_, C_, state = _ssd_inputs(cuda, b, s, h, p, n, g, dtype, init)
    ws = ops.workspace(x, dA, B_, C_, 256, state)
    for name in ops.PASSES:
        ops.run_pass(ws, name)
        for field, ref in ops.plain_pass(ws, name).items():
            out = getattr(ws, field)
            if field == "cb":
                out, ref = torch.tril(out), torch.tril(ref)
            _close_grad(out, ref, dtype if field == "y" else torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_unaligned_rows_match_plain(cuda, dtype):
    """x as a view whose rows lie 65 elements apart, so that the kernel
    copies its tiles element by element instead of 16 bytes at a time; a
    ragged chunk of 100 and an initial state."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_ref

    x, dA, B_, C_, state = _ssd_inputs(cuda, 2, 300, 4, 64, 128, 1, dtype, True)
    x = torch.cat([x, x[..., :1]], dim=3)[..., :64]
    assert not ops._aligned(x)
    y, final = ops.ssd(x, dA, B_, C_, 100, state)
    ref_y, ref_final = ssd_ref(x, dA, B_, C_, 100, state)
    torch.cuda.synchronize()
    _close_grad(y, ref_y, dtype)
    _close_grad(final, ref_final, torch.float32)


def test_ssd_kernel_refuses_gradients_and_missing_instances(cuda):
    from repro_torch.kernels.ssd_scan import ops

    x = torch.zeros(1, 64, 2, 64, device=cuda, requires_grad=True)
    dA = torch.zeros(1, 64, 2, device=cuda)
    bc = torch.zeros(1, 64, 1, 128, device=cuda)
    with pytest.raises(NotImplementedError, match="backward"):
        ops.ssd(x, dA, bc, bc, 64)
    with torch.no_grad():
        y, _ = ops.ssd(x, dA, bc, bc, 64)  # no gradient asked for: the kernel runs
    assert bool((y == 0).all())
    with pytest.raises(NotImplementedError):
        ops.ssd(x.detach(), dA, bc[..., :32], bc[..., :32], 64)  # d_state 32
    with pytest.raises(TypeError):
        ops.ssd(x.detach(), dA.bfloat16(), bc, bc, 64)


def test_ssm_models_on_card_run_no_plain_version(cuda, monkeypatch):
    """A mamba2 and a zamba2 smoke model (head_dim 64, d_state 64) on the
    card with every plain version made to raise: the forward runs B4 in
    every mamba layer and B1 in the shared attention, a decode step B2, and
    decode agrees with the forward."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SSMConfig
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import build_model

    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((fa_ops, "flash_attention_ref"), (dec_ops, "decode_attention_ref"),
                      (norm_ops, "rmsnorm_ref"), (ssd_ops, "ssd_ref")):
        monkeypatch.setattr(mod, name, boom)
    for arch, n_layers in (("mamba2-370m", 2), ("zamba2-1.2b", 8)):
        cfg = dataclasses.replace(
            get_config(arch + "-smoke"), n_layers=n_layers, d_model=128, head_dim=64,
            ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=1, chunk=32))
        api = build_model(cfg, device=cuda)
        params = api.init(seed=0)
        tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda)
        n_mamba = cfg.layer_kinds().count("mamba")
        before = (ssd_ops.ssd.launches, fa_ops.flash_attention.launches)
        with torch.no_grad():
            full = api.forward(params, tokens).float()
            after = (ssd_ops.ssd.launches, fa_ops.flash_attention.launches)
            assert after == (before[0] + n_mamba, before[1] + n_layers - n_mamba)
            cache = api.init_cache(2, 64)
            for i in range(64):
                lg, cache = api.decode_step(params, cache, tokens[:, i : i + 1], i)
                err = (lg[:, 0].float() - full[:, i]).abs().max().item()
                assert err < 1e-4 * max(1.0, full[:, i].abs().max().item()), (arch, i, err)


def _refuse_plain_versions(monkeypatch):
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((fa_ops, "flash_attention_ref"), (fa_ops, "flash_attention_bwd_ref"),
                      (dec_ops, "decode_attention_ref"), (norm_ops, "rmsnorm_ref"),
                      (norm_ops, "rmsnorm_bwd_ref"), (norm_ops, "rmsnorm_residual_ref"),
                      (ssd_ops, "ssd_ref")):
        monkeypatch.setattr(mod, name, boom)


def _two_pod_session():
    from repro_torch.core import Session, make_tpu_fleet_topology

    topo, _ = make_tpu_fleet_topology(pods=2, hosts_per_pod=1)
    s = Session(topology=topo)
    for pod in (0, 1):
        s.start_pilot_data(service_url=f"mem://cluster:pod{pod}/card{pod}",
                           affinity=f"cluster:pod{pod}")
    for p in [s.start_pilot(resource_url=f"sim://cluster:pod{pod}:host0", slots=1)
              for pod in (0, 1)]:
        p.wait_active()
    return s


def test_pilot_trainer_on_card_runs_no_plain_version(cuda, monkeypatch):
    """PilotTrainer at smoke size (head_dim 64, bf16) trains as two
    train_chunk CUs on the card with every plain version made to raise; the
    launch counters say every step of both CUs went through the kernels."""
    import dataclasses
    import json

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.training.trainer import PilotTrainer

    _refuse_plain_versions(monkeypatch)
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b-smoke"), head_dim=64, n_layers=3,
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    with _two_pod_session() as s:
        tr = PilotTrainer(cfg, s, total_steps=4, chunk_steps=2, batch=2, seq=64, n_shards=2,
                          tokens_per_shard=4 * 2 * 65, run_name="card-pilot", device=cuda)
        tr.stage_data(affinities=["cluster:pod0", "cluster:pod1"])
        tr.initial_checkpoint()
        fa_ops.flash_attention.launches = fa_ops.flash_attention.backward_launches = 0
        norm_ops.rmsnorm.launches = norm_ops.rmsnorm.backward_launches = 0
        summary = tr.run(timeout_per_chunk=300)
        du = s.ctx.lookup(tr.ckpt_dus[-1].id)
        meta = json.loads(s.ctx.lookup(du.locations[0]).fetch_du_file(du.id, "meta.json"))
    losses = [x for h in summary["history"] for x in h["losses"]]
    assert summary["chunks"] == 2 and len(losses) == 4
    assert all(torch.isfinite(torch.tensor(losses)))
    assert meta == {"step": 4, "run": "card-pilot"}
    n = cfg.n_layers  # every step: n forward, n recomputed, n backward
    assert fa_ops.flash_attention.launches == 4 * 2 * n
    assert fa_ops.flash_attention.backward_launches == 4 * n
    assert norm_ops.rmsnorm.launches == 4 * ((2 * n + 1) + 2 * n)
    assert norm_ops.rmsnorm.backward_launches == 4 * (2 * n + 1)


def test_two_serve_cus_on_card_count_every_launch(cuda, monkeypatch):
    """Two serve CUs decode at once on two pilots from one weights DU, on
    the card, with every plain version made to raise: both give a direct
    engine's tokens, and the launch counters, bumped from both agent
    threads, add up exactly."""
    import dataclasses

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core import FUNCTIONS
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.models import build_model
    from repro_torch.serving import DecodeEngine

    _refuse_plain_versions(monkeypatch)
    cfg = dataclasses.replace(get_config("gemma3-1b-smoke"), head_dim=64,
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    api = build_model(cfg, device=cuda)
    params = api.init(seed=0)
    prompts = torch.randint(0, cfg.vocab_size, (4, 24), generator=torch.Generator().manual_seed(0))
    new = 16

    def serve(cu_ctx, weights_du, tokens):
        engine = DecodeEngine.from_cu_context(api, cu_ctx, weights_du, batch=4, max_len=64)
        return engine.generate(torch.tensor(tokens), new).cpu().tolist()

    FUNCTIONS.register("card-serve", serve)
    with _two_pod_session() as s:
        du = Checkpointer(s, run_name="card-serve").save(0, params)
        dec_ops.decode_attention.launches = norm_ops.rmsnorm.launches = 0
        cus = [s.submit_cu(executable="card-serve", args=(du.id, prompts.tolist()),
                           input_data=[du], affinity=f"cluster:pod{pod}") for pod in (0, 1)]
        outs = [cu.result(timeout=300) for cu in cus]
        assert len({cu.pilot_id for cu in cus}) == 2
    steps = prompts.shape[1] + new - 1
    assert dec_ops.decode_attention.launches == 2 * cfg.n_layers * steps
    assert norm_ops.rmsnorm.launches == 2 * (2 * cfg.n_layers + 1) * steps
    direct = DecodeEngine(api, params, batch=4, max_len=64).generate(prompts, new)
    assert outs[0] == outs[1] == direct.cpu().tolist()
