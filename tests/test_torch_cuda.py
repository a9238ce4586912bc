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


@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 6, 8, 12, 48])
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

    q = torch.zeros(1, 1, 3, 96, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 1, 96, device=cuda, dtype=torch.bfloat16)
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
    # granite-moe-3b-a800m's decode (24/8 heads, G 3) at batch 4 and 8
    ("granite G 3", 4, 8, 3, 64, 512, 278, (8, 64)),
    ("granite G 3 at B 8", 8, 8, 3, 64, 512, 278, (4, 128)),
    ("G 3, empty splits", 1, 2, 3, 64, 1024, 300, (16, 64)),
    # whisper-large-v3's self cache (20/20 heads, max_len 448) at batch 4
    ("whisper self", 4, 20, 1, 64, 448, 127, (3, 150)),
    # h2o-danube-1.8b (32/8 heads of 80): the serve path's 1024 slots, and a
    # 4096-slot ring (its window) wrapped
    ("h2o-danube D 80", 4, 8, 4, 80, 1024, 543, (8, 128)),
    ("h2o-danube D 80, ring wrapped", 4, 8, 4, 80, 4096, 4700, (8, 512)),
    # granite-34b (48/1 heads of 128: MQA, G 48) at batch 4 and 8
    ("granite-34b G 48", 4, 1, 48, 128, 1024, 279, (16, 64)),
    ("granite-34b G 48 at B 8", 8, 1, 48, 128, 1024, 279, (16, 64)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_instances_fit_the_largest_cluster(cuda, dtype):
    """Every (D, G) instance, the G 48 ones with the most shared memory
    among them, fits a cluster of MAX_SPLIT blocks on the card."""
    from repro_torch.kernels.decode_attention import ops

    for d in ops.HEAD_DIMS:
        for g in ops.GROUPS:
            clusters, smem = ops.occupancy(dtype, d, g, ops.MAX_SPLIT)
            assert clusters >= 1 and smem <= 227 * 1024, (d, g, clusters, smem)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_over_a_cross_cache(cuda, dtype):
    """whisper-large-v3's cross-attention decode: [4, 1, 20, 64] over 1500
    frames, the query and every slot at position 0, so every slot is kept;
    3 splits of 500 slots (no multiple of the 32-slot tile) on 132 SMs."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    b, sk, h, d = 4, 1500, 20, 64
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if sms == 132:
        assert ops.split_plan(b, h, sk, sms) == (3, 500)
    gen = torch.Generator(device=cuda).manual_seed(sk)
    q = torch.randn(b, 1, h, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, sk, h, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, sk, h, d, generator=gen, device=cuda).to(dtype)
    pos_q = torch.zeros(b, device=cuda, dtype=torch.int32)
    pos_k = torch.zeros(1, sk, device=cuda, dtype=torch.int32).expand(b, sk)
    out = ops.decode_attention(q, k, v, pos_q, pos_k)
    ref = decode_attention_ref(q[:, 0], k, v, pos_q, pos_k)[:, None]
    # every slot kept: the plain softmax over all keys, no mask at all
    full = torch.softmax(torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), k.float()) * d**-0.5, -1)
    torch.cuda.synchronize()
    _close(out, ref, dtype)
    _close(ref[:, 0], torch.einsum("bhk,bkhd->bhd", full, v.float()), dtype)


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
    torch.cuda._sleep(1)  # the marker kernel, loaded before the traces
    # a trace can lose device events; one that holds both markers around the
    # call recorded the device, and only such a trace is read
    for _ in range(4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            ops.decode_attention(q, k, k, pos_q, pos_k)
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum("spin_kernel" in n for n in names) == 2:
            break
    else:
        pytest.fail(f"no trace of 4 recorded both marker kernels: {names}")
    names = [n for n in names if "spin_kernel" not in n]
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


@pytest.mark.parametrize("rows,d", [(1, 64), (5, 1152), (7, 1024), (1022, 2048), (33, 4096),
                                    (9, 1280), (301, 1536), (4, 6144)])
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
@pytest.mark.parametrize("g", [1, 2, 3, 4, 6, 8, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(cuda, s, d, g, dtype):
    """Forward (out, lse) and backward (dq, dk, dv) at S 77 and 333 (ragged
    last tiles, several 128-row and 64-key tiles), q/k/v as strided views of
    one fused projection, every mask."""
    q, k, v = _flash_inputs(cuda, d, g, dtype, seed=s + d + g)
    _check_flash(q, k, v, FLASH_MASKS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_granite_shape(cuda, dtype):
    """granite-moe-3b-a800m's forward, [4, 280, 24/8, 64]: G 3 leaves 2 spare
    rows in each 128-row query tile (42 positions) and 2 in each 32-row
    tile of the dK/dV kernel (10 positions), which must be masked."""
    q, k, v = _flash_inputs(cuda, 64, 3, dtype, seed=280, b=4, s=280, hkv=8)
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


# the training paths' B1 shapes: (label, B, Sq, Sk, Hq, Hkv, causal) at D 64
FLASH_PATH_SHAPES = [
    ("granite-moe train", 2, 8192, 8192, 24, 8, True),
    ("whisper encoder", 8, 1500, 1500, 20, 20, False),
    ("whisper decoder self", 8, 448, 448, 20, 20, True),
    ("whisper cross", 8, 448, 1500, 20, 20, False),
]


@pytest.mark.parametrize("case", FLASH_PATH_SHAPES, ids=[c[0] for c in FLASH_PATH_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_training_path_shapes(cuda, case, dtype):
    """Forward and backward at granite-moe's training shape (G 3, S 8192) and
    whisper's: the encoder's bidirectional attention, the decoder's causal
    self-attention and the cross-attention of 448 queries over 1500 keys,
    whose dK/dV tiles get fewer query rows than key rows."""
    _, b, sq, sk, hq, hkv, causal = case
    q, k, v = _flash_inputs(cuda, 64, hq // hkv, dtype, seed=sq + sk, b=b, s=sk, hkv=hkv,
                            sq=sq if sq != sk else None)
    _check_flash(q, k, v, [(causal, None)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_at_group_48_matches_plain(cuda, dtype):
    """granite-34b's MQA (48/1 heads of 128): its serve forward [4, 280]
    (bf16 takes 128-row query tiles of 2 positions, 32 spare rows) and a
    ragged [1, 100] (64-row tiles of 1 position, 16 spare rows), every
    mask; out and lse against the plain version."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref, kernel_key_tile

    for b, s, masks in ((4, 280, [(True, None)]), (1, 100, FLASH_MASKS)):
        q, k, v = _flash_inputs(cuda, 128, 48, dtype, seed=s, b=b, s=s, hkv=1)
        q32, k32, v32 = (t.float() for t in (q, k, v))
        for causal, window in masks:
            before = ops.flash_attention.launches
            out, lse = ops.flash_attention_fwd(q, k, v, causal, window)
            ref, lse_ref = flash_attention_ref(q32, k32, v32, causal=causal, window=window)
            torch.cuda.synchronize()
            assert ops.flash_attention.launches == before + 1
            assert out.dtype == dtype and out.shape == q.shape
            empty = lse_ref == float("-inf")
            assert torch.equal(lse == float("-inf"), empty)
            _close(lse[~empty], lse_ref[~empty], torch.float32)
            if dtype == torch.bfloat16:
                ref_p, _ = flash_attention_ref(q32, k32, v32, causal=causal, window=window,
                                               p_dtype=torch.bfloat16, block_k=kernel_key_tile(128))
                _close_rounded(out, ref, ref_p)
            else:
                _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_at_group_48_matches_plain(cuda, dtype):
    """granite-34b's MQA (48/1 heads of 128) backward: a slice of its
    training shape, [1, 2048] causal, and a ragged [1, 100] under every
    mask, forward and backward through the autograd Function against the
    plain versions with the launches counted (bf16's dK/dV kernel takes the
    48 heads in ``ops.HEAD_PARTS[48]`` parts and folds them; fp32's 64-row
    tiles hold one position, 16 rows spare); two backward calls give the
    same bits."""
    from repro_torch.kernels.flash_attention import ops

    for b, s, masks in ((1, 2048, [(True, None)]), (1, 100, FLASH_MASKS)):
        q, k, v = _flash_inputs(cuda, 128, 48, dtype, seed=s, b=b, s=s, hkv=1)
        _check_flash(q, k, v, masks)
        for causal, window in masks:
            out, lse = ops.flash_attention_fwd(q, k, v, causal, window)
            dout = torch.randn(out.shape, device=cuda,
                               generator=torch.Generator(device=cuda).manual_seed(s)).to(dtype)
            first = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal, window)
            second = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal, window)
            torch.cuda.synchronize()
            for x, y in zip(first, second):
                assert torch.equal(x, y), (b, s, causal, window)


@pytest.mark.parametrize("g", [6, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_rank_groups_matches_plain(cuda, g, dtype):
    """granite-34b's heads a rank at model 8 (6/1 heads of 128) and model 4
    (12/1): a slice of its training shape, [1, 2048] causal, and a ragged
    [1, 100] under every mask, forward and backward through the autograd
    Function against the plain versions with the launches counted (128-row
    query tiles of 21 / 10 positions, 2 / 8 rows spare; bf16's dK/dV kernel
    takes the heads in ``ops.HEAD_PARTS.get(g, 1)`` parts); two backward
    calls give the same bits."""
    from repro_torch.kernels.flash_attention import ops

    for b, s, masks in ((1, 2048, [(True, None)]), (1, 100, FLASH_MASKS)):
        q, k, v = _flash_inputs(cuda, 128, g, dtype, seed=s + g, b=b, s=s, hkv=1)
        _check_flash(q, k, v, masks)
        out, lse = ops.flash_attention_fwd(q, k, v, True, None)
        dout = torch.randn(out.shape, device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(s)).to(dtype)
        first = ops.flash_attention_bwd(q, k, v, out, lse, dout, True, None)
        second = ops.flash_attention_bwd(q, k, v, out, lse, dout, True, None)
        torch.cuda.synchronize()
        for x, y in zip(first, second):
            assert torch.equal(x, y), (b, s, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_refuses_a_group_without_an_instance(cuda, dtype):
    """G 5 has no instance in either direction: the forward and the
    backward raise NotImplementedError before any launch."""
    from repro_torch.kernels.flash_attention import ops

    q = torch.zeros(1, 64, 5, 128, device=cuda, dtype=dtype)
    k = torch.zeros(1, 64, 1, 128, device=cuda, dtype=dtype)
    lse = torch.zeros(1, 5, 64, device=cuda)
    before = (ops.flash_attention.launches, ops.flash_attention.backward_launches)
    with pytest.raises(NotImplementedError, match="group=5"):
        ops.flash_attention_bwd(q, k, k, q, lse, q)
    with pytest.raises(NotImplementedError, match="group=5"):
        ops.flash_attention_fwd(q, k, k)
    torch.cuda.synchronize()
    assert (ops.flash_attention.launches, ops.flash_attention.backward_launches) == before


def test_flash_kernel_rejects_what_it_has_no_instance_for(cuda):
    from repro_torch.kernels.flash_attention import ops

    q = torch.zeros(1, 8, 3, 48, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 1, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, k, k)
    with pytest.raises(TypeError):
        ops.flash_attention(q[..., :32].half(), k[..., :32].half(), k[..., :32].half())


@pytest.mark.parametrize("rows,d", [(1, 64), (300, 1152), (4100, 2560), (3583, 1280),
                                    (4097, 1536), (1024, 6144)])
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
    """A gradient of fp32 inputs runs the backward kernel (once, counted);
    what the kernels have no instance for raises: a gradient of bf16
    inputs (the backward is built for fp32 only, refused before the
    forward runs), d_state 32, a bf16 dA."""
    from repro_torch.kernels.ssd_scan import ops

    x = torch.zeros(1, 64, 2, 64, device=cuda, requires_grad=True)
    dA = torch.zeros(1, 64, 2, device=cuda)
    bc = torch.zeros(1, 64, 1, 128, device=cuda)
    before = (ops.ssd.launches, ops.ssd.backward_launches)
    y, _ = ops.ssd(x, dA, bc, bc, 64)
    (dx,) = torch.autograd.grad(y.sum(), (x,))
    torch.cuda.synchronize()
    assert (ops.ssd.launches, ops.ssd.backward_launches) == (before[0] + 1, before[1] + 1)
    # B = C = 0: y and dx are 0
    assert bool((y == 0).all()) and bool((dx == 0).all())
    with torch.no_grad():
        y, _ = ops.ssd(x, dA, bc, bc, 64)  # no gradient asked for: the forward runs
    assert bool((y == 0).all())
    launches = ops.ssd.launches
    with pytest.raises(NotImplementedError, match="backward"):
        ops.ssd(x.detach().bfloat16().requires_grad_(), dA, bc.bfloat16(), bc.bfloat16(), 64)
    assert ops.ssd.launches == launches
    with pytest.raises(NotImplementedError):
        ops.ssd(x.detach(), dA, bc[..., :32], bc[..., :32], 64)  # d_state 32
    with pytest.raises(TypeError):
        ops.ssd(x.detach(), dA.bfloat16(), bc, bc, 64)


# SSD backward: (B, S, H, P, N, G, initial state, dfinal) -- the card tests'
# smoke shapes at both d_states, G 2, and an initial state with dfinal; 16
# chunks of 256, so that dx and dC walk 8 ring stages of 32 positions (4
# tiles of 64) and the state pass walks 16 chunks, at both d_states; G 2 with
# dfinal at N 128
SSD_BWD_CASES = [
    (2, 512, 8, 64, 128, 1, False, False),
    (2, 512, 8, 64, 64, 1, False, False),
    (2, 512, 8, 64, 64, 2, True, True),
    (1, 1024, 4, 64, 128, 1, True, True),
    (1, 4096, 4, 64, 64, 1, False, False),
    (1, 4096, 4, 64, 128, 1, False, False),
    (2, 512, 8, 64, 128, 2, False, True),
]


def _ssd_grads(x, dA, B_, C_, chunk, state, dy, dfinal):
    """(dx, d_dA, dB, dC, d_initial) of ops.ssd by autograd; B and C are
    views of one tensor, as the model has them, so dB and dC come back
    through their base."""
    from repro_torch.kernels.ssd_scan import ops

    leaves = [t.detach().requires_grad_() for t in (x, dA, B_, C_)]
    if state is not None:
        leaves.append(state.detach().requires_grad_())
    y, final = ops.ssd(*leaves[:4], chunk, leaves[4] if state is not None else None)
    outs, grads_out = [y], [dy]
    if dfinal is not None:
        outs.append(final)
        grads_out.append(dfinal)
    grads = torch.autograd.grad(outs, leaves, grads_out)
    return tuple(grads) + ((None,) if state is None else ())


@pytest.mark.parametrize("b,s,h,p,n,g,init,dfin", SSD_BWD_CASES)
def test_ssd_backward_kernel_matches_plain(cuda, b, s, h, p, n, g, init, dfin):
    """B4's backward (through ops.ssd's autograd Function) against
    ssd_bwd_ref, fp32: 1e-4 relative plus 1e-5 x the tensor's largest
    value (the gradients sum a chunk of terms in another order); one
    backward launch a call; two calls equal bit for bit."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref

    x, dA, B_, C_, state = _ssd_inputs(cuda, b, s, h, p, n, g, torch.float32, init)
    gen = torch.Generator(device=cuda).manual_seed(s + n)
    dy = torch.randn(b, s, h, p, generator=gen, device=cuda)
    dfinal = torch.randn(b, h, p, n, generator=gen, device=cuda) if dfin else None
    before = ops.ssd.backward_launches
    got = _ssd_grads(x, dA, B_, C_, 256, state, dy, dfinal)
    again = _ssd_grads(x, dA, B_, C_, 256, state, dy, dfinal)
    want = ssd_bwd_ref(x, dA, B_, C_, 256, state, dy, dfinal)
    torch.cuda.synchronize()
    assert ops.ssd.backward_launches == before + 2
    for name, gv, av, wv in zip(("dx", "d_dA", "dB", "dC", "d_initial"), got, again, want):
        if name == "d_initial" and state is None:
            assert gv is None
            continue
        assert gv.dtype == torch.float32 and gv.shape == wv.shape, name
        assert torch.equal(gv, av), name
        _close_grad(gv, wv, torch.float32)


@pytest.mark.parametrize("b,s,h,p,n,g,init,dfin", SSD_BWD_CASES)
def test_ssd_backward_kernel_passes_match_plain(cuda, b, s, h, p, n, g, init, dfin):
    """Each of the backward's six passes against its plain version computed
    from the kernel's own scratch as the pass found it, on the forward
    kernel's scratch, with the gradients' tolerance."""
    from repro_torch.kernels.ssd_scan import ops

    x, dA, B_, C_, state = _ssd_inputs(cuda, b, s, h, p, n, g, torch.float32, init)
    gen = torch.Generator(device=cuda).manual_seed(s + n)
    dy = torch.randn(b, s, h, p, generator=gen, device=cuda)
    dfinal = torch.randn(b, h, p, n, generator=gen, device=cuda) if dfin else None
    ws = ops.workspace(x, dA, B_, C_, 256, state)
    for name in ops.PASSES:
        ops.run_pass(ws, name)
    bw = ops.bwd_workspace(ws, dy, dfinal)
    for name in ops.BWD_PASSES:
        ops.run_pass(bw, name)
        for field, ref in ops.plain_pass(bw, name).items():
            out = getattr(bw, field)
            _close_grad(out, ref, torch.float32)
            first = out.clone()
            ops.run_pass(bw, name)  # a pass reads no field it writes
            assert torch.equal(getattr(bw, field), first), (name, field)


def test_ssd_backward_kernel_unaligned_rows_match_plain(cuda):
    """x and dy as views whose rows lie 65 elements apart (the 4-byte
    cp.async path), a ragged chunk of 100 (two 64-row tiles, the second
    partial; 32-position stages of 32, 32, 32 and 4), an initial state and
    dfinal; two calls equal bit for bit."""
    from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref

    x, dA, B_, C_, state = _ssd_inputs(cuda, 2, 300, 4, 64, 128, 1, torch.float32, True)
    x = torch.cat([x, x[..., :1]], dim=3)[..., :64]
    gen = torch.Generator(device=cuda).manual_seed(300)
    dy = torch.randn(2, 300, 4, 65, generator=gen, device=cuda)[..., :64]
    dfinal = torch.randn(2, 4, 64, 128, generator=gen, device=cuda)
    got = _ssd_grads(x, dA, B_, C_, 100, state, dy, dfinal)
    again = _ssd_grads(x, dA, B_, C_, 100, state, dy, dfinal)
    want = ssd_bwd_ref(x, dA, B_, C_, 100, state, dy, dfinal)
    torch.cuda.synchronize()
    for gv, av, wv in zip(got, again, want):
        assert torch.equal(gv, av)
        _close_grad(gv, wv, torch.float32)


@pytest.mark.parametrize("name", ["dprev", "dx", "dc"])
@pytest.mark.parametrize("n", [64, 128])
def test_ssd_backward_shared_memory_matches_ops(cuda, name, n):
    """The shared memory the backward's CUDA source gives a block of each
    tensor pass is ops.bwd_smem_bytes's, the figure the CPU tests hold to
    the design's blocks an SM."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ops

    fn = build.load("ssd_scan_bwd").ssd_scan_bwd_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    assert fn(1 << ops.BWD_PASSES.index(name), n) == ops.bwd_smem_bytes(name, n)


def test_ssd_backward_kernels_do_not_spill(cuda):
    """ptxas's report for every kernel of the backward: no spill stores or
    loads, and no more registers than two blocks an SM leave a thread."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ops

    build.load("ssd_scan_bwd")
    report = build.ptxas_report(build.library_path("ssd_scan_bwd").with_suffix(".log").read_text())
    assert len(report) == 9, sorted(report)  # dprev, dx, dc at N 64 and 128; carry, dA, fold
    limit = 65536 // (ops.BWD_BLOCKS_PER_SM * ops.BWD_THREADS)
    for fn, (regs, spill_stores, spill_loads) in report.items():
        assert spill_stores == 0 and spill_loads == 0, fn
        assert regs <= limit, fn


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


def test_ssm_train_step_on_card_launches_the_schedule(cuda, monkeypatch):
    """A mamba2 and a zamba2 smoke model (head_dim 64, d_state 64, fp32), one
    eval and one remat train step on the card with every plain version made
    to raise: the launches are exactly what chip_smoke's
    ``train_launch_schedule`` implies (B4 forward, again for the mamba
    layers of the stacked groups, and its backward once per mamba layer;
    B1 both ways in zamba2's shared block; B3a both ways), and step 0's
    loss (lr 0) is the eval loss."""
    import dataclasses
    from pathlib import Path

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SSMConfig
    from repro_torch.models import build_model
    from repro_torch.optim import init_adamw
    from repro_torch.training import make_eval_step, make_train_step

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    _refuse_plain_versions(monkeypatch)
    for arch, n_layers in (("mamba2-370m", 2), ("zamba2-1.2b", 8)):
        cfg = dataclasses.replace(
            get_config(arch + "-smoke"), n_layers=n_layers, d_model=128, head_dim=64,
            ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=1, chunk=32))
        api = build_model(cfg, device=cuda)
        params = api.init(seed=0)
        opt = init_adamw(params)
        tokens = torch.randint(0, cfg.vocab_size, (2, 97), device=cuda,
                               generator=torch.Generator(device=cuda).manual_seed(0))
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        cs.reset_counts()
        ev = make_eval_step(api)(params, batch)
        assert cs.read_counts() == cs.path_launches(cfg, "forward")
        cs.reset_counts()
        params, opt, m = make_train_step(api, warmup_steps=1)(params, opt, batch)
        torch.cuda.synchronize()
        assert cs.read_counts() == cs.train_launch_schedule(cfg), arch
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
        assert abs(m["loss"].item() - ev["loss"].item()) < 1e-4 * max(1.0, ev["loss"].item())


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_moe_model_on_card_runs_no_plain_version(cuda, monkeypatch, kv):
    """A granite-moe smoke model (GQA group 3, head_dim 64, fp32, drop-free
    capacity factor E / k) on the card with every plain version made to
    raise: the forward runs B1 in every layer, a decode step B2 and the
    norms B3a.  On the compute-dtype cache decode agrees with the card's
    forward; on the int8 cache with the same decode on the CPU (the plain
    versions), since int8 noise alone moves a top-2-of-8 router's choice at
    this size.  fp32 keeps both comparisons at 1e-4: in bf16 a last-bit
    difference between B1 and B2 can flip a near tie of the router."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.models import build_model

    cfg = get_config("granite-moe-3b-a800m-smoke")
    cfg = dataclasses.replace(
        cfg, n_layers=3, n_heads=6, n_kv_heads=2, head_dim=64, kv_cache_dtype=kv,
        moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    cpu_api, api = build_model(cfg, device="cpu"), build_model(cfg, device=cuda)
    cpu_params = cpu_api.init(seed=0)
    params = _to(cpu_params, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 48), generator=torch.Generator().manual_seed(0))

    def decode(api, params):
        cache, out = api.init_cache(2, 48), []
        for i in range(48):
            lg, cache = api.decode_step(params, cache, tokens[:, i : i + 1].to(api.device), i)
            out.append(lg[:, 0].float().cpu())
        return torch.stack(out, dim=1)

    with torch.no_grad():
        ref = decode(cpu_api, cpu_params) if kv == "int8" else None
        _refuse_plain_versions(monkeypatch)

        def launches():
            return (fa_ops.flash_attention.launches, dec_ops.decode_attention.launches,
                    norm_ops.rmsnorm.launches)

        before = launches()
        full = api.forward(params, tokens.to(cuda)).float().cpu()
        assert launches() == (before[0] + 3, before[1], before[2] + 7)
        dec = decode(api, params)
        assert launches() == (before[0] + 3, before[1] + 3 * 48, before[2] + 7 * 49)
    want = full if ref is None else ref
    err = (dec - want).abs().amax(dim=(0, 2)) / want.abs().amax(dim=(0, 2)).clamp_min(1.0)
    assert float(err.max()) < 1e-4, (kv, err)


def test_moe_remat_gradients_equal_no_remat_on_card(cuda, monkeypatch):
    """granite-moe-3b-a800m at every width but cut to 2 layers, bf16, on 2 x
    1024 tokens: with remat the backward pass reruns each layer's routing,
    which must pick the forward's experts and slots (so drop the same
    pairs), and every gradient leaf must agree with the one without remat
    within one bf16 ulp of the leaf's largest value."""
    import dataclasses

    from repro_torch.checkpoint import flatten_tree
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, moe

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"), n_layers=2)
    api = build_model(cfg, device=cuda)
    params = api.init(seed=0)
    leaves = flatten_tree(params)
    tensors = [t.requires_grad_(True) for _, t in leaves]
    tokens = torch.randint(0, cfg.vocab_size, (2, 1025), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(0))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    dispatch, tables = moe._dispatch_tables, []

    def recording(expert_idx, n_tokens, e_pad, cap):
        slot_table, token_slots = dispatch(expert_idx, n_tokens, e_pad, cap)
        tables.append((expert_idx.clone(), token_slots.clone()))
        return slot_table, token_slots

    _refuse_plain_versions(monkeypatch)
    monkeypatch.setattr(moe, "_dispatch_tables", recording)
    grads = {}
    for remat in (True, False):
        tables.clear()
        loss, _ = api.loss_fn(params, batch, remat=remat)
        grads[remat] = torch.autograd.grad(loss, tensors)
        assert len(tables) == (2 if remat else 1) * cfg.n_layers
        if remat:
            recorded = list(tables)
    fwd, again = recorded[: cfg.n_layers], recorded[cfg.n_layers :][::-1]
    for a, b, c in zip(fwd, again, tables):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and torch.equal(a[0], c[0])
    for (path, _), g, h in zip(leaves, grads[True], grads[False]):
        diff = (g.float() - h.float()).abs().max().item()
        assert diff <= 2.0**-7 * h.float().abs().max().item(), (path, diff)


def test_whisper_model_on_card_runs_no_plain_version(cuda, monkeypatch):
    """A whisper smoke model (head_dim 64, fp32) on the card with every plain
    version made to raise: the encoder and the teacher-forced decoder run
    B1 (non-causal, causal, cross with Sq != Sk), a decode step B2 over the
    self and the cross cache, the norms B3a; decode agrees with the forward
    to 1e-4, and a train step launches every kernel the schedule implies."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.models import build_model, whisper
    from repro_torch.optim import init_adamw
    from repro_torch.training import make_train_step

    cfg = dataclasses.replace(get_config("whisper-large-v3-smoke"), head_dim=64)
    api = build_model(cfg, device=cuda)
    params = api.init(seed=0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    frames = torch.randn(2, cfg.encdec.n_frames, cfg.d_model, generator=gen, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen, device=cuda)
    _refuse_plain_versions(monkeypatch)

    def launches():
        return (fa_ops.flash_attention.launches, fa_ops.flash_attention.backward_launches,
                dec_ops.decode_attention.launches, norm_ops.rmsnorm.launches,
                norm_ops.rmsnorm.backward_launches)

    n_enc, n_dec = cfg.encdec.n_enc_layers, cfg.n_layers
    fwd_norms = 2 * n_enc + 3 * n_dec + 2
    with torch.no_grad():
        before = launches()
        full = api.forward(params, frames, tokens).float()
        assert launches() == (before[0] + n_enc + 2 * n_dec, before[1], before[2],
                              before[3] + fwd_norms, before[4])
        cache = whisper.prefill_cross_cache(params, frames, api.init_cache(2, 24), cfg)
        before = launches()
        for i in range(24):
            lg, cache = api.decode_step(params, cache, tokens[:, i : i + 1], i)
            err = (lg[:, 0].float() - full[:, i]).abs().max().item()
            assert err < 1e-4 * max(1.0, full[:, i].abs().max().item()), (i, err)
        assert launches() == (before[0], before[1], before[2] + 24 * 2 * n_dec,
                              before[3] + 24 * (3 * n_dec + 1), before[4])
    batch = {"frames": frames, "tokens": tokens, "labels": tokens.roll(-1, 1)}
    before = launches()
    _, _, m = make_train_step(api, warmup_steps=1)(params, init_adamw(params), batch)
    torch.cuda.synchronize()
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    # every encoder and decoder layer checkpointed: its attentions and norms
    # run again in the backward pass; the two final norms do not
    n_attn = n_enc + 2 * n_dec
    assert launches() == (before[0] + 2 * n_attn, before[1] + n_attn, before[2],
                          before[3] + 2 * fwd_norms - 2, before[4] + fwd_norms)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


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
                      (ssd_ops, "ssd_ref"), (ssd_ops, "ssd_bwd_ref")):
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


# each architecture's smoke config (reduced depth and d_model) at its
# published attention shape: (model, heads, kv heads, head_dim)
ARCH_SHAPES = [
    ("llava-next-mistral-7b", 32, 8, 128),  # G 4, prefix_embeds
    ("gemma3-12b", 16, 8, 256),  # G 2, sliding-window and global layers
    ("qwen3-moe-30b-a3b", 32, 4, 128),  # G 8, MoE
    ("granite-34b", 48, 1, 128),  # MQA, G 48
]


@pytest.mark.parametrize("case", ARCH_SHAPES, ids=[c[0] for c in ARCH_SHAPES])
def test_architectures_on_card_match_the_plain_path(cuda, monkeypatch, case):
    """fp32, 2 x 48 tokens (llava: 8 patch embeddings before them): the
    forward, ``loss_fn``, every gradient leaf (remat) and 8 decode steps on
    the card with every plain version made to raise, against the same
    config and params on the CPU, where the wrappers run the plain
    versions.  Logits, losses and decode within 1e-4 of the CPU tensor's
    max; gradients within 1e-3 of each leaf's max |g| (as phase 11 of
    chip_smoke.py holds the SSM gradients: sums in another order through
    every layer's backward)."""
    import dataclasses

    from repro_torch.checkpoint import flatten_tree
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    name, hq, hkv, d = case
    cfg = dataclasses.replace(get_config(name + "-smoke"), n_heads=hq, n_kv_heads=hkv, head_dim=d)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 49), generator=gen)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = 0.02 * torch.randn(2, cfg.vlm.n_patches, cfg.d_model,
                                                    generator=gen)

    def run(api, params):
        dev = {k: v.to(api.device) for k, v in batch.items()}
        with torch.no_grad():
            logits = api.forward(params, dev["tokens"], prefix_embeds=dev.get("prefix_embeds"))
            cache, dec = api.init_cache(2, 8), []
            for i in range(8):
                lg, cache = api.decode_step(params, cache, dev["tokens"][:, i : i + 1], i)
                dec.append(lg[:, 0])
        leaves = [t.requires_grad_(True) for _, t in flatten_tree(params)]
        loss, m = api.loss_fn(params, dev, remat=True)
        grads = torch.autograd.grad(loss, leaves)
        return [t.detach().float().cpu() for t in (logits, torch.stack(dec, 1), m["ce"], loss)], [
            g.float().cpu() for g in grads]

    cpu_api = build_model(cfg, device="cpu")
    cpu_params = cpu_api.init(seed=0)
    params = _to(cpu_params, cuda)
    want, want_g = run(cpu_api, cpu_params)
    _refuse_plain_versions(monkeypatch)
    got, got_g = run(build_model(cfg, device=cuda), params)
    for what, x, y in zip(("logits", "decode", "ce", "loss"), got, want):
        assert x.shape == y.shape and bool(x.isfinite().all()), what
        assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item(), what
    for (path, _), x, y in zip(flatten_tree(cpu_params), got_g, want_g):
        assert (x - y).abs().max().item() <= 1e-3 * y.abs().max().item(), path


# ---------------------------------------------------------------- distributed
@pytest.fixture(scope="module")
def card_mesh():
    """A (data 1, model 1) mesh over a one-rank NCCL group on a free
    localhost port (NCCL takes no second rank on the same card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import socket

    import torch.distributed as dist

    from repro_torch.launch import make_mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


def _card_cfg(name: str, **kw):
    import dataclasses

    from repro_torch.configs import get_config

    kw = dict(dict(head_dim=64, param_dtype="bfloat16", compute_dtype="bfloat16"), **kw)
    return dataclasses.replace(get_config(name), **kw)


def test_expert_parallel_layer_on_card_equals_local(cuda, card_mesh):
    """The EP path at world 1 over NCCL (an all_to_all_single out and one
    back) gives moe_mlp_local's y and aux bit for bit."""
    from repro_torch.checkpoint import flatten_tree
    from repro_torch.distributed import DistContext, distribute_tree, distribution
    from repro_torch.distributed.moe_parallel import moe_maybe_parallel
    from repro_torch.models import build_model, moe

    cfg = _card_cfg("granite-moe-3b-a800m-smoke")
    params = build_model(cfg, device=cuda).init(seed=0)
    layer = {"router": {"w": params["groups"]["pos0"]["moe"]["router"]["w"][0]},
             **{k: params["groups"]["pos0"]["moe"][k][0] for k in ("gate", "up", "down")}}
    x = torch.randn(2, 64, cfg.d_model, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(1)).to(torch.bfloat16)
    y_ref, aux_ref = moe.moe_mlp_local(layer, x, cfg)
    ctx = DistContext(card_mesh, ("data",))
    specs = {"router": {"w": (None, None)}, "gate": ("model", None, None),
             "up": ("model", None, None), "down": ("model", None, None)}
    dlayer = distribute_tree(layer, specs, ctx)
    dx = distribute_tree({"x": x}, {"x": ("data", "model", None)}, ctx)["x"]
    before = moe.moe_mlp_ep.exchanges
    with distribution(ctx):
        y, aux = moe_maybe_parallel(dlayer, dx, cfg)
    torch.cuda.synchronize()
    assert moe.moe_mlp_ep.exchanges == before + 2
    assert torch.equal(y.full_tensor(), y_ref) and torch.equal(aux.full_tensor(), aux_ref)
    assert len(flatten_tree(dlayer)) == 4


def test_sharded_train_step_on_card_runs_no_plain_version(cuda, card_mesh, monkeypatch):
    """One step of the sharded train step (granite-moe smoke, head dim 64,
    bf16) on the card with every plain version made to raise: the launches
    are the unsharded step's, and so are the loss, the grad norm and every
    updated leaf, bit for bit."""
    from repro_torch.checkpoint import flatten_tree, tree_map
    from repro_torch.distributed import DistContext, distribute_tree, opt_specs, param_specs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.models import build_model
    from repro_torch.optim import init_adamw
    from repro_torch.optim.adamw import tree_get
    from repro_torch.training import make_train_step

    cfg = _card_cfg("granite-moe-3b-a800m-smoke", n_layers=3)
    api = build_model(cfg, device=cuda)
    params = api.init(seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 80), device=cuda)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    _refuse_plain_versions(monkeypatch)
    counters = ((fa_ops.flash_attention, "launches"), (fa_ops.flash_attention, "backward_launches"),
                (norm_ops.rmsnorm, "launches"), (norm_ops.rmsnorm, "backward_launches"))

    def run(step, p, o):
        for fn, attr in counters:
            setattr(fn, attr, 0)
        p, o, m = step(p, o, batch)
        torch.cuda.synchronize()
        return p, o, {k: v.item() for k, v in m.items()}, [getattr(f, a) for f, a in counters]

    ref_p = tree_map(lambda t: t.clone(), params)
    ref_p, ref_o, ref_m, ref_n = run(make_train_step(api, warmup_steps=1), ref_p,
                                     init_adamw(ref_p))
    ctx = DistContext(card_mesh, ("data",))
    opt = init_adamw(params)
    ps = param_specs(params, cfg, ctx)
    opt = distribute_tree(opt, opt_specs(opt, ps, cfg, ctx), ctx)
    params = distribute_tree(params, ps, ctx)
    params, opt, m, n = run(make_train_step(api, warmup_steps=1, ctx=ctx), params, opt)
    assert n == ref_n and n[0] == 2 * cfg.n_layers and n[1] == cfg.n_layers
    assert m == ref_m and all(torch.isfinite(torch.tensor(v)) for v in m.values())
    for tree, ref in ((params, ref_p), (opt, ref_o)):
        for path, t in flatten_tree(tree):
            assert torch.equal(t.full_tensor(), tree_get(ref, path)), path


def test_group_12_attention_in_local_map_raises_before_any_launch(cuda, card_mesh, monkeypatch):
    """granite-34b at model 4 gives each rank 12 q heads on the one kv
    head: the flash kernel's G 12 instance runs inside the local region,
    one forward launch, and gives the unsharded block's output bit for bit
    with every plain version refused; a group still without an instance
    (G 5) raises there before it launches, and nothing falls back to the
    plain version.  One card holds one rank, so the local group is built by
    the heads (12/1, 5/1) at world 1."""
    from repro_torch.distributed import DistContext, distribute_tree, distribution, param_specs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import build_model
    from repro_torch.models.attention import attention_block
    from repro_torch.models.layers import rope_frequencies

    def block(n_heads):
        cfg = _card_cfg("granite-34b-smoke", n_heads=n_heads, n_kv_heads=1, head_dim=128)
        ctx = DistContext(card_mesh, ("data",))
        params = build_model(cfg, device=cuda).init(seed=0)
        attn = {k: {"w": v["w"][0]} for k, v in params["groups"]["pos0"]["attn"].items()}
        specs = param_specs({"groups": {"pos0": {"attn": params["groups"]["pos0"]["attn"]}}},
                            cfg, ctx)
        specs = {k: {"w": v["w"][1:]} for k, v in specs["groups"]["pos0"]["attn"].items()}
        dattn = distribute_tree(attn, specs, ctx)
        x = torch.randn(2, 64, cfg.d_model, device=cuda, generator=torch.Generator(
            device=cuda).manual_seed(n_heads)).to(torch.bfloat16)
        dx = distribute_tree({"x": x}, {"x": ("data", None, None)}, ctx)["x"]
        pos = torch.arange(64, device=cuda, dtype=torch.int32)[None].expand(2, 64)
        kw = dict(causal=True, rope=rope_frequencies(cfg.head_dim_, pos, cfg.rope_theta))

        def run():
            with distribution(ctx):
                return attention_block(dattn, dx, pos, cfg, **kw)
        return run, lambda: attention_block(attn, x, pos, cfg, **kw)

    counts = lambda: (fa_ops.flash_attention.launches, fa_ops.flash_attention.backward_launches)
    run, unsharded = block(12)
    _refuse_plain_versions(monkeypatch)
    ref = unsharded()[0]
    before = counts()
    out = run()[0]
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1])
    assert torch.equal(out.full_tensor(), ref)

    run, _ = block(5)
    before = counts()
    with pytest.raises(NotImplementedError, match="group=5"):
        run()
    torch.cuda.synchronize()
    assert counts() == before


# ----------------------------------------------- modes of a split over ranks
@pytest.mark.parametrize("d,g", [(64, 1), (256, 4), (128, 48), (80, 4)])
@pytest.mark.parametrize("n", [1, 2, 37, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_partial_mode_matches_plain(cuda, d, g, n, dtype):
    """B2's partial mode on one rank's ``n`` slots of a 4n-slot ring at a
    position where the early row keeps nothing of this range: the fp32 out
    and the log-sum-exp (-inf exactly where the plain version's is)."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_partial_ref
    from repro_torch.models.attention import ring_positions

    gen = torch.Generator(device=cuda).manual_seed(d + g + n)
    b, hkv, sk = 3, 1 if g == 48 else 2, 4 * n
    k = torch.randn(b, n, hkv, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, n, hkv, d, generator=gen, device=cuda).to(dtype)
    q = torch.randn(b, 1, hkv * g, d, generator=gen, device=cuda).to(dtype)
    pos = torch.tensor([5 * n, 2 * n, 0], device=cuda, dtype=torch.int32)
    lo = 2 * n  # the third range: past row 2's only slot
    pos_k = torch.cat([ring_positions(int(p), sk, 1, cuda, start=lo, count=n) for p in pos])
    for window in (None, n + 1):
        before = ops.decode_attention.partial_launches
        out, lse = ops.decode_attention_partial(q, k, v, pos, pos_k, window=window)
        ref, ref_lse = decode_attention_partial_ref(q[:, 0], k, v, pos, pos_k, window=window)
        torch.cuda.synchronize()
        assert ops.decode_attention.partial_launches == before + 1
        assert out.dtype == lse.dtype == torch.float32
        _close(out, ref, torch.float32)
        empty = torch.isinf(ref_lse)
        assert bool(empty[2].all()) and torch.equal(torch.isinf(lse), empty)
        assert bool((out[2] == 0).all())
        assert (lse[~empty] - ref_lse[~empty]).abs().max().item() < 1e-4


def test_decode_partial_folds_to_the_whole_cache(cuda):
    """A 1024-slot cache cut into 8 ranges at position 800 (the last keeps
    nothing): the folded partials equal B2 on the whole cache."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.models.attention import ring_positions

    gen = torch.Generator(device=cuda).manual_seed(8)
    b, sk, hq, hkv, d, pos = 4, 1024, 4, 1, 256, 800
    q = torch.randn(b, 1, hq, d, generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn(b, sk, hkv, d, generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn(b, sk, hkv, d, generator=gen, device=cuda).to(torch.bfloat16)
    pq = torch.full((b,), pos, device=cuda, dtype=torch.int32)
    parts = [ops.decode_attention_partial(q, k[:, r * 128:(r + 1) * 128],
                                          v[:, r * 128:(r + 1) * 128], pq,
                                          ring_positions(pos, sk, b, cuda, start=r * 128, count=128))
             for r in range(8)]
    lses = torch.stack([p[1] for p in parts])
    folded = ops.fold_partials(torch.stack([p[0] for p in parts]), lses).to(torch.bfloat16)
    whole = ops.decode_attention(q, k, v, pq, ring_positions(pos, sk, b, cuda))[:, 0]
    torch.cuda.synchronize()
    assert bool(torch.isinf(lses[7]).all())
    _close(folded, whole, torch.bfloat16)


@pytest.mark.parametrize("rows,d,width", [(1, 64, 128), (300, 1152, 1152), (4097, 256, 2048),
                                          (16384, 2048, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_external_statistic_matches_plain(cuda, rows, d, width, dtype):
    """B3a's external-statistic mode on this rank's first ``d`` columns of
    rows of ``width``: the row statistics, the forward and the backward
    against their plain versions, one launch each."""
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import (rmsnorm_ext_bwd_ref, rmsnorm_ext_ref,
                                                 row_stat_ref)

    gen = torch.Generator(device=cuda).manual_seed(rows + d)
    xf = (torch.randn(rows, width, generator=gen, device=cuda) * 3).to(dtype)
    dyf = torch.randn(rows, width, generator=gen, device=cuda).to(dtype)
    wf = (torch.randn(width, generator=gen, device=cuda) * 0.1).to(dtype)
    x, dy, w = xf[:, :d].contiguous(), dyf[:, :d].contiguous(), wf[:d].contiguous()
    counts = lambda: (ops.rmsnorm.stat_launches, ops.rmsnorm.ext_launches,  # noqa: E731
                      ops.rmsnorm.ext_backward_launches)
    before = counts()
    ss, c = ops.row_stat(xf), ops.row_stat(xf, dyf, wf)
    out = ops.rmsnorm_ext(x, w, ss, width)
    dx, dw = ops.rmsnorm_ext_bwd(dy, x, w, ss, c, width)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 2, before[1] + 1, before[2] + 1)
    _close_grad(ss, row_stat_ref(xf), torch.float32)
    _close_grad(c, row_stat_ref(xf, dyf, wf), torch.float32)
    _close(out, rmsnorm_ext_ref(x, w, ss, width), dtype)
    dx_ref, dw_ref = rmsnorm_ext_bwd_ref(dy, x, w, ss, c, width)
    assert dx.dtype == dtype and dw.dtype == dtype
    _close_grad(dx, dx_ref, dtype)
    _close_grad(dw, dw_ref, dtype)
