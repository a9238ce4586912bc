"""B2's launch plan and its order of work, on the CPU.

``split_plan`` cuts the cache into the splits that one cluster's blocks
fold, and ``decode_attention_split_ref`` is the kernel's order of work in
plain PyTorch (split by split, 32-slot tiles, the partials folded in cluster
rank order).  At the main path's plans it is held against the plain version
``decode_attention_ref`` and, where the Pallas kernel can express the mask
(no wrapped ring), against the Pallas kernel in interpret mode; GQA groups
1, 3 (granite-moe-3b-a800m), 4, 48 (granite-34b's MQA) and 6 and 12 (its
heads a rank at model 8 and model 4), head dims 64,
80 (h2o-danube-1.8b, which the Pallas wrapper pads to 128 itself), 128 and
256, and a wrapped ring at D 80.

Tolerance: fp32, max error over the reference's magnitude below 1e-4 (the
same sums taken in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro_torch.kernels.decode_attention.ops import BLOCKS_PER_SM, MAX_SPLIT, split_plan
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    decode_attention_split_ref,
)

SMS = 132  # an H100 SXM's streaming multiprocessors
TOL = 1e-4


def _maxerr(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


@pytest.mark.parametrize("b", [1, 4, 200])
@pytest.mark.parametrize("hkv", [1, 32])
@pytest.mark.parametrize("sk", [1, 17, 1000, 32768])
@pytest.mark.parametrize("sms", [SMS, 78])
def test_split_plan_covers_the_cache(b, hkv, sk, sms):
    n, split_len = split_plan(b, hkv, sk, sms)
    assert 1 <= n <= MAX_SPLIT
    assert (n - 1) * split_len < sk <= n * split_len  # every slot once, no empty split
    assert n == 1 or b * hkv * n <= BLOCKS_PER_SM * sms  # blocks a wave of the card holds


@pytest.mark.parametrize("shape,plan", [
    ((4, 1, 512), (16, 32)),  # gemma3-1b sliding-window ring
    ((8, 1, 512), (16, 32)),
    ((4, 1, 1024), (16, 64)),  # gemma3-1b global layer
    ((8, 1, 1024), (16, 64)),
    ((4, 32, 512), (2, 256)),  # zamba2-1.2b shared attention
    ((4, 8, 512), (8, 64)),  # granite-moe-3b-a800m (24/8 heads)
    ((8, 8, 512), (4, 128)),
    ((4, 8, 1024), (8, 128)),  # h2o-danube-1.8b (32/8 heads of 80), served
    ((4, 8, 4096), (8, 512)),  # its 4096-slot window ring
    ((4, 1, 1024), (16, 64)),  # granite-34b (48/1 heads: G 48)
    ((8, 1, 1024), (16, 64)),
])
def test_split_plan_of_the_main_path(shape, plan):
    assert split_plan(*shape, SMS) == plan


def _inputs(rng, b, sk, hkv, g, d):
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    return q, k, v


# (label, the model's (B, Hkv) that sets the plan, B, Sk, Hkv, G, D, window,
# query positions), all below Sk: slot j holds position j, which the Pallas
# kernel assumes.  The global row's splits 9-15 hold only slots past the
# query (empty); zamba2's plan is two splits, held here at fewer heads
PALLAS_PLANS = [
    ("gemma3-1b global", (4, 1), 4, 1024, 1, 4, 256, None, [543, 543, 100, 1023]),
    ("gemma3-1b ring", (4, 1), 4, 512, 1, 4, 256, 512, [500, 511, 31, 300]),
    ("zamba2-1.2b", (4, 32), 2, 512, 4, 1, 64, None, [511, 200]),
    # granite's plan and group of 3 (the kernel carries it as 4 lanes), at
    # fewer kv heads; splits 5-7 hold only slots past the second query
    ("granite-moe G 3", (4, 8), 2, 512, 2, 3, 64, None, [278, 300]),
    ("granite-moe G 3, window", (4, 8), 2, 512, 2, 3, 64, 100, [278, 511]),
    # h2o-danube-1.8b's plan and head dim 80 (a row of 10 bf16 chunks), at
    # fewer kv heads; with a window, as its sliding-window layers
    ("h2o-danube D 80", (4, 8), 2, 1024, 2, 4, 80, None, [543, 1000]),
    ("h2o-danube D 80, window", (4, 8), 2, 1024, 2, 4, 80, 300, [543, 1023]),
    # granite-34b's plan and MQA group of 48 at D 128, over two kv heads;
    # splits 5-15 hold only slots past the first query
    ("granite-34b G 48", (4, 1), 2, 1024, 2, 48, 128, None, [279, 800]),
    # its heads a rank at model 8 (G 6, carried as 8 lanes) and model 4 (G
    # 12, 4 head parts of 3), at its plan; with a window too
    ("granite-34b G 6", (4, 1), 4, 1024, 1, 6, 128, None, [279, 800, 0, 1023]),
    ("granite-34b G 6, window", (4, 1), 2, 1024, 1, 6, 128, 100, [279, 1023]),
    ("granite-34b G 12", (4, 1), 4, 1024, 1, 12, 128, None, [279, 800, 0, 1023]),
    ("granite-34b G 12, window", (4, 1), 2, 1024, 1, 12, 128, 100, [279, 1023]),
]


@pytest.mark.parametrize("case", PALLAS_PLANS, ids=[c[0] for c in PALLAS_PLANS])
def test_split_fold_matches_plain_version_and_pallas_kernel(case):
    _, of, b, sk, hkv, g, d, window, pos = case
    n_split, split_len = split_plan(*of, sk, SMS)
    rng = np.random.default_rng(sk + g)
    q, k, v = _inputs(rng, b, sk, hkv, g, d)
    pos_q = np.asarray(pos, np.int32)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    pq = torch.from_numpy(pos_q)
    pk = torch.arange(sk, dtype=torch.int32)[None].expand(b, sk)
    split = decode_attention_split_ref(qt, kt, vt, pq, pk, n_split=n_split,
                                       split_len=split_len, window=window)
    plain = decode_attention_ref(qt, kt, vt, pq, pk, window=window)
    pallas = jax_decode_attention(jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(pos_q), window=window)
    assert _maxerr(split.numpy(), plain.numpy()) < TOL
    assert _maxerr(split.numpy(), np.asarray(pallas)[:, 0]) < TOL


@pytest.mark.parametrize("sk,window,pos", [(512, 512, 543), (512, 512, 2000), (1024, None, 543)])
def test_split_fold_on_a_wrapped_ring(sk, window, pos):
    """Slot j holds pos - ((pos - j) mod Sk), as ``ring_positions`` makes it;
    never-written slots are negative.  The last row's query position
    precedes every slot, so it keeps nothing and gives 0."""
    b, hkv, g, d = 4, 1, 4, 256
    n_split, split_len = split_plan(b, hkv, sk, SMS)
    rng = np.random.default_rng(pos)
    qt, kt, vt = (torch.from_numpy(a) for a in _inputs(rng, b, sk, hkv, g, d))
    slots = torch.arange(sk, dtype=torch.int32)
    pk = (pos - torch.remainder(pos - slots, sk))[None].expand(b, sk)
    pq = torch.tensor([pos, pos, pos - 7, -1], dtype=torch.int32)
    split = decode_attention_split_ref(qt, kt, vt, pq, pk, n_split=n_split,
                                       split_len=split_len, window=window)
    plain = decode_attention_ref(qt, kt, vt, pq, pk, window=window)
    assert _maxerr(split.numpy(), plain.numpy()) < TOL
    assert bool((split[-1] == 0).all())


def test_split_fold_on_a_wrapped_ring_at_head_dim_80():
    """h2o-danube-1.8b's 4096-slot window ring wrapped at position 4700 (its
    plan for 32/8 heads, at 2 kv heads here): the first row keeps the whole
    window, the second (an earlier query) only the slots at or before it,
    the last none (0)."""
    b, hkv, g, d, sk, window = 3, 2, 4, 80, 4096, 4096
    n_split, split_len = split_plan(4, 8, sk, SMS)
    rng = np.random.default_rng(4700)
    qt, kt, vt = (torch.from_numpy(a) for a in _inputs(rng, b, sk, hkv, g, d))
    slots = torch.arange(sk, dtype=torch.int32)
    pk = (4700 - torch.remainder(4700 - slots, sk))[None].expand(b, sk)
    pq = torch.tensor([4700, 4200, -1], dtype=torch.int32)
    split = decode_attention_split_ref(qt, kt, vt, pq, pk, n_split=n_split,
                                       split_len=split_len, window=window)
    plain = decode_attention_ref(qt, kt, vt, pq, pk, window=window)
    assert _maxerr(split.numpy(), plain.numpy()) < TOL
    assert bool((split[-1] == 0).all())


# ------------------------------------------------------------ partial mode
# B2's partial mode runs on one rank's slot range of a cache split over
# ranks; its plain version, folded over the ranges in rank order, must be
# the unsharded plain version.  (ranges, ring length, window, the rows'
# query positions): gemma3-1b's 512-slot ring over 8 ranks past its wrap,
# with the early row keeping nothing in most ranges; its ring over 256
# ranks (2 slots a rank); the 1024-slot global cache over 8 ranks at
# position 100 (7 of 8 ranges hold nothing kept)
PARTIAL_CASES = [
    ("ring over 8", 8, 512, 512, [543, 40, -1]),
    ("ring over 256", 256, 512, 512, [600, 3, 511]),
    ("global at 100", 8, 1024, None, [100, 100, 0]),
]


@pytest.mark.parametrize("case", PARTIAL_CASES, ids=[c[0] for c in PARTIAL_CASES])
def test_partial_mode_folded_over_ranges_is_the_plain_version(case):
    from repro_torch.kernels.decode_attention.ops import fold_partials
    from repro_torch.kernels.decode_attention.ref import decode_attention_partial_ref
    from repro_torch.models.attention import ring_positions

    _, ranks, sk, window, pos = case
    b, hkv, g, d = len(pos), 1, 4, 64
    rng = np.random.default_rng(sk + ranks)
    qt, kt, vt = (torch.from_numpy(a) for a in _inputs(rng, b, sk, hkv, g, d))
    pq = torch.tensor(pos, dtype=torch.int32)
    pk = torch.stack([ring_positions(max(p, 0), sk, 1, "cpu")[0] for p in pos])
    plain = decode_attention_ref(qt, kt, vt, pq, pk, window=window)
    n = sk // ranks
    outs, lses, empty = [], [], 0
    for r in range(ranks):
        sl = slice(r * n, (r + 1) * n)
        o, lse = decode_attention_partial_ref(qt, kt[:, sl], vt[:, sl], pq,
                                              pk[:, sl].contiguous(), window=window)
        assert o.dtype == lse.dtype == torch.float32
        outs.append(o)
        lses.append(lse)
        empty += int(torch.isinf(lse).all(dim=-1).sum())  # rows with no kept slot here
    folded = fold_partials(torch.stack(outs), torch.stack(lses))
    assert empty > 0
    assert _maxerr(folded.numpy(), plain.numpy()) < TOL


@pytest.mark.parametrize("window", [None, 32])
def test_partial_mode_lse_is_the_logsumexp_of_the_kept_scores(window):
    from repro_torch.kernels.decode_attention.ref import decode_attention_partial_ref

    b, sk, hkv, g, d = 3, 48, 2, 3, 64
    rng = np.random.default_rng(7)
    qt, kt, vt = (torch.from_numpy(a) for a in _inputs(rng, b, sk, hkv, g, d))
    pq = torch.tensor([47, 20, -5], dtype=torch.int32)
    pk = torch.arange(sk, dtype=torch.int32)[None].expand(b, sk)
    _, lse = decode_attention_partial_ref(qt, kt, vt, pq, pk, window=window)
    s = torch.einsum("bhgd,bkhd->bhgk", qt.reshape(b, hkv, g, d), kt) * d**-0.5
    dpos = pq[:, None].long() - pk.long()
    keep = (dpos >= 0) & ((dpos < window) if window else True)
    want = torch.logsumexp(s.masked_fill(~keep[:, None, None], float("-inf")), -1)
    want = want.reshape(b, hkv * g)
    assert torch.allclose(lse[:2], want[:2], atol=1e-5)
    assert bool(torch.isinf(lse[2]).all() and (lse[2] < 0).all())  # keeps nothing


def test_split_order_partial_mode_matches_the_partial_plain_version():
    """The kernel's order of work (splits of 32-slot tiles folded in cluster
    rank order) gives the partial mode's out and lse too."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_partial_ref

    b, sk, hkv, g, d = 2, 100, 2, 4, 64
    rng = np.random.default_rng(11)
    qt, kt, vt = (torch.from_numpy(a) for a in _inputs(rng, b, sk, hkv, g, d))
    pq = torch.tensor([70, 5], dtype=torch.int32)
    pk = torch.arange(sk, dtype=torch.int32)[None].expand(b, sk)
    o, lse = decode_attention_split_ref(qt, kt, vt, pq, pk, n_split=4, split_len=25,
                                        window=64, partial=True)
    ro, rlse = decode_attention_partial_ref(qt, kt, vt, pq, pk, window=64)
    assert _maxerr(o.numpy(), ro.numpy()) < TOL
    assert _maxerr(lse.numpy(), rlse.numpy()) < TOL
