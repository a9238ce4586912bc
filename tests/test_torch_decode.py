"""B2's launch plan and its order of work, on the CPU.

``split_plan`` cuts the cache into the splits that one cluster's blocks
fold, and ``decode_attention_split_ref`` is the kernel's order of work in
plain PyTorch (split by split, 32-slot tiles, the partials folded in cluster
rank order).  At the main path's plans it is held against the plain version
``decode_attention_ref`` and, where the Pallas kernel can express the mask
(no wrapped ring), against the Pallas kernel in interpret mode; GQA groups
1, 3 (granite-moe-3b-a800m), 4 and 48 (granite-34b's MQA), head dims 64,
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
