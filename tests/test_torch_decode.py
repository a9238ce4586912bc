"""B2's launch plan and its order of work, on the CPU.

``split_plan`` cuts the cache into the splits that one cluster's blocks
fold, and ``decode_attention_split_ref`` is the kernel's order of work in
plain PyTorch (split by split, 32-slot tiles, the partials folded in cluster
rank order).  At the main path's plans it is held against the plain version
``decode_attention_ref`` and, where the Pallas kernel can express the mask
(no wrapped ring), against the Pallas kernel in interpret mode.

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
