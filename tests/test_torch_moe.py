"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on the same inputs, made with numpy from a
seed, with the experts of one layer of granite-moe-3b-a800m-smoke (8
experts, top 2) from the same checkpoint files.

* ``_route``: the expert ids equal; the gates and the aux loss within 1e-6
  (the router's fp32 product sums in another order in the two frameworks,
  so the last bit may differ);
* ``_capacity`` equal, and ``_dispatch_tables`` element for element on the
  same expert ids, in cases that drop tokens;
* ``moe_mlp_local`` within 1e-5 of max(1, max |JAX|), with and without
  dropping;
* the parameter tree's keys, shapes and dtypes equal JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpoint_files
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro_torch.bridge import params_from_files
from repro_torch.checkpoint import flatten_tree
from repro_torch.configs import get_config
from repro_torch.models import build_model, moe

SMOKE = dict(n_heads=6, n_kv_heads=2)  # granite's GQA group of 3


def _cfgs(capacity_factor=None):
    jcfg = dataclasses.replace(jax_get_config("granite-moe-3b-a800m-smoke"), **SMOKE)
    tcfg = dataclasses.replace(get_config("granite-moe-3b-a800m-smoke"), **SMOKE)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=capacity_factor))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def layer():
    """Layer 0's MoE params, JAX's and the port's from the same files."""
    jcfg, _ = _cfgs()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_files(checkpoint_files(0, "moe", jparams), device="cpu")
    jl = jax.tree.map(lambda a: a[0], jparams["groups"]["pos0"]["moe"])
    tl = {k: {"w": v["w"][0]} if isinstance(v, dict) else v[0]
          for k, v in tparams["groups"]["pos0"]["moe"].items()}
    return jl, tl


def _maxerr(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


@pytest.mark.parametrize("t", [1, 4, 48])
def test_route_matches_jax(layer, t):
    jl, tl = layer
    jcfg, tcfg = _cfgs()
    x = np.random.default_rng(t).standard_normal((t, jcfg.d_model)).astype(np.float32)
    gates, idx, aux = jax_moe._route(jnp.asarray(x), jl, jcfg)
    tgates, tidx, taux = moe._route(torch.from_numpy(x), tl, tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(tgates.numpy(), np.asarray(gates), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-6)
    assert tgates.dtype == torch.float32 and tidx.shape == (t, jcfg.moe.top_k)


@pytest.mark.parametrize("t", [1, 4, 37, 1120])
@pytest.mark.parametrize("cf", [1.25, 0.25, 5.0])
def test_capacity_matches_jax(t, cf):
    jcfg, tcfg = _cfgs(cf)
    assert moe._capacity(t, tcfg) == jax_moe._capacity(t, jcfg)


# (label, T, k, E, cap, how the ids are drawn)
DISPATCH = [
    ("uniform, cap 8", 48, 2, 8, 8, "uniform"),
    ("skewed to expert 0", 40, 2, 8, 8, "skewed"),
    ("granite decode, no drop", 4, 8, 40, 8, "uniform"),
]


@pytest.mark.parametrize("case", DISPATCH, ids=[c[0] for c in DISPATCH])
def test_dispatch_tables_match_jax(case):
    _, t, k, e, cap, how = case
    rng = np.random.default_rng(t + k + e)
    # k distinct experts per token, as top-k picks them
    if how == "skewed":
        p = np.array([0.5] + [0.5 / (e - 1)] * (e - 1))
        idx = np.stack([rng.choice(e, k, replace=False, p=p) for _ in range(t)])
    else:
        idx = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    idx = idx.astype(np.int32)
    slot_table, token_slots = jax_moe._dispatch_tables(jnp.asarray(idx), t, e, cap)
    tslot_table, ttoken_slots = moe._dispatch_tables(torch.from_numpy(idx).long(), t, e, cap)
    assert tslot_table.dtype == ttoken_slots.dtype == torch.int32
    np.testing.assert_array_equal(tslot_table.numpy(), np.asarray(slot_table))
    np.testing.assert_array_equal(ttoken_slots.numpy(), np.asarray(token_slots))
    dropped = int((ttoken_slots == e * cap).sum())
    counts = np.bincount(idx.reshape(-1), minlength=e)
    assert dropped == int(np.maximum(counts - cap, 0).sum())
    if how == "uniform" and k < 8:
        assert dropped > 0  # the case exercises dropping


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("b,s", [(2, 12), (4, 1)])
def test_moe_mlp_local_matches_jax(layer, cf, b, s):
    jl, tl = layer
    jcfg, tcfg = _cfgs(cf)
    x = np.random.default_rng(b * s).standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    y, aux = jax_moe.moe_mlp_local(jl, jnp.asarray(x), jcfg)
    ty, taux = moe.moe_mlp_local(tl, torch.from_numpy(x), tcfg)
    assert ty.shape == (b, s, jcfg.d_model) and ty.dtype == torch.float32
    assert _maxerr(ty.numpy(), np.asarray(y)) < 1e-5
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-6)


def test_params_tree_matches_jax():
    jcfg, tcfg = _cfgs()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    jtree = {k: (v.shape, str(v.dtype)) for k, v in flatten_tree(jparams)}
    ttree = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
             for k, v in flatten_tree(build_model(tcfg, device="cpu").init(seed=0))}
    assert ttree == jtree
    assert ttree["groups/pos0/moe/router/w"] == ((2, 64, 8), "float32")
    assert ttree["groups/pos0/moe/down"] == ((2, 8, 32, 64), "float32")
