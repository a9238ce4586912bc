"""The port's MoE training path against the JAX package on
granite-moe-3b-a800m-smoke with 6/2 heads (granite's GQA group of 3; 2
layers, 8 experts top 2, fp32), from the same checkpoint DU files and the
same batch (numpy, from a seed), at the published capacity factor 1.25 and
at 0.5, at which every expert's capacity is below its mean load, so pairs
are dropped (the test counts them):

* ``loss_fn``'s gradients, with and without remat, against
  ``jax.value_and_grad`` leaf by leaf: the router's through the gates and
  the aux loss, the experts' through the dispatch gathers;
* with remat, the routing that the backward pass recomputes equals the
  forward's, expert for expert and slot for slot;
* one and two ``make_train_step`` steps at microbatches 1 and 2 against
  JAX ``make_train_step``: loss, ce, aux, grad_norm and lr, then every
  param and every ``opt/`` leaf.

Tolerances as in ``test_torch_training.py`` (max |port - JAX| over
max(1, max |JAX|)): 1e-4 for losses, gradients, grad norms and the AdamW
moments; 2e-4 for params and masters after an update."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpoint_files as jax_checkpoint_files
from repro.checkpoint import flatten_tree as jax_flatten_tree
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.optim import init_adamw as jax_init_adamw
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import train_state_from_files
from repro_torch.checkpoint import flatten_tree
from repro_torch.configs import get_config
from repro_torch.models import build_model, moe
from repro_torch.training import make_train_step

MODEL = "granite-moe-3b-a800m-smoke"
TOL = 1e-4
PARAM_TOL = 2e-4
BATCH, SEQ = 4, 16
STEP_KW = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
#: the published capacity factor, and one whose capacity (8 slots for a mean
#: load of 16 pairs an expert at 64 tokens, and of 8 at 32) must drop
FACTORS = [1.25, 0.5]


def _maxerr(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = max(1.0, float(np.abs(b).max()))
    return float(np.abs(a - b).max()) / scale


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def _cfg(get, cf):
    cfg = dataclasses.replace(get(MODEL), n_heads=6, n_kv_heads=2)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


@functools.lru_cache(maxsize=None)
def _setup(cf):
    jcfg = _cfg(jax_get_config, cf)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    files = jax_checkpoint_files(0, "moe-train-parity", jparams, jax_init_adamw(jparams))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    return jcfg, jparams, files, {"tokens": tokens, "labels": labels}


def _port_state(cf):
    _, _, files, batch = _setup(cf)
    params, opt = train_state_from_files(files, device="cpu")
    api = build_model(_cfg(get_config, cf), device="cpu")
    return api, params, opt, {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(cf):
    return {k: jnp.asarray(v) for k, v in _setup(cf)[3].items()}


@functools.lru_cache(maxsize=None)
def _jax_grads(cf):
    jcfg, jparams, _, _ = _setup(cf)
    fn = jax.jit(jax.value_and_grad(jax_build_model(jcfg).loss_fn, has_aux=True))
    (loss, metrics), grads = fn(jparams, _jax_batch(cf))
    return jax.device_get(metrics), dict(jax_flatten_tree(jax.device_get(grads)))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("cf", FACTORS)
def test_loss_grads_match_jax(cf, remat, monkeypatch):
    jm, jgrads = _jax_grads(cf)
    api, params, _, batch = _port_state(cf)
    tables = []  # (expert ids, token slots, dropped pairs) of every dispatch
    dispatch = moe._dispatch_tables

    def recording(expert_idx, n_tokens, e_pad, cap):
        slot_table, token_slots = dispatch(expert_idx, n_tokens, e_pad, cap)
        tables.append((expert_idx, token_slots, int((token_slots == e_pad * cap).sum())))
        return slot_table, token_slots

    monkeypatch.setattr(moe, "_dispatch_tables", recording)
    leaves = flatten_tree(params)
    tensors = [t.requires_grad_(True) for _, t in leaves]
    loss, m = api.loss_fn(params, batch, remat=remat)
    n_layers = api.cfg.n_layers
    assert len(tables) == n_layers
    grads = torch.autograd.grad(loss, tensors)
    for key in ("ce", "aux", "loss"):
        assert _maxerr(_np(m[key]), jm[key]) < TOL, key
    assert sorted(jgrads) == sorted(p for p, _ in leaves)
    for (path, _), g in zip(leaves, grads):
        assert _maxerr(_np(g), jgrads[path]) < TOL, path
    router = dict(zip((p for p, _ in leaves), grads))["groups/pos0/moe/router/w"]
    assert float(router.abs().max()) > 0
    dropped = sum(t[2] for t in tables[:n_layers])
    if cf < 1:
        assert dropped > 0
    # with remat the backward pass reran every layer's routing, the last
    # layer first: the same experts and the same slots as the forward, so
    # the same pairs dropped
    assert len(tables) == (2 if remat else 1) * n_layers
    for fwd, again in zip(tables[:n_layers], tables[n_layers:][::-1]):
        assert torch.equal(fwd[0], again[0]) and torch.equal(fwd[1], again[1])
        assert fwd[2] == again[2]


@functools.lru_cache(maxsize=None)
def _jax_trajectory(cf, microbatches):
    jcfg, jparams, _, _ = _setup(cf)
    step = jax.jit(jax_make_train_step(jax_build_model(jcfg), microbatches=microbatches,
                                       **STEP_KW))
    params, opt = jparams, jax_init_adamw(jparams)
    out = []
    for _ in range(2):
        params, opt, metrics = step(params, opt, _jax_batch(cf))
        out.append((jax.device_get(metrics), jax.device_get(params), jax.device_get(opt)))
    return out


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("n_steps", [1, 2])
@pytest.mark.parametrize("cf", FACTORS)
def test_train_steps_match_jax(cf, n_steps, microbatches):
    ref = _jax_trajectory(cf, microbatches)
    api, params, opt, batch = _port_state(cf)
    step = make_train_step(api, microbatches=microbatches, **STEP_KW)
    for i in range(n_steps):
        params, opt, metrics = step(params, opt, batch)
        assert set(metrics) == set(ref[i][0])
        assert float(metrics["aux"]) > 0
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert _maxerr(_np(metrics[key]), ref[i][0][key]) < TOL, (i, key)
    _, jparams, jopt = ref[n_steps - 1]
    tp, to = dict(flatten_tree(params)), dict(flatten_tree(opt))
    jp, jo = dict(jax_flatten_tree(jparams)), dict(jax_flatten_tree(jopt))
    assert sorted(jp) == sorted(tp) and sorted(jo) == sorted(to)
    for path, leaf in jp.items():
        assert _maxerr(_np(tp[path]), leaf) < PARAM_TOL, path
    for path, leaf in jo.items():
        tol = PARAM_TOL if path.startswith("master/") else TOL
        assert _maxerr(_np(to[path]), leaf) < tol, path
    assert int(to["step"]) == n_steps
