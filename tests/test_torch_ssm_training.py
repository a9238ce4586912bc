"""The port's SSM training path against the JAX package, on mamba2-370m-smoke
(3 mamba layers) and zamba2-1.2b-smoke, fp32, chunk 16, on 4 x 48 tokens
(three chunks), from the same checkpoint DU files and the same batch
(numpy, from a seed):

* ``loss_fn``'s gradients, with and without remat, against
  ``jax.value_and_grad`` leaf by leaf: every mamba layer's through the
  SSD scan's backward (on the CPU its plain version, ``ssd_bwd_ref``), and
  zamba2's ``shared/`` leaves, which JAX sums over the block's
  occurrences.  zamba2 is cut to 14 layers here: two stacked groups of 5
  mamba + the one shared attention block, both checkpointed with remat,
  then a tail of 2 mamba without it;
* one and two ``make_train_step`` steps at microbatches 1 and 2 against JAX
  ``make_train_step``: loss, ce, grad_norm and lr, then every param and
  every ``opt/`` leaf.  zamba2 runs at 8 layers here (one group and the
  tail, as in ``test_torch_mamba.py``): at 14, one out_proj entry's
  gradient is -8.3e-9, 1.5e-7 of its leaf's largest, below fp32's noise,
  and AdamW's m / sqrt(v) turns its sign into a step of opposite sign in
  the two frameworks (the same with autograd through ``ssd_ref``);
* the train state through checkpoint files both ways.

Tolerances as in ``test_torch_training.py`` (max |port - JAX| over max(1,
max |JAX|)): 1e-4 for losses, gradients, grad norms and the AdamW moments;
2e-4 for params and masters after an update; exact for files."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpoint_files as jax_checkpoint_files
from repro.checkpoint import decode_array as jax_decode_array
from repro.checkpoint import flatten_tree as jax_flatten_tree
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.optim import init_adamw as jax_init_adamw
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import train_state_from_files
from repro_torch.checkpoint import checkpoint_files, flatten_tree
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import build_model
from repro_torch.optim import init_adamw
from repro_torch.training import make_train_step

#: smoke name -> layers of the gradient test, and of the train-step and file tests
GRAD_LAYERS = {"mamba2-370m": 3, "zamba2-1.2b": 14}
STEP_LAYERS = {"mamba2-370m": 3, "zamba2-1.2b": 8}
MODELS = sorted(GRAD_LAYERS)
TOL = 1e-4
PARAM_TOL = 2e-4
BATCH, SEQ = 4, 48
STEP_KW = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)


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


def _cfg(get, name, layers, dtype="float32"):
    return dataclasses.replace(get(name + "-smoke"), n_layers=layers, param_dtype=dtype,
                               compute_dtype=dtype)


@functools.lru_cache(maxsize=None)
def _setup(name, layers):
    jcfg = _cfg(jax_get_config, name, layers)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    files = jax_checkpoint_files(0, "ssm-train-parity", jparams, jax_init_adamw(jparams))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    return jcfg, jparams, files, {"tokens": tokens, "labels": labels}


def _port_state(name, layers):
    _, _, files, batch = _setup(name, layers)
    params, opt = train_state_from_files(files, device="cpu")
    api = build_model(_cfg(get_config, name, layers), device="cpu")
    return api, params, opt, {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(name, layers):
    return {k: jnp.asarray(v) for k, v in _setup(name, layers)[3].items()}


@functools.lru_cache(maxsize=None)
def _jax_grads(name):
    jcfg, jparams, _, _ = _setup(name, GRAD_LAYERS[name])
    fn = jax.jit(jax.value_and_grad(jax_build_model(jcfg).loss_fn, has_aux=True))
    (loss, metrics), grads = fn(jparams, _jax_batch(name, GRAD_LAYERS[name]))
    return jax.device_get(metrics), dict(jax_flatten_tree(jax.device_get(grads)))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", MODELS)
def test_loss_grads_match_jax(name, remat):
    jm, jgrads = _jax_grads(name)
    api, params, _, batch = _port_state(name, GRAD_LAYERS[name])
    leaves = flatten_tree(params)
    tensors = [t.requires_grad_(True) for _, t in leaves]
    n_mamba = api.cfg.layer_kinds().count("mamba")
    before = ssd_ops.ssd_bwd_ref
    calls = []

    def counting(*a, **k):
        calls.append(1)
        return before(*a, **k)

    ssd_ops.ssd_bwd_ref = counting
    try:
        loss, m = api.loss_fn(params, batch, remat=remat)
        grads = torch.autograd.grad(loss, tensors)
    finally:
        ssd_ops.ssd_bwd_ref = before
    assert len(calls) == n_mamba  # one backward of the scan per mamba layer
    for key in ("ce", "loss"):
        assert _maxerr(_np(m[key]), jm[key]) < TOL, key
    assert sorted(jgrads) == sorted(p for p, _ in leaves)
    by_path = dict(zip((p for p, _ in leaves), grads))
    for path, g in by_path.items():
        assert _maxerr(_np(g), jgrads[path]) < TOL, path
    for key in ("A_log", "dt_bias", "D", "conv_bc_w"):  # reached only through the scan
        assert float(by_path[f"groups/pos0/mamba/{key}"].abs().max()) > 0, key
    shared = [p for p in by_path if p.startswith("shared/")]
    assert bool(shared) == (name == "zamba2-1.2b")
    for path in shared:
        assert float(by_path[path].abs().max()) > 0, path


@functools.lru_cache(maxsize=None)
def _jax_trajectory(name, microbatches):
    jcfg, jparams, _, _ = _setup(name, STEP_LAYERS[name])
    step = jax.jit(jax_make_train_step(jax_build_model(jcfg), microbatches=microbatches,
                                       **STEP_KW))
    params, opt = jparams, jax_init_adamw(jparams)
    out = []
    for _ in range(2):
        params, opt, metrics = step(params, opt, _jax_batch(name, STEP_LAYERS[name]))
        out.append((jax.device_get(metrics), jax.device_get(params), jax.device_get(opt)))
    return out


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("n_steps", [1, 2])
@pytest.mark.parametrize("name", MODELS)
def test_train_steps_match_jax(name, n_steps, microbatches):
    ref = _jax_trajectory(name, microbatches)
    api, params, opt, batch = _port_state(name, STEP_LAYERS[name])
    step = make_train_step(api, microbatches=microbatches, **STEP_KW)
    for i in range(n_steps):
        params, opt, metrics = step(params, opt, batch)
        assert set(metrics) == set(ref[i][0])
        for key in ("loss", "ce", "grad_norm", "lr"):
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_train_state_crosses_checkpoint_files_both_ways(name, dtype):
    jcfg = _cfg(jax_get_config, name, STEP_LAYERS[name], dtype)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
    jopt = jax_init_adamw(jparams)
    jfiles = jax_checkpoint_files(7, "run", jparams, jopt)
    params, opt = train_state_from_files(jfiles, device="cpu")
    for jtree, ttree in ((jparams, params), (jopt, opt)):
        jl, tl = dict(jax_flatten_tree(jtree)), dict(flatten_tree(ttree))
        assert sorted(jl) == sorted(tl)
        for path, leaf in jl.items():
            np.testing.assert_array_equal(_np(tl[path]), np.asarray(leaf, np.float32)
                                          if leaf.dtype == jnp.bfloat16 else np.asarray(leaf))
    pfiles = checkpoint_files(7, "run", params, init_adamw(params))
    assert sorted(pfiles) == sorted(jfiles)
    for rel, data in jfiles.items():
        if rel.endswith(".npy"):
            a, b = jax_decode_array(pfiles[rel]), jax_decode_array(data)
            assert a.dtype == b.dtype and a.shape == b.shape, rel
            assert a.tobytes() == b.tobytes(), rel
