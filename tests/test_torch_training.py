"""The port's training path against the JAX package on h2o-danube-1.8b-smoke
(2 sliding-window layers, window 32, fp32), from the same checkpoint DU files
and the same batch (numpy, from a seed; seq 48 > window, so the window
masks):

* ``loss_fn`` (with and without remat, two CE chunk sizes) and
  ``make_eval_step`` against JAX ``impl="ref"``, and the forward against JAX
  ``impl="flash"`` (the Pallas kernel in interpret mode);
* one and two ``make_train_step`` steps against JAX ``make_train_step`` with
  microbatches 1 and 2: loss, grad_norm and lr of every step, then every
  param and every ``opt/`` leaf;
* the train state through checkpoint files both ways.

Tolerances (max |port - JAX| over max(1, max |JAX|)): 1e-4 for losses,
logits, grad norms, lrs and the AdamW moments; 2e-4 for params after the
update (an AdamW step moves a weight by up to lr = 1e-3, and m / sqrt(v) of
a gradient near 0 amplifies its last-bit differences); exact for files."""

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
from repro.configs import SMOKE_SHAPE
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.optim import init_adamw as jax_init_adamw
from repro.training.train_step import make_eval_step as jax_make_eval_step
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import train_state_from_files
from repro_torch.checkpoint import checkpoint_files, flatten_tree
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.optim import init_adamw
from repro_torch.training import make_eval_step, make_train_step

MODEL = "h2o-danube-1.8b-smoke"
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


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jax_get_config(MODEL)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    files = jax_checkpoint_files(0, "train-parity", jparams, jax_init_adamw(jparams))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    return jcfg, jparams, files, tokens, labels


def _port_state():
    _, _, files, tokens, labels = _setup()
    params, opt = train_state_from_files(files, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    return build_model(get_config(MODEL), device="cpu"), params, opt, batch


def _jax_batch():
    _, _, _, tokens, labels = _setup()
    return {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}


def test_loss_fn_and_eval_step_match_jax_ref():
    jcfg, jparams, _, _, _ = _setup()
    japi = jax_build_model(jcfg, impl="ref")
    api, params, _, batch = _port_state()
    jloss, jmetrics = japi.loss_fn(jparams, _jax_batch())
    for remat in (True, False):
        for ce_chunk in (512, 16):  # one chunk, and three
            loss, metrics = api.loss_fn(params, batch, remat=remat, ce_chunk=ce_chunk)
            assert _maxerr(_np(loss), jloss) < TOL
            assert set(metrics) == set(jmetrics) == {"ce", "aux", "loss"}
            assert _maxerr(_np(metrics["ce"]), jmetrics["ce"]) < TOL
            assert float(metrics["aux"]) == 0.0
    ev = make_eval_step(api)(params, batch)
    jev = jax_make_eval_step(japi)(jparams, _jax_batch())
    for key in ("ce", "loss"):
        assert _maxerr(_np(ev[key]), jev[key]) < TOL


def test_forward_matches_jax_flash_interpret():
    jcfg, jparams, _, tokens, _ = _setup()
    api, params, _, _ = _port_state()
    jlogits, _ = jax_build_model(jcfg, impl="flash").forward(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        logits = api.forward(params, torch.from_numpy(tokens))
        logits_remat = api.forward(params, torch.from_numpy(tokens), remat=True)
    assert logits.shape == (BATCH, SEQ, jcfg.vocab_size)
    assert _maxerr(_np(logits), jlogits) < TOL
    assert torch.equal(logits, logits_remat)


@functools.lru_cache(maxsize=None)
def _jax_trajectory(microbatches: int):
    """(metrics per step, params and opt state after each step) of two JAX
    train steps on the same batch."""
    jcfg, jparams, _, _, _ = _setup()
    step = jax.jit(jax_make_train_step(jax_build_model(jcfg, impl="ref"),
                                       microbatches=microbatches, **STEP_KW))
    params, opt = jparams, jax_init_adamw(jparams)
    out = []
    for _ in range(2):
        params, opt, metrics = step(params, opt, _jax_batch())
        out.append((jax.device_get(metrics), jax.device_get(params), jax.device_get(opt)))
    return out


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("n_steps", [1, 2])
def test_train_steps_match_jax(microbatches, n_steps):
    ref = _jax_trajectory(microbatches)
    api, params, opt, batch = _port_state()
    step = make_train_step(api, microbatches=microbatches, **STEP_KW)
    for i in range(n_steps):
        params, opt, metrics = step(params, opt, batch)
        jmetrics = ref[i][0]
        assert set(metrics) == set(jmetrics)
        for key in ("loss", "ce", "grad_norm", "lr"):
            assert _maxerr(_np(metrics[key]), jmetrics[key]) < TOL, (i, key)
    _, jparams, jopt = ref[n_steps - 1]
    assert float(metrics["lr"]) == np.float32(0.0 if n_steps == 1 else STEP_KW["peak_lr"])
    jp = dict(jax_flatten_tree(jparams))
    tp = dict(flatten_tree(params))
    assert sorted(jp) == sorted(tp)
    for path, leaf in jp.items():
        assert _maxerr(_np(tp[path]), leaf) < PARAM_TOL, path
    jo = dict(jax_flatten_tree(jopt))
    to = dict(flatten_tree(opt))
    assert sorted(jo) == sorted(to)
    assert int(to["step"]) == int(jo["step"]) == n_steps
    for path, leaf in jo.items():
        tol = PARAM_TOL if path.startswith("master/") else TOL
        assert _maxerr(_np(to[path]), leaf) < tol, path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_state_crosses_checkpoint_files_both_ways(dtype):
    jcfg = dataclasses.replace(jax_get_config(MODEL), param_dtype=dtype, compute_dtype=dtype)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
    jopt = jax_init_adamw(jparams)
    jfiles = jax_checkpoint_files(7, "run", jparams, jopt)
    params, opt = train_state_from_files(jfiles, device="cpu")
    assert opt["step"].dtype == torch.int32 and opt["master"]["embed"]["table"].dtype == torch.float32
    for jtree, ttree in ((jparams, params), (jopt, opt)):
        jl, tl = dict(jax_flatten_tree(jtree)), dict(flatten_tree(ttree))
        assert sorted(jl) == sorted(tl)
        for path, leaf in jl.items():
            np.testing.assert_array_equal(_np(tl[path]), np.asarray(leaf, np.float32)
                                          if leaf.dtype == jnp.bfloat16 else np.asarray(leaf))
    # the port's files, read by the JAX loader leaf for leaf
    pfiles = checkpoint_files(7, "run", params, init_adamw(params))
    assert sorted(pfiles) == sorted(jfiles)
    for rel, data in jfiles.items():
        if rel.endswith(".npy"):
            a, b = jax_decode_array(pfiles[rel]), jax_decode_array(data)
            assert a.dtype == b.dtype and a.shape == b.shape, rel
            assert a.tobytes() == b.tobytes(), rel


def test_batch_spec_matches_jax():
    jspec = jax_build_model(jax_get_config(MODEL)).batch_spec(SMOKE_SHAPE)
    spec = build_model(get_config(MODEL), device="cpu").batch_spec(SMOKE_SHAPE)
    assert {k: (s, str(d).split(".")[-1]) for k, (s, d) in spec.items()} == {
        k: (s, jnp.dtype(d).name) for k, (s, d) in jspec.items()
    }
