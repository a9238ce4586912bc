"""The port's encoder-decoder family (whisper) against the JAX package on
whisper-large-v3-smoke (2 encoder + 2 decoder layers, 16 frames, d_model 64,
4/2 heads of 16, fp32), from the same checkpoint DU files, frames and tokens
(numpy, from a seed):

* the parameter tree through checkpoint files both ways;
* ``encode``, ``forward`` (whole and ``last_only``) and ``loss_fn`` (remat on
  and off) against JAX ``impl="ref"``, and ``loss_fn``'s gradients against
  ``jax.value_and_grad`` leaf by leaf;
* one and two ``make_train_step`` steps (microbatches 1 and 2) against JAX
  ``make_train_step``;
* ``prefill_cross_cache``'s leaves, ``decode_step``'s logits and cache at
  every position, and ``DecodeEngine`` tokens with the cross cache filled
  as a JAX caller fills it; a decode past ``max_len`` raises (C4).

Tolerances (max |port - JAX| over max(1, max |JAX|)): 1e-4 for activations,
logits, losses, gradients, grad norms and the AdamW moments; 2e-4 for
params after an update (as in ``test_torch_training.py``: an AdamW step
moves a weight by up to lr, and m / sqrt(v) of a gradient near 0 amplifies
its last-bit differences); exact for files and tokens."""

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
from repro.models import whisper as jax_whisper
from repro.optim import init_adamw as jax_init_adamw
from repro.serving import DecodeEngine as JaxDecodeEngine
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_files, train_state_from_files
from repro_torch.checkpoint import checkpoint_files, flatten_tree
from repro_torch.configs import get_config
from repro_torch.models import build_model, whisper
from repro_torch.serving import DecodeEngine

MODEL = "whisper-large-v3-smoke"
TOL = 1e-4
PARAM_TOL = 2e-4
BATCH, SEQ = 4, 12
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
    files = jax_checkpoint_files(0, "whisper-parity", jparams, jax_init_adamw(jparams))
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((BATCH, jcfg.encdec.n_frames, jcfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    return jcfg, jparams, files, {"frames": frames, "tokens": tokens, "labels": labels}


def _port_state():
    _, _, files, batch = _setup()
    params, opt = train_state_from_files(files, device="cpu")
    api = build_model(get_config(MODEL), device="cpu")
    return api, params, opt, {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch():
    return {k: jnp.asarray(v) for k, v in _setup()[3].items()}


def test_params_tree_crosses_checkpoint_files_both_ways():
    jcfg, jparams, files, _ = _setup()
    api, params, _, _ = _port_state()
    own = api.init(seed=0)
    jl, tl, ol = (dict(flatten_tree(t)) for t in (jparams, params, own))
    assert sorted(jl) == sorted(tl) == sorted(ol)
    assert {k for k in params} == {"embed", "encoder", "enc_norm", "decoder", "final_norm"}
    assert set(params["encoder"]) == {"ln1", "attn", "ln2", "mlp"}
    assert set(params["decoder"]) == {"ln1", "self_attn", "ln_x", "cross_attn", "ln2", "mlp"}
    for path, leaf in jl.items():
        assert tuple(tl[path].shape) == tuple(ol[path].shape) == leaf.shape, path
        assert ol[path].dtype == tl[path].dtype, path
        np.testing.assert_array_equal(_np(tl[path]), np.asarray(leaf), err_msg=path)
    # the port's own init, written by the port, read by the JAX loader
    pfiles = checkpoint_files(0, "whisper", own)
    for path, leaf in ol.items():
        a = jax_decode_array(pfiles[f"params/{path}.npy"])
        assert a.shape == tuple(leaf.shape) and a.tobytes() == leaf.numpy().tobytes(), path


def test_encode_and_forward_match_jax_ref():
    jcfg, jparams, _, _ = _setup()
    api, params, _, batch = _port_state()
    jb = _jax_batch()
    jenc = jax_whisper.encode(jparams, jb["frames"], jcfg)
    jlogits, _ = jax_build_model(jcfg).forward(jparams, jb["frames"], jb["tokens"])
    with torch.no_grad():
        enc = whisper.encode(params, batch["frames"], api.cfg)
        enc_remat = whisper.encode(params, batch["frames"], api.cfg, remat=True)
        logits = api.forward(params, batch["frames"], batch["tokens"])
        last, aux = api.forward(params, batch["frames"], batch["tokens"], last_only=True,
                                return_aux=True)
    assert enc.shape == (BATCH, jcfg.encdec.n_frames, jcfg.d_model)
    assert _maxerr(_np(enc), jenc) < TOL
    assert torch.equal(enc, enc_remat)
    assert logits.shape == (BATCH, SEQ, jcfg.vocab_size)
    assert _maxerr(_np(logits), jlogits) < TOL
    assert torch.equal(last[:, 0], logits[:, -1]) and float(aux) == 0.0


def test_loss_fn_matches_jax_ref():
    jcfg, jparams, _, _ = _setup()
    api, params, _, batch = _port_state()
    jloss, jm = jax_build_model(jcfg).loss_fn(jparams, _jax_batch())
    for remat in (True, False):
        with torch.no_grad():
            loss, m = api.loss_fn(params, batch, remat=remat)
        assert set(m) == set(jm) == {"ce", "aux", "loss"}
        assert _maxerr(_np(loss), jloss) < TOL
        assert _maxerr(_np(m["ce"]), jm["ce"]) < TOL
        assert float(m["aux"]) == 0.0


@functools.lru_cache(maxsize=None)
def _jax_grads():
    jcfg, jparams, _, _ = _setup()
    japi = jax_build_model(jcfg)
    (loss, _), grads = jax.jit(jax.value_and_grad(japi.loss_fn, has_aux=True))(
        jparams, _jax_batch())
    return float(loss), dict(jax_flatten_tree(jax.device_get(grads)))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_grads_match_jax(remat):
    """Every leaf's gradient, the encoder's included: with remat each
    decoder layer recomputes its cross K/V, and the encoder output's
    gradient gathers all of them."""
    jloss, jgrads = _jax_grads()
    api, params, _, batch = _port_state()
    leaves = flatten_tree(params)
    tensors = [t.requires_grad_(True) for _, t in leaves]
    loss, _ = api.loss_fn(params, batch, remat=remat)
    grads = torch.autograd.grad(loss, tensors)
    assert _maxerr(_np(loss), jloss) < TOL
    assert sorted(jgrads) == sorted(p for p, _ in leaves)
    for (path, _), g in zip(leaves, grads):
        assert _maxerr(_np(g), jgrads[path]) < TOL, path
    assert float(dict(zip([p for p, _ in leaves], grads))["encoder/attn/q/w"].abs().max()) > 0


@functools.lru_cache(maxsize=None)
def _jax_trajectory(microbatches: int):
    jcfg, jparams, _, _ = _setup()
    step = jax.jit(jax_make_train_step(jax_build_model(jcfg), microbatches=microbatches,
                                       **STEP_KW))
    params, opt = jparams, jax_init_adamw(jparams)
    out = []
    for _ in range(2):
        params, opt, metrics = step(params, opt, _jax_batch())
        out.append((jax.device_get(metrics), jax.device_get(params), jax.device_get(opt)))
    return out


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("n_steps", [1, 2])
def test_train_steps_match_jax(microbatches, n_steps):
    from repro_torch.training import make_train_step

    ref = _jax_trajectory(microbatches)
    api, params, opt, batch = _port_state()
    step = make_train_step(api, microbatches=microbatches, **STEP_KW)
    for i in range(n_steps):
        params, opt, metrics = step(params, opt, batch)
        assert set(metrics) == set(ref[i][0])
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert _maxerr(_np(metrics[key]), ref[i][0][key]) < TOL, (i, key)
    _, jparams, jopt = ref[n_steps - 1]
    tp, to = dict(flatten_tree(params)), dict(flatten_tree(opt))
    for path, leaf in jax_flatten_tree(jparams):
        assert _maxerr(_np(tp[path]), leaf) < PARAM_TOL, path
    for path, leaf in jax_flatten_tree(jopt):
        tol = PARAM_TOL if path.startswith("master/") else TOL
        assert _maxerr(_np(to[path]), leaf) < tol, path
    assert int(to["step"]) == n_steps


def _jax_cache():
    jcfg, jparams, _, _ = _setup()
    cache = jax_whisper.init_encdec_cache(jcfg, BATCH, SEQ)
    return jax_whisper.prefill_cross_cache(jparams, _jax_batch()["frames"], cache, jcfg)


def _port_cache(api, params, batch):
    with torch.no_grad():
        return whisper.prefill_cross_cache(params, batch["frames"], api.init_cache(BATCH, SEQ),
                                           api.cfg)


def _assert_cache_matches(cache, jcache):
    jl, tl = dict(jax_flatten_tree(jcache)), dict(flatten_tree(cache))
    assert sorted(jl) == sorted(tl) == ["cross/k", "cross/v", "self/k", "self/v"]
    for key, leaf in jl.items():
        assert tuple(tl[key].shape) == leaf.shape and tl[key].dtype == torch.float32, key
        assert _maxerr(_np(tl[key]), leaf) < TOL, key


def test_prefill_cross_cache_and_decode_match_jax():
    """The cross cache after the prefill, then teacher-forced decode: the
    logits at every position and both caches after the last, against JAX;
    and against the port's own teacher-forced forward."""
    jcfg, jparams, _, _ = _setup()
    api, params, _, batch = _port_state()
    jcache, cache = _jax_cache(), _port_cache(api, params, batch)
    _assert_cache_matches(cache, jcache)
    assert not bool(cache["self"]["k"].any())
    tokens = _setup()[3]["tokens"]
    jstep = jax.jit(jax_build_model(jcfg).decode_step)
    with torch.no_grad():
        full = api.forward(params, batch["frames"], batch["tokens"])
        for i in range(SEQ):
            jlg, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, i : i + 1]), jnp.int32(i))
            lg, cache = api.decode_step(params, cache, batch["tokens"][:, i : i + 1].long(), i)
            assert lg.shape == (BATCH, 1, jcfg.vocab_size)
            assert _maxerr(_np(lg), jlg) < TOL, i
            assert _maxerr(_np(lg[:, 0]), _np(full[:, i])) < TOL, i
    _assert_cache_matches(cache, jcache)


def test_engine_tokens_match_jax_engine_and_stop_at_max_len():
    jcfg, jparams, _, _ = _setup()
    api, params, _, batch = _port_state()
    prompt = _setup()[3]["tokens"][:, :4]
    jeng = JaxDecodeEngine(jax_build_model(jcfg), jparams, batch=BATCH, max_len=SEQ)
    jeng.cache = jax_whisper.prefill_cross_cache(jparams, _jax_batch()["frames"], jeng.cache, jcfg)
    ref = jeng.generate(jnp.asarray(prompt), SEQ - 4)
    eng = DecodeEngine(api, params, batch=BATCH, max_len=SEQ)
    eng.cache = whisper.prefill_cross_cache(params, batch["frames"], eng.cache, api.cfg)
    out = eng.generate(torch.from_numpy(prompt).long(), SEQ - 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # the self cache is max_len long: a decode past it would wrap (C4);
    # positions 0-10 are fed, so 11 is the last one the cache holds
    with pytest.raises(ValueError, match=f"position {SEQ} is past max_len"):
        eng.prefill(out[:, -2:])


def test_params_from_files_and_batch_spec_match_jax():
    jcfg, _, files, _ = _setup()
    params = params_from_files(files, device="cpu")
    assert params["decoder"]["cross_attn"]["k"]["w"].shape == (2, 64, 2 * 16)
    jspec = jax_build_model(jcfg).batch_spec(SMOKE_SHAPE)
    spec = build_model(get_config(MODEL), device="cpu").batch_spec(SMOKE_SHAPE)
    assert {k: (s, str(d).split(".")[-1]) for k, (s, d) in spec.items()} == {
        k: (s, jnp.dtype(d).name) for k, (s, d) in jspec.items()
    }
