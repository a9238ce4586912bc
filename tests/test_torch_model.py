"""The port's model against the JAX reference (``impl="ref"``) from the same
checkpoint files: decode on gemma3-1b-smoke with a 4-slot sliding-window
ring over 12 tokens (the ring wraps 3 times), in fp32 and bf16, and the
port's decode against its own teacher-forced forward.

Tolerances: ``_maxerr`` below 1e-4 in fp32 and 2e-2 in bf16."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpoint_files
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.bridge import params_from_files
from repro_torch.configs import get_config
from repro_torch.models import build_model

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SEQ = 12


def _maxerr(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = max(1.0, float(np.abs(b).max()))
    return float(np.abs(a - b).max()) / scale


def _cfgs(dtype, n_layers):
    over = dict(sliding_window=4, n_layers=n_layers, param_dtype=dtype, compute_dtype=dtype)
    jcfg = dataclasses.replace(jax_get_config("gemma3-1b-smoke"), **over)
    tcfg = dataclasses.replace(get_config("gemma3-1b-smoke"), **over)
    return jcfg, tcfg


def _setup(dtype, n_layers, seed=0):
    jcfg, tcfg = _cfgs(dtype, n_layers)
    japi = jax_build_model(jcfg, impl="ref")
    jparams = japi.init(jax.random.PRNGKey(seed))
    files = checkpoint_files(0, "parity", jparams)
    tapi = build_model(tcfg, device="cpu")
    tparams = params_from_files(files, device="cpu")
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (2, SEQ)).astype(np.int32)
    return japi, jparams, tapi, tparams, tokens


def _jax_decode(api, params, tokens):
    cache = api.init_cache(tokens.shape[0], SEQ)
    step = jax.jit(api.decode_step)
    outs = []
    for i in range(SEQ):
        lg, cache = step(params, cache, jnp.asarray(tokens[:, i : i + 1]), jnp.int32(i))
        outs.append(np.asarray(lg[:, 0].astype(jnp.float32)))
    return np.stack(outs, axis=1)


def _port_decode(api, params, tokens):
    cache = api.init_cache(tokens.shape[0], SEQ)
    t = torch.from_numpy(tokens).long()
    outs = []
    with torch.no_grad():
        for i in range(SEQ):
            lg, cache = api.decode_step(params, cache, t[:, i : i + 1], i)
            outs.append(lg[:, 0].float().numpy())
    return np.stack(outs, axis=1)


@pytest.mark.parametrize(
    "dtype,n_layers", [("float32", 6), ("float32", 8), ("bfloat16", 8)]
)
def test_decode_matches_jax_ref_after_ring_wraps(dtype, n_layers):
    """At 8 layers the depth is one stacked group of the 6-block pattern plus
    a 2-block tail, as gemma3-1b's 26 = 4 x 6 + 2."""
    japi, jparams, tapi, tparams, tokens = _setup(dtype, n_layers)
    cache = tapi.init_cache(2, SEQ)
    assert cache["groups"]["pos0"]["k"].shape == (1, 2, 4, 1, 16)  # swa ring
    assert cache["groups"]["pos5"]["k"].shape == (1, 2, SEQ, 1, 16)  # global
    ref = _jax_decode(japi, jparams, tokens)
    out = _port_decode(tapi, tparams, tokens)
    for i in range(SEQ):
        assert _maxerr(out[:, i], ref[:, i]) < TOL[dtype], i


@pytest.mark.parametrize("n_layers", [6, 8])
def test_port_decode_matches_port_and_jax_forward(n_layers):
    japi, jparams, tapi, tparams, tokens = _setup("float32", n_layers, seed=1)
    t = torch.from_numpy(tokens).long()
    with torch.no_grad():
        full = tapi.forward(tparams, t)
        hidden = tapi.forward(tparams, t, return_hidden=True)
        last = tapi.forward(tparams, t, last_only=True)
    jfull, _ = japi.forward(jparams, jnp.asarray(tokens))
    assert full.shape == (2, SEQ, 256) and hidden.shape == (2, SEQ, 64)
    assert _maxerr(full.numpy(), np.asarray(jfull)) < TOL["float32"]
    assert _maxerr(last[:, 0].numpy(), full[:, -1].numpy()) < TOL["float32"]
    dec = _port_decode(tapi, tparams, tokens)
    assert _maxerr(dec, full.numpy()) < TOL["float32"]


def test_bf16_embed_rounds_sqrt_d_like_jax():
    """sqrt(1152) in bf16 is not the fp32 value; the port scales by the
    bf16-rounded factor, as the JAX package does."""
    from repro.models.layers import embed as jax_embed
    from repro_torch.models.layers import embed

    cfg = dataclasses.replace(
        get_config("gemma3-1b"), param_dtype="bfloat16", compute_dtype="bfloat16"
    )
    jcfg = dataclasses.replace(
        jax_get_config("gemma3-1b"), param_dtype="bfloat16", compute_dtype="bfloat16"
    )
    table = np.random.default_rng(0).standard_normal((16, cfg.d_model)).astype(np.float32)
    toks = np.array([[1, 7, 15]], np.int32)
    ref = jax_embed(jnp.asarray(toks), {"table": jnp.asarray(table, jnp.bfloat16)}, jcfg)
    out = embed(torch.from_numpy(toks).long(), {"table": torch.from_numpy(table).bfloat16()}, cfg)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_kv_cache_layouts_match_jax():
    from repro.models.attention import init_kv_cache as jax_init_kv_cache
    from repro.models.transformer import init_lm_cache as jax_init_lm_cache
    from repro_torch.checkpoint import flatten_tree
    from repro_torch.models.attention import init_kv_cache

    jcfg, tcfg = _cfgs("bfloat16", 8)
    ref = jax_init_kv_cache(jcfg, batch=2, max_len=10, n_layers=3)
    out = init_kv_cache(tcfg, batch=2, max_len=10, n_layers=3, device="cpu")
    assert {k: tuple(v.shape) for k, v in out.items()} == {k: v.shape for k, v in ref.items()}
    assert out["k"].dtype == torch.bfloat16
    jcache = dict(flatten_tree(jax_init_lm_cache(jcfg, 2, 10)))
    tcache = dict(flatten_tree(build_model(tcfg, device="cpu").init_cache(2, 10)))
    assert {k: v.shape for k, v in jcache.items()} == {k: tuple(v.shape) for k, v in tcache.items()}
