"""The port's model against the JAX reference (``impl="ref"``) from the same
checkpoint files: decode on gemma3-1b-smoke with a 4-slot sliding-window
ring over 12 tokens (the ring wraps 3 times), in fp32 and bf16, and the
port's decode against its own teacher-forced forward; granite-moe-3b-a800m-
smoke (MoE, GQA group 3): forward logits, the aux loss and ``loss_fn``, and
engine tokens on the bf16 and the int8 KV cache; the int8 cache's decode
logits and leaves (granite, and h2o-danube-1.8b-smoke past its ring wrap),
and its quantiser bit for bit on the same values; the dense models served
at their published attention shapes, h2o-danube-1.8b-smoke at head dim 80
(past its ring wrap) and granite-34b-smoke at 48/1 heads (MQA, group 48):
decode at every position against JAX and against the port's own forward.

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


# ------------------------------------------------ MoE and the int8 KV cache
# granite-moe-3b-a800m-smoke keeps granite's GQA group of 3 (6/2 heads);
# h2o-danube-1.8b-smoke at window 4 wraps its sliding-window ring 3 times
# in 12 positions, as tests/test_moe_blocked.py decodes it in JAX
GRANITE = ("granite-moe-3b-a800m-smoke", dict(n_heads=6, n_kv_heads=2))
DANUBE_RING = ("h2o-danube-1.8b-smoke", dict(sliding_window=4, n_layers=2))


def _setup_named(name, over, seed=0):
    jcfg = dataclasses.replace(jax_get_config(name), **over)
    tcfg = dataclasses.replace(get_config(name), **over)
    japi = jax_build_model(jcfg, impl="ref")
    jparams = japi.init(jax.random.PRNGKey(seed))
    files = checkpoint_files(0, "parity", jparams)
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (2, SEQ)).astype(np.int32)
    return japi, jparams, build_model(tcfg, device="cpu"), params_from_files(files, device="cpu"), tokens


def test_moe_forward_and_loss_match_jax():
    japi, jparams, tapi, tparams, tokens = _setup_named(*GRANITE)
    t = torch.from_numpy(tokens).long()
    jlogits, jaux = japi.forward(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        logits, aux = tapi.forward(tparams, t, return_aux=True)
    assert _maxerr(logits.numpy(), np.asarray(jlogits)) < TOL["float32"]
    assert abs(float(aux) - float(jaux)) < TOL["float32"] and float(aux) > 0
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    _, jm = japi.loss_fn(jparams, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    for remat in (False, True):
        with torch.no_grad():
            _, m = tapi.loss_fn(tparams, batch, remat=remat)
        for key in ("ce", "aux", "loss"):
            assert abs(float(m[key]) - float(jm[key])) < TOL["float32"], (key, remat)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_moe_engine_tokens_match_jax_engine(kv):
    from repro.serving import DecodeEngine as JaxDecodeEngine
    from repro_torch.serving import DecodeEngine

    over = dict(GRANITE[1], kv_cache_dtype=kv)
    japi, jparams, tapi, tparams, tokens = _setup_named(GRANITE[0], over, seed=2)
    ref = JaxDecodeEngine(japi, jparams, batch=2, max_len=SEQ).generate(
        jnp.asarray(tokens[:, :4]), SEQ - 4)
    out = DecodeEngine(tapi, tparams, batch=2, max_len=SEQ).generate(
        torch.from_numpy(tokens[:, :4]).long(), SEQ - 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", [GRANITE, DANUBE_RING], ids=["granite-moe", "danube-ring"])
def test_int8_cache_decode_matches_jax_ref(case):
    """Decode on the int8 cache against JAX ``impl="ref"`` at every position
    (after the ring wraps, for danube); the int8 leaves of the cache equal
    JAX's bit for bit and the scales agree to fp32 rounding (K and V come
    from products that round their last bit differently)."""
    name, over = case
    japi, jparams, tapi, tparams, tokens = _setup_named(name, dict(over, kv_cache_dtype="int8"))
    ref = _jax_decode(japi, jparams, tokens)
    out = _port_decode(tapi, tparams, tokens)
    for i in range(SEQ):
        assert _maxerr(out[:, i], ref[:, i]) < TOL["float32"], i
    from repro_torch.checkpoint import flatten_tree

    jc, tc = japi.init_cache(2, SEQ), tapi.init_cache(2, SEQ)
    step = jax.jit(japi.decode_step)
    with torch.no_grad():
        for i in range(SEQ):
            _, jc = step(jparams, jc, jnp.asarray(tokens[:, i : i + 1]), jnp.int32(i))
            _, tc = tapi.decode_step(tparams, tc, torch.from_numpy(tokens[:, i : i + 1]).long(), i)
    jleaves, tleaves = dict(flatten_tree(jc)), dict(flatten_tree(tc))
    assert sorted(jleaves) == sorted(tleaves)
    for key, leaf in jleaves.items():
        got = tleaves[key].numpy()
        assert got.dtype == np.asarray(leaf).dtype and got.shape == leaf.shape, key
        if key.endswith("scale"):
            np.testing.assert_allclose(got, np.asarray(leaf), rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got, np.asarray(leaf), err_msg=key)


def test_int8_quantiser_matches_jax_bit_for_bit():
    """Identity K and V projections at position 0 (RoPE the identity) write
    x itself into the cache, so both frameworks quantise the same values:
    rows whose max |x| is 127 (scale 1) with exact halves, which round to
    even, a zero row (scale floored at 1e-8) and random rows."""
    from repro.models.attention import attention_block as jax_attention_block
    from repro_torch.models.attention import attention_block
    from repro_torch.models.layers import rope_frequencies

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m-smoke"), d_model=32, n_heads=2,
                              n_kv_heads=2, head_dim=16, kv_cache_dtype="int8")
    jcfg = dataclasses.replace(jax_get_config("granite-moe-3b-a800m-smoke"), d_model=32,
                               n_heads=2, n_kv_heads=2, head_dim=16, kv_cache_dtype="int8")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1, 32)).astype(np.float32) * 5
    x[0, 0, :16] = [127, 2.5, -3.5, 0.5, 1.5, -0.5, 126.5, -2.5, 4.5, 5.5, 0, 3, -127, 6.5, 7.5, 8.5]
    x[1, 0, 16:] = 0.0
    eye = np.eye(32, dtype=np.float32)
    w = {n: rng.standard_normal((32, 32)).astype(np.float32) for n in ("q", "o")}
    w.update(k=eye, v=eye)
    jparams = {n: {"w": jnp.asarray(a)} for n, a in w.items()}
    tparams = {n: {"w": torch.from_numpy(a)} for n, a in w.items()}
    pos = np.zeros((3, 1), np.int32)
    jcache = {n: jnp.zeros((3, 4, 2, 16), jnp.int8) for n in ("k", "v")}
    jcache.update({f"{n}_scale": jnp.zeros((3, 4, 2), jnp.float32) for n in ("k", "v")})
    _, jnew = jax_attention_block(jparams, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                  cache=jcache, cache_index=jnp.int32(0))
    tcache = {n: torch.from_numpy(np.array(a)) for n, a in jcache.items()}
    tpos = torch.from_numpy(pos)
    attention_block(tparams, torch.from_numpy(x), tpos, cfg, rope=rope_frequencies(16, tpos, 1e4),
                    cache=tcache, cache_index=0,
                    positions_k=torch.tensor([[0, -4, -3, -2]] * 3, dtype=torch.int32))
    for n in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(tcache[n].numpy(), np.asarray(jnew[n]), err_msg=n)
    assert tcache["k"][0, 0, 0, :4].tolist() == [127, 2, -4, 0]  # halves to even
    assert float(tcache["k_scale"][1, 0, 1]) == np.float32(1e-8)


# ------------------------------------------------ dense serving shapes
# h2o-danube-1.8b's head dim 80 (its 4-slot window ring wraps 3 times in 12
# positions) and granite-34b's 48 query heads over one kv head
DANUBE_D80 = ("h2o-danube-1.8b-smoke", dict(head_dim=80, sliding_window=4))
GRANITE_34B = ("granite-34b-smoke", dict(n_heads=48, n_kv_heads=1))


@pytest.mark.parametrize("case", [DANUBE_D80, GRANITE_34B], ids=["danube-d80", "granite-34b-g48"])
def test_dense_serve_decode_matches_jax_ref(case):
    """Decode logits at every position against JAX ``impl="ref"`` from the
    same checkpoint files, and against the port's teacher-forced forward."""
    japi, jparams, tapi, tparams, tokens = _setup_named(*case, seed=3)
    ref = _jax_decode(japi, jparams, tokens)
    out = _port_decode(tapi, tparams, tokens)
    for i in range(SEQ):
        assert _maxerr(out[:, i], ref[:, i]) < TOL["float32"], i
    with torch.no_grad():
        full = tapi.forward(tparams, torch.from_numpy(tokens).long())
    assert _maxerr(out, full.numpy()) < TOL["float32"]
