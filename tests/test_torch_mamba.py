"""The port's SSM and hybrid families against the JAX package, on weights
made by JAX and crossed over through ``checkpoint_files``: mamba2-370m-smoke
(3 mamba layers) and zamba2-1.2b-smoke (8 layers: one group of 5 mamba + 1
shared attention, then a tail of 2 mamba), chunk 16.

- ``mamba_block`` and ``mamba_decode_step`` against JAX's, on layer 0;
- ``forward`` logits against JAX ``forward`` with ``impl="ref"`` and
  ``impl="ssd_kernel"`` (the Pallas kernel in interpret mode);
- ``decode_step`` logits over 20 steps, past the first chunk;
- ``DecodeEngine.generate`` tokens equal to the JAX engine's;
- in bf16, the port's own decode against its own forward.

Tolerances: ``_maxerr`` (max error over max(1, max |ref|)) below 1e-4 in
fp32; 2e-2 for the bf16 decode against the bf16 forward (a bf16 residual
stream, rounded at other places by the two paths)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpoint_files
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.mamba2 import mamba_block as jax_mamba_block
from repro.models.mamba2 import mamba_decode_step as jax_mamba_decode_step
from repro.serving import DecodeEngine as JaxDecodeEngine
from repro_torch.bridge import params_from_files
from repro_torch.checkpoint import flatten_tree
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.mamba2 import mamba_block, mamba_decode_step
from repro_torch.models.transformer import _group_slice
from repro_torch.serving import DecodeEngine

MODELS = {"mamba2-370m": 3, "zamba2-1.2b": 8}  # smoke name -> layers
TOL = 1e-4
SEQ = 48  # three chunks of 16


def _maxerr(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = max(1.0, float(np.abs(b).max()))
    return float(np.abs(a - b).max()) / scale


def _cfgs(name, dtype="float32", groups=1):
    over = dict(n_layers=MODELS[name], param_dtype=dtype, compute_dtype=dtype)
    jcfg = dataclasses.replace(jax_get_config(name + "-smoke"), **over)
    tcfg = dataclasses.replace(get_config(name + "-smoke"), **over)
    return (dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, n_groups=groups)),
            dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, n_groups=groups)))


def _setup(name, dtype="float32", seed=0, groups=1):
    jcfg, tcfg = _cfgs(name, dtype, groups)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(seed))
    files = checkpoint_files(0, "parity", jparams)
    return jcfg, jparams, files, tcfg, build_model(tcfg, device="cpu"), params_from_files(files, "cpu")


def _tokens(cfg, seed=0, b=2, s=SEQ):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_param_and_cache_trees_match_jax():
    for name in MODELS:
        jcfg, jparams, files, tcfg, tapi, tparams = _setup(name)
        jtree = {k: v.shape for k, v in flatten_tree(jparams)}
        ttree = {k: tuple(v.shape) for k, v in flatten_tree(tapi.init(seed=0))}
        assert ttree == jtree
        jcache = {k: v.shape for k, v in flatten_tree(jax_build_model(jcfg).init_cache(2, 20))}
        tcache = {k: tuple(v.shape) for k, v in flatten_tree(tapi.init_cache(2, 20))}
        assert tcache == jcache
        assert tcache["groups/pos0/ssm"] == (tcfg.n_layers // len(tcfg.pattern), 2, 8, 16, 16)


@pytest.mark.parametrize("name,groups", [("mamba2-370m", 1), ("zamba2-1.2b", 1), ("mamba2-370m", 2)])
def test_mamba_block_and_decode_step_match_jax(name, groups):
    """Also at 2 groups over the 8 heads: B and C reach head h from group
    h // 4 in the chunk scan and in the decode step's broadcast."""
    jcfg, jparams, _, tcfg, _, tparams = _setup(name, groups=groups)
    jbp = jax.tree.map(lambda a: a[0], jparams["groups"]["pos0"]["mamba"])
    tbp = _group_slice(tparams["groups"]["pos0"], 0)["mamba"]
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 32, tcfg.d_model)).astype(np.float32)
    init = rng.standard_normal((2, 8, 16, 16)).astype(np.float32)
    for state in (None, init):
        js = None if state is None else jnp.asarray(state)
        ts = None if state is None else torch.from_numpy(state)
        out, fin = mamba_block(tbp, torch.from_numpy(u), tcfg, initial_state=ts)
        for impl in ("ref", "ssd_kernel"):
            jout, jfin = jax_mamba_block(jbp, jnp.asarray(u), jcfg, initial_state=js, impl=impl)
            assert _maxerr(out.detach().numpy(), jout) < TOL
            assert _maxerr(fin.detach().numpy(), jfin) < TOL

    jcache = jax_build_model(jcfg).init_cache(2, 8)["groups"]["pos0"]
    jcache = jax.tree.map(lambda a: a[0], jcache)
    tcache = {k: v[0] for k, v in build_model(tcfg, device="cpu").init_cache(2, 8)["groups"]["pos0"].items()}
    with torch.no_grad():
        for i in range(6):
            jout, jcache = jax_mamba_decode_step(jbp, jnp.asarray(u[:, i : i + 1]), jcache, jcfg)
            out = mamba_decode_step(tbp, torch.from_numpy(u[:, i : i + 1]), tcache, tcfg)
            assert _maxerr(out.numpy(), jout) < TOL
            for k in ("ssm", "conv_x", "conv_bc"):
                assert _maxerr(tcache[k].numpy(), jcache[k]) < TOL, k


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_and_decode_match_jax(name):
    jcfg, jparams, _, tcfg, tapi, tparams = _setup(name, seed=1)
    tokens = _tokens(tcfg, seed=1)
    with torch.no_grad():
        full = tapi.forward(tparams, torch.from_numpy(tokens).long())
        last = tapi.forward(tparams, torch.from_numpy(tokens).long(), last_only=True)
    assert full.shape == (2, SEQ, tcfg.vocab_size) and last.shape == (2, 1, tcfg.vocab_size)
    for impl in ("ref", "ssd_kernel"):
        jfull, _ = jax_build_model(jcfg, impl=impl).forward(jparams, jnp.asarray(tokens))
        assert _maxerr(full.numpy(), jfull) < TOL, impl
    assert _maxerr(last[:, 0].numpy(), full[:, -1].numpy()) < TOL

    japi = jax_build_model(jcfg, impl="ref")
    jcache, tcache = japi.init_cache(2, 20), tapi.init_cache(2, 20)
    step = jax.jit(japi.decode_step)
    with torch.no_grad():
        for i in range(20):
            jl, jcache = step(jparams, jcache, jnp.asarray(tokens[:, i : i + 1]), jnp.int32(i))
            tl, tcache = tapi.decode_step(tparams, tcache, torch.from_numpy(tokens[:, i : i + 1]).long(), i)
            assert _maxerr(tl.numpy(), jl) < TOL, i
            assert _maxerr(tl[:, 0].numpy(), full[:, i].numpy()) < TOL, i
    assert _maxerr(tcache["groups"]["pos0"]["ssm"].numpy(), jcache["groups"]["pos0"]["ssm"]) < TOL


@pytest.mark.parametrize("name", list(MODELS))
def test_generate_matches_jax_engine(name):
    jcfg, jparams, files, tcfg, tapi, _ = _setup(name, seed=2)
    prompts = _tokens(tcfg, seed=2, s=6)
    jeng = JaxDecodeEngine(jax_build_model(jcfg, impl="ref"), jparams, batch=2, max_len=20)
    ref = np.asarray(jeng.generate(jnp.asarray(prompts), 12))
    eng = DecodeEngine.from_files(tapi, files, batch=2, max_len=20)
    out = eng.generate(torch.from_numpy(prompts), 12)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_decode_matches_own_forward(name):
    _, _, _, tcfg, tapi, tparams = _setup(name, dtype="bfloat16", seed=3)
    tokens = torch.from_numpy(_tokens(tcfg, seed=3, s=32)).long()
    cache = tapi.init_cache(2, 32)
    with torch.no_grad():
        full = tapi.forward(tparams, tokens).float()
        for i in range(32):
            lg, cache = tapi.decode_step(tparams, cache, tokens[:, i : i + 1], i)
            assert lg.dtype == torch.bfloat16
            assert _maxerr(lg[:, 0].float().numpy(), full[:, i].numpy()) < 2e-2, i
