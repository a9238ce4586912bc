"""Every architecture the port serves or trains without a test of its own,
held to the JAX package (``impl="ref"``) from the same checkpoint files:
llava-next-mistral-7b (a VLM: patch embeddings prepended through
``prefix_embeds``), gemma3-12b (sliding-window and global layers),
qwen3-moe-30b-a3b (MoE) and granite-34b, each at its smoke size, and
granite-34b also at its published 48 query heads over one kv head (MQA,
group 48) as ``test_torch_model.py`` builds it.

The inputs are ``make_fake_batch``'s (numpy, from a seed), handed to both.
Each check is one case per architecture: the forward's logits, ``loss_fn``
(loss, ce, aux), every gradient leaf of the loss with remat on and off, and
8 decode steps; llava once more with a ``loss_mask`` (loss and gradients).

Tolerance: fp32, max |port - JAX| within 1e-4 of the JAX tensor's max |x|
(each gradient leaf on its own)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpoint_files
from repro.checkpoint import flatten_tree as jax_flatten_tree
from repro.configs import SMOKE_SHAPE
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.registry import make_fake_batch
from repro_torch.bridge import params_from_files
from repro_torch.checkpoint import flatten_tree
from repro_torch.configs import get_config
from repro_torch.models import build_model

TOL = 1e-4
DECODE_STEPS = 8
#: (case id, config, overrides of its smoke size)
ARCHS = {
    "llava-next-mistral-7b": ("llava-next-mistral-7b-smoke", {}),
    "gemma3-12b": ("gemma3-12b-smoke", {}),
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b-smoke", {}),
    "granite-34b": ("granite-34b-smoke", {}),
    "granite-34b-g48": ("granite-34b-smoke", dict(n_heads=48, n_kv_heads=1)),
}


def _relerr(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _setup(arch, loss_mask=False):
    name, over = ARCHS[arch]
    jcfg = dataclasses.replace(jax_get_config(name), **over)
    japi = jax_build_model(jcfg, impl="ref")
    jparams = japi.init(jax.random.PRNGKey(0))
    files = checkpoint_files(0, "arch-parity", jparams)
    batch = {k: np.asarray(v) for k, v in make_fake_batch(
        jcfg, SMOKE_SHAPE, jax.random.PRNGKey(1)).items()}
    if loss_mask:  # every third text position counts
        batch["loss_mask"] = (np.arange(batch["labels"].size) % 3 == 0).reshape(
            batch["labels"].shape).astype(np.float32)
    return japi, jparams, files, batch


def _port(arch, loss_mask=False):
    name, over = ARCHS[arch]
    _, _, files, batch = _setup(arch, loss_mask)
    api = build_model(dataclasses.replace(get_config(name), **over), device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return api, params_from_files(files, device="cpu"), tbatch


def _jbatch(arch, loss_mask=False):
    return {k: jnp.asarray(v) for k, v in _setup(arch, loss_mask)[3].items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    japi, jparams, _, batch = _setup(arch)
    api, params, tbatch = _port(arch)
    jb = _jbatch(arch)
    ref, _ = japi.forward(jparams, jb["tokens"], prefix_embeds=jb.get("prefix_embeds"))
    with torch.no_grad():
        out = api.forward(params, tbatch["tokens"], prefix_embeds=tbatch.get("prefix_embeds"))
    if "prefix_embeds" in batch:  # the patches come first, then the text
        assert out.shape[1] == batch["prefix_embeds"].shape[1] + batch["tokens"].shape[1]
    assert _relerr(_np(out), ref) < TOL


def _loss_case(arch, loss_mask):
    japi, jparams, _, _ = _setup(arch, loss_mask)
    api, params, tbatch = _port(arch, loss_mask)
    _, jm = japi.loss_fn(jparams, _jbatch(arch, loss_mask))
    with torch.no_grad():
        _, m = api.loss_fn(params, tbatch)
    for key in ("loss", "ce", "aux"):
        assert abs(float(m[key]) - float(jm[key])) <= TOL * max(abs(float(jm[key])), 1e-30), key


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    _loss_case(arch, loss_mask=False)


@functools.lru_cache(maxsize=None)
def _jax_grads(arch, remat, loss_mask):
    japi, jparams, _, _ = _setup(arch, loss_mask)
    grads = jax.jit(jax.grad(lambda p, b: japi.loss_fn(p, b, remat=remat)[0]))(
        jparams, _jbatch(arch, loss_mask))
    return dict(jax_flatten_tree(jax.device_get(grads)))


def _grads_case(arch, remat, loss_mask):
    ref = _jax_grads(arch, remat, loss_mask)
    api, params, tbatch = _port(arch, loss_mask)
    leaves = flatten_tree(params)
    tensors = [t.requires_grad_(True) for _, t in leaves]
    loss, _ = api.loss_fn(params, tbatch, remat=remat)
    grads = torch.autograd.grad(loss, tensors)
    assert sorted(ref) == sorted(path for path, _ in leaves)
    for (path, _), g in zip(leaves, grads):
        assert _relerr(_np(g), ref[path]) < TOL, path


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(arch, remat):
    _grads_case(arch, remat, loss_mask=False)


@pytest.mark.parametrize("check", ["loss", "grads"])
def test_vlm_loss_mask_matches_jax(check):
    """llava with a loss mask over its text positions: the masked mean CE
    and its gradients."""
    if check == "loss":
        _loss_case("llava-next-mistral-7b", loss_mask=True)
    else:
        _grads_case("llava-next-mistral-7b", remat=True, loss_mask=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(arch):
    japi, jparams, _, batch = _setup(arch)
    api, params, _ = _port(arch)
    tokens = batch["tokens"][:, :DECODE_STEPS]
    jcache, tcache = japi.init_cache(tokens.shape[0], DECODE_STEPS), api.init_cache(
        tokens.shape[0], DECODE_STEPS)
    step = jax.jit(japi.decode_step)
    with torch.no_grad():
        for i in range(DECODE_STEPS):
            ref, jcache = step(jparams, jcache, jnp.asarray(tokens[:, i : i + 1]), jnp.int32(i))
            out, tcache = api.decode_step(
                params, tcache, torch.from_numpy(tokens[:, i : i + 1]).long(), i)
            assert _relerr(_np(out), ref) < TOL, i
