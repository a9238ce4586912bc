"""Checkpoint DU files cross between the JAX package and the port unchanged,
bf16 leaves included (the JAX loader returns those as ``|V2`` bytes)."""

import dataclasses

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
from repro_torch import bridge
from repro_torch.checkpoint import checkpoint_files, decode_array, flatten_tree


def _jax_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": jnp.asarray(rng.standard_normal((3, 4)), jnp.float32),
        "b": {
            "c": jnp.asarray(rng.standard_normal((5, 2)), jnp.bfloat16),
            "d": jnp.asarray(rng.integers(-9, 9, (2, 2)), jnp.int32),
        },
    }


def _as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def test_jax_files_load_into_port_tree():
    tree = _jax_tree()
    files = jax_checkpoint_files(3, "run", tree)
    port = bridge.params_from_files(files, device="cpu")
    jax_leaves = dict(jax_flatten_tree(tree))
    port_leaves = dict(flatten_tree(port))
    assert sorted(jax_leaves) == sorted(port_leaves)
    assert port["b"]["c"].dtype == torch.bfloat16
    assert port["a"].dtype == torch.float32 and port["b"]["d"].dtype == torch.int32
    for k, leaf in jax_leaves.items():
        assert tuple(port_leaves[k].shape) == leaf.shape
        np.testing.assert_array_equal(_as_f32(port_leaves[k]), _as_f32(leaf))


def test_port_files_decode_identically_in_jax():
    tree = _jax_tree(1)
    jax_files = jax_checkpoint_files(0, "run", tree)
    port_files = checkpoint_files(0, "run", bridge.params_from_files(jax_files, device="cpu"))
    assert sorted(port_files) == sorted(jax_files)
    for rel, data in jax_files.items():
        assert port_files[rel] == data, rel  # byte-identical .npy files
        if rel.endswith(".npy"):
            a, b = jax_decode_array(port_files[rel]), jax_decode_array(data)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_bf16_bits_roundtrip_through_numpy_bridge():
    tree = _jax_tree(2)
    port = bridge.params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")
    assert port["b"]["c"].dtype == torch.bfloat16
    back = bridge.params_to_numpy(port)
    assert back["b"]["c"].dtype == np.dtype("V2")
    assert back["b"]["c"].tobytes() == np.asarray(tree["b"]["c"]).tobytes()
    assert decode_array(jax_checkpoint_files(0, "r", tree)["params/b/c.npy"]).dtype == torch.bfloat16
    cast = bridge.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu", torch.float32)
    assert cast["b"]["c"].dtype == torch.float32 and cast["b"]["d"].dtype == torch.int32


@pytest.mark.parametrize("n_layers", [6, 8])
def test_model_tree_crosses_in_bf16(n_layers):
    """A bf16 gemma3 tree (stacked groups, plus a tail at 8 layers) keeps its
    key paths, shapes and bits through the DU files."""
    cfg = dataclasses.replace(
        jax_get_config("gemma3-1b-smoke"),
        n_layers=n_layers,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    port = bridge.params_from_files(jax_checkpoint_files(0, "m", params), device="cpu")
    jax_leaves = dict(jax_flatten_tree(params))
    port_leaves = dict(flatten_tree(port))
    assert sorted(jax_leaves) == sorted(port_leaves)
    assert ("tail/pos0/attn/q/w" in port_leaves) == (n_layers == 8)
    for k, leaf in jax_leaves.items():
        t = port_leaves[k]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == leaf.shape, k
        assert t.view(torch.int16).numpy().tobytes() == np.asarray(leaf).tobytes(), k
