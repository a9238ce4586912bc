"""The port's DecodeEngine gives the same greedy tokens as the JAX
DecodeEngine (``impl="ref"``) from the same checkpoint DU files."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpoint_files, decode_array, unflatten_tree
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serving import DecodeEngine as JaxDecodeEngine
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving import DecodeEngine

PROMPTS = [[1, 5, 9, 2], [3, 3, 7, 1]]
NEW = 8


def _files(window):
    cfg = dataclasses.replace(jax_get_config("gemma3-1b-smoke"), sliding_window=window)
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    return checkpoint_files(0, "serve", params)


@pytest.mark.parametrize("window", [4, 32])
def test_generate_matches_jax_engine(window):
    """At window 4 the 12 positions wrap the SWA ring twice."""
    files = _files(window)
    jcfg = dataclasses.replace(jax_get_config("gemma3-1b-smoke"), sliding_window=window)
    jparams = unflatten_tree(
        {rel[7:-4]: decode_array(b) for rel, b in files.items() if rel.startswith("params/")}
    )
    jeng = JaxDecodeEngine(jax_build_model(jcfg, impl="ref"), jparams, batch=2, max_len=16)
    ref = np.asarray(jeng.generate(jnp.asarray(PROMPTS, jnp.int32), NEW))

    tcfg = dataclasses.replace(get_config("gemma3-1b-smoke"), sliding_window=window)
    eng = DecodeEngine.from_files(build_model(tcfg, device="cpu"), files, batch=2, max_len=16)
    out = eng.generate(torch.tensor(PROMPTS), NEW)
    assert out.shape == (2, NEW)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_engine_refuses_to_decode_past_max_len():
    files = _files(4)
    cfg = dataclasses.replace(get_config("gemma3-1b-smoke"), sliding_window=4)
    eng = DecodeEngine.from_files(build_model(cfg, device="cpu"), files, batch=2, max_len=6)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(torch.tensor(PROMPTS), 4)
    with pytest.raises(ValueError, match="batch"):
        eng.prefill(torch.tensor([[1, 2]]))
