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


def test_serve_cus_match_the_jax_serve_cu():
    """Serve CUs, as examples/pilot_serve.py runs them: the weights DU is
    the CU's input.  Two port serve CUs on two pilots
    (``DecodeEngine.from_cu_context``) decode the JAX serve CU's tokens."""
    import repro.core as jax_core
    import repro_torch.core as port_core
    from repro.serving import params_from_input as jax_params_from_input

    files = _files(32)
    jcfg = jax_get_config("gemma3-1b-smoke")
    japi = jax_build_model(jcfg, impl="ref")
    api = build_model(get_config("gemma3-1b-smoke"), device="cpu")

    def jax_serve(cu_ctx, weights_du, prompts):
        params = jax.tree.map(jnp.asarray, jax_params_from_input(cu_ctx, weights_du))
        engine = JaxDecodeEngine(japi, params, batch=len(prompts), max_len=16)
        return np.asarray(engine.generate(jnp.asarray(prompts, jnp.int32), NEW)).tolist()

    def port_serve(cu_ctx, weights_du, prompts):
        engine = DecodeEngine.from_cu_context(api, cu_ctx, weights_du, batch=len(prompts),
                                              max_len=16)
        return engine.generate(torch.tensor(prompts), NEW).tolist()

    outs = {}
    for name, core, fn, n_cus in (("jax", jax_core, jax_serve, 1),
                                  ("port", port_core, port_serve, 2)):
        topo, _ = core.make_tpu_fleet_topology(pods=2, hosts_per_pod=1)
        with core.Session(topology=topo) as s:
            for pod in range(2):
                s.start_pilot(resource_url=f"sim://cluster:pod{pod}:host0", slots=1).wait_active()
            du = s.submit_du(name=f"serve-{name}-weights", files=files)
            core.FUNCTIONS.register(f"torch-parity-serve-{name}", fn)
            cus = [s.submit_cu(executable=f"torch-parity-serve-{name}", args=(du.id, PROMPTS),
                               input_data=[du], affinity=f"cluster:pod{pod}")
                   for pod in range(n_cus)]
            outs[name] = [cu.result(timeout=120) for cu in cus]
            assert len({cu.pilot_id for cu in cus}) == n_cus
    assert outs["port"] == outs["jax"] * 2
    assert np.asarray(outs["jax"][0]).shape == (2, NEW)
