"""The port's copy of the Pilot-Data runtime and the CUs that run on it,
against the JAX package:

* (a) every module of ``repro_torch.{core,backends,data}`` is the JAX
  package's byte for byte, apart from a listed set of lines (the
  lock-witness hook, and the witness's own imports of ``coordination``);
* (b) ``PilotTrainer`` in the port, started from the JAX trainer's
  ``ckpt_0`` DU, reproduces the JAX trainer's per-chunk losses and writes
  the same checkpoint DU (file names, ``meta.json``, every leaf), from
  byte-identical shard DUs;
* (c) the port's chunk DAG is submitted in one shot;
* (d) the port's ``Checkpointer`` writes the JAX ``Checkpointer``'s bytes,
  and each package's ``load_checkpoint_du`` reads the other's;
* the kernel wrappers' launch counters lose no update under threads.

Tolerances (max |port - JAX| over max(1, max |JAX|)), those of
``test_torch_training.py``: 1e-4 for losses and every leaf but the fp32
masters, 2e-4 for those (the fp32 tiny model has none); exact for
files."""

import difflib
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jax_core
from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.checkpoint import load_checkpoint_du as jax_load_checkpoint_du
from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.training.trainer import PilotTrainer as JaxPilotTrainer
import repro_torch.core as port_core
from repro_torch.checkpoint import Checkpointer, load_checkpoint_du, tensor_to_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.kernels import count_launch
from repro_torch.training.trainer import PilotTrainer

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
TOL = 1e-4
PARAM_TOL = 2e-4
# test_mlstack.py's tiny h2o-danube (fp32), cut to 4 steps in chunks of 2
TINY_CFG = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=128,
                head_dim=16)
TINY = dict(total_steps=4, chunk_steps=2, batch=4, seq=32, peak_lr=1e-3, n_shards=2,
            tokens_per_shard=4_000)

# the lines in which the copy differs from the JAX package: (JAX line, port line)
COPY_EDITS = {
    "core/coordination.py": [(
        "    from repro.analysis.witness import install as _install_lock_witness\n",
        "    from ..analysis.witness import install as _install_lock_witness\n",
    )],
    "analysis/witness.py": [(
        "    import repro.core.coordination as coordination\n",
        "    from ..core import coordination\n",
    )] * 2,
}


def _edits(jax_path: Path, port_path: Path):
    """The (JAX line, port line) replacements that turn one file into the
    other; raises on any other kind of difference."""
    a = jax_path.read_text().splitlines(keepends=True)
    b = port_path.read_text().splitlines(keepends=True)
    out = []
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes():
        if op == "equal":
            continue
        assert op == "replace" and i2 - i1 == j2 - j1, (port_path, op, a[i1:i2], b[j1:j2])
        out.extend(zip(a[i1:i2], b[j1:j2]))
    return out


@pytest.mark.parametrize("pkg", ["core", "backends", "data"])
def test_runtime_copy_is_the_jax_packages(pkg):
    jax_dir, port_dir = SRC / "repro" / pkg, SRC / "repro_torch" / pkg
    names = sorted(p.name for p in jax_dir.glob("*.py"))
    assert names and sorted(p.name for p in port_dir.glob("*.py")) == names
    for name in names:
        assert _edits(jax_dir / name, port_dir / name) == COPY_EDITS.get(f"{pkg}/{name}", []), name


def test_witness_copy_and_hook_wrap_the_ports_store_locks():
    rel = "analysis/witness.py"
    assert _edits(SRC / "repro" / rel, SRC / "repro_torch" / rel) == COPY_EDITS[rel]
    code = (
        "import sys\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch.core.coordination import CoordinationStore\n"
        "from repro_torch.analysis.witness import active_witness\n"
        "s = CoordinationStore()\n"
        "print(type(s._shards[0].lock).__name__)\n"
        "print(active_witness() is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_LOCK_WITNESS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["WitnessedLock", "True"]


def _session(core, tag):
    topo, _ = core.make_tpu_fleet_topology(pods=2, hosts_per_pod=1)
    s = core.Session(topology=topo)
    for pod in (0, 1):
        s.start_pilot_data(service_url=f"mem://cluster:pod{pod}/{tag}{pod}",
                           affinity=f"cluster:pod{pod}")
    for p in [s.start_pilot(resource_url=f"sim://cluster:pod{pod}:host0", slots=1)
              for pod in (0, 1)]:
        p.wait_active()
    return s


def _du_files(session, fut):
    """A sealed DU's files, read from its first replica."""
    du = session.ctx.lookup(fut.id)
    pd = session.ctx.lookup(du.locations[0])
    return {rel: pd.fetch_du_file(du.id, rel) for rel in du.manifest}


def _maxerr(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


def _npy(data: bytes) -> np.ndarray:
    from repro.checkpoint import decode_array

    arr = decode_array(data)
    if arr.dtype.kind == "V":  # bf16 bits: the high half of a float32
        return (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return arr


AFF = ["cluster:pod0", "cluster:pod1"]


def test_pilot_trainer_matches_jax_from_the_same_ckpt0():
    with _session(jax_core, "rt-jax") as js:
        jtr = JaxPilotTrainer(jax_reduced(jax_get_config("h2o-danube-1.8b"), **TINY_CFG), js,
                              run_name="rt-jax", **TINY)
        jtr.stage_data(affinities=AFF)
        ckpt0 = _du_files(js, jtr.initial_checkpoint())
        jshards = [_du_files(js, f) for f in jtr.shard_dus]
        jsum = jtr.run()
        jlast = _du_files(js, jtr.ckpt_dus[-1])
    with _session(port_core, "rt-port") as ps:
        tr = PilotTrainer(reduced(get_config("h2o-danube-1.8b"), **TINY_CFG), ps,
                          run_name="rt-jax", device="cpu", **TINY)
        tr.stage_data(affinities=AFF)
        tr.ckpt_dus.append(ps.submit_du(name="rt-jax.ckpt00000000", files=ckpt0))
        shards = [_du_files(ps, f) for f in tr.shard_dus]
        summary = tr.run()
        last = _du_files(ps, tr.ckpt_dus[-1])
    assert shards == jshards
    assert [h["steps"] for h in summary["history"]] == [(0, 2), (2, 4)]
    for h, jh in zip(summary["history"], jsum["history"]):
        assert len(h["losses"]) == 2
        assert _maxerr(h["losses"], jh["losses"]) < TOL, (h["losses"], jh["losses"])
    assert summary["improved"]
    assert sorted(last) == sorted(jlast)
    assert json.loads(last["meta.json"]) == json.loads(jlast["meta.json"]) == {
        "step": 4, "run": "rt-jax"}
    for rel in sorted(jlast):
        if rel.endswith(".npy"):
            tol = PARAM_TOL if rel.startswith("opt/master/") else TOL
            assert _maxerr(_npy(last[rel]), _npy(jlast[rel])) < tol, rel


def test_pilot_trainer_submits_whole_dag_upfront():
    with _session(port_core, "rt-dag") as s:
        tr = PilotTrainer(reduced(get_config("h2o-danube-1.8b"), **TINY_CFG), s,
                          run_name="rt-dag", device="cpu", **dict(TINY, total_steps=6))
        tr.stage_data(affinities=AFF)
        chunks = tr.submit_dag()
        # every chunk CU exists before any result, and the tail cannot be
        # done yet: its checkpoint producer is still unsealed
        assert len(chunks) == 3
        assert not chunks[-1][3].done()
        for _, _, _, cu in chunks:
            assert cu.result(timeout=300)["losses"]
        assert all(cu.output.sealed for _, _, _, cu in chunks)


def test_checkpointer_writes_the_jax_bytes_and_each_reads_the_other():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 5)).astype(np.float32)
    params = {"w": w, "emb": {"table": np.asarray(jnp.asarray(w[:3], jnp.bfloat16))},
              "n": np.arange(6, dtype=np.int32)}
    opt = {"step": np.asarray(3, np.int32), "m": {"w": w * 0.5}}
    with _session(jax_core, "ck-jax") as js, _session(port_core, "ck-port") as ps:
        jdu = JaxCheckpointer(js, run_name="ck").save(3, params, opt)
        pdu = Checkpointer(ps, run_name="ck").save(3, params, opt)
        jfiles, pfiles = _du_files(js, jdu), _du_files(ps, pdu)
        assert pfiles == jfiles
        # each package reads the other's DU
        step, tparams, topt = load_checkpoint_du(
            ps.ctx, ps.ctx.lookup(ps.submit_du(name="from-jax", files=jfiles).id))
        jstep, jparams, jopt = jax_load_checkpoint_du(
            js.ctx, js.ctx.lookup(js.submit_du(name="from-port", files=pfiles).id))
    assert step == jstep == 3
    assert isinstance(tparams["w"], torch.Tensor) and tparams["emb"]["table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tparams["w"].numpy(), jparams["w"])
    np.testing.assert_array_equal(tensor_to_numpy(tparams["emb"]["table"]).view(np.int16),
                                  jparams["emb"]["table"].view(np.int16))
    np.testing.assert_array_equal(tparams["n"].numpy(), jparams["n"])
    assert int(topt["step"]) == int(jopt["step"]) == 3
    np.testing.assert_array_equal(topt["m"]["w"].numpy(), jopt["m"]["w"])


def test_launch_counters_lose_no_update_under_threads():
    """16 threads bump one counter with the interpreter switching threads
    every microsecond: every bump lands."""

    def wrapper():
        pass

    wrapper.launches = 0
    n_threads, n_bumps = 16, 2_000

    def bump():
        for _ in range(n_bumps):
            count_launch(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == n_threads * n_bumps
