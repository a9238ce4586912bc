"""The launch layer of the port (``repro_torch.launch``: the dry run, its op
analyser, the kernel-site model and the H100 roofline) held to the JAX
package's ``repro.launch``, and the kernel wrappers' meta branches held to
their plain versions.

The JAX side runs in a subprocess on 8 host devices; the port's fake
process groups (one default group a process) run in another, on a fake
(data 2, model 4) mesh; the module fixture starts both at once and reads
their JSON."""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, get_config, get_shape, list_archs
from repro_torch.kernels import causal_conv, decode_attention, flash_attention, rmsnorm, ssd_scan
from repro_torch.launch import dryrun, kernel_substitution as ks, roofline
from repro_torch.launch.op_analysis import OpAnalysis

ROOT = Path(__file__).resolve().parents[1]
TIME_LIMIT_S = 240
#: the production meshes as (data-parallel ranks, model ranks): (32, 8),
#: (16, 16) (the JAX package's pod) and (2, 32, 8)
MESHES = {"d32m8": (32, 8), "d16m16": (16, 16), "p2d32m8": (64, 8)}
#: the small shapes of the fake-mesh cells and the argument-bytes parity
TRAIN, PREFILL, DECODE = (64, 4, "train"), (64, 4, "prefill"), (64, 4, "decode")
ARG_CONFIGS = ("h2o-danube-1.8b-smoke", "granite-moe-3b-a800m-smoke",
               "llava-next-mistral-7b-smoke")
MLP = dict(m=64, d=32, ff=96)
SYNTH = {
    "arch": "synthetic", "shape": "train_4k", "kind": "train", "status": "OK",
    "n_devices": 256, "microbatches": 2, "model_flops_global": 5.5e16,
    "memory": {"peak_per_device": 2.0e10, "peak_per_device_tpu_corrected": 2.0e10,
               "fits_16GiB": False, "fits_80GB": True},
}
SYNTH_COUNTS = {"flops": 3.1e14, "hbm_bytes": 2.2e12,
                "collective_per_axis": {"model": 4.0e10, "data": 9.0e9, "pod": 1.5e9}}

JAX_SCRIPT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    jax.devices()  # 8 host devices, before repro.launch.dryrun asks for 512
    from repro.configs import SHAPES, get_config, get_shape, list_archs
    from repro.configs.base import ShapeConfig
    from repro.distributed.compat import make_mesh
    from repro.distributed.context import DistContext
    from repro.distributed.sharding_rules import batch_specs, opt_specs, param_specs
    from repro.launch import dryrun, kernel_substitution as ks, roofline
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.models import build_model
    from repro.optim import init_adamw

    out = {"microbatches": {f"{a}|{s}": v for (a, s), v in dryrun.MICROBATCHES.items()}}
    meshes, train, mlp = json.loads(sys.argv[2]), json.loads(sys.argv[3]), json.loads(sys.argv[4])
    sites = {}
    for arch in list_archs():
        cfg = get_config(arch)
        for name in SHAPES:
            shape = get_shape(name)
            key = f"{arch}|{name}"
            out.setdefault("model_flops", {})[key] = dryrun._model_flops(cfg, shape)
            for mesh, (dp, tp) in meshes.items():
                mb = dryrun.MICROBATCHES.get((arch, name), 1) if shape.kind == "train" else 1
                train_ = shape.kind == "train"
                att = ks._attention_sites(cfg, shape, dp, tp, mb)
                ssd = ks._ssd_sites(cfg, shape, dp, mb, tp)
                sites[f"{key}|{mesh}"] = dict(
                    tp_split=ks._tp_split(cfg.n_heads, cfg.n_kv_heads, shape.seq_len, tp),
                    attention=att, ssd=ssd,
                    attention_analytic=[ks._attn_kernel_analytic(s, train_) for s in att],
                    ssd_analytic=[ks._ssd_kernel_analytic(s, train_) for s in ssd])
    out["sites"] = sites

    # derive_terms on the synthetic cell, with the JAX constants
    cell = json.loads(sys.argv[5])
    out["terms"] = roofline.derive_terms(cell)

    # a SwiGLU MLP's forward and gradient, lowered on the CPU
    def f(x, wg, wu, wd):
        return (jax.nn.silu(x @ wg) * (x @ wu)) @ wd

    m, d, ff = mlp["m"], mlp["d"], mlp["ff"]
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in ((m, d), (d, ff), (d, ff), (ff, d))]
    g = jax.grad(lambda *a: (f(*a) ** 2).sum(), argnums=(0, 1, 2, 3))
    out["mlp"] = {k: analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())["flops"]
                  for k, fn in (("forward", f), ("grad", g))}

    # argument bytes: the local shards of params, AdamW state and batch
    mesh = make_mesh((2, 4), ("data", "model"))
    ctx = DistContext(mesh=mesh, batch_axes=("data",))
    shape = ShapeConfig("t", *train)
    nbytes = lambda sd, spec: int(np.prod(NamedSharding(mesh, spec).shard_shape(sd.shape))
                                  * np.dtype(sd.dtype).itemsize)
    out["argument_bytes"] = {}
    for name in json.loads(sys.argv[6]):
        cfg = get_config(name)
        api = build_model(cfg, ep=4)
        params = jax.eval_shape(api.init, jax.random.PRNGKey(0))
        ps = param_specs(params, cfg, ctx)
        opt = jax.eval_shape(init_adamw, params)
        os_ = opt_specs(opt, ps, cfg, ctx)
        spec = api.batch_spec(shape)
        bs = batch_specs(spec, ctx)
        is_p = lambda x: isinstance(x, P)
        total = sum(jax.tree.leaves(jax.tree.map(nbytes, params, ps, is_leaf=is_p)))
        total += sum(jax.tree.leaves(jax.tree.map(nbytes, opt, os_, is_leaf=is_p)))
        total += sum(nbytes(jax.ShapeDtypeStruct(s, dt), bs[k]) for k, (s, dt) in spec.items())
        out["argument_bytes"][name] = total
    with open(sys.argv[1], "w") as fh:
        json.dump(out, fh)
    """
)

FAKE_SCRIPT = textwrap.dedent(
    """
    import json, sys
    import torch
    torch.set_num_threads(1)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SSMConfig, ShapeConfig, reduced
    from repro_torch.distributed.context import DistContext
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models import build_model

    mesh = dryrun.production_mesh(world=8, per_host=4)  # the fake group: (data 2, model 4)
    train, prefill, decode = (ShapeConfig(k, *v) for k, v in zip(
        ("train", "prefill", "decode"), json.loads(sys.argv[2])))
    out = {"mesh": [list(mesh.shape), list(mesh.mesh_dim_names)]}

    # a Shard(0) x Shard(1) product, and a Shard -> Replicate redistribute on model
    meta = lambda *s: torch.empty(*s, device="meta")
    a = DTensor.from_local(meta(4, 4096), mesh, [Shard(0), Replicate()], run_check=False)
    b = DTensor.from_local(meta(4096, 64), mesh, [Replicate(), Shard(1)], run_check=False)
    x = DTensor.from_local(meta(2, 64), mesh, [Replicate(), Shard(0)], run_check=False)
    with OpAnalysis(mesh) as an:
        c = a @ b
    out["product"] = dict(flops=an.flops, local=list(c.to_local().shape),
                          placements=[str(p) for p in c.placements])
    with OpAnalysis(mesh) as an:
        x.redistribute(placements=[Replicate(), Replicate()])
    out["gather"] = an.result()

    ctx = DistContext(mesh=mesh, batch_axes=("data",))
    out["argument_bytes"] = {}
    for name in json.loads(sys.argv[3]):
        cfg = get_config(name)
        api = build_model(cfg, device="meta", ep=4)
        out["argument_bytes"][name] = dryrun.cell_inputs(api, cfg, train, ctx)["argument_bytes"]

    # smoke cells at a head dim the kernels have (64); 24 q heads over one kv
    # head give 6 a rank at model 4 (G 6, granite-34b's at model 8), 20 give
    # 5: G 5, an instance B1 lacks
    h64 = dict(head_dim=64, param_dtype="bfloat16", compute_dtype="bfloat16")
    # SSD heads of 64 (B4's instance) at d_model 128: 4 heads, one a rank
    ssm = dict(d_model=128, ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=1,
                                          conv_width=4, chunk=64))
    cells = {
        "dense": reduced(get_config("h2o-danube-1.8b"), **h64),
        "moe": reduced(get_config("granite-moe-3b-a800m"), **h64),
        "ssm": reduced(get_config("mamba2-370m"), **h64, **ssm),
        "hybrid": reduced(get_config("zamba2-1.2b"), **h64, **ssm),
        "encdec": reduced(get_config("whisper-large-v3"), **h64),
        "g6": reduced(get_config("granite-34b"), n_heads=24, n_kv_heads=1, **h64),
        "g5": reduced(get_config("granite-34b"), n_heads=20, n_kv_heads=1, **h64),
    }
    shapes = {"dense": (train, prefill, decode), "moe": (train, prefill, decode),
              "ssm": (train, decode), "hybrid": (decode,), "encdec": (train, decode),
              "g6": (train,), "g5": (train,)}
    out["cells"] = {}
    for name, cfg in cells.items():
        for shape in shapes[name]:
            r = dryrun.cell_record(name, shape.name, cfg=cfg, shape=shape, mesh=mesh, save=False)
            out["cells"][f"{name}|{shape.name}"] = r
    with open(sys.argv[1], "w") as fh:
        json.dump(out, fh)
    """
)


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """Runs the JAX subprocess and the fake-group subprocess at once; returns
    (JAX results, port results)."""
    work = tmp_path_factory.mktemp("launch")
    synth = dict(SYNTH, hlo_analysis=SYNTH_COUNTS)
    procs = [
        subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(work / "jax.json"),
                          json.dumps(MESHES), json.dumps(TRAIN), json.dumps(MLP),
                          json.dumps(synth), json.dumps(ARG_CONFIGS)],
                         env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True),
        subprocess.Popen([sys.executable, "-c", FAKE_SCRIPT, str(work / "port.json"),
                          json.dumps([TRAIN, PREFILL, DECODE]), json.dumps(ARG_CONFIGS)],
                         env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True),
    ]
    deadline = time.monotonic() + TIME_LIMIT_S
    try:
        for proc, what in zip(procs, ("JAX", "fake group")):
            _, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert proc.returncode == 0, f"{what} subprocess: exit {proc.returncode}\n{err[-4000:]}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return (json.loads((work / "jax.json").read_text()),
            json.loads((work / "port.json").read_text()))


# --------------------------------------------------------- parity with JAX
def _listed(x):
    """JSON's view of a value (tuples as lists)."""
    return json.loads(json.dumps(x))


def test_microbatches_match_jax(sides):
    jax_, _ = sides
    assert {f"{a}|{s}": v for (a, s), v in dryrun.MICROBATCHES.items()} == jax_["microbatches"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_sites_and_analytic_costs_match_jax(sides, arch, mesh):
    jax_, _ = sides
    dp, tp = MESHES[mesh]
    cfg = get_config(arch)
    for name in SHAPES:
        shape = get_shape(name)
        assert dryrun._model_flops(cfg, shape) == jax_["model_flops"][f"{arch}|{name}"]
        train = shape.kind == "train"
        mb = dryrun.MICROBATCHES.get((arch, name), 1) if train else 1
        att = ks._attention_sites(cfg, shape, dp, tp, mb)
        ssd = ks._ssd_sites(cfg, shape, dp, mb, tp)
        port = dict(tp_split=ks._tp_split(cfg.n_heads, cfg.n_kv_heads, shape.seq_len, tp),
                    attention=att, ssd=ssd,
                    attention_analytic=[ks._attn_kernel_analytic(s, train) for s in att],
                    ssd_analytic=[ks._ssd_kernel_analytic(s, train) for s in ssd])
        assert _listed(port) == jax_["sites"][f"{arch}|{name}|{mesh}"], name


def test_derive_terms_matches_jax_with_its_constants(sides, monkeypatch):
    jax_, _ = sides
    monkeypatch.setattr(roofline, "BF16_FLOPS", 197e12)
    monkeypatch.setattr(roofline, "HBM_BW", 819e9)
    monkeypatch.setattr(roofline, "AXIS_BW", {"model": 50e9, "data": 50e9, "pod": 25e9})
    port = roofline.derive_terms(dict(SYNTH, op_analysis=SYNTH_COUNTS))
    want = jax_["terms"]
    for key in ("compute_s", "memory_s", "collective_s", "model_flops_dev", "useful_ratio",
                "roofline_frac", "mem_gib"):
        assert port[key] == pytest.approx(want[key], rel=1e-12), key
    assert port["flops_dev"] == want["hlo_flops_dev"]
    assert port["dominant"] == want["dominant"]


def test_h100_constants_and_their_one_home(monkeypatch):
    peaks = (roofline.BF16_FLOPS, roofline.TF32_FLOPS, roofline.FP32_FLOPS)
    assert peaks == (989e12, 495e12, 67e12)
    assert (roofline.HBM_BW, roofline.HBM_BYTES) == (3.35e12, 80e9)
    assert roofline.AXIS_BW == {"model": 450e9, "data": 50e9, "pod": 50e9}
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as cs

    assert (cs.BF16_FLOPS, cs.TF32_FLOPS, cs.FP32_FLOPS, cs.HBM_BYTES_PER_S) == (
        roofline.BF16_FLOPS, roofline.TF32_FLOPS, roofline.FP32_FLOPS, roofline.HBM_BW)
    assert not hasattr(cs, "kept_pairs")  # it lives with B1's cost
    # the dry run counts each kernel at its cost: the substitution record is
    # a comparison and derive_terms does not subtract it
    cell = dict(SYNTH, op_analysis=dict(SYNTH_COUNTS, compute_seconds=0.25))
    sub = dict(bytes_delta=1e12, flops_delta=1e14)
    assert roofline.derive_terms(dict(cell, kernel_substitution=sub)) == roofline.derive_terms(cell)
    assert roofline.derive_terms(cell)["compute_s"] == 0.25


def test_mlp_flops_match_the_hlo_analysis(sides):
    jax_, _ = sides
    m, d, ff = MLP["m"], MLP["d"], MLP["ff"]
    leaves = [torch.empty(s, device="meta", requires_grad=True)
              for s in ((m, d), (d, ff), (d, ff), (ff, d))]

    def f(x, wg, wu, wd):
        return (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd

    with OpAnalysis() as fwd:
        f(*leaves)
    with OpAnalysis() as grad:
        torch.autograd.grad((f(*leaves) ** 2).sum(), leaves)
    assert fwd.flops == jax_["mlp"]["forward"] == 3 * 2 * m * d * ff
    assert grad.flops == jax_["mlp"]["grad"] == 9 * 2 * m * d * ff


# ------------------------------------------------------- the fake (2, 4) mesh
def test_fake_mesh_product_counts_local_flops(sides):
    _, port = sides
    assert port["mesh"] == [[2, 4], ["data", "model"]]
    # [8, 4096] Shard(0) over data x [4096, 256] Shard(1) over model
    assert port["product"]["local"] == [4, 64]
    assert port["product"]["flops"] == 2 * 4 * 64 * 4096 != 2 * 8 * 256 * 4096


def test_fake_mesh_redistribute_counts_its_all_gather_on_model(sides):
    _, port = sides
    g = port["gather"]
    assert g["collective_per_op"] == {"all-gather": 2 * 64 * 4}
    assert g["collective_per_axis"] == {"model": 2 * 64 * 4}
    assert g["flops"] == 0


@pytest.mark.parametrize("name", ARG_CONFIGS)
def test_argument_bytes_match_jax_shard_shapes(sides, name):
    jax_, port = sides
    assert port["argument_bytes"][name] == jax_["argument_bytes"][name] > 0


@pytest.mark.parametrize("cell", ["dense|train", "dense|prefill", "moe|train", "moe|prefill"])
def test_run_cell_is_ok_for_dense_and_moe(sides, cell):
    _, port = sides
    r = port["cells"][cell]
    assert r["status"] == "OK", r.get("error")
    a = r["op_analysis"]
    assert a["flops"] > 0 and a["hbm_bytes"] > 0
    assert a["collective_per_axis"].get("model", 0) > 0
    launches = {k: v["launches"] for k, v in a["kernels"].items()}
    assert launches["flash_attention"] > 0 and launches["rmsnorm"] > 0
    if cell.endswith("train"):
        assert launches["flash_attention_bwd"] > 0 and launches["rmsnorm_bwd"] > 0
        assert a["collective_per_axis"].get("data", 0) > 0  # ZeRO's reduce-scatter
    m = r["memory"]
    assert m["peak_per_device"] >= m["argument_bytes"] > 0 and m["fits_80GB"]
    terms = roofline.derive_terms(r)
    assert terms["step_s"] > 0 and terms["dominant"] in ("compute", "memory", "collective")
    assert r["kernel_substitution"]["measured_scan_bytes"] > 0


def _ok_cell(port, cell):
    r = port["cells"][cell]
    assert r["status"] == "OK", r.get("error")
    a = r["op_analysis"]
    assert a["flops"] > 0 and a["hbm_bytes"] > 0
    assert a["collective_per_axis"].get("model", 0) > 0
    m = r["memory"]
    assert m["peak_per_device"] >= m["argument_bytes"] > 0 and m["fits_80GB"]
    return {k: v["launches"] for k, v in a["kernels"].items()}


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid", "encdec"])
def test_run_cell_decode_is_ok_on_a_split_cache(sides, family):
    # (data 2, model 4), batch 4 and a 64-slot cache: 16 slots a rank (the
    # whisper cross cache's 16 frames, 4); the SSM heads one a rank
    _, port = sides
    launches = _ok_cell(port, f"{family}|decode")
    assert launches["rmsnorm"] > 0
    if family != "ssm":  # B2's partial mode on every attention layer's slots
        assert launches["decode_attention_partial"] > 0
        assert "decode_attention" not in launches
    if family in ("ssm", "hybrid"):  # the gate norm over the heads' split
        assert launches["rmsnorm_stat"] > 0 and launches["rmsnorm_ext"] > 0


@pytest.mark.parametrize("family", ["ssm", "encdec"])
def test_run_cell_train_is_ok_for_ssm_and_encdec(sides, family):
    _, port = sides
    launches = _ok_cell(port, f"{family}|train")
    assert launches["rmsnorm"] > 0 and launches["rmsnorm_bwd"] > 0
    if family == "ssm":  # B4 on the local heads, the gate norm both ways
        assert launches["ssd_scan"] > 0 and launches["ssd_scan_bwd"] > 0
        assert launches["rmsnorm_ext"] > 0 and launches["rmsnorm_ext_bwd"] > 0
        # one row statistic for each of them
        assert launches["rmsnorm_stat"] == launches["rmsnorm_ext"] + launches["rmsnorm_ext_bwd"]
    else:
        assert launches["flash_attention"] > 0 and launches["flash_attention_bwd"] > 0


def test_run_cell_train_is_ok_at_a_rank_group_of_6(sides):
    """24 q heads over one kv head at model 4: each rank runs B1 both ways
    at G 6 on its heads, launches counted."""
    _, port = sides
    launches = _ok_cell(port, "g6|train")
    assert launches["flash_attention"] > 0 and launches["flash_attention_bwd"] > 0


def test_run_cell_fails_with_the_missing_instance(sides):
    _, port = sides
    r = port["cells"]["g5|train"]
    assert r["status"] == "FAIL"
    assert r["error"].startswith("NotImplementedError: flash_attention kernel has no instance "
                                 "for head_dim=64, group=5")


# ------------------------------------------------------- kernel meta branches
def _counts():
    fa, norm, ssd = (flash_attention.ops.flash_attention, rmsnorm.ops.rmsnorm,
                     ssd_scan.ops.ssd)
    da = decode_attention.ops.decode_attention
    conv = causal_conv.ops.causal_conv_silu
    return (da.launches, da.partial_launches, fa.launches, fa.backward_launches,
            norm.launches, norm.backward_launches, norm.residual_launches, norm.stat_launches,
            norm.ext_launches, norm.ext_backward_launches, ssd.launches, ssd.backward_launches,
            conv.launches, conv.backward_launches)



def _case(name):
    """(fn(device) -> outputs, the kernel's cost of the call) of one wrapper."""
    g = torch.Generator().manual_seed(0)

    def rnd(*s, dtype=torch.float32):
        return torch.randn(*s, generator=g).to(dtype)

    fa, da, rn, sd = (flash_attention.ops, decode_attention.ops, rmsnorm.ops, ssd_scan.ops)
    bf = torch.bfloat16
    if name in ("flash_attention", "flash_attention_bwd"):
        q, k, v, do = rnd(2, 16, 4, 64, dtype=bf), rnd(2, 16, 2, 64, dtype=bf), \
            rnd(2, 16, 2, 64, dtype=bf), rnd(2, 16, 4, 64, dtype=bf)
        if name == "flash_attention":
            return (lambda dev: fa.flash_attention_fwd(*(t.to(dev) for t in (q, k, v)), True, 8),
                    fa.cost(2, 16, 16, 4, 2, 64, True, 8))
        out, lse = fa.flash_attention_fwd(q, k, v, True, 8)
        return (lambda dev: fa.flash_attention_bwd(*(t.to(dev) for t in (q, k, v, out, lse, do)),
                                                   True, 8),
                fa.cost(2, 16, 16, 4, 2, 64, True, 8, backward=True))
    if name == "decode_attention":
        q, kc = rnd(2, 1, 8, 64, dtype=bf), rnd(2, 24, 2, 64, dtype=bf)
        pq = torch.full((2,), 23, dtype=torch.int32)
        pk = torch.arange(24, dtype=torch.int32)[None].expand(2, 24).contiguous()
        return (lambda dev: [da.decode_attention(*(t.to(dev) for t in (q, kc, kc, pq, pk)))],
                da.cost(2, 24, 8, 2, 64, 2 * 24))
    if name == "decode_attention_partial":  # a rank's 3 slots of a split cache
        q, kc = rnd(2, 1, 8, 64, dtype=bf), rnd(2, 3, 2, 64, dtype=bf)
        pq = torch.full((2,), 23, dtype=torch.int32)
        pk = torch.arange(6, 9, dtype=torch.int32)[None].expand(2, 3).contiguous()
        return (lambda dev: list(da.decode_attention_partial(
            *(t.to(dev) for t in (q, kc, kc, pq, pk)))),
            da.cost(2, 3, 8, 2, 64, 2 * 3, partial=True))
    if name.startswith("rmsnorm"):
        x, r, w = rnd(6, 128, dtype=bf), rnd(6, 128, dtype=bf), rnd(128, dtype=bf)
        if name == "rmsnorm":
            return lambda dev: [rn.rmsnorm(x.to(dev), w.to(dev))], rn.cost(6, 128)
        if name == "rmsnorm_residual":
            return (lambda dev: list(rn.rmsnorm(x.to(dev), w.to(dev), residual=r.to(dev))),
                    rn.cost(6, 128, residual=True))
        if name == "rmsnorm_bwd":
            return (lambda dev: rn.rmsnorm_bwd(r.to(dev), x.to(dev), w.to(dev)),
                    rn.cost(6, 128, backward=True))
        ss, c = torch.rand(6, generator=g) * 256 + 1, torch.randn(6, generator=g)
        if name == "rmsnorm_stat":
            return (lambda dev: [rn.row_stat(x.to(dev), r.to(dev), w.to(dev))],
                    rn.stat_cost(6, 128, with_dy=True))
        if name == "rmsnorm_ext":  # rows of 256, this rank's 128 columns
            return (lambda dev: [rn.rmsnorm_ext(x.to(dev), w.to(dev), ss.to(dev), 256)],
                    rn.ext_cost(6, 128))
        return (lambda dev: list(rn.rmsnorm_ext_bwd(
            r.to(dev), x.to(dev), w.to(dev), ss.to(dev), c.to(dev), 256)),
            rn.ext_cost(6, 128, backward=True))
    if name in ("causal_conv", "causal_conv_bwd"):
        cc = causal_conv.ops
        xc, wc, bc = rnd(2, 40, 96, dtype=bf), rnd(4, 96, dtype=bf), rnd(96, dtype=bf)
        if name == "causal_conv":
            return (lambda dev: [cc.causal_conv_silu(*(t.to(dev) for t in (xc, wc, bc)))],
                    cc.cost(2, 40, 96, 4))
        dy = rnd(2, 40, 96)
        return (lambda dev: list(cc.causal_conv_silu_bwd(*(t.to(dev) for t in (xc, wc, bc, dy)))),
                cc.bwd_cost(2, 40, 96, 4))
    x, dA, B, C = rnd(2, 64, 4, 64), -rnd(2, 64, 4).abs(), rnd(2, 64, 1, 128), rnd(2, 64, 1, 128)
    if name == "ssd_scan":
        return (lambda dev: sd.ssd(*(t.to(dev) for t in (x, dA, B, C)), 32),
                sd.cost(2, 64, 4, 64, 128, 1, 32, False))

    def grads(dev):
        leaves = [t.to(dev).requires_grad_() for t in (x, dA, B, C)]
        y, _ = sd.ssd(*leaves, 32)
        return torch.autograd.grad(y, leaves, torch.ones(y.shape, device=dev))

    return grads, sd.bwd_cost(2, 64, 4, 64, 128, 1, 32, False, False)


KERNELS = ["flash_attention", "flash_attention_bwd", "decode_attention",
           "decode_attention_partial", "rmsnorm", "rmsnorm_residual", "rmsnorm_bwd",
           "rmsnorm_stat", "rmsnorm_ext", "rmsnorm_ext_bwd", "ssd_scan", "ssd_scan_bwd",
           "causal_conv", "causal_conv_bwd"]


@pytest.mark.parametrize("name", KERNELS)
def test_meta_branch_matches_the_plain_version(name):
    fn, cost = _case(name)
    plain = fn("cpu")
    before = _counts()
    with OpAnalysis() as a:
        meta = fn("meta")
    assert _counts() == before  # the counters count launches on the card only
    assert [(t.shape, t.dtype) for t in meta] == [(t.shape, t.dtype) for t in plain]
    assert all(t.device.type == "meta" for t in meta)
    k = a.result()["kernels"][name]
    assert (k["launches"], k["bytes"], k["flops"]) == (1, cost.bytes, cost.flops)
    if name == "ssd_scan_bwd":  # the forward of the same call
        assert a.result()["kernels"]["ssd_scan"]["launches"] == 1


@pytest.mark.parametrize("call,message", [
    (lambda m: flash_attention.ops.flash_attention(
        torch.empty(1, 8, 4, 32, **m), torch.empty(1, 8, 4, 32, **m),
        torch.empty(1, 8, 4, 32, **m)), "no instance for head_dim=32, group=1"),
    (lambda m: flash_attention.ops.flash_attention(
        torch.empty(1, 8, 5, 64, **m), torch.empty(1, 8, 1, 64, **m),
        torch.empty(1, 8, 1, 64, **m)), "no instance for head_dim=64, group=5"),
    (lambda m: decode_attention.ops.decode_attention(
        torch.empty(1, 1, 5, 64, **m), torch.empty(1, 8, 1, 64, **m), torch.empty(1, 8, 1, 64, **m),
        torch.empty(1, dtype=torch.int32, device="meta"),
        torch.empty(1, 8, dtype=torch.int32, device="meta")),
     "no instance for head_dim=64, group=5"),
    (lambda m: rmsnorm.ops.rmsnorm(torch.empty(2, 16385, **m), torch.empty(16385, **m)),
     "rows of at most 16384"),
    (lambda m: ssd_scan.ops.ssd(
        torch.empty(1, 32, 2, 32, device="meta"), torch.empty(1, 32, 2, device="meta"),
        torch.empty(1, 32, 1, 64, device="meta"), torch.empty(1, 32, 1, 64, device="meta"), 16),
     "no instance for head_dim=32, d_state=64"),
], ids=["flash-head-dim", "flash-group", "decode-group", "rmsnorm-width", "ssd-head-dim"])
def test_meta_branch_raises_the_card_error_on_a_missing_instance(call, message):
    before = _counts()
    with pytest.raises(NotImplementedError, match=message):
        call(dict(dtype=torch.bfloat16, device="meta"))
    assert _counts() == before


def test_op_analysis_tracks_live_storages_once():
    x = torch.empty(1024, 256, device="meta")  # 1 MiB
    views = {"x": x, "view": x[:10], "t": x.t()}
    with OpAnalysis() as a:
        assert a.track(views) == 1024 * 256 * 4
        y = x * 2  # a new storage: +1 MiB, the peak 2 MiB
        del y
        z = x + 1
    assert a.peak_bytes == 2 * 1024 * 256 * 4
    assert a.live_bytes == 2 * 1024 * 256 * 4  # x and z
    del z
    assert a.live_bytes == 1024 * 256 * 4
    # mul and add: one operand and one result each; views are free
    assert a.hbm_bytes == 2 * 2 * 1024 * 256 * 4
