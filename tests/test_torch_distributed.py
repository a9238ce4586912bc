"""The port's distributed layer (``repro_torch.distributed``, ``launch.mesh``,
``optim.compression``, ``models.moe.moe_mlp_ep``) against the JAX package's
on the CPU.

The port runs as gloo ranks, each a ``python -c`` process with one torch
thread, started once per world size (2 and 4) by a module-scoped fixture
with a time limit (the ranks are killed when it runs out, so a hang fails
the test); their process group meets through a ``file://`` in the test's
temporary directory.  The JAX side runs in four subprocesses (the specs, the
collectives, and the train steps in two halves), each on 8 host devices
(``--xla_force_host_platform_device_count=8``), as
``tests/test_sharding_rules.py`` does.  Both run at once, on inputs this
module draws first (numpy from a seed; weights from the port's ``init``),
which both read from ``.npz`` files.

* (a) specs: ``param_specs``, ``opt_specs`` (ZeRO-1), ``batch_specs`` (of
  every shape kind) and ``cache_specs`` (batch 128 at 32768, and batch 1 at
  524288 on the int8 cache) of every registered config at full size
  (meta tensors against ``jax.eval_shape``), on meshes (data 2, model 4),
  (4, 2), (1, 8) and (pod 2, data 2, model 2) with ``ep`` the model size:
  equal;
* (b) ``compressed_psum`` / ``compress_tree_psum`` at 2 and 4 ranks against
  JAX's inside ``shard_map``, with and without a residual: the int8 values
  equal, the outputs and the residuals within 1e-6 of max(1, max |JAX|);
* (c) ``pipeline_apply`` at 4 stages x 8 microbatches on
  ``tests/test_pipeline.py``'s function and sizes, its stage params a plain
  stack and a ``DTensor`` sharded over the stages: the output against
  JAX's and against the stages applied in turn (1e-5), the gradients of
  the params and of x against autograd through the stages in turn (1e-5),
  ``bubble_fraction`` equal;
* (d) ``moe_maybe_parallel`` on a (data 2, model 2) mesh, granite-moe and
  qwen3-moe smoke configs at their published capacity factor (local
  capacity, so tokens drop), against JAX's under ``distribution(ctx)``: y
  and aux within 1e-5; decode (S 1) takes the local path (no exchange);
* (e) two ``make_train_step`` steps with a ``DistContext`` (fp32 smoke
  configs): h2o-danube-1.8b and granite-moe-3b-a800m on (data 2, model 2)
  with sequence parallelism on and off, granite-34b (4/1 heads: the one kv
  head replicated, each rank's 2 q heads use it) on (2, 2), h2o-danube-1.8b
  (4/2 heads) on (1, 4) (rank r's one q head uses kv head r // 2), and
  granite-34b at 24/1 heads on (1, 4) (6 q heads a rank on the replicated
  kv head: the GQA group 6 that its 48/1 heads give a rank at model 8).  Loss,
  grad_norm, lr, every param and every ``opt/`` leaf (gathered) against
  JAX's step under ``distribution(ctx)``, jitted with the same shardings
  on 4 host devices (``impl="ref"``), and against the port's unsharded
  step: 1e-4 of max(1, max |ref|) for the metrics and the moments, 2e-4
  for the params and masters (the tolerances of
  ``tests/test_torch_training.py``: fp32 sums in another order, amplified
  by m / sqrt(v) near 0).  Every gathered param equals its gathered
  master in the param's dtype.  Against the unsharded step the MoE configs drop
  nothing (capacity factor E / k) and weigh the aux loss 0: the sharded
  step routes, caps and averages the aux loss over each rank's tokens, as
  JAX's does, which the whole batch does not.  The first case also runs
  with 2 microbatches against the unsharded step with 2.
* (f) the families that shard beyond dense and MoE layers: two train
  steps each of mamba2-370m, zamba2-1.2b and whisper-large-v3 smoke
  configs on (data 2, model 2) and of whisper on (1, 4) (its kv heads
  replicated, each rank's q head slicing its own in the cross-attention
  region), held as (e) is, to JAX and to the unsharded port (the mamba
  mixer head-parallel with the gate norm's statistic all-reduced).  Their
  weights are drawn from FAMILY_SEED: from seed 1, one element of zamba2's
  first x_proj, whose gradient is 1.4e-6 of the leaf's max, ends 2.14e-4
  from JAX after two steps (the unsharded port alone 1.77e-4; sharded and
  unsharded 1.0e-4 apart): Adam's m / sqrt(v) turns fp32 roundoff of a
  gradient near 0 into a fifth of the learning rate there;
* (g) sharded decode, teacher-forced from one token sequence: gemma3-1b on
  (2, 2) past its 32-slot ring's second wrap (the ring split 16 a rank,
  so at positions 0-15 one rank holds no kept slot), granite-moe on the
  int8 cache, mamba2 and zamba2 (the SSM heads and conv channels split),
  whisper (the self cache and the 16-frame cross cache split at model 2,
  the cross cache filled by the sharded ``prefill_cross_cache``) and
  gemma3-1b at batch 1 on (2, 2), whose caches are split over data and
  model (long_500k's layout).  Every step's logits are held to JAX's
  ``decode_step`` jitted with the cache's shardings (``impl="ref"``; its
  argmax is ``serve_step``'s token) and to the port's unsharded decode:
  within 1e-5 of max(1, max |ref|), and the same argmax tokens.  The folds
  of B2's partials are counted, and the ring case must fold a rank whose
  range holds no kept slot;
* the stacked groups' weights through DTensor ``unbind``: granite-moe's
  (drop-free) ``loss_fn`` with remat on the debug mesh (data 2, model 2):
  each of the 10 stacked leaves feeds one ``UnbindBackward0`` (none falls
  back to index selects), and its gradient, gathered, is within 1e-4 of the
  unsharded port's;
* meshes: ``make_debug_mesh(2, 2)`` and ``make_production_mesh`` on the
  4 ranks (``LOCAL_WORLD_SIZE`` unset, 2 and 4; with and without
  ``multi_pod``): dim names, sizes and ``mesh_batch_axes`` against JAX's,
  each rank's ``model`` group its host's ranks; ``production_layout`` at
  256 / 512 ranks of 16 a host against JAX's pod meshes (JAX's
  ``make_mesh`` stood in for), and the layouts it refuses.

The cases of (f) and (g) run on a second group of 4 gloo ranks and in two
more JAX subprocesses, beside the others.

Wall time: ~60-90 s on one worker (the JAX subprocesses' compiles take
most of it; the ranks run meanwhile).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import flatten_tree, unflatten_tree
from repro_torch.configs import get_config, get_shape, list_archs
from repro_torch.distributed import (
    DistContext,
    batch_specs,
    cache_specs,
    constrain,
    opt_specs,
    param_specs,
)
from repro_torch.distributed.tensor_parallel import local_kv_heads
from repro_torch.launch import AbstractMesh, production_layout
from repro_torch.models import build_model
from repro_torch.optim import init_adamw
from repro_torch.training import make_train_step

ROOT = Path(__file__).resolve().parents[1]
TIME_LIMIT_S = 420

MESHES = {
    "d2m4": ((2, 4), ("data", "model")),
    "d4m2": ((4, 2), ("data", "model")),
    "d1m8": ((1, 8), ("data", "model")),
    "p2d2m2": ((2, 2, 2), ("pod", "data", "model")),
}
CACHES = [(128, 32768, None), (1, 524288, "int8")]  # (batch, max_len, kv_cache_dtype)
BATCH, SEQ = 4, 48
STEP_KW = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
TOL, PARAM_TOL = 1e-4, 2e-4
# (case, model, mesh shape, sequence parallel)
TRAIN_CASES = [
    ("danube-sp", "h2o-danube-1.8b-smoke", (2, 2), True),
    ("danube", "h2o-danube-1.8b-smoke", (2, 2), False),
    ("moe-sp", "granite-moe-3b-a800m-smoke", (2, 2), True),
    ("moe", "granite-moe-3b-a800m-smoke", (2, 2), False),
    ("granite34b-kv-replicated", "granite-34b-smoke", (2, 2), True),
    ("danube-m4-kv-replicated", "h2o-danube-1.8b-smoke", (1, 4), True),
    # 24/1 heads on model 4: 6 q heads a rank on the one kv head (G 6, the
    # group granite-34b's 48/1 heads give a rank at model 8)
    ("granite34b-g6", "granite-34b-smoke:24/1", (1, 4), True),
]
# (f): the same, on the second group of ranks
FAMILY_TRAIN_CASES = [
    ("mamba2", "mamba2-370m-smoke", (2, 2), True),
    ("zamba2", "zamba2-1.2b-smoke", (2, 2), True),
    ("whisper", "whisper-large-v3-smoke", (2, 2), True),
    ("whisper-m4-kv-replicated", "whisper-large-v3-smoke", (1, 4), True),
]
# the weights of (f) (see FAMILY_TRAIN_CASES' note in the docstring)
FAMILY_SEED = 2
MICROBATCH_CASE = "danube-sp"  # also run with 2 microbatches against the unsharded step's
# (g) (case, model, mesh shape, batch, max_len, steps, kv_cache_dtype)
DECODE_CASES = [
    ("gemma3-ring", "gemma3-1b-smoke", (2, 2), 2, 72, 72, None),
    ("granite-moe-int8", "granite-moe-3b-a800m-smoke", (2, 2), 2, 40, 20, "int8"),
    ("mamba2", "mamba2-370m-smoke", (2, 2), 2, 16, 12, None),
    ("zamba2", "zamba2-1.2b-smoke", (2, 2), 2, 24, 12, None),
    ("whisper", "whisper-large-v3-smoke", (2, 2), 2, 16, 12, None),
    ("gemma3-batch1", "gemma3-1b-smoke", (2, 2), 1, 72, 40, None),
]
DECODE_TOL = 1e-5
EP_MODELS = ["granite-moe-3b-a800m-smoke", "qwen3-moe-30b-a3b-smoke"]
#: the train case whose inputs the sharded gradients through DTensor unbind read
UNBIND_CASE, UNBIND_MODEL = "moe", "granite-moe-3b-a800m-smoke"
EP_B, EP_S = 4, 16
PIPE = dict(n_stages=4, n_micro=8, mb=2, d=16)
COMP_LEAVES = {"a": (4, 6), "b/c": (16,), "b/d": (3, 5, 2)}


def model_config(model):
    """The config a case names: a registered one, or ``name:Hq/Hkv`` for it
    with other head counts."""
    name, _, heads = model.partition(":")
    cfg = get_config(name)
    if heads:
        hq, hkv = map(int, heads.split("/"))
        cfg = dataclasses.replace(cfg, n_heads=hq, n_kv_heads=hkv)
    return cfg


def _drop_free(cfg):
    """``cfg`` with a capacity that drops nothing and the aux loss unweighed."""
    m = cfg.moe
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k, router_aux_coef=0.0))


def _decode_cfg(model, kv):
    cfg = get_config(model)
    return dataclasses.replace(cfg, kv_cache_dtype=kv) if kv else cfg


def _norm_spec(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


# --------------------------------------------------------------- the inputs
def _write_inputs(work: Path) -> None:
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32),
             "labels": rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32)}
    for case, model, shape, _ in TRAIN_CASES + FAMILY_TRAIN_CASES:
        cfg = model_config(model)
        seed = 1 if (case, model, shape, _) in TRAIN_CASES else FAMILY_SEED
        params = build_model(cfg, device="cpu", ep=shape[1]).init(seed=seed)
        extra = {}
        if cfg.family == "encdec":
            extra["frames"] = rng.standard_normal(
                (BATCH, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
        np.savez(work / f"train-{case}.npz", **batch, **extra,
                 **{f"params/{p}": t.numpy() for p, t in flatten_tree(params)})
    for case, model, shape, b, _, steps, kv in DECODE_CASES:
        cfg = _decode_cfg(model, kv)
        params = build_model(cfg, device="cpu", ep=shape[1]).init(seed=3)
        extra = {}
        if cfg.family == "encdec":
            extra["frames"] = rng.standard_normal(
                (b, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
        np.savez(work / f"decode-{case}.npz", tokens=rng.integers(0, 256, (b, steps)).astype(
            np.int32), **extra, **{f"params/{p}": t.numpy() for p, t in flatten_tree(params)})
    for model in EP_MODELS:
        cfg = get_config(model)
        params = build_model(cfg, device="cpu", ep=2).init(seed=2)
        layer = {p: t[0].numpy() for p, t in flatten_tree(params["groups"]["pos0"]["moe"])}
        x = rng.standard_normal((EP_B, EP_S, cfg.d_model)).astype(np.float32)
        np.savez(work / f"ep-{model}.npz", x=x, x_decode=x[:, :1].copy(),
                 **{f"params/{p}": a for p, a in layer.items()})
    for n in (2, 4):
        arrays = {}
        for leaf, shape in COMP_LEAVES.items():
            arrays[f"x/{leaf}"] = (rng.standard_normal((n, *shape)) * 3).astype(np.float32)
            arrays[f"e/{leaf}"] = (rng.standard_normal((n, *shape)) * 1e-2).astype(np.float32)
        np.savez(work / f"comp-{n}.npz", **arrays)
    np.savez(work / "split-norm.npz", x=(rng.standard_normal((6, 16)) * 3).astype(np.float32),
             w=(rng.standard_normal(16) * 0.1).astype(np.float32),
             dy=rng.standard_normal((6, 16)).astype(np.float32))
    p = PIPE
    np.savez(work / "pipe.npz",
             ws=(rng.standard_normal((p["n_stages"], p["d"], p["d"])) * 0.5).astype(np.float32),
             x=rng.standard_normal((p["n_micro"], p["mb"], p["d"])).astype(np.float32),
             cot=rng.standard_normal((p["n_micro"], p["mb"], p["d"])).astype(np.float32))
    (work / "plan.json").write_text(json.dumps(dict(
        meshes=MESHES, caches=CACHES, train=TRAIN_CASES, ep=EP_MODELS, pipe=PIPE,
        comp=list(COMP_LEAVES), step_kw=STEP_KW, microbatch_case=MICROBATCH_CASE,
        family_train=FAMILY_TRAIN_CASES, decode=DECODE_CASES, unbind=[UNBIND_CASE, UNBIND_MODEL])))


JAX_SCRIPT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, sys
    from pathlib import Path
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_config, get_shape, list_archs
    from repro.distributed.compat import make_mesh, shard_map
    from repro.distributed.context import DistContext, distribution
    from repro.distributed.moe_parallel import moe_maybe_parallel
    from repro.distributed.pipeline import bubble_fraction, pipeline_apply
    from repro.distributed.sharding_rules import batch_specs, cache_specs, opt_specs, param_specs
    from repro.models import build_model
    from repro.optim import init_adamw
    from repro.optim.compression import compress_tree_psum, quantize_int8
    from repro.training.train_step import make_train_step

    work = Path(sys.argv[1])
    plan = json.loads((work / "plan.json").read_text())
    part = sys.argv[2]

    def norm(spec):
        return [list(e) if isinstance(e, tuple) else e for e in spec]

    def unflatten(items):
        root = {}
        for path, v in items.items():
            node = root
            *head, last = path.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = v
        return root

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k in sorted(tree):
                out.update(flat(tree[k], f"{prefix}{k}/"))
            return out
        return {prefix.rstrip("/"): np.asarray(tree)}

    def is_spec(x):
        return isinstance(x, P)

    def spec_tree(tree):
        return jax.tree.map(norm, tree, is_leaf=is_spec)

    def specs():
        out = {}
        for name in list_archs():
            cfg = get_config(name)
            for key, (shape, axes) in plan["meshes"].items():
                mesh = make_mesh(shape, axes)
                ctx = DistContext(mesh=mesh, batch_axes=tuple(a for a in axes if a != "model"))
                api = build_model(cfg, ep=shape[-1])
                shapes = jax.eval_shape(api.init, jax.random.PRNGKey(0))
                ps = param_specs(shapes, cfg, ctx)
                os_ = opt_specs(jax.eval_shape(init_adamw, shapes), ps, cfg, ctx)
                bs = {kind: batch_specs(api.batch_spec(get_shape(kind)), ctx)
                      for kind in ("train_4k", "prefill_32k", "decode_32k")}
                caches = []
                for b, length, kv in plan["caches"]:
                    c = dataclasses.replace(cfg, kv_cache_dtype=kv) if kv else cfg
                    capi = build_model(c, ep=shape[-1])
                    cs = jax.eval_shape(lambda: capi.init_cache(b, length))
                    caches.append(spec_tree(cache_specs(cs, c, ctx)))
                out[f"{name}/{key}"] = dict(params=spec_tree(ps), opt=spec_tree(os_),
                                            batch=spec_tree(bs), caches=caches)
        (work / "jax-specs.json").write_text(json.dumps(out))

    def compression(n):
        # Per-rank inputs stacked on a leading dim, one rank a device.
        data = np.load(work / f"comp-{n}.npz")
        xs = unflatten({k[2:]: jnp.asarray(data[k]) for k in data if k.startswith("x/")})
        es = unflatten({k[2:]: jnp.asarray(data[k]) for k in data if k.startswith("e/")})
        mesh = make_mesh((n,), ("pod",))
        res = {}
        for tag, errs in (("noerr", None), ("err", es)):
            def body(x, e=None):
                x = jax.tree.map(lambda a: a[0], x)
                e = None if e is None else jax.tree.map(lambda a: a[0], e)
                out, new = compress_tree_psum(x, "pod", e)
                xe = x if e is None else jax.tree.map(jnp.add, x, e)
                q = jax.tree.map(lambda a: quantize_int8(a)[0], xe)
                lift = lambda t: jax.tree.map(lambda a: a[None], t)
                return lift(out), lift(new), lift(q)
            args = (xs,) if errs is None else (xs, errs)
            specs = tuple(jax.tree.map(lambda _: P("pod"), a) for a in args)
            outs = shard_map(body, mesh=mesh, in_specs=specs, out_specs=P("pod"))(*args)
            for label, t in zip(("out", "err", "q"), outs):
                res.update({f"{tag}/{label}/{k}": v for k, v in flat(t).items()})
        np.savez(work / f"jax-comp-{n}.npz", **res)

    def pipeline():
        # tests/test_pipeline.py's function, sizes and mesh.
        data = np.load(work / "pipe.npz")
        mesh = make_mesh((4, 2), ("pod", "data"))
        out = pipeline_apply(lambda w, x: jnp.tanh(x @ w), jnp.asarray(data["ws"]),
                             jnp.asarray(data["x"]), mesh, axis="pod")
        p = plan["pipe"]
        np.savez(work / "jax-pipe.npz", out=np.asarray(out),
                 bubble=np.asarray(bubble_fraction(p["n_stages"], p["n_micro"])))

    def expert_parallel(model):
        # moe_maybe_parallel under distribution(ctx) on make_debug_mesh(2, 2).
        from repro.launch.mesh import make_debug_mesh
        mesh = make_debug_mesh(2, 2)
        ctx = DistContext(mesh=mesh, batch_axes=("data",))
        cfg = get_config(model)
        data = np.load(work / f"ep-{model}.npz")
        layer = unflatten({k[7:]: jnp.asarray(data[k]) for k in data if k.startswith("params/")})
        res = {}
        with distribution(ctx):
            fn = jax.jit(lambda p, x: moe_maybe_parallel(p, x, cfg))
            for tag in ("x", "x_decode"):
                y, aux = fn(layer, jnp.asarray(data[tag]))
                res[f"{tag}/y"], res[f"{tag}/aux"] = np.asarray(y), np.asarray(aux)
        np.savez(work / f"jax-ep-{model}.npz", **res)

    def meshes():
        # launch.mesh: the debug mesh, and the production layouts with
        # compat.make_mesh stood in for (they need 256 and 512 devices).
        import types
        import repro.distributed.compat as compat
        from repro.launch import mesh as jm
        rec = lambda m: dict(shape=list(np.shape(m.devices)) if hasattr(m, "devices")
                             else list(m.shape), names=list(m.axis_names),
                             batch_axes=list(jm.mesh_batch_axes(m)))
        out = {"debug": rec(jm.make_debug_mesh(2, 2))}
        real = compat.make_mesh
        compat.make_mesh = lambda shape, axes: types.SimpleNamespace(
            shape=tuple(shape), axis_names=tuple(axes))
        try:
            for multi_pod in (False, True):
                out[f"production/{multi_pod}"] = rec(jm.make_production_mesh(multi_pod=multi_pod))
        finally:
            compat.make_mesh = real
        (work / "jax-meshes.json").write_text(json.dumps(out))

    def train(case, model, shape, sp):
        # Two steps of make_train_step jitted with the specs' shardings.
        name, _, heads = model.partition(":")  # "name:Hq/Hkv": other head counts
        cfg = get_config(name)
        if heads:
            hq, hkv = map(int, heads.split("/"))
            cfg = dataclasses.replace(cfg, n_heads=hq, n_kv_heads=hkv)
        data = np.load(work / f"train-{case}.npz")
        params = unflatten({k[7:]: jnp.asarray(data[k]) for k in data if k.startswith("params/")})
        batch = {k: jnp.asarray(data[k]) for k in ("tokens", "labels", "frames") if k in data}
        mesh = make_mesh(tuple(shape), ("data", "model"))
        ctx = DistContext(mesh=mesh, batch_axes=("data",), sequence_parallel=sp)
        api = build_model(cfg, ep=shape[1], impl="ref")
        opt = init_adamw(params)
        shard = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t, is_leaf=is_spec)
        ps = param_specs(params, cfg, ctx)
        p_sh, o_sh = shard(ps), shard(opt_specs(opt, ps, cfg, ctx))
        b_sh = shard(batch_specs({k: (v.shape, v.dtype) for k, v in batch.items()}, ctx))
        step = make_train_step(api, **plan["step_kw"])
        res = {}
        with distribution(ctx):
            jstep = jax.jit(step, in_shardings=(p_sh, o_sh, b_sh), out_shardings=(p_sh, o_sh, None))
            params, opt = jax.device_put(params, p_sh), jax.device_put(opt, o_sh)
            batch = jax.device_put(batch, b_sh)
            for i in range(2):
                params, opt, metrics = jstep(params, opt, batch)
                res.update({f"metrics/{i}/{k}": np.asarray(v) for k, v in metrics.items()})
        res.update({f"params/{k}": v for k, v in flat(params).items()})
        res.update({f"opt/{k}": v for k, v in flat(opt).items()})
        np.savez(work / f"jax-train-{case}.npz", **res)

    def decode(case, model, shape, b, length, steps, kv):
        # decode_step jitted on the cache's shardings, teacher-forced
        from repro.models import whisper
        cfg = get_config(model)
        if kv:
            cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
        data = np.load(work / f"decode-{case}.npz")
        params = unflatten({k[7:]: jnp.asarray(data[k]) for k in data if k.startswith("params/")})
        mesh = make_mesh(tuple(shape), ("data", "model"))
        ctx = DistContext(mesh=mesh, batch_axes=("data",))
        api = build_model(cfg, ep=shape[1], impl="ref")
        shard = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t, is_leaf=is_spec)
        cache = api.init_cache(b, length)
        c_sh = shard(cache_specs(cache, cfg, ctx))
        t_sh = shard(batch_specs({"tokens": ((b, 1), jnp.int32)}, ctx))["tokens"]
        logits = []
        with distribution(ctx):
            params = jax.device_put(params, shard(param_specs(params, cfg, ctx)))
            if cfg.family == "encdec":
                f_sh = shard(batch_specs({"frames": (data["frames"].shape, jnp.float32)}, ctx))
                frames = jax.device_put(jnp.asarray(data["frames"]), f_sh["frames"])
                cache = jax.jit(lambda p, f, c: whisper.prefill_cross_cache(p, f, c, cfg),
                                out_shardings=c_sh)(params, frames, cache)
            cache = jax.device_put(cache, c_sh)
            step = jax.jit(api.decode_step, out_shardings=(None, c_sh))
            for i in range(steps):
                tok = jax.device_put(jnp.asarray(data["tokens"][:, i:i + 1]), t_sh)
                lg, cache = step(params, cache, tok, jnp.int32(i))
                logits.append(np.asarray(lg[:, 0]))
        np.savez(work / f"jax-decode-{case}.npz", logits=np.stack(logits))

    if part == "specs":
        specs()
    elif part == "misc":
        compression(2)
        compression(4)
        pipeline()
        for model in plan["ep"]:
            expert_parallel(model)
        meshes()
    elif part == "family-train":
        for case in plan["family_train"]:
            train(*case)
    elif part == "decode":
        for case in plan["decode"]:
            decode(*case)
    else:  # "train:<i>": every other train case from the i-th
        for case in plan["train"][int(part[6:])::2]:
            train(*case)
    """
)

RANK_SCRIPT = textwrap.dedent(
    """
    import dataclasses, json, os, sys
    from pathlib import Path
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    work, rank, world = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    part = sys.argv[4]
    dist.init_process_group("gloo", init_method=f"file://{work}/pg-{world}-{part}", rank=rank,
                            world_size=world)

    from repro_torch.checkpoint import flatten_tree, unflatten_tree
    from repro_torch.configs import get_config
    from repro_torch.distributed import (DistContext, distribute_tree, distribution,
                                         gather_tree, opt_specs, param_specs)
    from repro_torch.distributed.moe_parallel import moe_maybe_parallel
    from repro_torch.distributed.pipeline import bubble_fraction, pipeline_apply
    from repro_torch.launch import (make_debug_mesh, make_mesh, make_production_mesh,
                                    mesh_batch_axes)
    from repro_torch.models import build_model, moe
    from repro_torch.optim import init_adamw
    from repro_torch.optim.compression import compress_tree_psum, quantize_int8
    from repro_torch.training import make_train_step

    plan = json.loads((work / "plan.json").read_text())

    def save(name, arrays):
        if rank == 0:
            np.savez(work / name, **{k: v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
                                     for k, v in arrays.items()})

    def load_tree(data, prefix):
        n = len(prefix)
        return unflatten_tree({k[n:]: torch.from_numpy(data[k].copy()) for k in data
                               if k.startswith(prefix)})

    def drop_free(cfg):
        m = cfg.moe
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k, router_aux_coef=0.0))

    def train(case, model, shape, sp):
        # the sharded train step, with each config and with its drop-free variant
        mesh = make_mesh(tuple(shape), ("data", "model"), device_type="cpu")
        ctx = DistContext(mesh, ("data",), sequence_parallel=sp)
        data = np.load(work / f"train-{case}.npz")
        batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels", "frames") if k in data}
        res = {}
        name, _, heads = model.partition(":")  # "name:Hq/Hkv": other head counts
        base = get_config(name)
        if heads:
            hq, hkv = map(int, heads.split("/"))
            base = dataclasses.replace(base, n_heads=hq, n_kv_heads=hkv)
        variants = [("jax", base, 1)]
        if base.moe is not None:
            variants.append(("drop-free", drop_free(base), 1))
        if case == plan["microbatch_case"]:
            variants.append(("mb2", base, 2))
        for tag, cfg, mb in variants:
            api = build_model(cfg, device="cpu", ep=shape[1])
            params = load_tree(data, "params/")
            opt = init_adamw(params)
            ps = param_specs(params, cfg, ctx)
            params = distribute_tree(params, ps, ctx)
            opt = distribute_tree(opt, opt_specs(opt, ps, cfg, ctx), ctx)
            step = make_train_step(api, ctx=ctx, microbatches=mb, **plan["step_kw"])
            for i in range(2):
                params, opt, metrics = step(params, opt, batch)
                res.update({f"{tag}/metrics/{i}/{k}": v for k, v in metrics.items()})
            res.update({f"{tag}/params/{p}": t for p, t in flatten_tree(gather_tree(params))})
            res.update({f"{tag}/opt/{p}": t for p, t in flatten_tree(gather_tree(opt))})
        save(f"port-train-{case}.npz", res)

    def decode(case, model, shape, b, length, steps, kv):
        # the sharded decode, teacher-forced, counting B2's folds and the
        # ranks' partials that kept no slot
        from repro_torch.distributed import batch_specs, cache_specs
        from repro_torch.kernels.decode_attention import ops as dec_ops
        from repro_torch.models import whisper
        cfg = get_config(model)
        if kv:
            cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
        mesh = make_mesh(tuple(shape), ("data", "model"), device_type="cpu")
        ctx = DistContext(mesh, ("data",))
        data = np.load(work / f"decode-{case}.npz")
        api = build_model(cfg, device="cpu", ep=shape[1])
        params = load_tree(data, "params/")
        params = distribute_tree(params, param_specs(params, cfg, ctx), ctx)
        cache = api.init_cache(b, length)
        cache = distribute_tree(cache, cache_specs(cache, cfg, ctx), ctx)
        t_spec = batch_specs({"tokens": ((b, 1), torch.int64)}, ctx)
        counts = {"folds": 0, "empty": 0}
        fold = dec_ops.fold_partials

        def counting_fold(outs, lses):
            counts["folds"] += 1
            counts["empty"] += int(sum(bool(torch.isinf(l).all()) for l in lses))
            return fold(outs, lses)

        dec_ops.fold_partials = counting_fold
        logits = []
        with torch.no_grad(), distribution(ctx):
            if cfg.family == "encdec":
                frames = torch.from_numpy(data["frames"])
                f_spec = batch_specs({"frames": (tuple(frames.shape), frames.dtype)}, ctx)
                whisper.prefill_cross_cache(
                    params, distribute_tree({"frames": frames}, f_spec, ctx)["frames"], cache, cfg)
            for i in range(steps):
                tok = torch.from_numpy(data["tokens"][:, i:i + 1]).long()
                tok = distribute_tree({"tokens": tok}, t_spec, ctx)["tokens"]
                lg, cache = api.decode_step(params, cache, tok, i)
                logits.append(lg.full_tensor()[:, 0])
        dec_ops.fold_partials = fold
        save(f"port-decode-{case}.npz", {"logits": torch.stack(logits),
                                         "folds": np.asarray(counts["folds"]),
                                         "empty": np.asarray(counts["empty"])})

    def split_norm():
        # the gate norm's rows split over model: B3a's external-statistic
        # mode on each rank's columns, gathered, against the whole rows, both
        # ways; and rms_norm refusing a row split over ranks
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from repro_torch.distributed import tensor_parallel as tp
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        group = mesh.get_group("model")
        data = np.load(work / "split-norm.npz")
        x, w, dy = (torch.from_numpy(data[k]) for k in ("x", "w", "dy"))
        n = x.shape[-1]
        cols = slice(mesh.get_local_rank("model") * n // 2, (mesh.get_local_rank("model") + 1) * n // 2)
        xl = x[:, cols].clone().requires_grad_(True)
        wl = w[cols].clone().requires_grad_(True)
        y = tp.split_rms_norm(xl, wl, 1e-6, n, group)
        y.backward(dy[:, cols])
        res = {}
        for name, t in (("y", y.detach()), ("dx", xl.grad), ("dw", wl.grad)):
            parts = [torch.empty_like(t) for _ in range(2)]
            dist.all_gather(parts, t.contiguous(), group=group)
            res[name] = torch.cat(parts, dim=-1)
        xd = distribute_tensor(x, mesh, [Replicate(), Shard(1)], src_data_rank=None)
        wd = distribute_tensor(w, mesh, [Replicate(), Replicate()], src_data_rank=None)
        try:
            with distribution(DistContext(mesh, ("data",))):
                tp.rms_norm(xd, {"scale": wd}, 1e-6)
            res["refusal"] = ""
        except ValueError as e:
            res["refusal"] = str(e)
        save("port-split-norm.npz", res)

    if part == "family":
        split_norm()
        for case in plan["family_train"]:
            train(*case)
        for case in plan["decode"]:
            decode(*case)
        dist.destroy_process_group()
        sys.exit(0)

    # compression at this world size: rank r's slice of every input
    data = np.load(work / f"comp-{world}.npz")
    res = {}
    for tag in ("noerr", "err"):
        xs = load_tree(data, "x/")
        es = load_tree(data, "e/") if tag == "err" else None
        mine = lambda t: None if t is None else {p: v[rank] for p, v in flatten_tree(t)}
        x, e = mine(xs), mine(es)
        out, new = compress_tree_psum(unflatten_tree(x), None,
                                      None if e is None else unflatten_tree(e))
        q = {p: quantize_int8(v if e is None else v + e[p])[0] for p, v in x.items()}
        for label, t in (("out", dict(flatten_tree(out))), ("err", dict(flatten_tree(new))),
                         ("q", q)):
            for p, v in t.items():
                gathered = [torch.empty_like(v) for _ in range(world)]
                dist.all_gather(gathered, v.contiguous())
                res[f"{tag}/{label}/{p}"] = torch.stack(gathered).numpy()
    save(f"port-comp-{world}.npz", res)
    if world == 2:
        dist.destroy_process_group()
        sys.exit(0)

    # pipeline over a (pod 4, data 1) mesh
    mesh = make_mesh((4, 1), ("pod", "data"), device_type="cpu")
    data = np.load(work / "pipe.npz")
    res = {"bubble": np.asarray(bubble_fraction(plan["pipe"]["n_stages"], plan["pipe"]["n_micro"]))}
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    for kind in ("plain", "dtensor"):
        ws = torch.from_numpy(data["ws"])
        if kind == "dtensor":
            ws = distribute_tensor(ws, mesh, [Shard(0), Replicate()], src_data_rank=None)
        ws.requires_grad_(True)
        x = torch.from_numpy(data["x"]).requires_grad_(True)
        out = pipeline_apply(lambda w, h: torch.tanh(h @ w), ws, x, mesh, axis="pod")
        (out * torch.from_numpy(data["cot"])).sum().backward()
        gw = ws.grad.full_tensor() if kind == "dtensor" else ws.grad
        res.update({f"{kind}/out": out.detach(), f"{kind}/gw": gw, f"{kind}/gx": x.grad})
    save("port-pipe.npz", res)

    # the debug mesh, and the production mesh at 2 and 4 cards a host,
    # with and without pods
    rec = lambda m: dict(shape=list(m.shape), names=list(m.mesh_dim_names),
                         batch_axes=list(mesh_batch_axes(m)),
                         model_ranks=sorted(m["model"].mesh.flatten().tolist()))
    debug = make_debug_mesh(2, 2, device_type="cpu")
    res = {"debug": rec(debug)}
    for per_host in (None, 2, 4):
        if per_host is not None:
            os.environ["LOCAL_WORLD_SIZE"] = str(per_host)
        for multi_pod in (False, True):
            key = f"{per_host}/{multi_pod}"
            try:
                mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            except ValueError as e:
                res[key] = {"error": str(e)}
                continue
            res[key] = rec(mesh)
        os.environ.pop("LOCAL_WORLD_SIZE", None)
    all_res = [None] * world
    dist.all_gather_object(all_res, res)
    if rank == 0:
        (work / "port-meshes.json").write_text(json.dumps(all_res))

    # expert parallelism on (data 2, model 2)
    mesh = debug
    ctx = DistContext(mesh, ("data",))
    for model in plan["ep"]:
        cfg = get_config(model)
        data = np.load(work / f"ep-{model}.npz")
        layer = load_tree(data, "params/")
        specs = {k: v for k, v in param_specs({"groups": {"pos0": {"moe": layer}}}, cfg, ctx)
                 ["groups"]["pos0"]["moe"].items()}
        specs = {k: (v[1:] if k != "router" else {"w": v["w"][1:]}) for k, v in specs.items()}
        layer = distribute_tree(layer, specs, ctx)
        res = {}
        for tag in ("x", "x_decode"):
            x = distribute_tree({"x": torch.from_numpy(data[tag])}, {"x": ("data", None, None)},
                                ctx)["x"]
            before = moe.moe_mlp_ep.exchanges
            with distribution(ctx):
                y, aux = moe_maybe_parallel(layer, x, cfg)
            res[f"{tag}/y"], res[f"{tag}/aux"] = y.full_tensor(), aux.full_tensor()
            res[f"{tag}/exchanges"] = np.asarray(moe.moe_mlp_ep.exchanges - before)
        save(f"port-ep-{model}.npz", res)

    # the stacked groups' gradients through DTensor unbind on the debug mesh:
    # the node whose input is each leaf, and the gradients gathered
    from repro_torch.distributed import batch_specs
    unbind_case, unbind_model = plan["unbind"]
    cfg = drop_free(get_config(unbind_model))
    api = build_model(cfg, device="cpu", ep=2)
    data = np.load(work / f"train-{unbind_case}.npz")
    params = load_tree(data, "params/")
    params = distribute_tree(params, param_specs(params, cfg, ctx), ctx)
    leaves = flatten_tree(params)
    tensors = [t.requires_grad_(True) for _, t in leaves]
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}
    batch = distribute_tree(batch, batch_specs({k: (tuple(x.shape), x.dtype)
                                                for k, x in batch.items()}, ctx), ctx)
    with distribution(ctx):
        loss, _ = api.loss_fn(params, batch, remat=True)
    paths, feeds, seen, todo = {id(t): p for p, t in leaves}, {}, set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if id(getattr(nxt, "variable", None)) in paths:
                feeds.setdefault(paths[id(nxt.variable)], []).append(type(node).__name__)
            todo.append(nxt)
    grads = torch.autograd.grad(loss, tensors)
    res = {f"grads/{p}": g.full_tensor() for (p, _), g in zip(leaves, grads)}
    res.update({f"feeds/{p}": np.asarray(",".join(sorted(f))) for p, f in feeds.items()})
    save("port-unbind.npz", res)

    for case in plan["train"]:
        train(*case)
    dist.destroy_process_group()
    """
)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return env


def _wait(procs, what: str, deadline: float) -> None:
    """Wait for every process; kill them all once one fails or time runs out."""
    while any(p.poll() is None for p in procs):
        failed = [p for p in procs if p.returncode not in (None, 0)]
        if failed or time.monotonic() > deadline:
            for proc in procs:
                proc.kill()
            if failed:
                raise AssertionError(f"{what}: exit {failed[0].returncode}\n"
                                     f"{failed[0].stderr.read()[-4000:]}")
            raise AssertionError(f"{what}: no end within {TIME_LIMIT_S} s; killed")
        time.sleep(0.2)
    bad = [p for p in procs if p.returncode != 0]
    if bad:
        raise AssertionError(f"{what}: exit {bad[0].returncode}\n{bad[0].stderr.read()[-4000:]}")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Draws the inputs, then runs the JAX subprocesses and the gloo ranks
    of both world sizes at once; returns the directory of their results."""
    work = tmp_path_factory.mktemp("dist")
    _write_inputs(work)
    deadline = time.monotonic() + TIME_LIMIT_S
    spawn = lambda args, env: subprocess.Popen(
        [sys.executable, "-c", *args], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    jax_env = dict(_env(), OMP_NUM_THREADS="2")
    jax_procs = [spawn([JAX_SCRIPT, str(work), part], jax_env)
                 for part in ("specs", "misc", "train:0", "train:1", "family-train", "decode")]
    groups = {(w, part): [spawn([RANK_SCRIPT, str(work), str(r), str(w), part], _env())
                          for r in range(w)]
              for w, part in ((2, "main"), (4, "main"), (4, "family"))}
    for (w, part), ranks in groups.items():
        _wait(ranks, f"gloo ranks (world {w}, {part})", deadline)
    _wait(jax_procs, "JAX subprocesses", deadline)
    return work


def _maxerr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


# ------------------------------------------------------------------ (a) specs
@pytest.fixture(scope="module")
def jax_specs(work):
    return json.loads((work / "jax-specs.json").read_text())


def _port_specs(name: str, mesh_key: str):
    shape, axes = MESHES[mesh_key]
    ctx = DistContext(AbstractMesh(shape, axes), tuple(a for a in axes if a != "model"))
    cfg = get_config(name)
    api = build_model(cfg, device="meta", ep=shape[-1])
    params = api.init()
    ps = param_specs(params, cfg, ctx)
    out = dict(params=ps, opt=opt_specs(init_adamw(params), ps, cfg, ctx),
               batch={kind: batch_specs(api.batch_spec(get_shape(kind)), ctx)
                      for kind in ("train_4k", "prefill_32k", "decode_32k")},
               caches=[])
    for b, length, kv in CACHES:
        c = dataclasses.replace(cfg, kv_cache_dtype=kv) if kv else cfg
        cache = build_model(c, device="meta", ep=shape[-1]).init_cache(b, length)
        out["caches"].append(cache_specs(cache, c, ctx))
    return out


def _spec_json(tree):
    """The JSON form of a tree of specs (what the JAX side writes)."""
    if isinstance(tree, dict):
        return {k: _spec_json(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_json(v) for v in tree]
    return _norm_spec(tree)


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("name", list_archs())
def test_specs_match_jax(jax_specs, name, mesh_key):
    port = _spec_json(_port_specs(name, mesh_key))
    assert json.loads(json.dumps(port)) == jax_specs[f"{name}/{mesh_key}"]


# ------------------------------------------------------------ (b) compression
@pytest.mark.parametrize("residual", ["noerr", "err"])
@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_matches_jax(work, world, residual):
    port = np.load(work / f"port-comp-{world}.npz")
    jax_ = np.load(work / f"jax-comp-{world}.npz")
    for leaf in COMP_LEAVES:
        q, jq = port[f"{residual}/q/{leaf}"], jax_[f"{residual}/q/{leaf}"]
        assert q.dtype == jq.dtype == np.int8 and np.array_equal(q, jq), leaf
        for label in ("out", "err"):
            key = f"{residual}/{label}/{leaf}"
            assert port[key].shape == jax_[key].shape
            assert _maxerr(port[key], jax_[key]) < 1e-6, key
        # every rank holds the same mean
        assert np.array_equal(port[f"{residual}/out/{leaf}"][0], port[f"{residual}/out/{leaf}"][-1])


# --------------------------------------------------------------- (c) pipeline
@pytest.mark.parametrize("kind", ["plain", "dtensor"])
def test_pipeline_matches_jax_and_sequential(work, kind):
    port, jax_ = np.load(work / "port-pipe.npz"), np.load(work / "jax-pipe.npz")
    data = np.load(work / "pipe.npz")
    ws = torch.from_numpy(data["ws"]).requires_grad_(True)
    x = torch.from_numpy(data["x"]).requires_grad_(True)
    ref = x
    for i in range(PIPE["n_stages"]):
        ref = torch.tanh(ref @ ws[i])
    (ref * torch.from_numpy(data["cot"])).sum().backward()
    assert port[f"{kind}/out"].shape == jax_["out"].shape == ref.shape
    assert _maxerr(port[f"{kind}/out"], jax_["out"]) < 1e-5
    assert _maxerr(port[f"{kind}/out"], ref.detach().numpy()) < 1e-5
    assert _maxerr(port[f"{kind}/gw"], ws.grad.numpy()) < 1e-5
    assert _maxerr(port[f"{kind}/gx"], x.grad.numpy()) < 1e-5


def test_bubble_fraction_matches_jax(work):
    port, jax_ = np.load(work / "port-pipe.npz"), np.load(work / "jax-pipe.npz")
    assert float(port["bubble"]) == float(jax_["bubble"]) == pytest.approx(3 / 11)


# --------------------------------------------------------------------- (d) EP
@pytest.mark.parametrize("tag", ["x", "x_decode"])
@pytest.mark.parametrize("model", EP_MODELS)
def test_expert_parallel_matches_jax(work, model, tag):
    port, jax_ = np.load(work / f"port-ep-{model}.npz"), np.load(work / f"jax-ep-{model}.npz")
    assert port[f"{tag}/y"].shape == jax_[f"{tag}/y"].shape
    assert _maxerr(port[f"{tag}/y"], jax_[f"{tag}/y"]) < 1e-5
    assert _maxerr(port[f"{tag}/aux"], jax_[f"{tag}/aux"]) < 1e-5
    # prefill takes the EP path (an exchange out and one back), decode the local one
    assert int(port[f"{tag}/exchanges"]) == (2 if tag == "x" else 0)


# ------------------------------------------------------------ (e) train step
def _unsharded(work: Path, case: str, microbatches: int = 1):
    """The port's two unsharded steps on the case's inputs (MoE: drop-free,
    aux unweighed): (metrics, params, opt) as numpy."""
    _, model, shape, _ = next(c for c in TRAIN_CASES + FAMILY_TRAIN_CASES if c[0] == case)
    cfg = model_config(model)
    if cfg.moe is not None:
        cfg = _drop_free(cfg)
    data = np.load(work / f"train-{case}.npz")
    params = unflatten_tree({k[7:]: torch.from_numpy(data[k].copy()) for k in data
                             if k.startswith("params/")})
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels", "frames") if k in data}
    api = build_model(cfg, device="cpu", ep=shape[1])
    opt = init_adamw(params)
    step = make_train_step(api, microbatches=microbatches, **STEP_KW)
    metrics = {}
    for i in range(2):
        params, opt, m = step(params, opt, batch)
        metrics.update({f"metrics/{i}/{k}": v.numpy() for k, v in m.items()})
    return dict(metrics, **{f"params/{p}": t.detach().numpy() for p, t in flatten_tree(params)},
                **{f"opt/{p}": t.numpy() for p, t in flatten_tree(opt)})


def _compare(port: dict, prefix: str, ref, skip=()) -> None:
    keys = sorted(k for k in ref.keys())
    assert sorted(k[len(prefix):] for k in port if k.startswith(prefix)) == keys
    for key in keys:
        if key in skip:
            continue
        got, want = port[prefix + key], ref[key]
        assert np.shape(got) == np.shape(want), key
        if key.startswith("params/"):  # each param its master in the param's dtype
            master = port[prefix + "opt/master/" + key[len("params/"):]]
            assert np.array_equal(got, master.astype(got.dtype)), key
        if key.startswith("opt/step"):
            assert int(got) == int(want) == 2
            continue
        tol = PARAM_TOL if key.startswith(("params/", "opt/master/")) else TOL
        assert _maxerr(got, want) < tol, (key, _maxerr(got, want))


ALL_TRAIN_CASES = TRAIN_CASES + FAMILY_TRAIN_CASES


@pytest.mark.parametrize("case", [c[0] for c in ALL_TRAIN_CASES])
def test_sharded_train_step_matches_jax(work, case):
    _compare(np.load(work / f"port-train-{case}.npz"), "jax/",
             np.load(work / f"jax-train-{case}.npz"))


@pytest.mark.parametrize("case", [c[0] for c in ALL_TRAIN_CASES])
def test_sharded_train_step_matches_unsharded(work, case):
    port = np.load(work / f"port-train-{case}.npz")
    model = next(c[1] for c in ALL_TRAIN_CASES if c[0] == case)
    if model_config(model).moe is None:
        _compare(port, "jax/", _unsharded(work, case))
    else:  # the aux metric is each rank's tokens' mean, averaged (unweighed here)
        _compare(port, "drop-free/", _unsharded(work, case),
                 skip=("metrics/0/aux", "metrics/1/aux"))


def test_sharded_train_step_with_microbatches_matches_unsharded(work):
    port = np.load(work / f"port-train-{MICROBATCH_CASE}.npz")
    _compare(port, "mb2/", _unsharded(work, MICROBATCH_CASE, microbatches=2))


def test_sharded_grads_through_dtensor_unbind_match_unsharded(work):
    """On the debug mesh each stacked DTensor leaf feeds exactly one
    ``UnbindBackward0`` (no leaf falls back to index selects), and the
    gathered gradients equal the unsharded port's."""
    port = np.load(work / "port-unbind.npz")
    cfg = _drop_free(model_config(UNBIND_MODEL))
    data = np.load(work / f"train-{UNBIND_CASE}.npz")
    params = unflatten_tree({k[7:]: torch.from_numpy(data[k].copy()) for k in data
                             if k.startswith("params/")})
    leaves = flatten_tree(params)
    tensors = [t.requires_grad_(True) for _, t in leaves]
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}
    loss, _ = build_model(cfg, device="cpu", ep=2).loss_fn(params, batch, remat=True)
    grads = torch.autograd.grad(loss, tensors)
    stacked = [p for p, _ in leaves if p.startswith("groups/")]
    assert len(stacked) == 10
    assert {p: str(port[f"feeds/{p}"]) for p in stacked} == dict.fromkeys(stacked,
                                                                         "UnbindBackward0")
    for (path, _), g in zip(leaves, grads):
        assert _maxerr(port[f"grads/{path}"], g.numpy()) < TOL, path


def test_split_gate_norm_normalises_whole_rows(work):
    """Each rank holds half of every row's 16 columns: the output and both
    gradients must be the whole row's norm (a rank normalising its own
    columns alone would give another output and other gradients)."""
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

    port = np.load(work / "port-split-norm.npz")
    data = np.load(work / "split-norm.npz")
    x, w, dy = (torch.from_numpy(data[k]) for k in ("x", "w", "dy"))
    dx, dw = rmsnorm_bwd_ref(dy, x, w, 1e-6)
    assert _maxerr(port["y"], rmsnorm_ref(x, w, 1e-6).numpy()) < 1e-6
    assert _maxerr(port["dx"], dx.numpy()) < 1e-6
    assert _maxerr(port["dw"], dw.numpy()) < 1e-6
    halves = torch.cat([rmsnorm_ref(x[:, :8], w[:8], 1e-6), rmsnorm_ref(x[:, 8:], w[8:], 1e-6)], -1)
    assert _maxerr(port["y"], halves.numpy()) > 1e-3


def test_rms_norm_refuses_rows_split_over_ranks(work):
    assert "last dim is split" in str(np.load(work / "port-split-norm.npz")["refusal"])


# -------------------------------------------------------------- (g) decode
def _unsharded_decode(work: Path, case: str) -> np.ndarray:
    """The port's unsharded decode of the case's tokens: logits [steps, B, V]."""
    from repro_torch.models import whisper

    _, model, shape, b, length, steps, kv = next(c for c in DECODE_CASES if c[0] == case)
    cfg = _decode_cfg(model, kv)
    data = np.load(work / f"decode-{case}.npz")
    params = unflatten_tree({k[7:]: torch.from_numpy(data[k].copy()) for k in data
                             if k.startswith("params/")})
    api = build_model(cfg, device="cpu", ep=shape[1])
    cache = api.init_cache(b, length)
    out = []
    with torch.no_grad():
        if cfg.family == "encdec":
            whisper.prefill_cross_cache(params, torch.from_numpy(data["frames"]), cache, cfg)
        for i in range(steps):
            lg, cache = api.decode_step(params, cache, torch.from_numpy(
                data["tokens"][:, i:i + 1]).long(), i)
            out.append(lg[:, 0].numpy())
    return np.stack(out)


def _check_logits(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert got.shape == want.shape, what
    for i in range(got.shape[0]):
        assert _maxerr(got[i], want[i]) < DECODE_TOL, (what, i, _maxerr(got[i], want[i]))
    assert np.array_equal(got.argmax(-1), want.argmax(-1)), what


@pytest.mark.parametrize("case", [c[0] for c in DECODE_CASES])
def test_sharded_decode_matches_jax_serve_step(work, case):
    port = np.load(work / f"port-decode-{case}.npz")
    _check_logits(port["logits"], np.load(work / f"jax-decode-{case}.npz")["logits"], case)


@pytest.mark.parametrize("case", [c[0] for c in DECODE_CASES])
def test_sharded_decode_matches_unsharded(work, case):
    port = np.load(work / f"port-decode-{case}.npz")
    _check_logits(port["logits"], _unsharded_decode(work, case), case)
    model = next(c[1] for c in DECODE_CASES if c[0] == case)
    attention = any(k != "mamba" for k in get_config(model).layer_kinds())
    # B2's partials are folded wherever a cache's slots are split
    assert (int(port["folds"]) > 0) == attention
    if case == "gemma3-ring":  # positions 0-15: the second half of the ring is empty
        assert int(port["empty"]) > 0


# ---------------------------------------------------------------- meshes
@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_layout_matches_jax(work, multi_pod):
    # 256 / 512 ranks of 16 cards a host: the JAX package's pod meshes
    jax_ = json.loads((work / "jax-meshes.json").read_text())[f"production/{multi_pod}"]
    shape, names = production_layout(512 if multi_pod else 256, 16, multi_pod)
    assert (list(shape), list(names)) == (jax_["shape"], jax_["names"])


@pytest.mark.parametrize("world,per_host,multi_pod,want", [
    (8, 4, False, ((2, 4), ("data", "model"))),
    (8, 4, True, ((2, 1, 4), ("pod", "data", "model"))),
    (2, 8, False, ((1, 2), ("data", "model"))),  # fewer ranks than cards a host
    (6, 4, False, "not a multiple"),
    (4, 4, True, "even number of hosts"),
])
def test_production_layout(world, per_host, multi_pod, want):
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            production_layout(world, per_host, multi_pod)
    else:
        assert production_layout(world, per_host, multi_pod) == want


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("per_host", [None, 2, 4])
def test_make_production_mesh_on_gloo_ranks(work, per_host, multi_pod):
    """World 4, ``LOCAL_WORLD_SIZE`` unset (on the CPU: one host), 2 or 4:
    the mesh's dims, their sizes, its DP axes (JAX's ``mesh_batch_axes`` of
    the same dims) and each rank's ``model`` group (its host's ranks)."""
    ranks = json.loads((work / "port-meshes.json").read_text())
    jax_ = json.loads((work / "jax-meshes.json").read_text())
    got = [r[f"{per_host}/{multi_pod}"] for r in ranks]
    model = per_host or 4
    if multi_pod and model == 4:  # one host cannot split into two pods
        assert all("even number of hosts" in g["error"] for g in got)
        return
    want = production_layout(4, model, multi_pod)
    jax_axes = jax_[f"production/{multi_pod}"]
    for rank, g in enumerate(got):
        assert (tuple(g["shape"]), tuple(g["names"])) == want
        assert g["names"] == jax_axes["names"] and g["batch_axes"] == jax_axes["batch_axes"]
        first = rank - rank % model
        assert g["model_ranks"] == list(range(first, first + model))


def test_make_debug_mesh_matches_jax(work):
    jax_ = json.loads((work / "jax-meshes.json").read_text())["debug"]
    for rank, r in enumerate(json.loads((work / "port-meshes.json").read_text())):
        g = r["debug"]
        assert [g["shape"], g["names"], g["batch_axes"]] == [
            jax_["shape"], jax_["names"], jax_["batch_axes"]]
        assert g["model_ranks"] == [rank - rank % 2, rank - rank % 2 + 1]


# ------------------------------------------------------------- small pieces
def test_local_kv_heads():
    # granite-34b at model 4: 12 q heads a rank on the one kv head (G 12)
    assert [local_kv_heads(r, 12, 48) for r in range(4)] == [(0, 1)] * 4
    # h2o-danube-1.8b-smoke (4/2) at model 4: rank r's q head uses kv head r // 2
    assert [local_kv_heads(r, 1, 2) for r in range(4)] == [(0, 1), (0, 1), (1, 1), (1, 1)]
    # 8 q heads a rank at G 4: two kv heads each
    assert local_kv_heads(1, 8, 4) == (2, 2)
    with pytest.raises(NotImplementedError):
        local_kv_heads(1, 4, 6)


def test_constrain_is_a_no_op_on_plain_tensors():
    from repro_torch.distributed import distribution

    x = torch.ones(4, 8, 2)
    assert constrain(x, "residual") is x
    ctx = DistContext(AbstractMesh((2, 2), ("data", "model")), ("data",))
    with distribution(ctx):
        assert constrain(x, "residual") is x
