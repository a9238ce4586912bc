"""The published Zamba2's ``hybrid`` kind in repro_torch against the
benchmark's plain reference (``portbench/reference/zamba2.py``), on the CPU.

A tiny model of the published layer (one period of 5 mamba layers and a
hybrid one, then a tail of 2 mamba layers; d 64, 4 heads of 32 over the 128
wide concatenation, N 16, adapter rank 8, vocab 256) on the same weights:
the loss and every leaf's gradient, the shared block's, the adapters' and
the linear's included, with remat on and off, in fp32 and in bf16.  Then
the parameter count at the published widths (on the meta device), and the
paths the kind does not have: decode and a mesh."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the benchmark's reference lives beside src/
    sys.path.insert(0, str(ROOT))

from portbench import weights  # noqa: E402
from portbench.reference import common, zamba2  # noqa: E402
from repro_torch.checkpoint import flatten_tree  # noqa: E402
from repro_torch.configs.base import ModelConfig, SSMConfig  # noqa: E402
from repro_torch.configs.zamba2_1_2b_published import CONFIG as PUBLISHED  # noqa: E402
from repro_torch.distributed.sharding_rules import param_specs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCH = {"family": "hybrid", "n_layers": 8, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
        "head_dim": 32, "d_ff": 128, "vocab_size": 256, "pattern": ["mamba"] * 5 + ["hybrid"],
        "rope_theta": 10000.0, "norm_eps": 1e-5, "tie_embeddings": True,
        "adapter_rank": 8, "param_dtype": "float32", "compute_dtype": "float32",
        "ssm": {"d_state": 16, "head_dim": 16, "expand": 2, "n_groups": 1, "conv_width": 4,
                "chunk": 16}}
BATCH, SEQ = 2, 64  # 4 SSD chunks
#: fp32 on both sides: the sums run in another order (the flash kernel's
#: plain version and the chunked scan against the reference's query blocks
#: and einsums), a few fp32 ulps on values of order 1, well under this
FP32_TOL = 1e-4
#: bf16 activations and weights against the reference on its masters
#: rounded to bf16: every product of the program rounds to bf16 (2^-9
#: relative), 8 layers deep and back.  These weights read a loss gap of
#: 1.7e-5 and a worst gradient-norm gap of 0.067 (``mamba/D``, remat on and
#: off alike); the reference with fp8 products reads 3.0e-4 and 0.24
#: against the fp32 one, outside both bounds
BF16_LOSS_TOL = 1e-4
BF16_GRAD_TOL = 0.1


def config(dtype: str) -> ModelConfig:
    a = dict(ARCH, param_dtype=dtype, compute_dtype=dtype)
    a["pattern"] = tuple(a["pattern"])
    a["ssm"] = SSMConfig(**a["ssm"])
    return ModelConfig(name="zamba2-published-tiny", **a)


def draw(seed: int):
    """fp32 weights by the benchmark's draw, with the norm scales and conv
    biases (drawn as 0) given values, so that they are tested too."""
    params = weights.make_params(zamba2.param_shapes(ARCH), seed, "cpu", fp32=True)
    gen = torch.Generator().manual_seed(seed)
    for path, t in common.flatten(params):
        if path.endswith(("scale", "_b")):
            t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
    return params


def batch(seed: int):
    gen = torch.Generator().manual_seed(seed)
    t = torch.randint(0, ARCH["vocab_size"], (BATCH, SEQ + 1), generator=gen, dtype=torch.int32)
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}


def program_grads(params, b, dtype: str, remat: bool):
    api = build_model(config(dtype), device="cpu")
    prog = common.unflatten((p, t.to(getattr(torch, d)).requires_grad_(True))
                            for (p, t), (_, (_, d)) in zip(
                                common.flatten(params),
                                common.flatten(zamba2.param_shapes(dict(ARCH, param_dtype=dtype)))))
    leaves = flatten_tree(prog)
    loss, _ = api.loss_fn(prog, b, remat=remat)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return float(loss.detach()), {p: g.float() for (p, _), g in zip(leaves, grads)}


def reference_grads(params, b, dtype: str):
    shapes = zamba2.param_shapes(dict(ARCH, param_dtype=dtype))
    num = common.Numerics(dtypes=common.unflatten((p, d) for p, (_, d) in common.flatten(shapes)))
    ref = common.unflatten((p, t.clone().requires_grad_(True)) for p, t in common.flatten(params))
    leaves = common.flatten(ref)
    loss = zamba2.loss_fn(ref, b, ARCH, num)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return float(loss.detach()), {p: g for (p, _), g in zip(leaves, grads)}


OWN = ("shared/attn/q/w", "shared/mlp/gate_up/w", "shared/ln1/scale", "groups/pos5/linear/w",
       "groups/pos5/lora/q/down/w", "groups/pos5/lora/v/up/w", "groups/pos5/lora/gate_up/up/w",
       "groups/pos5/mamba/out_proj/w", "tail/pos1/mamba/A_log")


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_fp32_loss_and_every_gradient(remat):
    params, b = draw(1), batch(1)
    loss, grads = program_grads(params, b, "float32", remat)
    want, ref = reference_grads(params, b, "float32")
    assert abs(loss - want) <= FP32_TOL * abs(want)
    assert set(grads) == set(ref) and set(OWN) <= set(grads)
    for path, g in ref.items():
        scale = float(g.abs().max())
        assert scale > 0, path  # every leaf is reached
        err = float((grads[path] - g).abs().max())
        assert err <= FP32_TOL * scale, (path, err, scale)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_bf16_against_the_references_rounding(remat):
    params, b = draw(2), batch(2)
    loss, grads = program_grads(params, b, "bfloat16", remat)
    want, ref = reference_grads(params, b, "bfloat16")
    assert abs(loss - want) <= BF16_LOSS_TOL * abs(want)
    norms = {p: float(g.norm()) for p, g in ref.items()}
    med = sorted(norms.values())[len(norms) // 2]
    for path, g in grads.items():  # the harness's measure: by norm, floored at the median's
        gap = abs(float(g.norm()) - norms[path]) / max(norms[path], med)
        assert gap <= BF16_GRAD_TOL, (path, gap)


def test_shared_block_spans_and_counter():
    """While the profiler records, a forward calls the shared block once a
    hybrid layer, inside the ``shared`` span, and each Mamba2 mixer inside
    ``mamba``; their backward spans follow."""
    api = build_model(config("float32"), device="cpu")
    params = api.init(seed=3)
    leaves = [t.requires_grad_(True) for _, t in flatten_tree(params)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        loss, _ = api.loss_fn(params, batch(3), remat=True)
        torch.autograd.grad(loss, leaves)
    names = [e.name for e in prof.events()]
    counts = {n: names.count(n) for n in ("shared", "shared.bwd", "mamba", "mamba.bwd")}
    # one hybrid call of 8 layers; remat recomputes the group's forward
    assert counts == {"shared": 2, "shared.bwd": 1, "mamba": 8 + 6, "mamba.bwd": 8}, counts


def test_published_parameter_count():
    params = build_model(PUBLISHED, device="meta").init(seed=0)
    n = sum(t.numel() for _, t in flatten_tree(params))
    assert n == PUBLISHED.param_count() == 1_205_078_912
    assert PUBLISHED.layer_kinds().count("hybrid") == 6
    shapes = zamba2.param_shapes(dict(ARCH, n_layers=38, d_model=2048, n_heads=32,
                                      n_kv_heads=32, head_dim=128, d_ff=8192, vocab_size=32000,
                                      adapter_rank=128,
                                      ssm=dict(ARCH["ssm"], d_state=64, head_dim=64, chunk=256)))
    assert {p: tuple(s) for p, (s, _) in common.flatten(shapes)} == {
        p: tuple(t.shape) for p, t in flatten_tree(params)}


def test_decode_and_mesh_are_not_ported():
    api = build_model(config("float32"), device="cpu")
    with pytest.raises(NotImplementedError):
        api.init_cache(BATCH, 16)
    with pytest.raises(NotImplementedError):
        param_specs(build_model(PUBLISHED, device="meta").init(seed=0), PUBLISHED, None)
