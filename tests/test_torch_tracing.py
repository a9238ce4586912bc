"""The port's spans and counters (``repro_torch.tracing``) in a training
step of a tiny granite-moe (granite-moe-3b-a800m-smoke at 3 layers, fp32,
capacity factor 0.5 so that pairs are dropped), remat on, on the CPU:

* one train step under ``torch.profiler`` holds every span the benchmark
  reads: ``step.forward``, ``step.backward``, ``optimizer``, ``recompute``,
  ``moe`` / ``moe.bwd`` and ``ce`` / ``ce.bwd``, the backward ones on the
  thread that runs the backward, each recompute inside ``step.backward`` and
  outside every ``.bwd`` span of the MoE layer;
* the MoE counters equal a count made here from the router's top-k and
  ``_capacity`` on the inputs each MoE layer received, once a forward
  (remat's recompute adds nothing);
* the loss, every gradient and the updated state are bit for bit the same
  with the profiler on and off, and when it starts or stops between a
  forward and its backward;
* with the profiler off no span node joins the graph, no counter moves and
  no ``record_function`` is entered;
* the sharded step (one gloo rank) holds the same spans, in a subprocess.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.checkpoint import flatten_tree, unflatten_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import moe_parallel  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.optim import init_adamw  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402

LAYERS = 3
BATCH, SEQ = 2, 32
STEP_KW = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10, remat=True)
SPANS = ("step.forward", "step.backward", "step.backward.caller", "optimizer", "recompute", "moe",
         "moe.bwd", "ce", "ce.bwd")
REPO = Path(__file__).resolve().parents[1]


def _cfg():
    cfg = get_config("granite-moe-3b-a800m-smoke")
    return dataclasses.replace(cfg, n_layers=LAYERS,
                               moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))


@pytest.fixture(scope="module")
def model():
    cfg = _cfg()
    api = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen)
             for k in ("tokens", "labels")}
    return api, api.init(seed=0), batch


@pytest.fixture(autouse=True)
def fresh_counters():
    tracing.reset_counters()
    yield
    tracing.reset_counters()


def _fresh(params):
    return unflatten_tree({p: t.detach().clone() for p, t in flatten_tree(params)})


def _step(api, params, batch, traced: bool):
    """One train step on copies of ``params``: (new params, opt state,
    metrics, the profiler's events or None)."""
    params = _fresh(params)
    step = make_train_step(api, **STEP_KW)
    if not traced:
        return (*step(params, init_adamw(params), batch), None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = step(params, init_adamw(params), batch)
    return (*out, prof.events())


def _grads(api, params, batch, remat: bool):
    """(loss, grads) through the train step's own forward_backward."""
    params = _fresh(params)
    tensors = [t.requires_grad_(True) for _, t in flatten_tree(params)]
    loss, _, grads = tracing.forward_backward(
        lambda p: api.loss_fn(p, batch, remat=remat), params, tensors, allow_unused=True)
    return loss.detach(), grads


def _named(events, name):
    return [e for e in events if e.name == name]


def _ancestors(e):
    out, p = [], e.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def _inside(inner, outer) -> bool:
    a, b = inner.time_range, outer.time_range
    return inner.thread == outer.thread and b.start <= a.start and a.end <= b.end


def test_train_step_holds_every_span(model):
    api, params, batch = model
    *_, events = _step(api, params, batch, traced=True)
    counts = {name: len(_named(events, name)) for name in SPANS}
    # a forward and a recompute a MoE layer; the CE over one chunk, recomputed once
    assert counts == {"step.forward": 1, "step.backward": 1, "step.backward.caller": 1,
                      "optimizer": 1, "recompute": LAYERS + 1, "moe": 2 * LAYERS,
                      "moe.bwd": LAYERS, "ce": 1, "ce.bwd": 1}, counts
    (fwd,), (bwd,) = _named(events, "step.forward"), _named(events, "step.backward")
    backward_threads = {e.thread for e in events
                        if e.name.startswith("autograd::engine::evaluate_function")}
    assert backward_threads, "no autograd node in the trace"
    for name in ("step.backward", "moe.bwd", "ce.bwd"):
        assert {e.thread for e in _named(events, name)} <= backward_threads, name
    for e in _named(events, "moe.bwd") + _named(events, "ce.bwd"):
        assert _inside(e, bwd)
    # the calling thread's side holds the whole backward (here one thread runs both)
    (caller,) = _named(events, "step.backward.caller")
    assert fwd.time_range.end <= caller.time_range.start and _inside(bwd, caller)
    for e in _named(events, "recompute"):
        assert _inside(e, bwd) and "step.backward" in _ancestors(e)
        assert "moe.bwd" not in _ancestors(e)
    first = [e for e in _named(events, "moe") if _inside(e, fwd)]
    again = [e for e in _named(events, "moe") if "recompute" in _ancestors(e)]
    assert len(first) == len(again) == LAYERS
    assert all(_inside(e, fwd) for e in _named(events, "ce"))
    # the spans of one step do not overlap
    (opt,) = _named(events, "optimizer")
    assert fwd.time_range.end <= bwd.time_range.start <= bwd.time_range.end
    assert caller.time_range.end <= opt.time_range.start


def test_moe_span_in_a_forward_without_grad(model):
    api, params, batch = model
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        api.forward(params, batch["tokens"])
    events = prof.events()
    assert len(_named(events, "moe")) == LAYERS and not _named(events, "moe.bwd")
    assert tracing.counters()["moe.routed"] == LAYERS * BATCH * SEQ * _cfg().moe.top_k


def _expected_counts(calls, cfg):
    """The counters from each MoE layer's input: per expert, the pairs the
    router's top-k sends it, against ``_capacity``."""
    out = dict.fromkeys(("moe.routed", "moe.dropped", "moe.rows", "moe.rows_filled"), 0)
    for lp, x in calls:
        x_flat = x.reshape(-1, x.shape[-1])
        _, idx, _ = moe._route(x_flat, lp, cfg)
        cap = moe._capacity(x_flat.shape[0], cfg)
        load = torch.bincount(idx.reshape(-1), minlength=lp["gate"].shape[0])
        out["moe.routed"] += idx.numel()
        out["moe.dropped"] += int((load - cap).clamp_min(0).sum())
        out["moe.rows"] += lp["gate"].shape[0] * cap
        out["moe.rows_filled"] += int(load.clamp_max(cap).sum())
    return out


def test_counters_match_the_router(model, monkeypatch):
    api, params, batch = model
    calls = []
    layer_fn = moe_parallel.moe_mlp_local

    def recording(lp, x, cfg):
        if torch._C._current_graph_task_id() == -1:  # the first forward, not the recompute
            calls.append(({k: (v.detach() if torch.is_tensor(v) else
                               {kk: vv.detach() for kk, vv in v.items()})
                           for k, v in lp.items()}, x.detach()))
        return layer_fn(lp, x, cfg)

    monkeypatch.setattr(moe_parallel, "moe_mlp_local", recording)
    *_, events = _step(api, params, batch, traced=True)
    assert len(calls) == LAYERS and len(_named(events, "recompute")) == LAYERS + 1
    got, want = tracing.counters(), _expected_counts(calls, api.cfg)
    assert got == want
    assert got["moe.dropped"] > 0  # capacity factor 0.5 drops
    assert got["moe.rows_filled"] == got["moe.routed"] - got["moe.dropped"]
    assert got["moe.rows_filled"] < got["moe.rows"]


def _assert_same(a, b, what):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert [p for p, _ in fa] == [p for p, _ in fb], what
    for (p, x), (_, y) in zip(fa, fb):
        assert torch.equal(x, y), f"{what}: {p}"


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_tracing_changes_no_gradient(model, remat):
    api, params, batch = model
    loss_off, grads_off = _grads(api, params, batch, remat)
    with profile(activities=[ProfilerActivity.CPU]):
        loss_on, grads_on = _grads(api, params, batch, remat)
    assert torch.equal(loss_on, loss_off)
    for g_on, g_off in zip(grads_on, grads_off):
        assert (g_on is None) == (g_off is None)
        if g_on is not None:
            assert torch.equal(g_on, g_off)


def test_tracing_changes_no_step(model):
    api, params, batch = model
    p_off, o_off, m_off, _ = _step(api, params, batch, traced=False)
    p_on, o_on, m_on, _ = _step(api, params, batch, traced=True)
    _assert_same(p_on, p_off, "params")
    _assert_same(o_on, o_off, "opt state")
    for k in m_off:
        assert torch.equal(m_on[k], m_off[k]), k


@pytest.mark.parametrize("recorded", ["forward", "backward"])
def test_profiler_toggled_between_forward_and_backward(model, recorded):
    """Remat's recompute builds the graph of the forward it repeats, so a
    profiler started or stopped in between changes nothing."""
    api, params, batch = model
    loss_ref, grads_ref = _grads(api, params, batch, remat=True)
    p = _fresh(params)
    tensors = [t.requires_grad_(True) for _, t in flatten_tree(p)]
    prof = profile(activities=[ProfilerActivity.CPU])
    if recorded == "forward":
        prof.start()
    loss, _ = api.loss_fn(p, batch, remat=True)
    prof.stop() if recorded == "forward" else prof.start()
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    if recorded == "backward":
        prof.stop()
    assert torch.equal(loss.detach(), loss_ref)
    for g, r in zip(grads, grads_ref):
        assert torch.equal(g, r)


def _node_names(root):
    seen, todo, names = set(), [root], set()
    while todo:
        n = todo.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        names.add(type(n).__name__)
        todo.extend(f for f, _ in n.next_functions)
    return names


def test_off_means_off(model, monkeypatch):
    api, params, batch = model
    p = _fresh(params)
    for _, t in flatten_tree(p):
        t.requires_grad_(True)
    loss, _ = api.loss_fn(p, batch, remat=True)
    off = _node_names(loss.grad_fn)
    with profile(activities=[ProfilerActivity.CPU]):
        loss_on, _ = api.loss_fn(p, batch, remat=True)
    on = _node_names(loss_on.grad_fn)
    assert {"_OpensBackward", "_ClosesBackward"} <= on
    assert off == on - {"_OpensBackward", "_ClosesBackward"}

    def refused(*a, **k):
        raise AssertionError("record_function entered with the profiler off")

    assert tracing.span("x") is tracing.span("y")  # the shared no-op context
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(tracing._Span, "open", refused)
    tracing.reset_counters()  # the traced forward above counted
    _step(api, params, batch, traced=False)
    assert tracing.counters() == {}


SHARDED = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tracing
    from repro_torch.configs import get_config
    from repro_torch.distributed import (DistContext, distribute_tree, opt_specs,
                                         param_specs)
    from repro_torch.launch import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import init_adamw
    from repro_torch.training import make_train_step

    dist.init_process_group("gloo", init_method="file://" + sys.argv[1], rank=0, world_size=1)
    cfg = get_config("granite-moe-3b-a800m-smoke")
    cfg = dataclasses.replace(cfg, n_layers=2)
    api = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
             for k in ("tokens", "labels")}
    ctx = DistContext(make_mesh((1, 1), ("data", "model"), device_type="cpu"), ("data",))
    outs = []
    for traced in (False, True):
        params = api.init(seed=0)
        opt = init_adamw(params)
        p_specs = param_specs(params, cfg, ctx)
        opt = distribute_tree(opt, opt_specs(opt, p_specs, cfg, ctx), ctx)
        params = distribute_tree(params, p_specs, ctx)
        step = make_train_step(api, ctx=ctx, peak_lr=1e-3, warmup_steps=1, total_steps=10)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                _, _, m = step(params, opt, batch)
        else:
            _, _, m = step(params, opt, batch)
        outs.append(m["loss"].item())
    names = [e.name for e in prof.events()]
    counts = {n: names.count(n) for n in sys.argv[2].split(",")}
    print("RESULT", json.dumps({"counts": counts, "losses": outs,
                                "routed": tracing.counters().get("moe.routed")}))
    dist.destroy_process_group()
""")


def test_sharded_step_spans(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    args = [sys.executable, "-c", SHARDED, str(tmp_path / "rdzv"), ",".join(SPANS)]
    run = subprocess.run(args, env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-4000:]
    line = next(x for x in run.stdout.splitlines() if x.startswith("RESULT "))
    out = json.loads(line[len("RESULT "):])
    # 2 layers: a forward and a recompute a MoE layer; the CE over one chunk
    assert out["counts"] == {"step.forward": 1, "step.backward": 1, "step.backward.caller": 1,
                             "optimizer": 1, "recompute": 3, "moe": 4, "moe.bwd": 2, "ce": 1,
                             "ce.bwd": 1}
    assert out["losses"][0] == out["losses"][1]
    assert out["routed"] == 2 * 2 * 32 * 2  # layers x tokens x top-k
