"""One run of one cell: set-up, the measured (or traced) window, and the
comparison with the plain reference that decides ``correct``.

Set-up makes the weights and the token batches from the seed, builds the
program's train step (``repro_torch.training.make_train_step``, remat on)
and drives it through the cell's checked steps on the first batches: they
warm up every shape the window uses and give the program's readings (each
step's loss, each leaf's first gradient as AdamW received it, worked out
from its first moment after step 1, and how far the steps moved each
leaf's fp32 master and its bf16 parameter, the one the next step's
forward reads).  The same object then runs the window.  Once the window
has closed and the peak memory is read, the program's state is freed and
the reference (``reference/<family>.py``) follows the same steps in fp32,
on its masters rounded as the program's parameters are, from the same
weights on the same batches; ``compare`` turns both sides' readings into
the numbers held to the cell's limits.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from . import spans, traffic
from .reference import common
from .trace import Trace
from .weights import change_norms, make_params

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict  # configs/<config>.json
    mix: Dict  # traffic/<mix>.json
    limits: Dict  # limits/<cell>.json: {number: {"limit": ...}}
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def arch(self) -> Dict:
        return self.config["arch"]


def load_cell(name: str, bench_file: Path = REPO / "BENCHMARK.json") -> Cell:
    bench = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_file.name}: {sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(
        name=name, chips=w["chips"],
        config=json.loads((REPO / entry["file"]).read_text()),
        mix=traffic.load(ROOT, w["traffic"]),
        limits=json.loads((ROOT / "limits" / f"{name}.json").read_text()),
        end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]),
    )


def reference_module(cell: Cell):
    return importlib.import_module(f"portbench.reference.{cell.config['reference']}")


def port_config(cell: Cell):
    """The program's ModelConfig of the configuration file's ``arch``."""
    from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

    a = dict(cell.arch)
    a["pattern"] = tuple(a["pattern"])
    if "moe" in a:
        a["moe"] = MoEConfig(**a["moe"])
    if "ssm" in a:
        a["ssm"] = SSMConfig(**a["ssm"])
    return ModelConfig(name=cell.config["name"], **a)


def check_tree(api, shapes: Dict) -> None:
    """The program's parameter tree (shapes and dtypes, drawn on the meta
    device) must be the one the benchmark makes weights for."""
    from repro_torch.checkpoint import flatten_tree
    from repro_torch.models import build_model

    meta = build_model(api.cfg, device="meta").init(seed=0)
    got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for p, t in flatten_tree(meta)}
    want = {p: (tuple(s), d) for p, (s, d) in common.flatten(shapes)}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))[:6]
        raise RuntimeError(f"the program's parameter tree is not the benchmark's: {diff}")


@dataclasses.dataclass
class Readings:
    losses: List[float]  # each checked step's loss
    grads: Dict[str, float]  # each leaf's norm of the clipped gradient of step 1
    change: Dict[str, float]  # each leaf's || fp32 master after the checked steps - initial ||
    param_change: Dict[str, float]  # the same of the parameter the forward reads
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)  # the reference's


@dataclasses.dataclass
class Program:
    api: object
    params: Dict
    opt: Dict
    step: Callable
    batches: List[Dict]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build_program(cell: Cell, seed: int, device) -> Program:
    from repro_torch.models import build_model
    from repro_torch.optim import init_adamw
    from repro_torch.training import make_train_step

    sched = cell.mix["schedule"]
    api = build_model(port_config(cell), device=device)
    shapes = reference_module(cell).param_shapes(cell.arch)
    check_tree(api, shapes)
    params = make_params(shapes, seed, device)
    step = make_train_step(api, peak_lr=sched["peak_lr"], warmup_steps=sched["warmup_steps"],
                           total_steps=sched["total_steps"], max_grad_norm=sched["max_grad_norm"],
                           remat=True)
    batches = traffic.pretrain_batches(cell.mix, cell.arch["vocab_size"], seed, device)
    return Program(api, params, init_adamw(params), step, batches)


def checked_steps(cell: Cell, prog: Program, seed: int) -> Readings:
    """The program's first steps, through the window's own call and feed."""
    losses, first = [], {}
    for i in range(cell.mix["checked_steps"]):
        prog.params, prog.opt, metrics = prog.step(prog.params, prog.opt, prog.batches[i])
        losses.append(metrics["loss"])
        if i == 0:  # after one step AdamW's first moment is (1 - b1) x the gradient
            first = {p: torch.linalg.vector_norm(m.float()) / (1 - common.B1)
                     for p, m in common.flatten(prog.opt["m"])}
    shapes = reference_module(cell).param_shapes(cell.arch)
    change = change_norms(shapes, seed, prog.opt.get("master", prog.params))
    return Readings([float(x) for x in losses], {p: float(g) for p, g in first.items()}, change,
                    change_norms(shapes, seed, prog.params))


def reference_readings(cell: Cell, seed: int, batches: List[Dict], fp8: bool = False) -> Readings:
    """The reference's readings over the same checked steps, in fp32 (or,
    as the control, with its products in fp8)."""
    ref = reference_module(cell)
    common.fp32_mode()
    shapes = ref.param_shapes(cell.arch)
    device = batches[0]["tokens"].device
    params = make_params(shapes, seed, device, fp32=True)
    num = common.Numerics(fp8, common.unflatten((p, d) for p, (_, d) in common.flatten(shapes)))
    losses, first, final = common.train(lambda p, b: ref.loss_fn(p, b, cell.arch, num), params,
                                        batches[: cell.mix["checked_steps"]], cell.mix["schedule"])
    return Readings(losses, first, change_norms(shapes, seed, final),
                    change_norms(shapes, seed, final, as_param=True),
                    {k: float(v) for k, v in num.counts.items()})


#: leaves whose reference gradient is under this share of the median
#: leaf's move by round-off alone under AdamW: left out of ``update_gap``
STILL_LEAF = 1e-3


def compare(prog: Readings, ref: Readings) -> Dict[str, Dict]:
    """The numbers a cell compares, each with the step or leaf that sets
    it.  ``loss_gap``: the largest |program loss - reference loss| /
    reference loss over the checked steps.  ``grad_gap``, ``update_gap``
    and ``param_gap``: the largest gap over the leaves between the two
    sides' norms of a leaf's first gradient, of its master's change over
    the checked steps, and of its parameter's change (as the next step's
    forward reads it), over the larger of the reference's norm of that
    leaf and of the median leaf."""
    losses = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
              for a, b in zip(prog.losses, ref.losses)]
    med_g = statistics.median(ref.grads.values())
    moving = [p for p in ref.grads if ref.grads[p] >= STILL_LEAF * med_g]
    out = {}
    i = max(range(len(losses)), key=losses.__getitem__)
    out["loss_gap"] = {"value": losses[i], "at": f"step {i + 1}"}
    for name, a, b, paths in (("grad_gap", prog.grads, ref.grads, list(ref.grads)),
                              ("update_gap", prog.change, ref.change, moving),
                              ("param_gap", prog.param_change, ref.param_change, moving)):
        med = statistics.median(b[p] for p in paths)
        gaps = {p: abs(a[p] - b[p]) / max(b[p], med) if math.isfinite(a[p]) else math.inf
                for p in paths}
        worst = max(gaps, key=gaps.get)
        out[name] = {"value": gaps[worst], "at": worst}
    return out


def window(prog: Program, seconds: float, first_batch: int, device) -> Dict:
    """Whole steps until ``seconds`` have passed: the host waits for step
    i only once step i + 1 is queued, so the device never waits on the
    check of the clock.  All steps' tokens over all of their time."""
    n = len(prog.batches)
    losses = []
    cuda = torch.device(device).type == "cuda"
    sync(device)
    t0 = time.perf_counter()
    prev = None
    while True:
        batch = prog.batches[(first_batch + len(losses)) % n]
        prog.params, prog.opt, metrics = prog.step(prog.params, prog.opt, batch)
        losses.append(metrics["loss"])
        ev = torch.cuda.Event() if cuda else None
        if cuda:
            ev.record()
        if prev is not None or not cuda:
            if cuda:
                prev.synchronize()
            if time.perf_counter() - t0 >= seconds:
                break
        prev = ev
    sync(device)
    wall = time.perf_counter() - t0
    tokens = prog.batches[0]["tokens"].numel() * len(losses)
    finite = torch.isfinite(torch.stack(losses)).sum().item()
    return {"steps": len(losses), "wall_s": wall, "tokens_per_s": tokens / wall,
            "failed": len(losses) - int(finite)}


def traced(cell: Cell, prog: Program, first_batch: int, device) -> Trace:
    """``trace_steps`` steps under torch.profiler with the benchmark's
    spans on."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    n, b = cell.mix["trace_steps"], first_batch
    rec = spans.Records()
    losses = []
    with spans.installed(rec), profile(activities=acts) as prof:
        sync(device)
        t0 = time.perf_counter()
        for i in range(n):
            prog.params, prog.opt, m = prog.step(prog.params, prog.opt,
                                                 prog.batches[(b + i) % len(prog.batches)])
            losses.append(m["loss"])
        sync(device)
        wall = time.perf_counter() - t0
    tr = Trace(prof.events(), wall, n, rec, cell.arch, cell.mix["batch"], cell.mix["seq_len"])
    tr.failed = n - int(torch.isfinite(torch.stack(losses)).sum().item())
    return tr


def read_metric(name: str, trace: Trace) -> Optional[float]:
    """The per-layer metric ``name`` by its reader, ``metrics/<name>.py``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace)


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: what this
    process has loaded), each compared whole: ``repro_torch`` is not
    ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def device_info(device) -> Dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: Optional[float] = None) -> Dict:
    """One run; returns the result line's object (``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    t0 = time.perf_counter()
    prog = build_program(cell, seed, device)
    sync(device)
    t1 = time.perf_counter()
    mine = checked_steps(cell, prog, seed)
    sync(device)
    setup_s = time.perf_counter() - t_start
    print(f"portbench: set-up {setup_s:.3f} s: start {t0 - t_start:.3f}, weights and state "
          f"{t1 - t0:.3f}, checked steps {time.perf_counter() - t1:.3f}", file=sys.stderr)
    first = cell.mix["checked_steps"]
    metrics: Dict[str, Dict] = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    t0 = time.perf_counter()
    if trace:
        tr = traced(cell, prog, first, device)
        attempted, failed = tr.steps, tr.failed
        for m in cell.per_layer:
            value = read_metric(m["name"], tr)
            if value is None:  # a span or kernel it reads has gone from the program
                raise RuntimeError(f"{m['name']}, listed for {cell.name}, read nothing")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        w = window(prog, seconds, first, device)
        attempted, failed = w["steps"], w["failed"]
        values = {"train_tokens_per_s": w["tokens_per_s"], "setup_s": setup_s}
        if torch.device(device).type == "cuda":
            values["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        for name, v in values.items():
            if name in units:
                metrics[name] = {"value": v, "unit": units[name]}
    window_s = time.perf_counter() - t0
    dev = device_info(device)
    if trace:
        dev.update(busy_s=tr.busy_s, window_s=tr.wall_s)
    batches = prog.batches
    del prog
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    theirs = reference_readings(cell, seed, batches)
    numbers = compare(mine, theirs)
    reference_s = time.perf_counter() - t0
    checks = {k: {"value": numbers[k]["value"], "limit": cell.limits[k]["limit"]}
              for k in cell.limits}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    for k in checks:
        checks[k]["at"] = numbers[k]["at"]
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if trace and torch.device(device).type == "cuda":
        out["breakdown"] = tr.breakdown()
    out["timing_s"] = {"setup": setup_s, "window": window_s, "reference": reference_s}
    out["losses"] = {"program": mine.losses, "reference": theirs.losses}
    if theirs.counts.get("moe_pairs"):
        out["moe_dropped_share"] = theirs.counts["moe_dropped"] / theirs.counts["moe_pairs"]
    out["checks"] = checks  # last: each number compared beside its limit
    return out


def check_lines(result: Dict) -> List[str]:
    """The numbers compared, one a line, for standard error; strips the
    leaf or step that set each from the result line."""
    lines = []
    for k, c in result["checks"].items():
        at = c.pop("at", "")
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        lines.append(f"check {k} {c['value']!r} limit {c['limit']!r} {verdict} ({at})")
    lines.append(f"check failed_steps {result['failed']} limit 0")
    return lines
