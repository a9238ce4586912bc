"""What a traced window holds, read from ``torch.profiler``: the device's
kernels and copies, the device time under each span, and the costs that
the benchmark's spans recorded.  Per-layer metric readers
(``metrics/<name>.py``) read only this."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import costs
from .spans import Records


def kernel_group(name: str) -> str:
    """The group of a device kernel by its name (chip_smoke.py's grouping of
    a train step's profile, copied)."""
    low = name.lower()
    if "nccl" in low:
        return "NCCL collectives"
    if "flash_fwd" in name:
        return "B1 flash_attention forward"
    if "flash_bwd" in name:
        return "B1 flash_attention backward"
    if "ssd_bwd" in name:
        return "B4 ssd_scan backward"
    if "ssd_scan" in name:
        return "B4 ssd_scan forward"
    if "rmsnorm_bwd" in name or "rmsnorm_dw" in name:
        return "B3a rmsnorm backward"
    if "rmsnorm_kernel" in name:
        return "B3a rmsnorm forward"
    if any(x in low for x in ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitk")):
        return "matmul (cuBLAS)"
    if any(x in low for x in ("sort", "topk", "searchsorted", "scatter", "index", "gather")):
        return "PyTorch sort/top-k/index/scatter/gather"
    if any(x in low for x in ("elementwise", "reduce", "copy", "vectorized", "softmax", "fill",
                              "cat")):
        return "PyTorch elementwise/reduce/copy"
    return "other"


ELEMENTWISE_GROUPS = ("PyTorch elementwise/reduce/copy", "PyTorch sort/top-k/index/scatter/gather")


class Trace:
    """A traced window of ``steps`` training steps of ``tokens`` tokens
    each, ``wall_s`` long on the host's clock."""

    def __init__(self, events, wall_s: float, steps: int, rec: Records, arch: Dict,
                 batch: int, seq: int):
        self.wall_s, self.steps, self.records = wall_s, steps, rec
        self.arch, self.batch, self.seq = arch, batch, seq
        self.kernels: List[Tuple[str, float, float]] = []  # (name, start us, duration us)
        self.cpu = []
        for e in events:
            if e.device_type.name == "CPU":
                self.cpu.append(e)
            elif e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False):
                # (a span's interval on the device's timeline is not device work)
                self.kernels.append((e.name, e.time_range.start, e.time_range.elapsed_us()))
        self.kernels.sort(key=lambda k: k[1])
        self._busy = _merge([(s, s + d) for _, s, d in self.kernels])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy) / 1e6

    def span_device_s(self, name: str) -> Optional[float]:
        """Device seconds of the kernels launched inside the spans called
        ``name`` (outermost ones; None if there is no such span)."""
        spans = [e for e in self.cpu if e.name == name]
        if not spans:
            return None
        inner = {id(c) for e in spans for c in _descendants(e)}
        return sum(e.device_time_total for e in spans if id(e) not in inner) / 1e6

    def group_s(self, groups) -> float:
        return sum(d for n, _, d in self.kernels if kernel_group(n) in groups) / 1e6

    def roofline(self, name: str) -> Optional[float]:
        """% of its roofline at which the instrumented op ``name`` ran: the
        least time of its launches by the frozen costs over the device time
        of its forward and backward spans."""
        launches = self.records.costs.get(name)
        if not launches:
            return None
        t = (self.span_device_s(name) or 0.0) + (self.span_device_s(name + ".bwd") or 0.0)
        if t <= 0:
            return None
        return 100.0 * sum(costs.roofline_s(c) for c in launches) / t

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host op running when each began."""
        by_name: Dict[str, float] = {}
        for n, _, d in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(((b0[1], b1[0]) for b0, b1 in zip(self._busy, self._busy[1:])),
                      key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[n[:160], d / 1e6] for n, d in ops],
            "idle_gaps": [[self._host_at(a), (b - a) / 1e6] for a, b in gaps],
        }

    def _host_at(self, t: float) -> str:
        best, width = "host", float("inf")
        for e in self.cpu:
            r = e.time_range
            if r.start <= t <= r.end and r.end - r.start < width:
                best, width = e.name, r.end - r.start
        return best[:160]


def _descendants(e):
    for c in e.cpu_children:
        yield c
        yield from _descendants(c)


def _merge(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out
