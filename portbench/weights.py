"""Weights drawn from the seed, leaf by leaf on the device, in the dtype
they are trained in.

Each leaf has a generator of its own, seeded from (seed, path), so any one
leaf can be drawn again later without the others: the comparison draws the
initial weights again to measure how far the steps moved each leaf, and
the reference draws them as the program got them.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch

from .reference.common import DTYPES, flatten, unflatten


def leaf_seed(seed: int, path: str) -> int:
    digest = hashlib.sha256(f"{seed}/{path}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def draw(seed: int, path: str, shape: Tuple[int, ...], dtype: str, device) -> torch.Tensor:
    """One leaf's initial value: norm scales, biases 0; D 1; Mamba2's A_log
    and dt_bias; the embedding N(0, 0.02); every other matrix N(0, 1) x
    fan_in^-0.5 (fan_in = the second-to-last dim)."""
    name = path.split("/")[-1]
    dt = DTYPES[dtype]
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, path))
    if name in ("scale", "conv_x_b", "conv_bc_b"):
        return torch.zeros(shape, dtype=dt, device=device)
    if name == "D":
        return torch.ones(shape, dtype=dt, device=device)
    if name == "A_log":  # A uniform in [1, 16]
        return torch.rand(shape, generator=gen, device=device).mul_(15).add_(1).log_().to(dt)
    if name == "dt_bias":  # softplus^-1 of dt, log-uniform in [1e-3, 1e-1]
        lo, hi = math.log(1e-3), math.log(1e-1)
        d = torch.rand(shape, generator=gen, device=device).mul_(hi - lo).add_(lo).exp_()
        return (d + torch.log(-torch.expm1(-d))).to(dt)
    scale = 0.02 if path == "embed/table" else shape[-2] ** -0.5
    return torch.randn(shape, generator=gen, device=device, dtype=dt).mul_(scale)


def make_params(shapes: Dict, seed: int, device, fp32: bool = False) -> Dict:
    """The whole tree of ``shapes`` ({path: (shape, dtype name)} nested);
    with ``fp32`` every leaf converted to fp32 after it is drawn."""
    out = []
    for path, (shape, dtype) in flatten(shapes):
        leaf = draw(seed, path, tuple(shape), dtype, device)
        out.append((path, leaf.float() if fp32 else leaf))
    return unflatten(out)


@torch.no_grad()
def change_norms(shapes: Dict, seed: int, params: Dict, as_param: bool = False
                 ) -> Dict[str, float]:
    """{path: || params[path] - its initial value ||} in fp32; with
    ``as_param`` each value first rounded to the leaf's dtype (an fp32
    master as the program's parameter)."""
    flat = dict(flatten(params))
    out = {}
    for path, (shape, dtype) in flatten(shapes):
        now = flat[path]
        init = draw(seed, path, tuple(shape), dtype, now.device)
        dt = DTYPES[dtype] if as_param else now.dtype
        # a stacked leaf slice by slice: no leaf-sized fp32 temporary
        rows = zip(now.unbind(0), init.unbind(0)) if now.dim() > 2 else [(now, init)]
        total = sum((a.to(dt).float() - b.float()).square().sum() for a, b in rows)
        out[path] = float(total) ** 0.5
        del init
    return out
