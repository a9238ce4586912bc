"""Plain PyTorch pieces that both references share: the numerics (fp32,
or the fp8 control; the weights as the program computes with them),
RMSNorm, RoPE, causal GQA attention, the SwiGLU MLP,
the cross-entropy over the tied embedding, and the training steps (global
clip, AdamW with bias correction, warmup-cosine learning rate).

Everything computes in fp32 with TF32 off.  The trained state is fp32
masters; the forward reads each master rounded to the dtype of the
program's parameter (bf16, or fp32 for the router and the SSM's A, D and
dt bias), and its gradient reaches the master unchanged, as the
program's bf16 parameters and fp32 masters do.  Memory is bounded by
recomputing: each layer, each block of 512 queries and each block of 512
positions of the cross-entropy is checkpointed.

The parameter tree follows the program's layout (``groups/pos<i>/...``
stacked on a leading dim, ``shared``, ``tail``, ``embed/table`` padded to
a multiple of 256 rows), so that both sides are handed the same weights.
"""

from __future__ import annotations

import math
from itertools import repeat
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
DTYPES = {"bfloat16": torch.bfloat16, "float32": F32}
BLOCK = 512  # queries of one attention block, positions of one cross-entropy block
FP8_MAX = 448.0  # largest float8_e4m3fn


def fp32_mode() -> None:
    """fp32 products stay fp32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8_e4m3fn under one per-tensor scale, back in fp32."""
    if t.numel() == 0:
        return t
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(F32) * scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both operands rounded to fp8; the backward multiplies the
    incoming gradient by the rounded operands."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        ga = g @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ g
        # undo broadcasting over leading dims
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


class _AsParam(torch.autograd.Function):
    """An fp32 master as the program's parameter: rounded to ``dtype`` and
    back in fp32; the gradient passes to the master unchanged."""

    @staticmethod
    def forward(ctx, w, dtype):
        return w.to(dtype).to(F32)

    @staticmethod
    def backward(ctx, g):
        return g, None


class Numerics:
    """Where the reference multiplies matrices: in fp32, or (``fp8``) with
    both operands rounded to float8_e4m3fn, the control that a comparison
    has to fail.  ``dtypes`` (the params' tree of dtype names) says what
    each master is rounded to where the forward reads it; without it the
    params are read as given.  ``counts`` adds up what the layers count
    (the MoE layer: its (token, expert) pairs and those dropped)."""

    def __init__(self, fp8: bool = False, dtypes: Optional[Dict] = None):
        self.fp8 = fp8
        self.dtypes = dtypes
        self.counts: Dict[str, torch.Tensor] = {}

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _Fp8Matmul.apply(a, b) if self.fp8 else a @ b

    def params(self, tree, dtypes):
        """``tree`` as the program computes with it: each leaf rounded to
        its dtype in ``dtypes``, a tree beside it (None: as given)."""
        if dtypes is None:
            return tree
        if isinstance(tree, dict):
            return {k: self.params(v, dtypes[k]) for k, v in tree.items()}
        return tree if DTYPES[dtypes] == F32 else _AsParam.apply(tree, DTYPES[dtypes])

    def leaf(self, params: Dict, path: str) -> torch.Tensor:
        """The leaf at ``path`` (``a/b/c``) as the program computes with it."""
        dtypes = self.dtypes
        for key in path.split("/"):
            params, dtypes = params[key], None if dtypes is None else dtypes[key]
        return self.params(params, dtypes)

    def count(self, name: str, n) -> None:
        self.counts[name] = self.counts.get(name, 0) + n


# ------------------------------------------------------------------ tree
def padded_vocab(v: int) -> int:
    return -(-v // 256) * 256


def attention_shapes(arch: Dict, lead: Tuple[int, ...] = ()) -> Dict:
    d, hd = arch["d_model"], arch["head_dim"]
    bf = arch["param_dtype"]
    return {
        "q": {"w": ((*lead, d, arch["n_heads"] * hd), bf)},
        "k": {"w": ((*lead, d, arch["n_kv_heads"] * hd), bf)},
        "v": {"w": ((*lead, d, arch["n_kv_heads"] * hd), bf)},
        "o": {"w": ((*lead, arch["n_heads"] * hd, d), bf)},
    }


def norm_shape(arch: Dict, lead: Tuple[int, ...] = ()) -> Dict:
    return {"scale": ((*lead, arch["d_model"]), arch["param_dtype"])}


def lm_shapes(arch: Dict, block_shapes: Callable[[str, Tuple[int, ...]], Dict]) -> Dict:
    """The whole tree: embedding, final norm, the stacked groups (a
    ``shared_attn`` position has none: it is ``shared``), the tail."""
    pattern = list(arch["pattern"])
    g = arch["n_layers"] // len(pattern)
    tail = layer_kinds(arch)[g * len(pattern):]
    tree = {
        "embed": {"table": ((padded_vocab(arch["vocab_size"]), arch["d_model"]),
                            arch["param_dtype"])},
        "final_norm": norm_shape(arch),
    }
    if g:
        tree["groups"] = {f"pos{i}": block_shapes(k, (g,)) for i, k in enumerate(pattern)
                          if k != "shared_attn"}
    if "shared_attn" in pattern:
        tree["shared"] = block_shapes("shared_attn", ())
    if tail:
        tree["tail"] = {f"pos{i}": block_shapes(k, ()) for i, k in enumerate(tail)}
    return tree


def flatten(tree: Dict, prefix: str = "") -> List[Tuple[str, object]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.extend(flatten(v, path))
        else:
            out.append((path, v))
    return out


def unflatten(items: Iterable[Tuple[str, object]]) -> Dict:
    tree: Dict = {}
    for path, v in items:
        node = tree
        *parts, last = path.split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def layer_kinds(arch: Dict) -> List[str]:
    pattern = list(arch["pattern"])
    reps = -(-arch["n_layers"] // len(pattern))
    return (pattern * reps)[: arch["n_layers"]]


def layers(params: Dict, arch: Dict):
    """(kind, the layer's params) for every layer in order: a stacked
    group's slice, the shared block, or a tail layer.  ``params`` may be
    the tree of dtype names, whose leaves a slice keeps."""
    pattern = list(arch["pattern"])
    g = arch["n_layers"] // len(pattern)

    def each(tree, f):
        if isinstance(tree, dict):
            return {k: each(v, f) for k, v in tree.items()}
        return tree if isinstance(tree, str) else f(tree)

    # each stacked leaf split once: one autograd node a leaf, not one a layer
    groups = {j: each(params["groups"][f"pos{j}"], lambda t: t.unbind(0))
              for j, kind in enumerate(pattern) if g and kind != "shared_attn"}
    for i in range(g):
        for j, kind in enumerate(pattern):
            yield kind, params["shared"] if kind == "shared_attn" else each(
                groups[j], lambda t: t[i])
    for j, kind in enumerate(layer_kinds(arch)[g * len(pattern):]):
        yield kind, params["shared"] if kind == "shared_attn" else params["tail"][f"pos{j}"]


# ---------------------------------------------------------------- layers
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of x [B, S, H, D] at positions 0..S-1."""
    s, d = x.shape[1], x.shape[3]
    half = d // 2
    freq = 1.0 / theta ** (torch.arange(half, dtype=F32, device=x.device) / half)
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, num: Numerics) -> torch.Tensor:
    """Softmax attention of q [B, S, Hq, D] over k, v [B, S, Hkv, D], query
    i over keys 0..i; query head h reads kv head h // (Hq / Hkv).  In blocks
    of BLOCK queries, each recomputed in the backward pass."""
    b, s, hq, d = q.shape
    g = hq // k.shape[2]
    kt = k.repeat_interleave(g, dim=2).permute(0, 2, 3, 1)  # [B, Hq, D, S]
    vt = v.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)  # [B, Hq, S, D]
    qt = q.permute(0, 2, 1, 3)  # [B, Hq, S, D]

    def block(qb, kb, vb, start):
        n = kb.shape[-1]
        scores = num.mm(qb, kb) * d**-0.5
        qpos = torch.arange(start, start + qb.shape[2], device=q.device)[:, None]
        keep = torch.arange(n, device=q.device)[None, :] <= qpos
        scores = scores.masked_fill(~keep, float("-inf"))
        return num.mm(torch.softmax(scores, dim=-1), vb)

    outs = []
    for start in range(0, s, BLOCK):
        end = min(start + BLOCK, s)
        outs.append(checkpoint(block, qt[:, :, start:end], kt[..., :end], vt[:, :, :end], start,
                               use_reentrant=False))
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3)


def attention_block(p: Dict, h: torch.Tensor, arch: Dict, num: Numerics) -> torch.Tensor:
    b, s, _ = h.shape
    hd = arch["head_dim"]
    q = rope(num.mm(h, p["q"]["w"]).reshape(b, s, -1, hd), arch["rope_theta"])
    k = rope(num.mm(h, p["k"]["w"]).reshape(b, s, -1, hd), arch["rope_theta"])
    v = num.mm(h, p["v"]["w"]).reshape(b, s, -1, hd)
    return num.mm(causal_attention(q, k, v, num).reshape(b, s, -1), p["o"]["w"])


def swiglu(h: torch.Tensor, p: Dict, num: Numerics) -> torch.Tensor:
    return num.mm(F.silu(num.mm(h, p["gate"]["w"])) * num.mm(h, p["up"]["w"]), p["down"]["w"])


def embed(tokens: torch.Tensor, table: torch.Tensor, d: int) -> torch.Tensor:
    return table[tokens.long()] * math.sqrt(d)


def cross_entropy(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor, vocab: int,
                  num: Numerics) -> torch.Tensor:
    """Mean next-token cross-entropy of the final hidden states x [B, S, d]
    against the tied embedding's first ``vocab`` rows, in blocks."""
    w = table[:vocab].t()

    def block(xc, lc):
        logits = num.mm(xc, w)
        gold = torch.gather(logits, -1, lc[..., None])[..., 0]
        return (torch.logsumexp(logits, dim=-1) - gold).sum()

    total = x.new_zeros(())
    for i in range(0, x.shape[1], BLOCK):
        total = total + checkpoint(block, x[:, i:i + BLOCK], labels[:, i:i + BLOCK].long(),
                                   use_reentrant=False)
    return total / labels.numel()


def run_layers(params: Dict, x: torch.Tensor, arch: Dict,
               block: Callable[[str, Dict, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
               num: Numerics):
    """Every layer in order, on its params as the program computes with
    them, each recomputed in the backward pass; returns (x, the sum of the
    layers' aux losses)."""

    def layer(kind, p, dtypes, x):
        return block(kind, num.params(p, dtypes), x)

    dtypes = layers(num.dtypes, arch) if num.dtypes is not None else repeat((None, None))
    aux = x.new_zeros(())
    for (kind, p), (_, dt) in zip(layers(params, arch), dtypes):
        x, a = checkpoint(layer, kind, p, dt, x, use_reentrant=False)
        aux = aux + a
    return x, aux


# --------------------------------------------------------------- training
def warmup_cosine(step: int, peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> float:
    """Linear warmup from 0 at step 0, then cosine decay to final_frac x peak."""
    if step < warmup_steps:
        return peak_lr * step / max(1.0, warmup_steps)
    progress = min(max((step - warmup_steps) / max(1.0, total_steps - warmup_steps), 0.0), 1.0)
    return peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * progress)))


B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.95, 1e-8, 0.1


def train(loss_fn: Callable[[Dict, Dict], torch.Tensor], params: Dict,
          batches: Sequence[Dict], schedule: Dict) -> Tuple[List[float], Dict[str, float], Dict]:
    """One step per batch from ``params`` (fp32 masters, updated in place):
    gradients, a clip to the global norm ``max_grad_norm``, then AdamW.
    Returns (each step's loss, each leaf's norm of the first step's
    clipped gradient, the params after the last step)."""
    leaves = flatten(params)
    for _, t in leaves:
        t.requires_grad_(True)
    m = [torch.zeros_like(t) for _, t in leaves]
    v = [torch.zeros_like(t) for _, t in leaves]
    losses, first = [], {}
    for step, batch in enumerate(batches):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, [t for _, t in leaves], allow_unused=True)
        losses.append(float(loss.detach()))
        del loss
        with torch.no_grad():
            grads = [torch.zeros_like(t) if g is None else g for (_, t), g in zip(leaves, grads)]
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.clamp(schedule["max_grad_norm"] / torch.clamp(norm, min=1e-12), max=1.0)
            lr = warmup_cosine(step, schedule["peak_lr"], schedule["warmup_steps"],
                               schedule["total_steps"])
            bc1, bc2 = 1 - B1 ** (step + 1), 1 - B2 ** (step + 1)
            for i, ((path, t), g) in enumerate(zip(leaves, grads)):
                g.mul_(scale)
                if step == 0:
                    first[path] = float(g.norm())
                m[i].mul_(B1).add_(g, alpha=1 - B1)
                v[i].mul_(B2).addcmul_(g, g, value=1 - B2)
                upd = torch.div(v[i], bc2).sqrt_().add_(EPS)  # two leaf-sized temporaries
                upd = torch.div(m[i], bc1).div_(upd)
                t.sub_(upd.add_(t, alpha=WEIGHT_DECAY).mul_(lr))
            del grads
    for _, t in leaves:
        t.requires_grad_(False)
    return losses, first, params
