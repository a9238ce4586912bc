"""The one traffic generator: a mix is a JSON file of parameters under
``traffic/``, read here.

``pretrain``: ``distinct_batches`` batches of ``batch`` packed sequences
of ``seq_len`` tokens (labels: the next token), token ids drawn from a Zipf
law of exponent ``zipf_exponent`` over the vocabulary in an order permuted
by the seed, so that a few ids repeat often, as in text.  Every seed gives
the same sizes.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

KINDS = ("pretrain",)


def load(root: Path, name: str) -> Dict:
    mix = json.loads((root / "traffic" / f"{name}.json").read_text())
    if mix.get("kind") not in KINDS:
        raise ValueError(f"traffic {name}: kind {mix.get('kind')!r} is not one of {KINDS}")
    return mix


def pretrain_batches(mix: Dict, vocab: int, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    rng = np.random.default_rng([seed % 2**64, 0x70726574])
    order = rng.permutation(vocab)
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -float(mix["zipf_exponent"])
    cdf = np.cumsum(p / p.sum())
    n, b, s = mix["distinct_batches"], mix["batch"], mix["seq_len"]
    ranks = np.minimum(np.searchsorted(cdf, rng.random(n * b * (s + 1)), side="right"), vocab - 1)
    ids = torch.from_numpy(order[ranks].astype(np.int32).reshape(n, b, s + 1)).to(device)
    return [{"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()} for t in ids]
