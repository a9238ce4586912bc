"""Checkpoint DU file format: the array codec of ``repro.checkpoint``.

A checkpoint is a DU file-set: ``meta.json`` plus one ``.npy`` file per leaf
of ``{"params": ..., "opt": ...}``, named by the leaf's ``/``-joined key path.
This module writes and reads that format byte for byte as the JAX package
does, so checkpoints cross between the two packages unchanged.

bfloat16 has no numpy dtype without ``ml_dtypes`` (which ships with JAX and
is not a dependency of the port).  The JAX package saves bf16 leaves with the
``<V2`` descriptor and loads them back as ``|V2`` void bytes; here they are
written from, and read into, the int16 bit pattern viewed as
``torch.bfloat16``.
"""

from __future__ import annotations

import io
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_BF16_DESCR = "<V2"  # what np.save writes for an ml_dtypes bfloat16 array


def flatten_tree(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten_tree(tree[k], f"{prefix}{k}/"))
        return out
    return [(prefix.rstrip("/"), tree)]


def tree_map(fn, tree: Any) -> Any:
    """``fn`` applied to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unflatten_tree(items: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for path, value in items.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def is_bf16_bits(arr: np.ndarray) -> bool:
    """True for a numpy array that holds bfloat16 values: ``|V2`` bytes from
    ``np.load`` or an ``ml_dtypes.bfloat16`` array handed over by JAX."""
    return arr.dtype.kind == "V" and arr.dtype.itemsize == 2 and arr.dtype.names is None


def tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor with ``arr``'s values; bf16 bit patterns become bf16."""
    arr = np.ascontiguousarray(arr)
    if is_bf16_bits(arr):
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t``; a bf16 tensor comes back as its int16 bits
    viewed as ``V2`` (what the JAX package's loader returns)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2").copy()
    return t.numpy().copy()


def encode_array(arr: Any) -> bytes:
    """``.npy`` bytes of a tensor or array, identical to the JAX package's."""
    if isinstance(arr, torch.Tensor):
        arr = tensor_to_numpy(arr)
    arr = np.asarray(arr)
    buf = io.BytesIO()
    if is_bf16_bits(arr):
        bits = np.ascontiguousarray(arr).view(np.int16)
        np.lib.format.write_array_header_1_0(
            buf, {"descr": _BF16_DESCR, "fortran_order": False, "shape": bits.shape}
        )
        buf.write(bits.tobytes())
    else:
        np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def decode_array(data: bytes) -> torch.Tensor:
    """A CPU tensor from ``.npy`` bytes written by either package."""
    return tensor_from_numpy(np.load(io.BytesIO(data), allow_pickle=False))


def checkpoint_files(
    step: int, run_name: str, params: Any, opt_state: Optional[Any] = None
) -> Dict[str, bytes]:
    """Serialize (step, params, opt_state) into a checkpoint DU file-set."""
    files = {"meta.json": json.dumps({"step": step, "run": run_name}).encode()}
    for path, leaf in flatten_tree({"params": params}):
        files[f"{path}.npy"] = encode_array(leaf)
    if opt_state is not None:
        for path, leaf in flatten_tree({"opt": opt_state}):
            files[f"{path}.npy"] = encode_array(leaf)
    return files
