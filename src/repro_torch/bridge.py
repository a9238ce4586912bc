"""Weight crossing between the JAX package's parameter trees and the port's.

Both packages use the same tree: nested dicts keyed as in
``repro.models.transformer.init_lm``, with the per-group weights stacked on a
leading ``groups`` dimension.  The port's leaves are torch tensors; the JAX
side hands over numpy arrays (``np.asarray`` of its leaves, or the arrays its
checkpoint loader returns).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .checkpoint import decode_array, tensor_from_numpy, tensor_to_numpy, tree_map, unflatten_tree
from .device import resolve_device


def params_from_numpy(
    tree: Any,
    device: Union[str, torch.device] = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> Dict:
    """The port's parameter tree from a tree of numpy arrays (bf16 leaves as
    ``ml_dtypes.bfloat16`` or ``|V2`` bytes); ``dtype`` casts float leaves."""
    dev = resolve_device(device)

    def leaf(a: np.ndarray) -> torch.Tensor:
        t = tensor_from_numpy(np.asarray(a))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return tree_map(leaf, tree)


def params_to_numpy(tree: Any) -> Dict:
    """The numpy tree of the port's parameters (bf16 leaves as ``V2`` bits,
    which is what the JAX package's checkpoint loader returns)."""
    return tree_map(tensor_to_numpy, tree)


def _tree_from_files(files: Mapping[str, bytes], prefix: str, dev: torch.device) -> Dict:
    items = {
        rel[len(prefix) : -len(".npy")]: decode_array(data).to(dev)
        for rel, data in files.items()
        if rel.startswith(prefix) and rel.endswith(".npy")
    }
    return unflatten_tree(items)


def params_from_files(
    files: Mapping[str, bytes], device: Union[str, torch.device] = "cuda"
) -> Dict:
    """Model params from a checkpoint DU file-set (``params/<path>.npy``);
    the counterpart of ``repro.serving.engine.params_from_input``."""
    return _tree_from_files(files, "params/", resolve_device(device))


def train_state_from_files(
    files: Mapping[str, bytes], device: Union[str, torch.device] = "cuda"
) -> Tuple[Dict, Dict]:
    """(params, opt_state) from a checkpoint DU file-set, read from its
    ``params/`` and ``opt/`` leaves as ``repro.training.trainer``'s
    ``_restore_from_input`` reads them; the counterpart of that function.
    ``checkpoint_files(step, run, params, opt_state)`` writes both."""
    dev = resolve_device(device)
    return _tree_from_files(files, "params/", dev), _tree_from_files(files, "opt/", dev)
