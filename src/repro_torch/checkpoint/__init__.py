from .checkpointer import (
    Checkpointer,
    CheckpointError,
    CheckpointTimeout,
    load_checkpoint_du,
)
from .codec import (
    checkpoint_files,
    decode_array,
    encode_array,
    flatten_tree,
    tensor_from_numpy,
    tensor_to_numpy,
    tree_map,
    unflatten_tree,
)

__all__ = [
    "CheckpointError",
    "CheckpointTimeout",
    "Checkpointer",
    "checkpoint_files",
    "decode_array",
    "encode_array",
    "flatten_tree",
    "load_checkpoint_du",
    "tensor_from_numpy",
    "tensor_to_numpy",
    "tree_map",
    "unflatten_tree",
]
