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
    "checkpoint_files",
    "decode_array",
    "encode_array",
    "flatten_tree",
    "tensor_from_numpy",
    "tensor_to_numpy",
    "tree_map",
    "unflatten_tree",
]
