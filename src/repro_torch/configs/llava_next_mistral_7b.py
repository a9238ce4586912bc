"""llava-next-mistral-7b [vlm] — mistral-7b backbone, anyres tiling.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
The vision tower is a STUB per the assignment: input_specs() provides
precomputed patch embeddings [B, n_patches, d_model] that are prepended
to the token embeddings.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""

from .base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    pattern=("attn",),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    vlm=VLMConfig(n_patches=576),
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
