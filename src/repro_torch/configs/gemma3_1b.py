"""gemma3-1b [dense] — 5:1 local:global attention, 128k context.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144
[hf:google/gemma-3-1b-pt; unverified]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    pattern=("swa",) * 5 + ("global",),
    sliding_window=512,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)
