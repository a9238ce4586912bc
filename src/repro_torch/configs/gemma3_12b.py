"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144
[hf:google/gemma-3-1b-pt; unverified]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=256,
    pattern=("swa",) * 5 + ("global",),
    sliding_window=1024,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)
