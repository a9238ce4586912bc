"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf]
"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    # mamba backbone; ONE shared transformer block re-applied every 6th
    # layer (weights shared across occurrences — zamba2's design)
    pattern=("mamba",) * 5 + ("shared_attn",),
    rope_theta=10000.0,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=1),
    source="arXiv:2411.15242; hf",
)
