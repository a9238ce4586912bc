"""zamba2-1.2b [hybrid]: the JAX package's variant of Zamba2-1.2B.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf]

Not the published model: here a "shared_attn" block takes the place of
every sixth Mamba2 layer, attends over the residual alone (2048 wide, heads
of 64) and has no LoRA adapters and no per-call linear (0.951 B params).
The published layer is ``zamba2_1_2b_published`` beside this module.
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
