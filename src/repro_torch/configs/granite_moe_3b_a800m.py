"""granite-moe-3b-a800m [moe] — 40 experts top-8.

32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    pattern=("moe",),
    rope_theta=10000.0,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
