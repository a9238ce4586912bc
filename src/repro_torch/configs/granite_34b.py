"""granite-34b [dense] — llama-arch code model.

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152
[arXiv:2405.04324; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    pattern=("attn",),
    rope_theta=10000.0,
    tie_embeddings=False,
    source="arXiv:2405.04324; hf",
)
