"""mamba2-370m [ssm] — attention-free, SSD (state-space duality).

48L d_model=1024 d_ff=0 vocab=50280 ssm_state=128
[arXiv:2405.21060; unverified]
"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=32,  # SSD heads: d_inner(2048) / head_dim(64)
    n_kv_heads=32,
    d_ff=0,
    vocab_size=50280,
    head_dim=64,
    pattern=("mamba",),
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1),
    source="arXiv:2405.21060; unverified",
)
