"""zamba2-1.2b-published [hybrid]: the published Zamba2-1.2B (Zyphra).

38 Mamba2 layers (d_model 2048, expand 2, heads of 64, N 64, 1 group, conv
4, chunk 256), every sixth a "hybrid" layer: the ONE shared block over the
residual and the embedding concatenated (4096 wide; 32/32 heads of 128,
scores scaled by (128/2)^-0.5, RoPE theta 10,000 over the whole head; a
GELU-gated MLP of 8192), with rank-128 LoRA adapters on q, k, v and
gate-up and a 2048 x 2048 linear of each call's own, whose output is added
to the input of that layer's Mamba2 mixer.  Vocab 32,000, tied;
1,205,078,912 parameters.  The layers wrap into 6 groups of the pattern and
a tail of 2 mamba layers.

[https://huggingface.co/Zyphra/Zamba2-1.2B config.json; arXiv:2411.15242]

Not in the registry's ``ARCHS``: the dry run walks that list, and the
hybrid kind has no sharding rules.  ``zamba2_1_2b`` is the JAX package's
variant.
"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b-published",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=128,
    pattern=("mamba",) * 5 + ("hybrid",),
    rope_theta=10000.0,
    norm_eps=1e-5,
    tie_embeddings=True,
    adapter_rank=128,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=1, conv_width=4, chunk=256),
    source="https://huggingface.co/Zyphra/Zamba2-1.2B; arXiv:2411.15242",
)
