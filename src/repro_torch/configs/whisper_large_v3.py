"""whisper-large-v3 [audio] — encoder-decoder transformer backbone.

32L (enc) + 32L (dec), d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866.
The conv audio frontend is a STUB per the assignment: input_specs()
provides precomputed frame embeddings [B, n_frames, d_model].
Positional encoding: RoPE on the backbone (hardware adaptation note in
DESIGN.md — original uses learned absolute embeddings; backbone compute
is unchanged).
[arXiv:2212.04356; unverified]
"""

from .base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    pattern=("attn",),
    rope_theta=10000.0,
    tie_embeddings=True,
    mlp_type="gelu",
    encdec=EncDecConfig(n_enc_layers=32, n_frames=1500),
    source="arXiv:2212.04356; unverified",
)
