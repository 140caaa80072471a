"""seamless-m4t-medium [arXiv:2308.11596]. Enc-dec 12L+12L d_model=1024
16H d_ff=4096 vocab=256206.  The audio frontend is a STUB per the
assignment: input_specs provides precomputed frame embeddings (B, S, D)."""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    n_enc_layers=12,
    d_model=1024,
    vocab=256206,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    rope_theta=1e4,
    frontend="audio",
)

SMOKE = ModelConfig(
    name="seamless-smoke",
    family="encdec",
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    vocab=256,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    frontend="audio",
)
