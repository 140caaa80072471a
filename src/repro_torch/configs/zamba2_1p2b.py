"""zamba2-1.2b [arXiv:2411.15242]. Hybrid: 38 Mamba-2 layers (d_model=2048,
d_state=64) with ONE shared attention+MLP block (32H kv=32, d_ff=8192)
applied after every 6 mamba layers (6 applications, per-application KV
cache; weights shared).  vocab=32000, tied embeddings.

long_500k RUNS: mamba state is O(1); the shared-attn caches are the only
sequence-length state."""

from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    vocab=32000,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    ssm=SSMConfig(d_model=2048, d_state=64, head_dim=64, expand=2,
                  n_groups=1, d_conv=4, chunk=128),
    shared_every=6,
    rope_theta=1e4,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=5,
    d_model=64,
    vocab=256,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    ssm=SSMConfig(d_model=64, d_state=16, head_dim=16, expand=2,
                  n_groups=1, d_conv=4, chunk=8),
    shared_every=2,
    tie_embeddings=True,
)
