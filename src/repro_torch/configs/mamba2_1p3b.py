"""mamba2-1.3b [arXiv:2405.21060]. Attention-free SSD: 48L d_model=2048
(d_inner=4096, 64 heads x P=64, d_state=128, conv 4), vocab=50280, tied.

long_500k RUNS: O(1) decode state, no KV cache."""

from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    vocab=50280,
    ssm=SSMConfig(d_model=2048, d_state=128, head_dim=64, expand=2,
                  n_groups=1, d_conv=4, chunk=128),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    vocab=256,
    ssm=SSMConfig(d_model=64, d_state=16, head_dim=16, expand=2,
                  n_groups=1, d_conv=4, chunk=8),
    tie_embeddings=True,
)
