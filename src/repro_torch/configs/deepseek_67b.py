"""deepseek-67b [arXiv:2401.02954]. Llama-arch dense 95L d_model=8192
64H (GQA kv=8) d_ff=22016 vocab=102400."""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    vocab=102400,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="deepseek-67b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    vocab=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
)
