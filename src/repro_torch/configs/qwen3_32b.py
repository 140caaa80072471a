"""qwen3-32b [hf:Qwen/Qwen3-32B family]. Dense 64L d_model=5120 64H
(GQA kv=8) d_ff=25600 vocab=151936, qk_norm."""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    vocab=151936,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    qk_norm=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen3-32b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    vocab=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    qk_norm=True,
)
