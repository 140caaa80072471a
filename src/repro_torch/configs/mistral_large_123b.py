"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407].
Dense 88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768."""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    vocab=32768,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="mistral-large-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    vocab=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
)
