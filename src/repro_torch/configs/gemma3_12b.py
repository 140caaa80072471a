"""gemma3-12b [hf:google/gemma-3-12b family].

Dense 48L d_model=3840 16H (GQA kv=8) head_dim=256 d_ff=15360
vocab=262144; 5:1 local:global attention (window 1024, every 6th layer
global with rope_theta=1e6, locals 1e4); tied embeddings.

long_500k RUNS for this arch: 40 of 48 layers cap their decode cache at the
1024-token window; only the 8 global layers hold the full 500k KV.
"""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    vocab=262144,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    qk_norm=True,
    rope_theta=1e6,
    rope_theta_local=1e4,
    window=1024,
    window_pattern=6,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    n_layers=6,
    d_model=64,
    vocab=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    qk_norm=True,
    window=8,
    window_pattern=3,
    tie_embeddings=True,
)
