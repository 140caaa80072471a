"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-235B-A22B family].

94L d_model=4096 64H (GQA kv=4) MoE 128 experts top-8, expert d_ff=1536,
vocab=151936, qk_norm.  No projection of this model goes through the
optical engine: MoE FFNs ignore `rosa_mlp` and attention is always plain,
so its serving plan is empty (the reference's code does the same; its
docstring names QKV/O and the expert FFNs as optical).
"""

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    vocab=151936,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_model=4096, d_ff=1536,
                  capacity_factor=1.25),
    moe_ep=True,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    vocab=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    qk_norm=True,
    moe=MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=32,
                  capacity_factor=2.0),
    moe_ep=False,
)
