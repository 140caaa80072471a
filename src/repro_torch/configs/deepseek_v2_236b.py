"""deepseek-v2-236b [arXiv:2405.04434].

60L d_model=5120, 128 heads MLA (kv_lora=512, q_lora=1536, qk_nope=128,
qk_rope=64, v_head=128), MoE 160 routed top-6 + 2 shared, expert d_ff=1536,
layer 0 dense FFN d_ff=12288, vocab=102400.  The decode cache holds only
(c_kv, k_rope) = 576 values/token — the paper's MLA compression.
"""

from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="mla_moe",
    n_layers=60,
    d_model=5120,
    vocab=102400,
    n_heads=128,
    head_dim=128,          # v_head (for cache bookkeeping)
    n_kv_heads=128,
    rope_theta=1e4,
    mla=MLAConfig(d_model=5120, n_heads=128, q_lora=1536, kv_lora=512,
                  qk_nope=128, qk_rope=64, v_head=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_model=5120, d_ff=1536,
                  n_shared=2, capacity_factor=1.25),
    first_dense_ff=12288,
    moe_ep=True,
)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke",
    family="mla_moe",
    n_layers=3,
    d_model=64,
    vocab=256,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    mla=MLAConfig(d_model=64, n_heads=4, q_lora=32, kv_lora=16,
                  qk_nope=16, qk_rope=8, v_head=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=32, n_shared=1,
                  capacity_factor=2.0),
    first_dense_ff=128,
    moe_ep=False,
)
