"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct].

Backbone: 32L d_model=3072 32H (MHA kv=32) d_ff=8192 vocab=32064.
The CLIP frontend is a STUB per the assignment: input_specs provides
precomputed patch embeddings that are prepended to the text tokens."""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="dense",
    n_layers=32,
    d_model=3072,
    vocab=32064,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    rope_theta=1e4,
    frontend="vision",
)

SMOKE = ModelConfig(
    name="phi3v-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    vocab=256,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    frontend="vision",
)
