"""Multi-head Latent Attention configuration (the `MLAConfig` of
`repro.models.mla`, DeepSeek-V2, arXiv:2405.04434).

Only the metadata is ported: the model zoo lowers MLA architectures to
their low-rank projection rows from it (`configs/model_zoo.py`).  The
attention itself lands with the mla_moe family, ROADMAP Queue 1 item 5;
until then `models.transformer.check_family` refuses to build an MLA model.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128
    rope_theta: float = 1e4
    uniform_decode: bool = True    # see layers.AttnConfig.uniform_decode

    @property
    def cache_width(self) -> int:
        """Values cached per token: (c_kv, k_rope)."""
        return self.kv_lora + self.qk_rope
