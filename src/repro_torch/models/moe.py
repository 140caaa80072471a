"""Mixture-of-experts configuration (the `MoEConfig` of `repro.models.moe`).

Only the metadata is ported: the model zoo lowers MoE architectures to
their GEMM rows from it (`configs/model_zoo.py`).  The block itself (top-k
router, shared and routed experts) lands with the moe family, ROADMAP
Queue 1 item 5; until then `models.transformer.check_family` refuses to
build an MoE model.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                    # per-expert hidden
    n_shared: int = 0            # always-on shared experts (deepseek-v2)
    capacity_factor: float = 1.25
    router_scale: bool = True    # normalize top-k weights to sum to 1
