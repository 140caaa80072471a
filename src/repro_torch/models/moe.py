"""Mixture-of-experts block: top-k router, shared + routed experts (PyTorch
port of `repro.models.moe`, its single-device path).

`moe_ref` evaluates every expert for every token and combines them with
the router's gates.  Without a mesh it is the block the reference serves
with (`repro.models.transformer._ffn_apply`), and the port has no mesh, so
it is what the port serves with: a decode step reads every expert's
weights.  The reference's expert-parallel path (`_pack_local`,
`_unpack_local`, `moe_ep_local` inside `shard_map`) waits for the port of
`distributed`.

The expert projections are batched products against the stored weights
viewed as (E, d, 2f) and (E, f, d): no layout of a weight is ever copied
(at deepseek-v2's width `wi` is 6.4 GB a layer in float32).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.module import ParamDef


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                    # per-expert hidden
    n_shared: int = 0            # always-on shared experts (deepseek-v2)
    capacity_factor: float = 1.25
    router_scale: bool = True    # normalize top-k weights to sum to 1


def moe_def(cfg: MoEConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": ParamDef((d, e), ("embed", None), scale=0.02),
        "wi": ParamDef((e, d, 2, f), ("experts", "embed", None, None)),
        "wo": ParamDef((e, f, d), ("experts", None, "embed")),
    }
    if cfg.n_shared:
        p["shared_wi"] = ParamDef((d, 2, cfg.n_shared * f),
                                  ("embed", None, "mlp"))
        p["shared_wo"] = ParamDef((cfg.n_shared * f, d), ("mlp", "embed"))
    return p


def _route(p: dict, cfg: MoEConfig, x2: torch.Tensor):
    """x2: (T, d) -> top-k (weights (T, k) in x2's dtype, ids (T, k)),
    routed in float32."""
    logits = x2.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.router_scale:
        w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return w.to(x2.dtype), ids


def _shared(p: dict, cfg: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    gu = torch.einsum("td,dcf->tcf", x, p["shared_wi"])
    h = F.silu(gu[:, 0]) * gu[:, 1]
    return h @ p["shared_wo"]


def _expert_ffn(wi: torch.Tensor, wo: torch.Tensor,
                buf: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, d); wi: (E, d, 2, f); wo: (E, f, d) -> (E, C, d)."""
    e, d, _, f = wi.shape
    gu = torch.bmm(buf, wi.view(e, d, 2 * f)).view(e, -1, 2, f)
    h = F.silu(gu[:, :, 0]) * gu[:, :, 1]
    return torch.bmm(h, wo)


def moe_ref(p: dict, cfg: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d).  Every expert evaluated on every token, weighted by
    the router's gates (zero off the top k)."""
    b, s, d = x.shape
    x2 = x.reshape(-1, d)
    w, ids = _route(p, cfg, x2)                       # (T, k)
    gates = torch.zeros((x2.shape[0], cfg.n_experts), dtype=x.dtype,
                        device=x.device).scatter_add_(1, ids, w)
    # one stride-0 view of the tokens per expert: (E, T, d)
    y_all = _expert_ffn(p["wi"], p["wo"],
                        x2.expand(cfg.n_experts, *x2.shape))
    y = torch.einsum("te,etd->td", gates, y_all)
    if cfg.n_shared:
        y = y + _shared(p, cfg, x2)
    return y.reshape(b, s, d)


def capacity_of(t_local: int, cfg: MoEConfig) -> int:
    """Per-expert slots of the expert-parallel path:
    ceil(T * top_k * capacity_factor / E), at least 1."""
    c = int(-(-t_local * cfg.top_k * cfg.capacity_factor // cfg.n_experts))
    return max(1, c)
