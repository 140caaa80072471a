"""Mixture-of-experts block: top-k router, shared + routed experts (PyTorch
port of `repro.models.moe`).

Two paths with the same semantics:

  * `moe_ref` evaluates every expert for every token and combines them
    with the router's gates.  Without a live mesh it is the block the
    reference serves with (`repro.models.transformer._ffn_apply`), so a
    single-device decode step reads every expert's weights.
  * `moe_ep_local` is the reference's expert-parallel body, run on each
    rank's LOCAL tensors with explicit collectives
    (`distributed.runtime`): experts over the `model` mesh axis, their
    d_model dims FSDP-sharded over `fsdp_axes` and all-gathered here.
    Each rank packs the tokens routed to its experts into an (E_local,
    capacity, d) buffer (`_pack_local`; a token beyond an expert's
    capacity is dropped, GShard-style), runs the batched expert products
    and scatters the gated outputs back (`_unpack_local`).  With
    `a2a=False` the tokens are the same on every model rank and the
    outputs `psum` over it; with `a2a=True` each rank routes its own
    tokens against every expert and two `all_to_all`s carry them to the
    experts' owners and back.

`moe_ep_local` trains as it serves: its collectives carry their
transposes (`distributed.runtime`), so the FSDP gathers' gradients come
back reduce-scattered, the `psum` over "model" hands every rank the whole
cotangent of its partial output, and the all_to_alls send the cotangents
back to the ranks the tokens came from.

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


def moe_ref(p: dict, cfg: MoEConfig, x: torch.Tensor,
            tp: dict | None = None) -> torch.Tensor:
    """x: (B, S, d).  Every expert evaluated on every token, weighted by
    the router's gates (zero off the top k).  `tp`, the local specs of
    `p` on a tensor-parallel rank: the shared experts' d_ff split
    (`_shared_tp`); the routed experts come whole."""
    from repro_torch.distributed.sharding import split_axes
    axes = split_axes(tp.get("shared_wi")) if tp else ()
    if tp and (split_axes(tp.get("shared_wo")) != axes or any(
            split_axes(tp.get(k)) for k in ("router", "wi", "wo"))):
        raise ValueError(f"MoE leaves split unevenly: {tp}")
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
        y = y + (_shared_tp(p["shared_wi"], p["shared_wo"], x2, axes)
                 if axes else _shared(p, cfg, x2))
    return y.reshape(b, s, d)


def capacity_of(t_local: int, cfg: MoEConfig) -> int:
    """Per-expert slots of the expert-parallel path:
    ceil(T * top_k * capacity_factor / E), at least 1."""
    c = int(-(-t_local * cfg.top_k * cfg.capacity_factor // cfg.n_experts))
    return max(1, c)


# ---------------------------------------------------------------------------
# Capacity pack / unpack (per rank, no collectives)
# ---------------------------------------------------------------------------
def _pack_local(x2: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
                e_first: int, e_local: int, capacity: int):
    """Scatter the tokens routed to experts [e_first, e_first + e_local)
    into a buffer (e_local, capacity, d), each expert's in token order,
    an expert's assignments beyond `capacity` dropped.  Returns (buf,
    slot, valid, w_sorted, tok_sorted): the (T * k,) assignment records,
    sorted by local expert, that `_unpack_local` reads."""
    t, d = x2.shape
    k = ids.shape[1]
    dev = x2.device
    e_flat = ids.reshape(-1) - e_first             # (T * k,) local expert
    w_flat = w.reshape(-1)
    tok_flat = torch.arange(t, device=dev).repeat_interleave(k)
    is_local = (e_flat >= 0) & (e_flat < e_local)
    key = torch.where(is_local, e_flat, e_local)   # elsewhere -> bucket E
    order = torch.sort(key, stable=True).indices
    e_sorted = key[order]
    # each assignment's place in its expert's contiguous run
    counts = torch.bincount(e_sorted, minlength=e_local + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=dev) - starts[e_sorted]
    valid = (e_sorted < e_local) & (pos < capacity)
    slot = torch.where(valid, e_sorted * capacity + pos,
                       e_local * capacity)
    # the token ids into the slots (one dump slot at the end takes the
    # dropped), then one gather of (e_local * capacity, d) rows
    tok_slot = torch.full((e_local * capacity + 1,), t, dtype=torch.long,
                          device=dev)
    tok_slot[slot[valid]] = tok_flat[order][valid]
    x2_pad = torch.cat([x2, x2.new_zeros((1, d))], dim=0)
    buf = x2_pad[tok_slot[:-1]].reshape(e_local, capacity, d)
    return buf, slot, valid, w_flat[order], tok_flat[order]


def _unpack_local(y_buf: torch.Tensor, slot: torch.Tensor,
                  valid: torch.Tensor, w_sorted: torch.Tensor,
                  tok_sorted: torch.Tensor, t: int) -> torch.Tensor:
    """The gated scatter-add of the experts' outputs back to token order:
    (e_local, capacity, d) -> (t, d); dropped assignments add nothing."""
    e_local, capacity, d = y_buf.shape
    flat = torch.cat([y_buf.reshape(-1, d), y_buf.new_zeros((1, d))], 0)
    picked = flat[torch.where(valid, slot, e_local * capacity)]
    contrib = picked * (w_sorted * valid)[:, None]
    return y_buf.new_zeros((t, d)).index_add_(0, tok_sorted, contrib)


def dropped_assignments(ids: torch.Tensor, n_experts: int,
                        capacity: int) -> int:
    """How many of the (T, k) routed assignments `ids` overflow their
    expert's `capacity` (the ones `_pack_local` drops)."""
    counts = torch.bincount(ids.reshape(-1), minlength=n_experts)
    return int(torch.clamp(counts - capacity, min=0).sum())


# ---------------------------------------------------------------------------
# The expert-parallel body
# ---------------------------------------------------------------------------
def moe_ep_local(p_local: dict, cfg: MoEConfig, x_local: torch.Tensor, *,
                 model_axis: str = "model", fsdp_axes=("pod", "data"),
                 capacity: int | None = None, a2a: bool = False,
                 mesh=None) -> torch.Tensor:
    """One rank's MoE (the reference's `shard_map` body).  `p_local`: this
    rank's shards as `distributed.sharding.ep_param_specs` lays them out
    (wi / wo experts over `model_axis`, their d_model dims over
    `fsdp_axes`, gathered here; the router whole; the shared experts'
    d_ff over `model_axis`).  `x_local`: (B, S, d) this rank's tokens,
    the same on every `model_axis` rank unless `a2a`.  The collectives
    run on `mesh` (default: the active context's)."""
    from repro_torch.distributed import runtime as rt
    b, s, d = x_local.shape
    x2 = x_local.reshape(-1, d)
    t_local = b * s
    cap = capacity or capacity_of(t_local, cfg)
    e_local = p_local["wi"].shape[0]
    n_shards = cfg.n_experts // e_local
    fsdp_axes = tuple(fsdp_axes or ())

    w, ids = _route(p_local, cfg, x2)
    wi, wo = p_local["wi"], p_local["wo"]
    if fsdp_axes:
        wi = rt.all_gather(wi, fsdp_axes, axis=1, tiled=True, mesh=mesh)
        wo = rt.all_gather(wo, fsdp_axes, axis=2, tiled=True, mesh=mesh)

    if a2a:
        # pack against the GLOBAL expert space, then exchange
        buf, slot, valid, w_srt, tok_srt = _pack_local(
            x2, w, ids, 0, cfg.n_experts, cap)          # (E, cap, d)
        buf = buf.reshape(n_shards, e_local, cap, d)
        recv = rt.all_to_all(buf, model_axis, 0, 0, tiled=True, mesh=mesh)
        h = _expert_ffn(wi, wo, recv.transpose(0, 1).reshape(
            e_local, n_shards * cap, d))
        back = h.reshape(e_local, n_shards, cap, d).transpose(0, 1)
        back = rt.all_to_all(back.contiguous(), model_axis, 0, 0,
                             tiled=True, mesh=mesh)
        y = _unpack_local(back.reshape(cfg.n_experts, cap, d), slot, valid,
                          w_srt, tok_srt, t_local)
    else:
        first = rt.axis_index(model_axis, mesh) * e_local
        buf, slot, valid, w_srt, tok_srt = _pack_local(
            x2, w, ids, first, e_local, cap)
        y = _unpack_local(_expert_ffn(wi, wo, buf), slot, valid, w_srt,
                          tok_srt, t_local)
        y = rt.psum(y, model_axis, mesh)
    if cfg.n_shared:
        # shared experts: d_ff over `model` (arriving sharded), d_model
        # FSDP-gathered here
        swi, swo = p_local["shared_wi"], p_local["shared_wo"]
        if fsdp_axes:
            swi = rt.all_gather(swi, fsdp_axes, axis=0, tiled=True,
                                mesh=mesh)
            swo = rt.all_gather(swo, fsdp_axes, axis=1, tiled=True,
                                mesh=mesh)
        if a2a:
            # the ranks' tokens differ, so a TP psum would mix them:
            # gather the (small) shared weights and compute locally
            swi = rt.all_gather(swi, model_axis, axis=2, tiled=True,
                                mesh=mesh)
            swo = rt.all_gather(swo, model_axis, axis=0, tiled=True,
                                mesh=mesh)
            y = y + _shared({"shared_wi": swi, "shared_wo": swo}, cfg, x2)
        else:
            y = y + _shared_tp(swi, swo, x2, model_axis, mesh)
    return y.reshape(b, s, d)


def _shared_tp(swi: torch.Tensor, swo: torch.Tensor, x2: torch.Tensor,
               model_axis: str, mesh=None) -> torch.Tensor:
    """The shared experts with d_ff tensor-parallel over `model_axis`:
    each rank's partial output, summed over it."""
    from repro_torch.distributed import runtime as rt
    gu = torch.einsum("td,dcf->tcf", x2, swi)
    h = F.silu(gu[:, 0]) * gu[:, 1]
    return rt.psum(h @ swo, model_axis, mesh)
