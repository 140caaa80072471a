"""Multi-head Latent Attention (PyTorch port of `repro.models.mla`,
DeepSeek-V2, arXiv:2405.04434).

Queries and keys/values are low-rank compressed:

    c_q  = W_dq  h            (q_lora)             -> q = W_uq norm(c_q)
    c_kv = W_dkv h            (kv_lora)            -> k_nope = W_uk norm(c_kv)
    k_rope = RoPE(W_kr h)     (qk_rope, per token, shared across heads)
    v    = W_uv norm(c_kv)

The prefill attends with the full keys and values; the decode cache holds
only (c_kv, k_rope), kv_lora + qk_rope values a token, and decode absorbs
W_uk / W_uv into the query and output so scores are taken against the
compressed cache:

    score  = (q_nope W_uk) . c_kv + q_rope . k_rope
    out    = (sum_j p_j c_kv_j) W_uv

A bfloat16 cache is cast up to the query's dtype before it enters a
product, the promotion the reference's einsums make implicitly.

On a tensor-parallel rank (`tp`, the local specs of the params) the
heads split: the up-projections and `wo`'s rows are the rank's, the
compressions whole, the output `psum`-med.  Decode on a rank's slice of
a sequence-sharded latent cache gathers the query heads, attends over
the slice and joins the slices with `flash_decode`'s statistics
(`layers.seq_combine`), the rank keeping its heads' compressed context.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.sharding import split_axes
from repro_torch.models.layers import (LATENT_AXES, _mask_bias, _psum,
                                       cache_write, rmsnorm, rmsnorm_def,
                                       rope, seq_combine, seq_shard)
from repro_torch.models.module import ParamDef


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


def mla_def(cfg: MLAConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    return {
        "w_dq": ParamDef((d, cfg.q_lora), ("embed", "lora")),
        "q_norm": rmsnorm_def(cfg.q_lora, "lora"),
        "w_uq": ParamDef((cfg.q_lora, h, cfg.qk_nope + cfg.qk_rope),
                         ("lora", "heads", "head_dim")),
        "w_dkv": ParamDef((d, cfg.kv_lora), ("embed", "lora")),
        "kv_norm": rmsnorm_def(cfg.kv_lora, "lora"),
        "w_kr": ParamDef((d, cfg.qk_rope), ("embed", None)),
        "w_uk": ParamDef((cfg.kv_lora, h, cfg.qk_nope),
                         ("lora", "heads", "head_dim")),
        "w_uv": ParamDef((cfg.kv_lora, h, cfg.v_head),
                         ("lora", "heads", "head_dim")),
        "wo": ParamDef((h, cfg.v_head, d), ("heads", "head_dim", "embed")),
    }


def _project_q(p, cfg: MLAConfig, x, positions):
    cq = rmsnorm(p["q_norm"], torch.einsum("bsd,dl->bsl", x, p["w_dq"]))
    q = torch.einsum("bsl,lhk->bshk", cq, p["w_uq"])
    q_nope, q_rope = q[..., :cfg.qk_nope], q[..., cfg.qk_nope:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _compress_kv(p, cfg: MLAConfig, x, positions):
    c_kv = rmsnorm(p["kv_norm"], torch.einsum("bsd,dl->bsl", x, p["w_dkv"]))
    k_rope = torch.einsum("bsd,dr->bsr", x, p["w_kr"])
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


_HEAD_LEAVES = ("w_uq", "w_uk", "w_uv", "wo")


def _head_axes(tp: dict | None) -> tuple[str, ...]:
    """The mesh axes this rank's heads split over, from the local specs
    `tp` of the MLA params (None: one process): its heads' up-projections
    and `wo`'s rows; the compressions and their norms whole."""
    if not tp:
        return ()
    got = {k: split_axes(tp.get(k)) for k in tp}
    axes = got["wo"]
    if any(got[k] != axes for k in _HEAD_LEAVES) or any(
            got[k] for k in got if k not in _HEAD_LEAVES):
        raise ValueError(f"MLA leaves split unevenly: {tp}")
    return axes


def mla_apply(p: dict, cfg: MLAConfig, x: torch.Tensor,
              positions: torch.Tensor, tp: dict | None = None
              ) -> torch.Tensor:
    """Full-sequence MLA. x: (B, S, D).  `tp`, the local specs of `p` on
    a tensor-parallel rank (`mla_prefill`)."""
    y, _ = mla_prefill(p, cfg, x, positions, tp)
    return y


def mla_prefill(p: dict, cfg: MLAConfig, x: torch.Tensor,
                positions: torch.Tensor, tp: dict | None = None):
    """Returns (out, cache=(c_kv, k_rope)), the compressed cache in x's
    dtype (the reference's prefill does not cast it).  `tp`, the local
    specs of `p` on a tensor-parallel rank: its heads' up-projections and
    `wo`'s rows, the partial output `psum`-med; the cache, which has no
    heads, whole."""
    axes = _head_axes(tp)
    q_nope, q_rope = _project_q(p, cfg, x, positions)
    c_kv, k_rope = _compress_kv(p, cfg, x, positions)
    k_nope = torch.einsum("bsl,lhk->bshk", c_kv, p["w_uk"])
    v = torch.einsum("bsl,lhv->bshv", c_kv, p["w_uv"])
    scale = (cfg.qk_nope + cfg.qk_rope) ** -0.5
    scores = (torch.einsum("bqhn,bkhn->bhqk", q_nope, k_nope)
              + torch.einsum("bqhr,bkr->bhqk", q_rope, k_rope))
    scores = scores.float() * scale
    bias = _mask_bias(positions, positions, True, 0)
    probs = torch.softmax(scores + bias[:, None], dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhv->bqhv", probs, v)
    return (_psum(torch.einsum("bqhv,hvd->bqd", o, p["wo"]), axes),
            (c_kv, k_rope))


def mla_decode(p: dict, cfg: MLAConfig, x: torch.Tensor, cache: tuple,
               pos: torch.Tensor, tp: dict | None = None):
    """Absorbed decode against the compressed cache.

    x: (B, C, D); cache: (c_kv (B, S, kv_lora), k_rope (B, S, qk_rope));
    pos: (B,) first position of the chunk (C == 1: one token; C > 1: a
    serving prefill chunk).  Returns (out (B, C, D), cache), the cache
    written in place.  `tp`, the local specs of `p` on a tensor-parallel
    rank (`mla_prefill`).  On a rank's slice of a sequence-sharded latent
    cache (`layers.seq_shard`) the rank writes only the positions it
    holds, attends with every head's query (gathered over the head axes)
    over its slice, `seq_combine` joins the slices, and the rank keeps its
    heads' compressed context."""
    from repro_torch.distributed import runtime as rt
    axes = _head_axes(tp)
    b, c = x.shape[:2]
    q_pos = pos[:, None] + torch.arange(c, device=x.device)[None, :]
    q_nope, q_rope = _project_q(p, cfg, x, q_pos)
    c_new, r_new = _compress_kv(p, cfg, x, q_pos)
    c_kv, k_rope = cache
    shard = seq_shard(c_kv, LATENT_AXES)
    if shard is not None and c != 1:
        raise NotImplementedError(
            "a prefill chunk on a sequence-sharded latent cache: the "
            "sharded decode covers the one-token step")
    start = shard[1] if shard is not None else 0
    cache_write(c_kv, c_new, pos, cfg.uniform_decode, offset=start)
    cache_write(k_rope, r_new, pos, cfg.uniform_decode, offset=start)
    ckv, kr = c_kv.to(q_nope.dtype), k_rope.to(q_rope.dtype)

    # absorb W_uk into q: q_c (B, C, H, kv_lora)
    q_c = torch.einsum("bqhn,lhn->bqhl", q_nope, p["w_uk"])
    if shard is not None and axes:
        q_c = rt.all_gather(q_c, axes, axis=2, tiled=True)
        q_rope = rt.all_gather(q_rope, axes, axis=2, tiled=True)
    scale = (cfg.qk_nope + cfg.qk_rope) ** -0.5
    scores = (torch.einsum("bqhl,bkl->bhqk", q_c, ckv)
              + torch.einsum("bqhr,bkr->bhqk", q_rope, kr))
    scores = scores.float() * scale
    s = c_kv.shape[1]
    k_pos = (start + torch.arange(s, device=x.device))[None, :].expand(b, s)
    bias = _mask_bias(q_pos, k_pos, True, 0, k_len_valid=(pos + c)[:, None])
    scores = scores + bias[:, None]

    def context(probs):
        return torch.einsum("bhqk,bkl->bqhl", probs.to(x.dtype),
                            ckv.to(x.dtype))
    if shard is None:
        o_c = context(torch.softmax(scores, dim=-1))
    else:
        o_c = seq_combine(scores, context, shard[0])
        if axes:
            n = p["w_uk"].shape[1]
            o_c = o_c.narrow(2, rt.axis_index(axes) * n, n)
    o = torch.einsum("bqhl,lhv->bqhv", o_c, p["w_uv"])      # absorb W_uv
    return (_psum(torch.einsum("bqhv,hvd->bqd", o, p["wo"]), axes),
            (c_kv, k_rope))
