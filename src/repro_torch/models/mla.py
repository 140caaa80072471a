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
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.sharding import split_axes
from repro_torch.models.layers import (_mask_bias, cache_write, rmsnorm,
                                       rmsnorm_def, rope)
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


def mla_apply(p: dict, cfg: MLAConfig, x: torch.Tensor,
              positions: torch.Tensor, tp: dict | None = None
              ) -> torch.Tensor:
    """Full-sequence MLA. x: (B, S, D).  `tp`, the local specs of `p` on
    a tensor-parallel rank: its heads' up-projections and `wo`'s rows
    (the compressions and their norms whole), the partial output
    `psum`-med."""
    axes = ()
    if tp:
        got = {k: split_axes(tp.get(k)) for k in tp}
        axes = got["wo"]
        if any(got[k] != axes for k in _HEAD_LEAVES) or any(
                got[k] for k in got if k not in _HEAD_LEAVES):
            raise ValueError(f"MLA leaves split unevenly: {tp}")
    y, _ = mla_prefill(p, cfg, x, positions)
    if not axes:
        return y
    from repro_torch.distributed import runtime as rt
    return rt.psum(y, axes)


def mla_prefill(p: dict, cfg: MLAConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """Returns (out, cache=(c_kv, k_rope)), the compressed cache in x's
    dtype (the reference's prefill does not cast it)."""
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
    return torch.einsum("bqhv,hvd->bqd", o, p["wo"]), (c_kv, k_rope)


def mla_decode(p: dict, cfg: MLAConfig, x: torch.Tensor, cache: tuple,
               pos: torch.Tensor):
    """Absorbed decode against the compressed cache.

    x: (B, C, D); cache: (c_kv (B, S, kv_lora), k_rope (B, S, qk_rope));
    pos: (B,) first position of the chunk (C == 1: one token; C > 1: a
    serving prefill chunk).  Returns (out (B, C, D), cache), the cache
    written in place."""
    b, c = x.shape[:2]
    q_pos = pos[:, None] + torch.arange(c, device=x.device)[None, :]
    q_nope, q_rope = _project_q(p, cfg, x, q_pos)
    c_new, r_new = _compress_kv(p, cfg, x, q_pos)
    c_kv, k_rope = cache
    c_kv = cache_write(c_kv, c_new, pos, cfg.uniform_decode)
    k_rope = cache_write(k_rope, r_new, pos, cfg.uniform_decode)
    ckv, kr = c_kv.to(q_nope.dtype), k_rope.to(q_rope.dtype)

    # absorb W_uk into q: q_c (B, C, H, kv_lora)
    q_c = torch.einsum("bqhn,lhn->bqhl", q_nope, p["w_uk"])
    scale = (cfg.qk_nope + cfg.qk_rope) ** -0.5
    scores = (torch.einsum("bqhl,bkl->bhqk", q_c, ckv)
              + torch.einsum("bqhr,bkr->bhqk", q_rope, kr))
    scores = scores.float() * scale
    s = c_kv.shape[1]
    k_pos = torch.arange(s, device=x.device)[None, :].expand(b, s)
    bias = _mask_bias(q_pos, k_pos, True, 0, k_len_valid=(pos + c)[:, None])
    probs = torch.softmax(scores + bias[:, None], dim=-1).to(x.dtype)
    o_c = torch.einsum("bhqk,bkl->bqhl", probs, ckv.to(x.dtype))
    o = torch.einsum("bqhl,lhv->bqhv", o_c, p["w_uv"])      # absorb W_uv
    return torch.einsum("bqhv,hvd->bqd", o, p["wo"]), (c_kv, k_rope)
