"""Shared transformer building blocks (PyTorch port of
`repro.models.layers`).

Every block is a pair: `<block>_def(cfg)` gives the ParamDef skeleton,
`<block>_apply(params, ...)` the activations.  Layouts are the reference's:
activations (B, S, D), heads (B, S, H, D), KV caches (B, S, KV, D), MLP
weights wi (D, 2, F) and wo (F, D).  Attention is causal (decoders),
bidirectional (encoders: `causal=False`) or cross (`cross=True`: K/V from
an encoder memory, no RoPE, masked by the memory's positions only).

Caches are updated in place (the reference donates them to its jitted
steps); writes past the cache's end are dropped, as the reference's
scatter drops them.  Under a live sharding context whose cache sequence is
sharded (`distributed.sharding.use_sharding(mesh, rules, sizes=
{"cache_seq": S})`), each rank holds its slice of the KV cache: a decode
step writes a position only on the rank whose slice holds it, and
`flash_decode` combines the ranks' partial softmax statistics over the
sequence axes (`FLASH_DECODES` counts its calls).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import rosa
from repro_torch.models.module import ParamDef

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_def(dim: int, axis: str = "embed") -> ParamDef:
    return ParamDef((dim,), (axis,), "ones")


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6,
            axes=(), n: int | None = None) -> torch.Tensor:
    """RMSNorm with float32 statistics and the reference's hand-written
    backward (`_RMSNorm`): every (B, S, D) cotangent stays in the
    activation dtype, and only the (B, S, 1) reductions run in float32.
    Without a graph to record (serving, `no_grad`) the same forward runs
    as plain ops.  Where the ranks over the mesh `axes` each hold a block
    of a last dim of global size `n` (a tensor-parallel rank's heads),
    the means over it, forward and backward, are the `psum` of the
    blocks' sums over n, and `scale` is this rank's block."""
    axes = tuple(axes)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps, axes, n)
    return _rmsnorm_fwd(x, scale, eps, axes, n)[0]


def _row_mean(t: torch.Tensor, axes: tuple, n: int | None) -> torch.Tensor:
    """The mean over the last dim, kept; over `axes`' blocks of a dim of
    global size n where `axes` is not empty."""
    if not axes:
        return torch.mean(t, dim=-1, keepdim=True)
    from repro_torch.distributed import runtime as rt
    return rt.psum(torch.sum(t, dim=-1, keepdim=True), axes) / n


def _rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float,
                 axes: tuple = (), n: int | None = None):
    """(x * r * scale, r): r = rsqrt(mean(x^2) + eps) in float32, cast to
    the activation dtype."""
    var = _row_mean(torch.square(x.float()), axes, n)
    r = torch.rsqrt(var + eps).to(x.dtype)
    return x * r * scale, r


class _RMSNorm(torch.autograd.Function):
    """The reference's `_rmsnorm_fwd2` / `_rmsnorm_bwd2`: d_scale summed in
    float32 over every leading axis, then cast to the scale's dtype; the
    mean of (g * scale) * x_hat in float32 (over the whole dim where it
    is split: every rank's block of x moves every rank's r), cast to the
    activation dtype; dx = r * (g * scale - x_hat * m)."""

    @staticmethod
    def forward(ctx, x, scale, eps, axes, n):
        y, r = _rmsnorm_fwd(x, scale, eps, axes, n)
        ctx.save_for_backward(x, r, scale)
        ctx.axes, ctx.n = axes, n
        return y

    @staticmethod
    def backward(ctx, g):
        x, r, scale = ctx.saved_tensors
        xh = x * r
        d_scale = torch.sum((g * xh).float(),
                            dim=tuple(range(g.ndim - 1))).to(scale.dtype)
        gsc = g * scale
        m = _row_mean((gsc * xh).float(), ctx.axes, ctx.n).to(x.dtype)
        dx = r * (gsc - xh * m)
        return dx, d_scale, None, None, None


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    # torch.full fills on the device; a tensor made from the host scalar
    # would be a synchronizing copy in every layer of every step
    freq = torch.exp(
        -torch.log(torch.full((), theta, dtype=torch.float32,
                              device=x.device))
        * (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., None].float() * freq
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA, optional qk-norm / bidirectional / cross)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 1e6
    causal: bool = True          # False -> bidirectional (encoder)
    cross: bool = False          # K/V from the encoder memory
    uniform_decode: bool = True  # serving decodes at ragged positions


def attn_def(cfg: AttnConfig) -> dict:
    d = cfg.d_model
    p = {
        "wq": ParamDef((d, cfg.n_heads, cfg.head_dim),
                       ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, cfg.n_kv_heads, cfg.head_dim),
                       ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, cfg.n_kv_heads, cfg.head_dim),
                       ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((cfg.n_heads, cfg.head_dim, d),
                       ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_def(cfg.head_dim, "head_dim")
        p["k_norm"] = rmsnorm_def(cfg.head_dim, "head_dim")
    return p


def cache_write(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                uniform: bool = False, offset: int = 0) -> torch.Tensor:
    """Write `new` (B, C, ...) into `cache` (B, S, ...) at pos[b] + [0, C),
    in place; tokens at positions outside [offset, offset + S) are
    dropped.  Returns `cache`.  `offset` is the first global position of a
    rank's slice of a sequence-sharded cache (0 for a whole cache).

    One token column at a time: each step writes one position per row,
    clamped into range and re-writing the old value where the position is
    out of range, so no step has duplicate indices and nothing syncs with
    the host.  The lower bound matters on a slice: a negative column
    would wrap to the slice's end.  (`uniform`, the reference's
    all-rows-equal fast path for a sequence-sharded cache, needs no path
    of its own here.)"""
    b, c = new.shape[:2]
    s = cache.shape[1]
    new = new.to(cache.dtype)
    rows = torch.arange(b, device=cache.device)
    for j in range(c):
        col = pos + (j - offset)
        ok = ((col >= 0) & (col < s)).reshape(b, *([1] * (cache.ndim - 2)))
        colc = torch.clamp(col, 0, s - 1)
        cache[rows, colc] = torch.where(ok, new[:, j], cache[rows, colc])
    return cache


def _repeat_kv(k: torch.Tensor, n_heads: int,
               heads: torch.Tensor | None) -> torch.Tensor:
    """The KV heads (B, S, KV, D) as a rank's query heads read them:
    with `heads`, the global indices of the query heads it holds (its KV
    heads whole: they do not split over its ranks), (B, S, len(heads), D),
    each head's KV head of the global `n_heads` grouping; without, k as it
    is (`attention_core` pairs each KV head with its query heads)."""
    if heads is None:
        return k
    return k.index_select(-2, heads // (n_heads // k.shape[-2]))


def _head_split(p: dict, tp, x: torch.Tensor):
    """The model axes this rank's attention heads split over (from the
    local specs `tp` of `p`), and the global indices of its query heads
    when its KV heads are whole (None when both split or neither)."""
    from repro_torch.distributed.sharding import split_axes
    if not tp:
        return (), None
    hq, hkv = split_axes(tp.get("wq")), split_axes(tp.get("wk"))
    if split_axes(tp.get("wo")) != hq or split_axes(tp.get("wv")) != hkv \
            or (hkv and hkv != hq):
        raise ValueError(f"attention leaves split unevenly: {tp}")
    if not hq or hkv:
        return hq, None
    from repro_torch.distributed import runtime as rt
    n = p["wq"].shape[-2]
    first = rt.axis_index(hq) * n
    return hq, torch.arange(first, first + n, device=x.device)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window, k_len_valid=None) -> torch.Tensor:
    """Additive mask (..., Sq, Sk); window <= 0 means unlimited."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok = ok & (diff >= 0)
    if window > 0:
        ok = ok & (diff < window)
    if k_len_valid is not None:
        ok = ok & (k_pos[..., None, :] < k_len_valid[..., None])
    return torch.where(ok, 0.0, NEG_INF).float()


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B, Sq, H, D) against k (B, Sk, KV, D), each KV head serving its
    group of H / KV query heads in place (the products of repeated KV
    heads without their (B, Sk, H, D) copies: a decode's whole cache in
    the query dtype at 32768 positions and 64 heads is 34 GB a leaf at 32
    rows): the scaled float32 scores (B, H, Sq, Sk)."""
    b, c, h, d = q.shape
    kv = k.shape[2]
    if h % kv:
        raise ValueError(f"{h} query heads cannot pair with {kv} KV heads")
    s = torch.einsum("bckgd,bskd->bkgcs", q.reshape(b, c, kv, h // kv, d),
                     k.to(q.dtype))
    return s.reshape(b, h, c, -1).float() * d ** -0.5


def _grouped_values(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Weights (B, H, Sq, Sk) against v (B, Sk, KV, D), grouped as
    `_grouped_scores`: (B, Sq, H, D) in the weights' dtype."""
    b, h, c, s = probs.shape
    kv, d = v.shape[2:]
    o = torch.einsum("bkgcs,bskd->bckgd",
                     probs.reshape(b, kv, h // kv, c, s), v.to(probs.dtype))
    return o.reshape(b, c, h, d)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D), KV dividing H, each KV
    head serving its group of query heads; bias: (B or 1, Sq, Sk).  A
    bfloat16 cache promotes to the query dtype, as in the reference."""
    scores = _grouped_scores(q, k) + bias[:, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _grouped_values(probs, v)


def attn_apply(p: dict, cfg: AttnConfig, x: torch.Tensor,
               positions: torch.Tensor, *, window=0, theta=None,
               memory: torch.Tensor | None = None,
               memory_pos: torch.Tensor | None = None,
               tp: dict | None = None) -> torch.Tensor:
    """Full-sequence attention, no cache. x: (B, S, D).  A cross attention
    takes K/V from `memory` (B, Sm, D) without RoPE and masks by
    `memory_pos` only.  `tp`, the local specs of `p` on a
    tensor-parallel rank (`distributed.sharding.local_specs`): its query
    heads (and KV heads where they split too; else the KV heads its
    heads read) and `wo`'s rows, the partial output `psum`-med."""
    theta = cfg.rope_theta if theta is None else theta
    axes, heads = _head_split(p, tp, x)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    src = memory if cfg.cross else x
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if cfg.cross:
        k_pos = memory_pos
    else:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
        k_pos = positions
    bias = _mask_bias(positions, k_pos, cfg.causal and not cfg.cross, window)
    o = attention_core(q, _repeat_kv(k, cfg.n_heads, heads),
                       _repeat_kv(v, cfg.n_heads, heads), bias)
    return _psum(torch.einsum("bshk,hkd->bsd", o, p["wo"]), axes)


def attn_prefill(p: dict, cfg: AttnConfig, x: torch.Tensor,
                 positions: torch.Tensor, *, window=0, theta=None,
                 tp: dict | None = None):
    """Full-prompt attention; also returns the (k, v) cache.  `tp`, the
    local specs of `p` on a tensor-parallel rank (as `attn_apply`): the
    cache is that of its KV heads (every KV head where they do not
    split)."""
    theta = cfg.rope_theta if theta is None else theta
    axes, heads = _head_split(p, tp, x)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)
    bias = _mask_bias(positions, positions, cfg.causal, window)
    o = attention_core(q, _repeat_kv(k, cfg.n_heads, heads),
                       _repeat_kv(v, cfg.n_heads, heads), bias)
    return _psum(torch.einsum("bshk,hkd->bsd", o, p["wo"]), axes), (k, v)


KV_AXES = ("cache_batch", "cache_seq", "kv_heads", "head_dim")
LATENT_AXES = ("cache_batch", "cache_seq", None)   # MLA's (c_kv, k_rope)
FLASH_DECODES = {"calls": 0}     # flash_decode's sharded decodes, counted


def seq_shard(kc: torch.Tensor, axes: tuple = KV_AXES):
    """(sequence mesh axes, first global position of this rank's slice) of
    a local cache leaf (B, S_local, ...), its logical `axes` (a KV cache's
    by default, MLA's latent `LATENT_AXES`), under a live context whose
    `cache_seq` is sharded; None for a whole cache (no live context, or
    the sequence resolves to no mesh axis)."""
    from repro_torch.distributed import runtime
    from repro_torch.distributed.sharding import (current_ctx, live_mesh,
                                                  local_spec)
    ctx = current_ctx()
    if live_mesh(ctx) is None:
        return None
    spec = local_spec(ctx, tuple(kc.shape), axes)
    part = spec[1] if len(spec) > 1 else None
    if part is None:
        return None
    axes = (part,) if isinstance(part, str) else tuple(part)
    return axes, runtime.axis_index(axes, ctx.mesh) * kc.shape[1]


def seq_combine(s: torch.Tensor, values, axes) -> torch.Tensor:
    """Attention over a sequence-sharded cache, combined across the
    sequence's mesh `axes` (the statistics of the reference's
    `flash_decode`): `s`, this rank's masked float32 scores (B, H, C,
    S_local) at its slice's global key positions; `values(p)`, its
    partial output (B, C, H, D) of unnormalized weights p (B, H, C,
    S_local).  The slices' maxima `pmax`, their sums of exponentials and
    partial outputs `psum`: only (B, H, C) statistics and the partial
    output move."""
    from repro_torch.distributed import runtime
    m = runtime.pmax(torch.amax(s, dim=-1), axes)            # (B, H, C)
    p_ = torch.exp(s - m[..., None])
    denom = runtime.psum(torch.sum(p_, -1), axes)
    o = runtime.psum(values(p_), axes)
    return o / denom.transpose(1, 2)[..., None].to(o.dtype)


def flash_decode(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                 pos: torch.Tensor, window, n_heads: int):
    """Decode attention over a sequence-sharded KV cache (the reference's
    `flash_decode`, its `shard_map` body on this rank's tensors).

    Each rank takes its slice's scores at the slice's global key
    positions and `seq_combine` joins the ranks' partial softmaxes.  q:
    (B, 1, H, D), every head on every rank (`n_heads` = H: the ranks of a
    sequence-sharded cache hold every KV head of their slice, and a rank
    that computes only some heads gathers the others' queries first,
    `attn_decode`); kc / vc: (B, S_local, KV, D), this rank's slice; pos:
    (B,).  Returns None without a live context or when the cache's
    sequence is not sharded (the caller then attends over its whole
    cache)."""
    shard = seq_shard(kc)
    if shard is None:
        return None
    axes, start = shard
    FLASH_DECODES["calls"] += 1
    b, s_loc = kc.shape[:2]
    k_pos = (start + torch.arange(s_loc, device=kc.device))[None, :] \
        .expand(b, s_loc)
    bias = _mask_bias(pos[:, None], k_pos, True, window,
                      k_len_valid=(pos + 1)[:, None])
    if q.shape[2] != n_heads:
        raise ValueError(f"flash_decode: {q.shape[2]} query heads, "
                         f"n_heads {n_heads}")
    return seq_combine(_grouped_scores(q, kc) + bias[:, None],
                       lambda p: _grouped_values(p.to(q.dtype), vc), axes)


def attn_decode(p: dict, cfg: AttnConfig, x: torch.Tensor, cache: tuple,
                pos: torch.Tensor, *, window=0, theta=None,
                memory_pos: torch.Tensor | None = None,
                tp: dict | None = None):
    """Cached decode. x: (B, C, D); cache: (k, v) each (B, S, KV, D);
    pos: (B,) first position of the chunk (C == 1: one token; C > 1: a
    prefill chunk).  Returns (out, cache), the cache written in place.
    A cross attention reads its static (k, v) memory cache against
    `memory_pos` (B, Sm) and returns the cache unchanged.  `tp`, the
    local specs of `p` on a tensor-parallel rank (as `attn_apply`): the
    cache holds its KV heads or, where they do not split, every KV head
    (of its slice, on a sequence-sharded cache: there `flash_decode`
    attends with every rank's query heads, gathered, and the rank keeps
    its heads' output)."""
    theta = cfg.rope_theta if theta is None else theta
    axes, heads = _head_split(p, tp, x)
    b, c = x.shape[:2]
    q_pos = pos[:, None] + torch.arange(c, device=x.device)[None, :]
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
    if cfg.cross:
        k_full, v_full = cache
        bias = _mask_bias(q_pos, memory_pos, False, 0)
        o = attention_core(q, _repeat_kv(k_full, cfg.n_heads, heads),
                           _repeat_kv(v_full, cfg.n_heads, heads), bias)
        return _psum(torch.einsum("bshk,hkd->bsd", o, p["wo"]), axes), cache
    q = rope(q, q_pos, theta)
    k_new = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v_new = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        k_new = rmsnorm(p["k_norm"], k_new)
    k_new = rope(k_new, q_pos, theta)
    kc, vc = cache
    shard = seq_shard(kc)
    if shard is not None:
        # this rank's slice of a sequence-sharded cache: write only the
        # positions it holds, then combine the ranks' attention
        if c != 1:
            raise NotImplementedError(
                "a prefill chunk on a sequence-sharded KV cache: "
                "flash_decode covers the one-token decode step")
        if axes and heads is None:
            raise ValueError("a sequence-sharded KV cache whose KV heads "
                             f"split over {axes}")
        cache_write(kc, k_new, pos, cfg.uniform_decode, offset=shard[1])
        cache_write(vc, v_new, pos, cfg.uniform_decode, offset=shard[1])
        if not axes:
            o = flash_decode(q, kc, vc, pos, window, q.shape[2])
        else:
            from repro_torch.distributed import runtime as rt
            qa = rt.all_gather(q, axes, axis=2, tiled=True)
            o = flash_decode(qa, kc, vc, pos, window, qa.shape[2]).narrow(
                2, rt.axis_index(axes) * q.shape[2], q.shape[2])
        return _psum(torch.einsum("bshk,hkd->bsd", o, p["wo"]), axes), \
            (kc, vc)
    kc = cache_write(kc, k_new, pos, cfg.uniform_decode)
    vc = cache_write(vc, v_new, pos, cfg.uniform_decode)
    s = kc.shape[1]
    k_pos = torch.arange(s, device=x.device)[None, :].expand(b, s)
    bias = _mask_bias(q_pos, k_pos, True, window,
                      k_len_valid=(pos + c)[:, None])
    o = attention_core(q, _repeat_kv(kc, cfg.n_heads, heads),
                       _repeat_kv(vc, cfg.n_heads, heads), bias)
    return _psum(torch.einsum("bshk,hkd->bsd", o, p["wo"]), axes), (kc, vc)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def mlp_def(d_model: int, d_ff: int) -> dict:
    return {
        "wi": ParamDef((d_model, 2, d_ff), ("embed", None, "mlp")),  # gate|up
        "wo": ParamDef((d_ff, d_model), ("mlp", "embed")),
    }


def mlp_apply(p: dict, x: torch.Tensor,
              engine: "rosa.Engine | None" = None,
              key: torch.Generator | None = None, *, name: str = "mlp",
              step: int = 0, tp: dict | None = None) -> torch.Tensor:
    """SwiGLU MLP; with an optical `rosa.Engine` both projections run
    through the paper's optical MAC under the layer names `{name}/wi` and
    `{name}/wo`.  A layer stack passes its layer index as `step`, so layers
    draw independent noise while sharing the name's plan, chip variation
    and ledger entry (the reference's scanned stack traces its body once).
    `tp`, the local specs of `p` on a tensor-parallel rank: `wi`'s
    columns and `wo`'s rows of this rank's MLP units, the partial output
    `psum`-med (an optical product cut as `ProductSplit` says)."""
    from repro_torch.distributed.sharding import ProductSplit, split_axes
    axes = split_axes(tp.get("wi")) if tp else ()
    if tp and split_axes(tp.get("wo")) != axes:
        raise ValueError(f"MLP leaves split unevenly: {tp}")
    if engine is not None and not engine.is_dense:
        if key is not None:
            engine = engine.with_key(key)
        b, s, d = x.shape
        f = p["wi"].shape[-1]
        gu = engine.matmul(
            x.reshape(-1, d), p["wi"].reshape(d, 2 * f), name=f"{name}/wi",
            step=step, split=ProductSplit.columns(axes, blocks=2)
            if axes else None).reshape(b, s, 2, f)
        h = F.silu(gu[..., 0, :]) * gu[..., 1, :]
        y = engine.matmul(h.reshape(-1, f), p["wo"], name=f"{name}/wo",
                          step=step,
                          split=ProductSplit.rows(axes) if axes else None)
        return _psum(y, axes).reshape(b, s, d).to(x.dtype)
    gu = torch.einsum("bsd,dcf->bscf", x, p["wi"])
    h = F.silu(gu[..., 0, :]) * gu[..., 1, :]
    return _psum(torch.einsum("bsf,fd->bsd", h, p["wo"]), axes)


def _psum(t: torch.Tensor, axes) -> torch.Tensor:
    """`t` summed over the mesh `axes` (a tensor-parallel rank's partial
    output); `t` itself for no axes."""
    if not axes:
        return t
    from repro_torch.distributed import runtime as rt
    return rt.psum(t, axes)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_def(vocab: int, d_model: int) -> ParamDef:
    return ParamDef((vocab, d_model), ("vocab", "embed"), "normal", 0.02)


def embed_apply(table: torch.Tensor, tokens: torch.Tensor,
                axes: tuple[str, ...] = ()) -> torch.Tensor:
    """The tokens' rows of `table`; with `axes`, the mesh axes a
    tensor-parallel rank's vocab rows split over, the rank's rows looked
    up (zero for a token another rank holds) and `psum`-med."""
    if not axes:
        return table[tokens]
    first, n = _vocab_block(table.shape[0], axes)
    local = tokens - first
    own = (local >= 0) & (local < n)
    rows = table[torch.where(own, local, 0)]
    return _psum(rows * own[..., None].to(rows.dtype), axes)


def _vocab_block(n: int, axes) -> tuple[int, int]:
    """(first global vocab row, rows) of this rank's block of `n` rows."""
    from repro_torch.distributed import runtime as rt
    return rt.axis_index(axes) * n, n


def unembed_def(d_model: int, vocab: int) -> ParamDef:
    return ParamDef((d_model, vocab), ("embed", "vocab"))


def unembed_apply(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,dv->bsv", x, w)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None,
                 vocab_axes: tuple[str, ...] = ()) -> torch.Tensor:
    """Mean next-token cross entropy in float32; logits (B, S, V), labels
    (B, S).  With a mask, the masked mean over max(sum(mask), 1); under
    a live sharded context whose rows are split over ranks both sums are
    `psum`-med over them (every rank's value is the global batch's).
    With `vocab_axes` the logits are a tensor-parallel rank's block of
    the vocab (`_split_nll`)."""
    logits = logits.float()
    if vocab_axes:
        nll = _split_nll(logits, labels, vocab_axes)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    num, den = torch.sum(nll * mask), torch.sum(mask)
    from repro_torch.distributed.sharding import row_axes
    axes = row_axes()
    if axes:
        # rows split over ranks: the masked mean of the global batch
        from repro_torch.distributed import runtime as rt
        num, den = rt.psum(num, axes), rt.psum(den, axes)
    return num / torch.clamp(den, min=1.0)


def _split_nll(logits: torch.Tensor, labels: torch.Tensor,
               axes) -> torch.Tensor:
    """-log softmax at the labels of logits whose vocab the ranks over
    `axes` split (this rank's block (B, S, V/M)): the logsumexp from the
    `pmax` of the blocks' maxima (a shift, held constant: the
    logsumexp's gradient does not depend on it) and the `psum` of the
    shifted exponential sums; the gold logit a `psum` of the pick the
    label's owner makes."""
    from repro_torch.distributed import runtime as rt
    first, n = _vocab_block(logits.shape[-1], axes)
    m = rt.pmax(logits.detach().amax(dim=-1), axes)
    logz = m + torch.log(rt.psum(
        torch.sum(torch.exp(logits - m[..., None]), dim=-1), axes))
    local = labels.long() - first
    own = (local >= 0) & (local < n)
    pick = torch.gather(logits, -1, torch.where(own, local, 0)[..., None])
    gold = rt.psum(pick[..., 0] * own.to(logits.dtype), axes)
    return logz - gold
