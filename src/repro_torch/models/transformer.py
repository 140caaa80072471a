"""Decoder-only stacks of the dense, moe, mla_moe and ssm families (PyTorch
port of those paths of `repro.models.transformer`).

Parameters keep the reference's stacked layout (a leading `layers` axis on
every block leaf); the reference's `scan` over layers becomes a Python loop
that passes the layer index as `step`.  deepseek-v2's dense first layer
(`first_dense_ff`) is one unstacked `layer0` in front of the stack, as in
the reference: its FFN is dense (width `first_dense_ff`, through the
optical engine under `rosa_mlp`) and its noise key folds step 0, while the
stacked layers keep their indices 1..n-1.  MoE FFNs are plain: like the
reference, the moe block ignores `rosa_mlp`.  Step functions take and
return plain dicts of tensors:

    prefill(params, cfg, batch)      -> (last-token logits (B, V), cache)
    decode_step(params, cfg, batch)  -> (logits (B, V), cache)
    chunk_step(params, cfg, batch)   -> (logits at the last real token, cache)

Caches are written in place and returned.  The ssm family (Mamba-2
blocks, no FFN) prefills whole prompts only: its `chunk_step` raises, as
the reference's does.  The hybrid and encdec families raise
NotImplementedError naming the family; their config fields (and the
modality frontends) are carried for the model zoo's lowering only
(`configs/model_zoo.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import rosa
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.module import ParamDef, map_tree


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | mla_moe | ssm (ported) |
    #                              hybrid | encdec (metadata only)
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    qk_norm: bool = False
    rope_theta: float = 1e6
    # sliding-window pattern: layers with (i % pattern != pattern-1) are
    # local with `window`; pattern == 0 -> all layers full attention
    window: int = 0
    window_pattern: int = 0
    rope_theta_local: float = 1e4
    moe: MOE.MoEConfig | None = None
    mla: MLA.MLAConfig | None = None
    first_dense_ff: int = 0
    ssm: SSM.SSMConfig | None = None
    shared_every: int = 0        # zamba2: shared attn after every k ssm layers
    n_enc_layers: int = 0        # encdec: encoder depth (n_layers = decoder)
    frontend: str = "none"       # none | vision | audio
    tie_embeddings: bool = False
    rosa_mlp: bool = False       # route MLP projections through the ROSA MAC
    cache_dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    uniform_decode: bool = True  # False -> ragged per-slot positions

    @property
    def attn(self) -> L.AttnConfig:
        return L.AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                            self.head_dim, self.qk_norm, self.rope_theta,
                            uniform_decode=self.uniform_decode)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0


PORTED_FAMILIES = ("dense", "moe", "mla_moe", "ssm")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to "
            f"repro_torch yet (ported: {', '.join(PORTED_FAMILIES)})")


def stack_defs(skel, n: int):
    """Prepend a layer dimension of size n to every ParamDef."""
    return map_tree(lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes,
                                       d.init, d.scale), skel)


def layer_at(tree, i: int):
    """One layer's params (views) out of a stacked tree."""
    return map_tree(lambda a: a[i], tree)


def layer_meta(cfg: ModelConfig, i: int) -> dict:
    """Attention window and rope theta of layer i."""
    if cfg.window_pattern > 0 and \
            i % cfg.window_pattern != cfg.window_pattern - 1:
        return {"window": cfg.window, "theta": cfg.rope_theta_local}
    return {"window": 0, "theta": cfg.rope_theta}


def dense0(cfg: ModelConfig) -> ModelConfig:
    """The config of deepseek-v2's dense first layer: the same block with
    a dense FFN of width `first_dense_ff` (rosa_mlp kept)."""
    return dataclasses.replace(cfg, moe=None, d_ff=cfg.first_dense_ff)


def n_stacked(cfg: ModelConfig) -> int:
    """Layers in the stack: all but the unstacked `layer0`, if any."""
    return cfg.n_layers - (1 if cfg.first_dense_ff else 0)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _ffn_def(cfg: ModelConfig) -> dict:
    if cfg.moe is not None:
        return MOE.moe_def(cfg.moe)
    return L.mlp_def(cfg.d_model, cfg.d_ff)


def _ffn_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
               step: int = 0) -> torch.Tensor:
    if cfg.moe is not None:
        return MOE.moe_ref(p, cfg.moe, x)
    if cfg.rosa_mlp:
        # the installed engine (a compiled rosa.Program installs its own)
        # carries the serving plan, the pinned chip and the ledger
        engine = rosa.ambient_engine()
        if engine is None:
            engine = rosa.Engine.from_config()
        return L.mlp_apply(p, x, engine=engine, step=step)
    return L.mlp_apply(p, x)


def _block_def(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"ln1": L.rmsnorm_def(d), "ssm": SSM.ssm_def(cfg.ssm)}
    attn = (MLA.mla_def(cfg.mla) if cfg.family == "mla_moe"
            else L.attn_def(cfg.attn))
    return {"ln1": L.rmsnorm_def(d), "ln2": L.rmsnorm_def(d),
            "attn": attn, "ffn": _ffn_def(cfg)}


def _block_prefill(p: dict, cfg: ModelConfig, x, positions, meta, step):
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if "ssm" in p:
        # full-sequence ssm + final state capture for the decode cache
        y, cache = _ssm_prefill(p["ssm"], cfg.ssm, h)
        return x + y, cache
    if cfg.family == "mla_moe":
        a, cache = MLA.mla_prefill(p["attn"], cfg.mla, h, positions)
    else:
        a, cache = L.attn_prefill(p["attn"], cfg.attn, h, positions,
                                  window=meta["window"], theta=meta["theta"])
        cache = tuple(c.to(cfg.cache_dtype) for c in cache)
    x = x + a
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + _ffn_apply(p["ffn"], cfg, h, step), cache


def _block_decode(p: dict, cfg: ModelConfig, x, pos, meta, cache, step):
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if "ssm" in p:
        y, cache = SSM.ssm_decode(p["ssm"], cfg.ssm, h, cache)
        return x + y, cache
    if cfg.family == "mla_moe":
        a, cache = MLA.mla_decode(p["attn"], cfg.mla, h, cache, pos)
    else:
        a, cache = L.attn_decode(p["attn"], cfg.attn, h, cache, pos,
                                 window=meta["window"], theta=meta["theta"])
    x = x + a
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + _ffn_apply(p["ffn"], cfg, h, step), cache


def _ssm_prefill(p: dict, scfg: SSM.SSMConfig, u: torch.Tensor):
    """Like ssm_apply, but also returns the decode cache: the last d_conv-1
    pre-conv inputs and the final scan state.

    A prompt shorter than d_conv-1 tokens leaves fewer rows; they are
    left-padded with zeros, the history `_causal_conv`'s own zero padding
    assumes, so the cache always has the shape of `ssm_cache_def`.  (The
    reference keeps the short rows, which no slot cache can take.)"""
    out, state, pre = SSM.ssm_forward(p, scfg, u)
    k = scfg.d_conv - 1
    conv = [torch.nn.functional.pad(
        t[:, -k:], (0, 0) * (t.ndim - 2) + (max(k - t.shape[1], 0), 0))
        for t in pre]
    cache = {"conv_x": conv[0], "conv_b": conv[1], "conv_c": conv[2],
             "state": state}
    return out, cache


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------
def model_def(cfg: ModelConfig) -> dict:
    check_family(cfg)
    d = cfg.d_model
    skel: dict = {"embed": L.embed_def(cfg.vocab, d),
                  "final_norm": L.rmsnorm_def(d),
                  "layers": stack_defs(_block_def(cfg), n_stacked(cfg))}
    if cfg.first_dense_ff:
        skel["layer0"] = _block_def(dense0(cfg))
    if not cfg.tie_embeddings:
        skel["unembed"] = L.unembed_def(d, cfg.vocab)
    return skel


def logits_of(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return L.unembed_apply(params["unembed"], x)


def prefill(params, cfg: ModelConfig, batch: dict):
    """Run the prompt, return (last-token logits (B, V), cache)."""
    check_family(cfg)
    tokens = batch["tokens"]
    x = L.embed_apply(params["embed"], tokens)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    cache: dict = {}
    off = 0
    if cfg.first_dense_ff:
        x, cache["layer0"] = _block_prefill(params["layer0"], dense0(cfg), x,
                                            positions, layer_meta(cfg, 0), 0)
        off = 1
    caches = []
    for i in range(n_stacked(cfg)):
        x, c = _block_prefill(layer_at(params["layers"], i), cfg, x,
                              positions, layer_meta(cfg, i + off), i + off)
        caches.append(c)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_of(params, cfg, x[:, -1:])[:, 0]
    if cfg.family == "ssm":
        layers = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
    else:
        layers = tuple(torch.stack(t) for t in zip(*caches))
    cache["layers"] = layers
    cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return logits, cache


def _decode_layers(params, cfg: ModelConfig, x, pos, cache) -> torch.Tensor:
    if cfg.family == "ssm":
        sc = cache["layers"]
        for i in range(cfg.n_layers):
            x, new = _block_decode(layer_at(params["layers"], i), cfg, x,
                                   pos, None, layer_at(sc, i), i)
            for k, t in new.items():
                sc[k][i].copy_(t)
        return x
    off = 0
    if cfg.first_dense_ff:
        x, _ = _block_decode(params["layer0"], dense0(cfg), x, pos,
                             layer_meta(cfg, 0), cache["layer0"], 0)
        off = 1
    kc, vc = cache["layers"]          # (k, v), or MLA's (c_kv, k_rope)
    for i in range(n_stacked(cfg)):
        x, _ = _block_decode(layer_at(params["layers"], i), cfg, x, pos,
                             layer_meta(cfg, i + off), (kc[i], vc[i]),
                             i + off)
    return x


def decode_step(params, cfg: ModelConfig, batch: dict):
    """One token per row: batch = {token (B,), pos (B,), cache}.
    Returns (logits (B, V), cache) with the cache advanced in place."""
    check_family(cfg)
    token, pos, cache = batch["token"], batch["pos"], batch["cache"]
    x = L.embed_apply(params["embed"], token[:, None])
    x = _decode_layers(params, cfg, x, pos, cache)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_of(params, cfg, x)[:, 0]
    return logits, dict(cache, pos=pos + 1)


def chunk_step(params, cfg: ModelConfig, batch: dict):
    """Prefill one chunk of C tokens against a running per-sequence cache.

    batch = {tokens (B, C), n_valid (B,), cache[, pos]}: positions
    pos..pos+C-1 are written, `pos` advances by `n_valid` (the chunk tail
    may be padding), and the logits (B, V) are read at the last real token.
    """
    check_family(cfg)
    if cfg.family == "ssm":
        raise ValueError(f"chunked prefill unsupported for {cfg.family}: "
                         "state-space caches admit no positional chunking")
    tokens, n_valid = batch["tokens"], batch["n_valid"]
    cache = batch["cache"]
    pos = batch.get("pos", cache["pos"])
    x = L.embed_apply(params["embed"], tokens)
    x = _decode_layers(params, cfg, x, pos, cache)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    idx = torch.clamp(n_valid - 1, min=0).long()
    x_last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    logits = logits_of(params, cfg, x_last)[:, 0]
    return logits, dict(cache, pos=pos + n_valid)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zero decode cache.  dense and moe: {"layers": (k, v) each (L, B, S,
    KV, D)}; mla_moe: {"layers": (c_kv (L, B, S, kv_lora), k_rope (L, B, S,
    qk_rope))} over the stacked layers, and with `first_dense_ff` also
    "layer0": the same pair without the layer axis; all in
    cfg.cache_dtype.  ssm: {"layers": {conv_x, conv_b, conv_c, state}},
    each leaf `ssm_cache_def`'s float32 one with a leading layer axis (no
    sequence axis: max_len does not enter).  All with "pos": (B,) int32;
    `models.model.cache_axes` names every axis."""
    check_family(cfg)
    pos = torch.zeros((batch,), dtype=torch.int32, device=device)
    if cfg.family == "ssm":
        one = SSM.ssm_cache_def(cfg.ssm, batch, device="meta")
        return {"layers": {k: torch.zeros((cfg.n_layers, *t.shape),
                                          dtype=t.dtype, device=device)
                           for k, t in one.items()},
                "pos": pos}
    dt = cfg.cache_dtype
    if cfg.family == "mla_moe":
        def mk(lead):
            return tuple(torch.zeros(lead + (batch, max_len, w), dtype=dt,
                                     device=device)
                         for w in (cfg.mla.kv_lora, cfg.mla.qk_rope))
        cache = {"layers": mk((n_stacked(cfg),)), "pos": pos}
        if cfg.first_dense_ff:
            cache["layer0"] = mk(())
        return cache
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"layers": tuple(torch.zeros(shape, dtype=dt, device=device)
                            for _ in "kv"),
            "pos": pos}
