"""Model stacks of the dense, moe, mla_moe, ssm, hybrid and encdec
families (PyTorch port of `repro.models.transformer`; of its sharding
hooks, the expert-parallel MoE under a live mesh).

Parameters keep the reference's stacked layout (a leading `layers` axis on
every block leaf); the reference's `scan` over layers becomes a Python loop
that passes the layer index as `step`.  deepseek-v2's dense first layer
(`first_dense_ff`) is one unstacked `layer0` in front of the stack, as in
the reference: its FFN is dense (width `first_dense_ff`, through the
optical engine under `rosa_mlp`) and its noise key folds step 0, while the
stacked layers keep their indices 1..n-1.  MoE FFNs are plain: like the
reference, the moe block ignores `rosa_mlp`.  With `moe_ep` and a live
sharding context (`distributed.sharding.live_mesh`) the MoE FFN runs the
expert-parallel `moe.moe_ep_local` on the rank's local shards, with the
reference's choice of dispatch and FSDP axes; otherwise `moe_ref`.

Under a live train context (`launch.steps.make_train_step(layout=)`) the
params are the rank's shards of the `TRAIN_RULES` layout and the model
gathers them where it uses them: the top-level leaves (embed, unembed,
final norm, `layer0`, zamba2's `shared_attn`, the encoder's norm) on entry
to `forward` / `train_loss`, and a stacked layer's (or zamba2 group's)
leaves inside its recomputed body, on the local slice `layer_at` hands
in, so the recomputation gathers again and autograd never keeps a
layer's gathered weights.  The gathers leave the tensor-parallel dims
local (`distributed.sharding.tp_axes`: "model", unless the batch's rows
take it) and hand each block the local specs of what stays split, so a
rank computes its attention heads (and KV heads, or the KV heads its
heads read), its MLP units (plain or optical), its SSM heads and its
vocab rows, with a `psum` a projection pair and the vocab's softmax
statistics summed, as the reference's GSPMD partitions its step.
An expert-parallel MoE FFN's expert weights stay split over "model"
(`moe_ep_local` gathers their FSDP dims itself); without `moe_ep` the
routed experts are gathered whole and the shared experts split.

Under a live serve context (`launch.steps.make_serve_step`, the
`SERVE_RULES` layout) `prefill`, `decode_step` and `chunk_step` of the
families of `SERVED_FAMILIES` (dense, moe, mla_moe, ssm) take the same
route without recomputation: the top-level leaves (deepseek-v2's
`layer0` among them) gathered on entry, each layer's leaves before its
block, each rank computing its heads, MLP units, experts, SSM heads and
vocab rows on its rows of the batch and its part of the cache (its KV
heads, or every KV head of its slice of a sequence-sharded cache, which
`flash_decode` attends over with the query heads gathered; MLA's latent
cache, which has no heads, whole or its slice of the sequence); the
logits' vocab blocks are gathered, so every rank returns whole (B, V)
logits of its rows.  Under sharded params the other families raise.

zamba2 (`hybrid`) stacks its Mamba-2 layers as `groups` (n_groups,
shared_every, ...) plus an unstacked remainder `tail`, and applies ONE
shared attention + MLP block (`shared_attn`) after every group, with a KV
cache per application.  The shared MLP is plain, as in the reference:
it never routes through the optical engine.  seamless (`encdec`) runs a
bidirectional encoder over `batch["src_embeds"]` (the audio frontend's
frame embeddings) and decoder layers with cross attention to its output;
prefill caches the cross K/V once (`cache_dtype`), and decode reads them
against `memory_pos`.  Step functions take and return plain dicts of
tensors:

    forward(params, cfg, batch)      -> final hidden states (B, S, D)
    train_loss(params, cfg, batch)   -> scalar loss (labels in the batch)
    prefill(params, cfg, batch)      -> (last-token logits (B, V), cache)
    decode_step(params, cfg, batch)  -> (logits (B, V), cache)
    chunk_step(params, cfg, batch)   -> (logits at the last real token, cache)

Caches are written in place and returned.  The ssm and hybrid families
prefill whole prompts only: their `chunk_step` raises, as the reference's
does.  The vision frontend (phi-3-vision) takes precomputed patch
embeddings `batch["patch_embeds"]` (B, S_img, D) that `prefill` puts
ahead of the token embeddings, so its cache holds S_img + S_tok
positions; `chunk_step` and `decode_step` embed tokens only, as the
reference's do, so serving runs such a model text-only.
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
    family: str                  # dense | moe | mla_moe | ssm | hybrid |
    #                              encdec
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
    remat: str = "full"          # full | dots | none: what the train-time
    #                              backward recomputes (memory, not numbers)
    moe_ep: bool = False         # expert-parallel MoE under a live mesh
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


PORTED_FAMILIES = ("dense", "moe", "mla_moe", "ssm", "hybrid", "encdec")


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


# the params' stacked subtrees (a leading layer dim): gathered layer by
# layer; every other leaf is a top-level one
_STACKED = ("layers", "groups", "tail")
# an expert-parallel MoE FFN's leaves that stay split (moe_ep_local)
EP_LOCAL = ("wi", "wo", "shared_wi", "shared_wo")


def _is_stacked(path: tuple) -> bool:
    return path[0] in _STACKED or path[:2] == ("encoder", "layers")


def gather_top(params):
    """Under a live sharded context (`sharding.sharded_ctx`): the
    top-level leaves gathered but for their tensor-parallel dims (the
    stacked subtrees left local), and the local specs of what stays split
    (`sharding.local_specs`); otherwise (params, None)."""
    from repro_torch.distributed.sharding import (gather_tree, local_specs,
                                                  sharded_ctx, tp_axes)
    ctx = sharded_ctx()
    if ctx is None:
        return params, None
    axes = tp_axes()

    def keep(path) -> tuple[str, ...]:
        return axes
    return (gather_tree(params, ctx.params, ctx.mesh, skip=_is_stacked,
                        keep=keep), local_specs(ctx.params, keep))


def gather_layer(p, cfg: ModelConfig, *keys: str):
    """Under a live sharded context: the slice `p` of the stacked subtree
    `keys` (one layer, or one zamba2 group) gathered but for its
    tensor-parallel dims and an expert-parallel MoE FFN's expert weights
    (which `moe_ep_local` takes as they are), with the local specs of
    what stays split; otherwise (p, None).  A MoE FFN's routed experts
    split over "model" by their experts dim, not a tensor-parallel one:
    without `moe_ep` they are gathered whole."""
    from repro_torch.distributed.sharding import (drop_dims, gather_tree,
                                                  local_specs, sharded_ctx,
                                                  tp_axes)
    ctx = sharded_ctx()
    if ctx is None:
        return p, None
    specs = ctx.params
    for k in keys:
        specs = specs[k]
    specs = drop_dims(specs, 1)
    moe = cfg.moe is not None
    ep = moe and cfg.moe_ep
    axes = tp_axes()

    def ffn(path, names) -> bool:
        return path[-2:-1] == ("ffn",) and path[-1] in names

    def keep(path) -> tuple[str, ...]:
        return () if moe and ffn(path, ("wi", "wo")) else axes
    return (gather_tree(p, specs, ctx.mesh,
                        skip=lambda path: ep and ffn(path, EP_LOCAL),
                        keep=keep), local_specs(specs, keep))


def _sub(tp, *keys):
    """The local specs of a subtree (None without a sharded context)."""
    for k in keys:
        tp = None if tp is None else tp[k]
    return tp


SERVED_FAMILIES = ("dense", "moe", "mla_moe", "ssm")


def check_served(cfg: ModelConfig, tp: Any = True) -> None:
    """Serving across ranks (a rank's local specs `tp`; None: one process,
    nothing to check) covers the families of `SERVED_FAMILIES`; the
    others raise rather than run whole."""
    if tp is not None and cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: serving across ranks covers the "
            f"{' and '.join(SERVED_FAMILIES)} families, not {cfg.family!r}")


def _vocab_axes(tp, cfg: ModelConfig) -> tuple[str, ...]:
    """The mesh axes a tensor-parallel rank's vocab splits over (the
    logits' table: the embedding when tied)."""
    from repro_torch.distributed.sharding import split_axes
    return split_axes(_sub(tp, "embed" if cfg.tie_embeddings
                           else "unembed"))


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


def cross_cfg(cfg: ModelConfig) -> L.AttnConfig:
    """The decoder's cross attention: K/V from the encoder memory."""
    return dataclasses.replace(cfg.attn, cross=True, causal=False)


def hybrid_depth(cfg: ModelConfig) -> tuple[int, int]:
    """zamba2's (groups of `shared_every` ssm layers, tail layers)."""
    return divmod(cfg.n_layers, cfg.shared_every)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _ffn_def(cfg: ModelConfig) -> dict:
    if cfg.moe is not None:
        return MOE.moe_def(cfg.moe)
    return L.mlp_def(cfg.d_model, cfg.d_ff)


def ep_choice(cfg: ModelConfig, ctx, x_shape: tuple[int, ...]
              ) -> tuple[tuple[str, ...], bool]:
    """The reference's (fsdp_axes, a2a) of the expert-parallel FFN under
    `ctx`: FSDP over the mesh axes of the "embed" rule, dropped where they
    do not divide d_model; all-to-all dispatch when the tokens' batch
    resolves over "model" (a ZeRO-3-style layout).  `x_shape` is the
    local activation's; its batch's global size comes from `ctx.sizes`."""
    import math
    from repro_torch.distributed.sharding import local_spec, mesh_axes
    sizes = mesh_axes(ctx.mesh)
    x_spec = local_spec(ctx, x_shape, ("batch", None, None))
    fsdp = tuple(a for a in (ctx.rules.get("embed") or ()) if a in sizes)
    if fsdp and cfg.moe.d_model % math.prod(sizes[a] for a in fsdp):
        fsdp = ()
    bp = x_spec[0] if len(x_spec) else None
    return fsdp, "model" in (bp if isinstance(bp, tuple) else (bp,))


def _ffn_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
               step: int = 0, tp: dict | None = None) -> torch.Tensor:
    if cfg.moe is not None:
        from repro_torch.distributed.sharding import current_ctx, live_mesh
        ctx = current_ctx()
        if cfg.moe_ep and live_mesh(ctx) is not None:
            # the rank's local shards, laid out by `ep_param_specs`
            fsdp, a2a = ep_choice(cfg, ctx, tuple(x.shape))
            return MOE.moe_ep_local(p, cfg.moe, x, model_axis="model",
                                    fsdp_axes=fsdp, a2a=a2a)
        return MOE.moe_ref(p, cfg.moe, x, tp)
    if cfg.rosa_mlp:
        # the installed engine (a compiled rosa.Program installs its own)
        # carries the serving plan, the pinned chip and the ledger
        engine = rosa.ambient_engine()
        if engine is None:
            engine = rosa.Engine.from_config()
        return L.mlp_apply(p, x, engine=engine, step=step, tp=tp)
    return L.mlp_apply(p, x, tp=tp)


def _block_def(cfg: ModelConfig, cross: bool = False) -> dict:
    d = cfg.d_model
    if cfg.family in ("ssm", "hybrid"):
        return {"ln1": L.rmsnorm_def(d), "ssm": SSM.ssm_def(cfg.ssm)}
    attn = (MLA.mla_def(cfg.mla) if cfg.family == "mla_moe"
            else L.attn_def(cfg.attn))
    p = {"ln1": L.rmsnorm_def(d), "ln2": L.rmsnorm_def(d),
         "attn": attn, "ffn": _ffn_def(cfg)}
    if cross:
        p["ln_cross"] = L.rmsnorm_def(d)
        p["cross"] = L.attn_def(cross_cfg(cfg))
    return p


def _block_prefill(p: dict, cfg: ModelConfig, x, positions, meta, step,
                   tp=None):
    """A whole-prompt block and its cache; `tp`, the local specs of `p`
    on a tensor-parallel rank (its cache that of its KV or SSM heads)."""
    if "ssm" in p:
        return _ssm_layer_prefill(p, cfg, x, tp)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.family == "mla_moe":
        a, cache = MLA.mla_prefill(p["attn"], cfg.mla, h, positions,
                                   _sub(tp, "attn"))
    else:
        a, cache = L.attn_prefill(p["attn"], cfg.attn, h, positions,
                                  window=meta["window"], theta=meta["theta"],
                                  tp=_sub(tp, "attn"))
        cache = tuple(c.to(cfg.cache_dtype) for c in cache)
    x = x + a
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + _ffn_apply(p["ffn"], cfg, h, step, _sub(tp, "ffn")), cache


def _block_decode(p: dict, cfg: ModelConfig, x, pos, meta, cache, step,
                  memory_pos=None, tp=None) -> torch.Tensor:
    """One attention block on a chunk of C >= 1 tokens; its cache (with
    a cross attention {"self": (k, v), "cross": (k, v)}) is written in
    place.  `tp`, the local specs of `p` on a tensor-parallel rank."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.family == "mla_moe":
        a, _ = MLA.mla_decode(p["attn"], cfg.mla, h, cache, pos,
                              _sub(tp, "attn"))
    else:
        a, _ = L.attn_decode(p["attn"], cfg.attn, h,
                             cache["self"] if "cross" in p else cache, pos,
                             window=meta["window"], theta=meta["theta"],
                             tp=_sub(tp, "attn"))
    x = x + a
    if "cross" in p:
        h = L.rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        a, _ = L.attn_decode(p["cross"], cross_cfg(cfg), h, cache["cross"],
                             pos, memory_pos=memory_pos)
        x = x + a
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + _ffn_apply(p["ffn"], cfg, h, step, _sub(tp, "ffn"))


def _ssm_step(p: dict, cfg: ModelConfig, x, cache: dict,
              tp=None) -> torch.Tensor:
    """One ssm block's decode token; `cache` (views into the stacked
    cache, a tensor-parallel rank's heads) is advanced in place."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, new = SSM.ssm_decode(p["ssm"], cfg.ssm, h, cache, _sub(tp, "ssm"))
    for k, t in new.items():
        cache[k].copy_(t)
    return x + y


def _ssm_layer_prefill(p: dict, cfg: ModelConfig, x, tp=None):
    """A whole-sequence ssm block: full-sequence scan plus the final state
    for the decode cache (of a tensor-parallel rank's heads)."""
    y, cache = _ssm_prefill(p["ssm"], cfg.ssm,
                            L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                            _sub(tp, "ssm"))
    return x + y, cache


def _ssm_prefill(p: dict, scfg: SSM.SSMConfig, u: torch.Tensor, tp=None):
    """Like ssm_apply, but also returns the decode cache: the last d_conv-1
    pre-conv inputs and the final scan state.

    A prompt shorter than d_conv-1 tokens leaves fewer rows; they are
    left-padded with zeros, the history `_causal_conv`'s own zero padding
    assumes, so the cache always has the shape of `ssm_cache_def`.  (The
    reference keeps the short rows, which no slot cache can take.)"""
    out, state, pre = SSM.ssm_forward(p, scfg, u, tp)
    k = scfg.d_conv - 1
    conv = [torch.nn.functional.pad(
        t[:, -k:], (0, 0) * (t.ndim - 2) + (max(k - t.shape[1], 0), 0))
        for t in pre]
    cache = {"conv_x": conv[0], "conv_b": conv[1], "conv_c": conv[2],
             "state": state}
    return out, cache


def _block_fwd(p: dict, cfg: ModelConfig, x, positions, meta, step,
               memory=None, memory_pos=None, tp=None) -> torch.Tensor:
    """Full-sequence block forward (the train path: no cache); `tp`, the
    local specs of `p` on a tensor-parallel rank."""
    if "ssm" in p:
        return x + SSM.ssm_apply(p["ssm"], cfg.ssm,
                                 L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                                 _sub(tp, "ssm"))
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.family == "mla_moe":
        a = MLA.mla_apply(p["attn"], cfg.mla, h, positions, _sub(tp, "attn"))
    else:
        a = L.attn_apply(p["attn"], cfg.attn, h, positions,
                         window=meta["window"], theta=meta["theta"],
                         tp=_sub(tp, "attn"))
    x = x + a
    if "cross" in p:
        h = L.rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        x = x + L.attn_apply(p["cross"], cross_cfg(cfg), h, positions,
                             memory=memory, memory_pos=memory_pos,
                             tp=_sub(tp, "cross"))
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + _ffn_apply(p["ffn"], cfg, h, step, _sub(tp, "ffn"))


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective recomputation that keeps only the outputs of plain 2-D
    products (`dots_with_no_batch_dims_saveable`)."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """`fn` under the config's recomputation policy.  A policy changes
    what the backward keeps, never a number: the optical engine folds a
    fresh generator per (layer name, step), so a recomputed block draws
    its noise again bit for bit without the global RNG state stashed.
    The recomputation runs where autograd runs the backward (for CUDA
    tensors a device thread of its own, which does not see the caller's
    context), so it re-installs the engine the forward saw."""
    if cfg.remat == "none":
        return fn
    from torch.utils import checkpoint as ckpt
    kw: dict = {}
    if cfg.remat == "dots":
        kw["context_fn"] = lambda: ckpt.create_selective_checkpoint_contexts(
            _dots_policy)
    elif cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r}: full | dots | none")

    def run(*args):
        engine = rosa.ambient_engine()

        def body(*a):
            with rosa.engine_context(engine):
                return fn(*a)
        return ckpt.checkpoint(body, *args, use_reentrant=False,
                               preserve_rng_state=False, **kw)
    return run


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------
def model_def(cfg: ModelConfig) -> dict:
    check_family(cfg)
    d = cfg.d_model
    skel: dict = {"embed": L.embed_def(cfg.vocab, d),
                  "final_norm": L.rmsnorm_def(d)}
    if not cfg.tie_embeddings:
        skel["unembed"] = L.unembed_def(d, cfg.vocab)
    if cfg.family == "hybrid":
        n_groups, rem = hybrid_depth(cfg)
        skel["groups"] = stack_defs(stack_defs(_block_def(cfg),
                                               cfg.shared_every), n_groups)
        if rem:
            skel["tail"] = stack_defs(_block_def(cfg), rem)
        skel["shared_attn"] = {"ln": L.rmsnorm_def(d),
                               "attn": L.attn_def(cfg.attn),
                               "ln2": L.rmsnorm_def(d),
                               "ffn": L.mlp_def(d, cfg.d_ff)}
    elif cfg.family == "encdec":
        enc_block = {"ln1": L.rmsnorm_def(d), "ln2": L.rmsnorm_def(d),
                     "attn": L.attn_def(dataclasses.replace(cfg.attn,
                                                            causal=False)),
                     "ffn": L.mlp_def(d, cfg.d_ff)}
        skel["encoder"] = {"layers": stack_defs(enc_block, cfg.n_enc_layers),
                           "norm": L.rmsnorm_def(d)}
        skel["layers"] = stack_defs(
            _block_def(dataclasses.replace(cfg, family="dense"), cross=True),
            cfg.n_layers)
    else:
        skel["layers"] = stack_defs(_block_def(cfg), n_stacked(cfg))
        if cfg.first_dense_ff:
            skel["layer0"] = _block_def(dense0(cfg))
    return skel


def logits_of(params, cfg: ModelConfig, x: torch.Tensor,
              vocab_axes: tuple[str, ...] = ()) -> torch.Tensor:
    """The logits of the table (the embedding when tied).  On a
    tensor-parallel rank the table is its block of the vocab, and so are
    the logits; with `vocab_axes`, the mesh axes those blocks split over,
    they are gathered whole (the reference lays them out split over
    "vocab": the same numbers)."""
    if cfg.tie_embeddings:
        out = torch.einsum("bsd,vd->bsv", x, params["embed"])
    else:
        out = L.unembed_apply(params["unembed"], x)
    if not vocab_axes:
        return out
    from repro_torch.distributed import runtime as rt
    return rt.all_gather(out, vocab_axes, axis=-1, tiled=True)


def forward(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Full-sequence forward to the final hidden states (B, S, D): each
    block of the stack (zamba2: each group with its shared block; the
    encoder's layers) under `_remat`.  The layer index is the optical
    noise `step`, as the reference's scanned `meta["idx"]`: 0 for
    deepseek-v2's `layer0`, 1..n-1 for the layers after it, 0 for every
    encdec layer (its stack passes no index).  Under a recomputing remat
    policy an ssm layer's scan runs twice a train step (the forward and
    the recomputation; zamba2's `tail` layers, outside the recomputed
    groups, once) and its backward once."""
    check_family(cfg)
    return _forward(*gather_top(params), cfg, batch)


def _forward(params, tp, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """`forward` on params whose top-level leaves are gathered (`tp`:
    their local specs on a tensor-parallel rank, else None)."""
    x, positions = _embed_in(params, cfg, batch, tp)
    if cfg.family == "hybrid":
        x = _hybrid_fwd(params, tp, cfg, x, positions)
    elif cfg.family == "encdec":
        mem = _encode(params, cfg, batch)
        mem_pos = _positions(*mem.shape[:2], mem.device)
        meta = {"window": 0, "theta": cfg.rope_theta}
        body = _remat(cfg, _stacked_fwd(cfg, positions, mem, mem_pos))
        for i in range(cfg.n_layers):
            x = body(layer_at(params["layers"], i), x, meta, 0)
    else:
        off = 0
        if cfg.first_dense_ff:
            x = _block_fwd(params["layer0"], dense0(cfg), x, positions,
                           {"window": 0, "theta": cfg.rope_theta}, 0,
                           tp=_sub(tp, "layer0"))
            off = 1
        body = _remat(cfg, _stacked_fwd(cfg, positions))
        for i in range(n_stacked(cfg)):
            x = body(layer_at(params["layers"], i), x,
                     layer_meta(cfg, i + off), i + off)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def _stacked_fwd(cfg: ModelConfig, positions, memory=None,
                 memory_pos=None):
    """The body of a stacked layer: its slice gathered (`gather_layer`),
    then the block; run under `_remat`, so the recompute gathers again."""
    def run(p, x, meta, step):
        p, tp = gather_layer(p, cfg, "layers")
        return _block_fwd(p, cfg, x, positions, meta, step, memory,
                          memory_pos, tp)
    return run


def _hybrid_fwd(params, tp, cfg: ModelConfig, x, positions) -> torch.Tensor:
    """zamba2: each group of `shared_every` ssm layers and the shared
    attention + MLP block after it as one recomputed unit, then the
    `tail` layers as they are."""
    from repro_torch.distributed.sharding import drop_dims
    shared, tp_s = params["shared_attn"], _sub(tp, "shared_attn")

    def group(p_g, x):
        p_g, tp_g = gather_layer(p_g, cfg, "groups")
        tp_l = None if tp_g is None else drop_dims(tp_g, 1)
        for i in range(cfg.shared_every):
            x = _block_fwd(layer_at(p_g, i), cfg, x, positions, None, 0,
                           tp=tp_l)
        h = L.rmsnorm(shared["ln"], x, cfg.norm_eps)
        x = x + L.attn_apply(shared["attn"], cfg.attn, h, positions,
                             tp=_sub(tp_s, "attn"))
        h = L.rmsnorm(shared["ln2"], x, cfg.norm_eps)
        return x + L.mlp_apply(shared["ffn"], h, tp=_sub(tp_s, "ffn"))

    body = _remat(cfg, group)
    for g in range(hybrid_depth(cfg)[0]):
        x = body(layer_at(params["groups"], g), x)
    if "tail" in params:
        for i in range(params["tail"]["ln1"].shape[0]):
            p, tp_t = gather_layer(layer_at(params["tail"], i), cfg, "tail")
            x = _block_fwd(p, cfg, x, positions, None, 0, tp=tp_t)
    return x


def train_loss(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Mean next-token cross entropy of `forward` against
    batch["labels"] (masked by batch["mask"] if given); a vision model's
    loss skips the patch positions.  Under a live train context it is the
    mean over this rank's rows (the step weighs it into the global
    loss)."""
    check_family(cfg)
    params, tp = gather_top(params)
    x = _forward(params, tp, cfg, batch)
    if cfg.frontend == "vision":
        x = x[:, batch["patch_embeds"].shape[1]:]
    # on a tensor-parallel rank the logits are its block of the vocab
    return L.softmax_xent(logits_of(params, cfg, x), batch["labels"],
                          batch.get("mask"), _vocab_axes(tp, cfg))


def _stack(caches: list[dict]) -> dict:
    """Leaf-wise `torch.stack` of per-layer dict caches."""
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def _stack_pairs(pairs: list[tuple]) -> tuple:
    """Element-wise `torch.stack` of per-layer (k, v)-style pairs."""
    return tuple(torch.stack(t) for t in zip(*pairs))


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def _embed_in(params, cfg: ModelConfig, batch: dict, tp=None):
    """Token embedding (with the vision frontend, the patch embeddings in
    the embedding dtype ahead of it) and positions (B, S) over the whole
    sequence; `tp`, the top-level local specs on a tensor-parallel rank
    (its vocab rows)."""
    x = _embed_tokens(params, tp, batch["tokens"])
    if cfg.frontend == "vision":
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x, _positions(*x.shape[:2], x.device)


def _embed_tokens(params, tp, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' embeddings; `tp`, the top-level local specs on a
    tensor-parallel rank (its vocab rows of the table)."""
    from repro_torch.distributed.sharding import split_axes
    return L.embed_apply(params["embed"], tokens,
                         split_axes(_sub(tp, "embed")))


def prefill(params, cfg: ModelConfig, batch: dict):
    """Run the prompt, return (last-token logits (B, V), cache).  encdec
    takes the encoder's input as `batch["src_embeds"]` (B, Sm, D).  Under
    a live serve context: this rank's rows, its cache of its KV (or SSM)
    heads, the logits whole over the vocab."""
    check_family(cfg)
    params, tp = gather_top(params)
    check_served(cfg, tp)
    x, positions = _embed_in(params, cfg, batch, tp)
    if cfg.family == "hybrid":
        x, cache = _hybrid_prefill(params, cfg, x, positions)
    elif cfg.family == "encdec":
        x, cache = _encdec_prefill(params, cfg, batch, x, positions)
    else:
        x, cache = _stack_prefill(params, tp, cfg, x, positions)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_of(params, cfg, x[:, -1:], _vocab_axes(tp, cfg))[:, 0]
    b, s = x.shape[:2]
    cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return logits, cache


def _stack_prefill(params, tp, cfg: ModelConfig, x, positions):
    """The layers' prefill (`tp`, the top-level local specs on a
    tensor-parallel rank: `layer0`'s)."""
    cache: dict = {}
    off = 0
    if cfg.first_dense_ff:
        x, cache["layer0"] = _block_prefill(params["layer0"], dense0(cfg), x,
                                            positions, layer_meta(cfg, 0), 0,
                                            _sub(tp, "layer0"))
        off = 1
    caches = []
    for i in range(n_stacked(cfg)):
        p, tp = gather_layer(layer_at(params["layers"], i), cfg, "layers")
        x, c = _block_prefill(p, cfg, x, positions, layer_meta(cfg, i + off),
                              i + off, tp)
        caches.append(c)
    cache["layers"] = (_stack(caches) if cfg.family == "ssm"
                       else _stack_pairs(caches))
    return x, cache


def _shared_prefill(shared: dict, cfg: ModelConfig, x, positions):
    """zamba2's shared attention + MLP block (plain MLP, no engine)."""
    h = L.rmsnorm(shared["ln"], x, cfg.norm_eps)
    a, kv = L.attn_prefill(shared["attn"], cfg.attn, h, positions)
    x = x + a
    h = L.rmsnorm(shared["ln2"], x, cfg.norm_eps)
    return (x + L.mlp_apply(shared["ffn"], h),
            tuple(c.to(cfg.cache_dtype) for c in kv))


def _hybrid_prefill(params, cfg: ModelConfig, x, positions):
    n_groups, _ = hybrid_depth(cfg)
    ssm, shared = [], []
    for g in range(n_groups):
        p_g = layer_at(params["groups"], g)
        caches = []
        for i in range(cfg.shared_every):
            x, c = _ssm_layer_prefill(layer_at(p_g, i), cfg, x)
            caches.append(c)
        x, kv = _shared_prefill(params["shared_attn"], cfg, x, positions)
        ssm.append(_stack(caches))
        shared.append(kv)
    cache = {"groups": {"ssm": _stack(ssm), "shared": _stack_pairs(shared)}}
    if "tail" in params:
        tails = []
        for i in range(params["tail"]["ln1"].shape[0]):
            x, c = _ssm_layer_prefill(layer_at(params["tail"], i), cfg, x)
            tails.append(c)
        cache["tail"] = _stack(tails)
    return x, cache


def _encode(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """The bidirectional encoder over `batch["src_embeds"]` (B, Sm, D),
    run in the parameter dtype whatever the input's."""
    enc = params["encoder"]
    mem = batch["src_embeds"].to(enc["norm"].dtype)
    pos = _positions(*mem.shape[:2], mem.device)
    acfg = dataclasses.replace(cfg.attn, causal=False)

    def layer(p, mem):
        p, tp = gather_layer(p, cfg, "encoder", "layers")
        h = L.rmsnorm(p["ln1"], mem, cfg.norm_eps)
        mem = mem + L.attn_apply(p["attn"], acfg, h, pos,
                                 tp=_sub(tp, "attn"))
        h = L.rmsnorm(p["ln2"], mem, cfg.norm_eps)
        return mem + L.mlp_apply(p["ffn"], h, tp=_sub(tp, "ffn"))

    body = _remat(cfg, layer) if torch.is_grad_enabled() else layer
    for i in range(cfg.n_enc_layers):
        mem = body(layer_at(enc["layers"], i), mem)
    return L.rmsnorm(enc["norm"], mem, cfg.norm_eps)


def _encdec_prefill(params, cfg: ModelConfig, batch: dict, x, positions):
    """Decoder prefill against the encoded memory; the cross K/V are
    computed once here and cached in `cache_dtype`.  The MLPs are plain,
    as in the reference's prefill."""
    mem = _encode(params, cfg, batch)
    mem_pos = _positions(*mem.shape[:2], mem.device).to(torch.int32)
    ccfg, dt = cross_cfg(cfg), cfg.cache_dtype
    selfs, crosses = [], []
    for i in range(cfg.n_layers):
        p = layer_at(params["layers"], i)
        h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
        a, kv = L.attn_prefill(p["attn"], cfg.attn, h, positions)
        x = x + a
        h = L.rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        ck = torch.einsum("bsd,dhk->bshk", mem, p["cross"]["wk"])
        cv = torch.einsum("bsd,dhk->bshk", mem, p["cross"]["wv"])
        x = x + L.attn_apply(p["cross"], ccfg, h, positions, memory=mem,
                             memory_pos=mem_pos)
        h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + L.mlp_apply(p["ffn"], h)
        selfs.append(tuple(c.to(dt) for c in kv))
        crosses.append((ck.to(dt), cv.to(dt)))
    return x, {"layers": {"self": _stack_pairs(selfs),
                          "cross": _stack_pairs(crosses)},
               "memory_pos": mem_pos.contiguous()}


def _decode_layers(params, cfg: ModelConfig, x, pos, cache,
                   tp=None) -> torch.Tensor:
    """Every layer on a chunk x (B, C, D) at positions pos..pos+C-1 (C is
    1 but for the attention families' prefill chunks), caches in place;
    `tp`, the top-level local specs on a tensor-parallel rank
    (`layer0`'s)."""
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            p, tp = gather_layer(layer_at(params["layers"], i), cfg,
                                 "layers")
            x = _ssm_step(p, cfg, x, layer_at(cache["layers"], i), tp)
        return x
    if cfg.family == "hybrid":
        return _hybrid_decode(params, cfg, x, pos, cache)
    if cfg.family == "encdec":
        (sk, sv), (ck, cv) = (cache["layers"]["self"],
                              cache["layers"]["cross"])
        for i in range(cfg.n_layers):
            # noise step 0: the reference's encdec stack passes no layer
            # index to its FFN
            x = _block_decode(layer_at(params["layers"], i), cfg, x, pos,
                              layer_meta(cfg, i),
                              {"self": (sk[i], sv[i]),
                               "cross": (ck[i], cv[i])}, 0,
                              memory_pos=cache["memory_pos"])
        return x
    off = 0
    if cfg.first_dense_ff:
        x = _block_decode(params["layer0"], dense0(cfg), x, pos,
                          layer_meta(cfg, 0), cache["layer0"], 0,
                          tp=_sub(tp, "layer0"))
        off = 1
    kc, vc = cache["layers"]          # (k, v), or MLA's (c_kv, k_rope)
    for i in range(n_stacked(cfg)):
        p, tp = gather_layer(layer_at(params["layers"], i), cfg, "layers")
        x = _block_decode(p, cfg, x, pos, layer_meta(cfg, i + off),
                          (kc[i], vc[i]), i + off, tp=tp)
    return x


def _hybrid_decode(params, cfg: ModelConfig, x, pos, cache) -> torch.Tensor:
    shared = params["shared_attn"]
    ssm, (sk, sv) = cache["groups"]["ssm"], cache["groups"]["shared"]
    n_groups, _ = hybrid_depth(cfg)
    for g in range(n_groups):
        p_g = layer_at(params["groups"], g)
        for i in range(cfg.shared_every):
            x = _ssm_step(layer_at(p_g, i), cfg, x,
                          {k: t[g, i] for k, t in ssm.items()})
        h = L.rmsnorm(shared["ln"], x, cfg.norm_eps)
        a, _ = L.attn_decode(shared["attn"], cfg.attn, h, (sk[g], sv[g]), pos)
        x = x + a
        h = L.rmsnorm(shared["ln2"], x, cfg.norm_eps)
        x = x + L.mlp_apply(shared["ffn"], h)
    if "tail" in params:
        for i in range(params["tail"]["ln1"].shape[0]):
            x = _ssm_step(layer_at(params["tail"], i), cfg, x,
                          layer_at(cache["tail"], i))
    return x


def decode_step(params, cfg: ModelConfig, batch: dict):
    """One token per row: batch = {token (B,), pos (B,), cache}.
    Returns (logits (B, V), cache) with the cache advanced in place.
    Under a live serve context: this rank's rows and part of the cache,
    the logits whole over the vocab."""
    check_family(cfg)
    params, tp = gather_top(params)
    check_served(cfg, tp)
    token, pos, cache = batch["token"], batch["pos"], batch["cache"]
    x = _embed_tokens(params, tp, token[:, None])
    x = _decode_layers(params, cfg, x, pos, cache, tp)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_of(params, cfg, x, _vocab_axes(tp, cfg))[:, 0]
    return logits, dict(cache, pos=pos + 1)


def chunk_step(params, cfg: ModelConfig, batch: dict):
    """Prefill one chunk of C tokens against a running per-sequence cache.

    batch = {tokens (B, C), n_valid (B,), cache[, pos]}: positions
    pos..pos+C-1 are written, `pos` advances by `n_valid` (the chunk tail
    may be padding), and the logits (B, V) are read at the last real token.
    """
    check_family(cfg)
    if cfg.family in ("ssm", "hybrid"):
        raise ValueError(f"chunked prefill unsupported for {cfg.family}: "
                         "state-space caches admit no positional chunking")
    params, tp = gather_top(params)
    check_served(cfg, tp)
    tokens, n_valid = batch["tokens"], batch["n_valid"]
    cache = batch["cache"]
    pos = batch.get("pos", cache["pos"])
    x = _embed_tokens(params, tp, tokens)
    x = _decode_layers(params, cfg, x, pos, cache, tp)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    idx = torch.clamp(n_valid - 1, min=0).long()
    x_last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    logits = logits_of(params, cfg, x_last, _vocab_axes(tp, cfg))[:, 0]
    return logits, dict(cache, pos=pos + n_valid)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None, src_len: int = 0) -> dict:
    """Zero decode cache; `models.model.cache_axes` names every axis.

    * dense and moe: {"layers": (k, v) each (L, B, S, KV, D)};
    * mla_moe: {"layers": (c_kv (L, B, S, kv_lora), k_rope (L, B, S,
      qk_rope))} over the stacked layers, and with `first_dense_ff` also
      "layer0": the same pair without the layer axis;
    * ssm: {"layers": {conv_x, conv_b, conv_c, state}}, each leaf
      `ssm_cache_def`'s float32 one with a leading layer axis (no sequence
      axis: max_len does not enter);
    * hybrid: {"groups": {"ssm": those leaves with axes (n_groups,
      shared_every) in front, "shared": (k, v) each (n_groups, B, S, KV,
      D)}}, and "tail" with the remainder's ssm leaves when
      shared_every does not divide the depth;
    * encdec: {"layers": {"self": (k, v), "cross": (k, v) of length
      `src_len` (else max_len)}, "memory_pos": (B, src_len) int32};

    attention caches in cfg.cache_dtype, all with "pos": (B,) int32."""
    check_family(cfg)
    dt = cfg.cache_dtype

    def kv(n: int, s: int) -> tuple:
        return tuple(torch.zeros((n, batch, s, cfg.n_kv_heads, cfg.head_dim),
                                 dtype=dt, device=device) for _ in "kv")

    def ssm_stack(lead: tuple) -> dict:
        one = SSM.ssm_cache_def(cfg.ssm, batch, device="meta")
        return {k: torch.zeros(lead + t.shape, dtype=t.dtype, device=device)
                for k, t in one.items()}

    if cfg.family == "ssm":
        cache = {"layers": ssm_stack((cfg.n_layers,))}
    elif cfg.family == "hybrid":
        n_groups, rem = hybrid_depth(cfg)
        cache = {"groups": {"ssm": ssm_stack((n_groups, cfg.shared_every)),
                            "shared": kv(n_groups, max_len)}}
        if rem:
            cache["tail"] = ssm_stack((rem,))
    elif cfg.family == "encdec":
        m = src_len or max_len
        cache = {"layers": {"self": kv(cfg.n_layers, max_len),
                            "cross": kv(cfg.n_layers, m)},
                 "memory_pos": _positions(batch, m, device)
                 .to(torch.int32).contiguous()}
    elif cfg.family == "mla_moe":
        def mk(lead):
            return tuple(torch.zeros(lead + (batch, max_len, w), dtype=dt,
                                     device=device)
                         for w in (cfg.mla.kv_lora, cfg.mla.qk_rope))
        cache = {"layers": mk((n_stacked(cfg),))}
        if cfg.first_dense_ff:
            cache["layer0"] = mk(())
    else:
        cache = {"layers": kv(cfg.n_layers, max_len)}
    cache["pos"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache
