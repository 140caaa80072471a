"""build_model(cfg) — the model API of the port (PyTorch port of
`repro.models.model` without logical-axis sharding: the dense, moe,
mla_moe, ssm, hybrid and encdec families).

A `ModelBundle` exposes functions over plain dicts of tensors:

    bundle.init(generator, dtype, device)   real params
    bundle.abstract(dtype)                  `meta` params (tracing)
    bundle.train_loss / forward / prefill / decode_step / chunk_step
    bundle.input_specs(shape) / step_fn(shape)

plus `cache_axes` and the slot API of continuous-batching serving
(`write_slot`, `evict_slot`, `read_slot`, `pad_cache`, each driven by the
cache's logical axes), `input_shardings`, the specs that lay a concrete
batch and cache out on a rank under the rules (cut by
`distributed.sharding.shard_tree`, as the weights are), and
`params_from_reference` /
`opt_state_from_reference`, which carry the reference's numbers across
(with `robust.variation.from_reference` for a chip), so the two packages
can compute on identical weights, optimizer state and chip.

`make_inputs` builds the inputs of the assignment's shape grid
(`ASSIGNED_SHAPES`, reduced in `SMOKE_SHAPES`): ``train_*`` shapes give
tokens and labels, ``prefill_*`` a prompt, ``decode_*`` / ``long_*`` one
token against a zero cache of the shape's length.  The modality
frontends are stubs, as in the reference: vision cells get precomputed
patch embeddings, audio cells source embeddings.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.module import (abstract_params, init_params,
                                       map_tree, param_count)
from repro_torch.models.transformer import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int


ASSIGNED_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# reduced shapes for CPU smoke tests
SMOKE_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 32, 2),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32, 2),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32, 2),
    "long_500k": ShapeSpec("long_500k", "decode", 64, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """The assignment's skip rule: 500k-token decode needs a sub-quadratic
    path (a state-space layer or a sliding window)."""
    if shape.name == "long_500k":
        sub_quadratic = (cfg.family in ("ssm", "hybrid")
                         or cfg.window_pattern > 0)
        if not sub_quadratic:
            return False, ("pure full-attention arch: no sub-quadratic path "
                           "for 500k decode (skip per assignment)")
    return True, ""


def _split_vlm(seq: int) -> tuple[int, int]:
    """(image positions, text positions) of a vision cell's sequence."""
    img = min(1024, max(seq // 4, 1))
    return img, seq - img


def make_inputs(cfg: ModelConfig, shape: ShapeSpec, concrete: bool = False,
                generator: torch.Generator | None = None):
    """(batch, logical-axes tree) of one cell of the shape grid.

    concrete=False gives `meta` tensors; True real ones on the generator's
    device, each field one draw from `generator` (default: the CPU's,
    seed 0) in the reference's order: token ids uniform over the
    vocabulary, embeddings N(0, 1) rounded to bfloat16 and scaled by
    0.02.  Decode cells carry a zero cache from `init_cache`, its cursor
    at the last position."""
    b, s = shape.global_batch, shape.seq_len
    tok_dt, emb_dt = torch.int32, torch.bfloat16
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    device = gen.device

    def arr(shp, dt):
        if not concrete:
            return torch.empty(shp, dtype=dt, device="meta")
        if dt == tok_dt:
            return torch.randint(0, cfg.vocab, shp, generator=gen,
                                 dtype=dt, device=device)
        return torch.randn(shp, generator=gen, device=device).to(dt) * 0.02

    if shape.kind == "train":
        s_tok = s
        batch, axes = {}, {}
        if cfg.frontend == "vision":
            s_img, s_tok = _split_vlm(s)
            batch["patch_embeds"] = arr((b, s_img, cfg.d_model), emb_dt)
            axes["patch_embeds"] = ("batch", None, None)
        if cfg.frontend == "audio":
            batch["src_embeds"] = arr((b, s, cfg.d_model), emb_dt)
            axes["src_embeds"] = ("batch", "act_seq", None)
        batch["tokens"] = arr((b, s_tok), tok_dt)
        batch["labels"] = arr((b, s_tok), tok_dt)   # loss on text positions
        axes["tokens"] = ("batch", "act_seq")
        axes["labels"] = ("batch", "act_seq")
        return batch, axes

    if shape.kind == "prefill":
        # the reference draws the full-length prompt first and, for a
        # vision cell, draws it again at the text length: so does this
        batch = {"tokens": arr((b, s), tok_dt)}
        axes = {"tokens": ("batch", "act_seq")}
        if cfg.frontend == "vision":
            s_img, s_tok = _split_vlm(s)
            batch = {"tokens": arr((b, s_tok), tok_dt),
                     "patch_embeds": arr((b, s_img, cfg.d_model), emb_dt)}
            axes = {"tokens": ("batch", "act_seq"),
                    "patch_embeds": ("batch", "act_seq", None)}
        if cfg.frontend == "audio":
            batch["src_embeds"] = arr((b, s, cfg.d_model), emb_dt)
            axes["src_embeds"] = ("batch", "act_seq", None)
        return batch, axes

    # decode: one token against a full cache of length s
    cache = T.init_cache(cfg, b, s, device=device if concrete else "meta",
                         src_len=s if cfg.is_encdec else 0)
    pos = (torch.full((b,), max(s - 1, 0), dtype=torch.int32, device=device)
           if concrete else torch.empty((b,), dtype=torch.int32,
                                        device="meta"))
    batch = {"token": arr((b,), tok_dt), "pos": pos, "cache": cache}
    axes = {"token": ("cache_batch",), "pos": ("cache_batch",),
            "cache": cache_axes(cfg)}
    return batch, axes


def input_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh, rules: dict):
    """The spec tree of `make_inputs(cfg, shape)` (the batch and, for a
    decode cell, its cache) under `rules` on `mesh` (a `MeshShape` or a
    `DeviceMesh`), in the batch's structure: each leaf's logical axes
    resolved on its global shape, as the reference's `tree_shardings`."""
    from repro_torch.distributed.sharding import resolve_spec, zip_tree
    batch, axes = make_inputs(cfg, shape)
    return zip_tree(batch, axes, lambda t, a: resolve_spec(
        tuple(t.shape), a, rules, mesh))


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    skeleton: dict

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> dict:
        return init_params(self.skeleton, generator, dtype, device)

    def abstract(self, dtype=torch.bfloat16) -> dict:
        return abstract_params(self.skeleton, dtype)

    @property
    def n_params(self) -> int:
        return param_count(self.skeleton)

    def train_loss(self, params, batch):
        return T.train_loss(params, self.cfg, batch)

    def forward(self, params, batch):
        return T.forward(params, self.cfg, batch)

    def prefill(self, params, batch):
        return T.prefill(params, self.cfg, batch)

    def decode_step(self, params, batch):
        return T.decode_step(params, self.cfg, batch)

    def chunk_step(self, params, batch):
        """Serving prefill chunk: batch = {tokens (B, C), n_valid, cache}."""
        return T.chunk_step(params, self.cfg, batch)

    def input_specs(self, shape: ShapeSpec, concrete: bool = False,
                    generator: torch.Generator | None = None):
        return make_inputs(self.cfg, shape, concrete, generator)

    def step_fn(self, shape: ShapeSpec):
        if shape.kind == "train":
            return self.train_loss
        if shape.kind == "prefill":
            return self.prefill
        return self.decode_step


def build_model(cfg: ModelConfig) -> ModelBundle:
    return ModelBundle(cfg=cfg, skeleton=T.model_def(cfg))


# ---------------------------------------------------------------------------
# Cache logical axes (mirror transformer.init_cache's structure)
# ---------------------------------------------------------------------------
_KV_AX = ("layers", "cache_batch", "cache_seq", "kv_heads", "head_dim")
_SSM_AX = {
    "conv_x": ("layers", "cache_batch", None, "heads", "head_dim"),
    "conv_b": ("layers", "cache_batch", None, None, "state"),
    "conv_c": ("layers", "cache_batch", None, None, "state"),
    "state": ("layers", "cache_batch", "heads", "state", "head_dim"),
}


def cache_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of `init_cache(cfg, ...)` for the
    families the port serves, in the cache's structure: "cache_batch" is
    the slot axis, "cache_seq" the sequence axis a decode grows
    ("memory_seq", the encoder memory's, does not grow)."""
    if cfg.family == "hybrid":
        ax = {"groups": {
            "ssm": {k: (None,) + v for k, v in _SSM_AX.items()},
            "shared": (_KV_AX, _KV_AX)}}
        if cfg.n_layers % cfg.shared_every:
            ax["tail"] = dict(_SSM_AX)
    elif cfg.family == "encdec":
        mem_ax = ("layers", "cache_batch", "memory_seq", "kv_heads",
                  "head_dim")
        ax = {"layers": {"self": (_KV_AX, _KV_AX),
                         "cross": (mem_ax, mem_ax)},
              "memory_pos": ("cache_batch", None)}
    elif cfg.family == "ssm":
        ax = {"layers": dict(_SSM_AX)}
    elif cfg.family == "mla_moe":
        mla_ax = ("layers", "cache_batch", "cache_seq", None)
        ax = {"layers": (mla_ax, mla_ax)}
        if cfg.first_dense_ff:
            ax["layer0"] = (mla_ax[1:], mla_ax[1:])
    else:
        ax = {"layers": (_KV_AX, _KV_AX)}
    ax["pos"] = ("cache_batch",)
    return ax


def _flatten(cache, axes) -> list[tuple[torch.Tensor, tuple]]:
    """(leaf, logical axes) pairs of a cache, dict keys sorted."""
    if isinstance(cache, dict):
        return [pair for k in sorted(cache)
                for pair in _flatten(cache[k], axes[k])]
    if isinstance(cache, tuple):
        return [pair for c, a in zip(cache, axes, strict=True)
                for pair in _flatten(c, a)]
    return [(cache, axes)]


def _unflatten(cache, leaves):
    """A cache of `cache`'s structure holding the iterator `leaves` (in
    `_flatten` order)."""
    if isinstance(cache, dict):
        return {k: _unflatten(cache[k], leaves) for k in sorted(cache)}
    if isinstance(cache, tuple):
        return tuple(_unflatten(c, leaves) for c in cache)
    return next(leaves)


def _leaves(cfg: ModelConfig, cache) -> list[tuple[torch.Tensor, tuple]]:
    return _flatten(cache, cache_axes(cfg))


# ---------------------------------------------------------------------------
# Slot API: a slot cache is a decode cache with batch = n_slots.  Requests
# come and go by writing or zeroing ONE row (along "cache_batch") of every
# leaf, in place.
# ---------------------------------------------------------------------------
def write_slot(cfg: ModelConfig, cache, req_cache, slot: int,
               valid: bool = True):
    """Admit one request: copy `req_cache` (batch 1, same seq length) into
    slot `slot` of `cache`, in place; a no-op when `valid` is False."""
    T.check_family(cfg)
    if valid:
        for (c, a), (r, _) in zip(_leaves(cfg, cache),
                                  _leaves(cfg, req_cache), strict=True):
            ax = a.index("cache_batch")
            c.select(ax, slot).copy_(r.select(ax, 0))
    return cache


def evict_slot(cfg: ModelConfig, cache, slot: int, valid: bool = True):
    """Zero slot `slot` in place (freed state never outlives its request)."""
    T.check_family(cfg)
    if valid:
        for c, a in _leaves(cfg, cache):
            c.select(a.index("cache_batch"), slot).zero_()
    return cache


def read_slot(cfg: ModelConfig, cache, slot: int) -> dict:
    """Slot `slot` as a new batch-1 cache."""
    T.check_family(cfg)
    return _unflatten(cache, iter(
        [c.narrow(a.index("cache_batch"), slot, 1).clone()
         for c, a in _leaves(cfg, cache)]))


def cache_len(cfg: ModelConfig, cache) -> int | None:
    """The positions the cache's "cache_seq" axes hold (None for a cache
    without one: an ssm state)."""
    for c, a in _leaves(cfg, cache):
        if "cache_seq" in a:
            return c.shape[a.index("cache_seq")]
    return None


def pad_cache(cfg: ModelConfig, cache, extra: int) -> dict:
    """Grow every "cache_seq" axis by `extra` zero slots (decode room);
    leaves without one (ssm states, `pos`) stay as they are, and a cache
    with none is returned itself."""
    T.check_family(cfg)
    leaves = _leaves(cfg, cache)
    if not any("cache_seq" in a for _, a in leaves):
        return cache
    grown = []
    for c, a in leaves:
        if "cache_seq" in a:
            after = c.ndim - 1 - a.index("cache_seq")
            c = torch.nn.functional.pad(c, (0, 0) * after + (0, extra))
        grown.append(c)
    return _unflatten(cache, iter(grown))


# ---------------------------------------------------------------------------
# Bridges from the reference package (numbers only; no import of it)
# ---------------------------------------------------------------------------
def params_from_reference(tree, device=None) -> dict:
    """The reference bundle's params, converted leaf by leaf
    (`np.asarray` of each array), in the reference layout: stacked
    `layers` axis, wi as (d, 2, f), wo as (f, d); the moe tree (router,
    wi (E, d, 2, f), wo (E, f, d), shared_wi, shared_wo), the MLA tree
    (w_dq, q_norm, w_uq, w_dkv, kv_norm, w_kr, w_uk, w_uv, wo), the
    unstacked `layer0`, the ssm tree (w_x, w_z, w_b, w_c, w_dt,
    dt_bias, a_log, d_skip, conv_*, gate_norm, w_out), zamba2's `groups`
    (n_groups, shared_every, ...), `tail` and `shared_attn` (ln, attn,
    ln2, ffn), and seamless's `encoder` (layers, norm) and the decoder
    layers' `ln_cross` / `cross` as they are."""
    return map_tree(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def opt_state_from_reference(tree, device=None) -> dict:
    """The reference's `init_opt_state` tree ({"adam": {"mu", "nu",
    "step"}} and, with gradient compression, "err"), converted leaf by
    leaf as `params_from_reference` converts; the step counter stays an
    int32 (0-d) tensor."""
    return params_from_reference(tree, device)
