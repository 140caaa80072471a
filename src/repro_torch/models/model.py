"""build_model(cfg) — the model API of the port (PyTorch port of the
serving part of `repro.models.model`, dense and ssm families).

A `ModelBundle` exposes functions over plain dicts of tensors:

    bundle.init(generator, dtype, device)   real params
    bundle.abstract(dtype)                  `meta` params (tracing)
    bundle.prefill / decode_step / chunk_step

plus the slot API of continuous-batching serving (`write_slot`,
`evict_slot`, `read_slot`, `pad_cache`), and `params_from_reference`,
which carries the reference's numbers across (with
`robust.variation.from_reference` for a chip), so the two packages can
compute on identical weights and an identical chip.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.module import (abstract_params, init_params,
                                       map_tree, param_count)
from repro_torch.models.transformer import ModelConfig


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

    def prefill(self, params, batch):
        return T.prefill(params, self.cfg, batch)

    def decode_step(self, params, batch):
        return T.decode_step(params, self.cfg, batch)

    def chunk_step(self, params, batch):
        """Serving prefill chunk: batch = {tokens (B, C), n_valid, cache}."""
        return T.chunk_step(params, self.cfg, batch)


def build_model(cfg: ModelConfig) -> ModelBundle:
    return ModelBundle(cfg=cfg, skeleton=T.model_def(cfg))


# ---------------------------------------------------------------------------
# Slot API: a slot cache is a decode cache with batch = n_slots.  Requests
# come and go by writing or zeroing ONE row of every leaf, in place.
# ---------------------------------------------------------------------------
def _leaves(cache) -> list[tuple[torch.Tensor, int]]:
    """(leaf, batch axis) of a cache, in a fixed order.  Dense KV leaves
    (L, B, S, KV, D) and ssm leaves (L, B, ...: conv_x, conv_b, conv_c,
    state; no sequence axis) carry the batch at axis 1, `pos` (B,) at
    axis 0."""
    layers = cache["layers"]
    if isinstance(layers, dict):
        out = [(layers[k], 1) for k in sorted(layers)]
    else:
        out = [(t, 1) for t in layers]
    return out + [(cache["pos"], 0)]


def _rebuild(cache, leaves: list[torch.Tensor]) -> dict:
    """A cache of `cache`'s structure holding `leaves` (in `_leaves`
    order)."""
    layers = cache["layers"]
    if isinstance(layers, dict):
        new = dict(zip(sorted(layers), leaves[:-1]))
    else:
        new = tuple(leaves[:-1])
    return {"layers": new, "pos": leaves[-1]}


def write_slot(cfg: ModelConfig, cache, req_cache, slot: int,
               valid: bool = True):
    """Admit one request: copy `req_cache` (batch 1, same seq length) into
    slot `slot` of `cache`, in place; a no-op when `valid` is False."""
    T.check_family(cfg)
    if valid:
        for (c, ax), (r, _) in zip(_leaves(cache), _leaves(req_cache)):
            c.select(ax, slot).copy_(r.select(ax, 0))
    return cache


def evict_slot(cfg: ModelConfig, cache, slot: int, valid: bool = True):
    """Zero slot `slot` in place (freed state never outlives its request)."""
    T.check_family(cfg)
    if valid:
        for c, ax in _leaves(cache):
            c.select(ax, slot).zero_()
    return cache


def read_slot(cfg: ModelConfig, cache, slot: int) -> dict:
    """Slot `slot` as a new batch-1 cache."""
    T.check_family(cfg)
    return _rebuild(cache, [c.narrow(ax, slot, 1).clone()
                            for c, ax in _leaves(cache)])


def pad_cache(cfg: ModelConfig, cache, extra: int) -> dict:
    """Grow every sequence axis by `extra` zero slots (decode room).  Dense
    KV leaves have theirs at axis 2; ssm leaves have none and stay as they
    are."""
    T.check_family(cfg)
    if cfg.family == "ssm":
        return cache
    grown = [torch.nn.functional.pad(c, (0, 0, 0, 0, 0, extra))
             if ax == 1 else c for c, ax in _leaves(cache)]
    return _rebuild(cache, grown)


# ---------------------------------------------------------------------------
# Bridges from the reference package (numbers only; no import of it)
# ---------------------------------------------------------------------------
def params_from_reference(tree, device=None) -> dict:
    """The reference bundle's params, converted leaf by leaf
    (`np.asarray` of each array), in the reference layout: stacked
    `layers` axis, wi as (d, 2, f), wo as (f, d); the ssm tree (w_x, w_z,
    w_b, w_c, w_dt, dt_bias, a_log, d_skip, conv_*, gate_norm, w_out) as
    it is."""
    return map_tree(lambda a: torch.from_numpy(np.array(a)).to(device), tree)
