"""AdamW with float32 moments over nested dicts of tensors (PyTorch port
of `repro.optim.adamw`).

The arithmetic is the reference's, in its order: the int32 step counter,
`lr(step)`, `b ** step` and the bias corrections in float32; the gradient
norm summed over the leaves in `jax.tree.leaves` order (dict keys sorted,
recursively), which fixes the clip scale's bits up to each leaf's own
sum.  Memory is not the reference's: it builds whole-tree temporaries
(clipped grads, mu_hat, nu_hat) and donates the old state, which at
qwen3-32b's width would cost one params-sized buffer each.  Here params,
mu and nu are updated in place, leaf by leaf and in slices of `CHUNK`
elements, so an update needs a few slices of scratch; elementwise work
gives the same bits whatever the slicing.  Gradients are read, never
written.  Across ranks the trees are shards and the same update runs on
each (`global_norm` takes the layout).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.module import leaves, map_tree

CHUNK = 1 << 24                 # elements of one slice of an update


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> dict:
    """Zero float32 moments shaped like `params`, and the int32 step
    counter (0-d, on the params' device)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(t for _, t in leaves(params)).device
    return {"mu": map_tree(zeros, params), "nu": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    added one after another in sorted-key order.

    Across ranks (`specs`, the tree's `PartitionSpec`s, on the live
    `mesh`) each leaf is this rank's shard: the squares of the shards are
    summed and `psum`-med over every mesh axis, a leaf replicated over an
    axis counted on index 0 of that axis only, so each element counts
    once and every rank gets the same norm (and clips with the same
    scale)."""
    if specs is not None:
        from repro_torch.distributed import runtime as rt
        from repro_torch.distributed.sharding import mesh_axes, spec_axes
        axes = tuple(mesh_axes(mesh))
        spec_of = dict(leaves(specs))
    total = None
    for path, g in leaves(tree):
        if specs is not None:
            used = spec_axes(spec_of[path])
            if any(rt.axis_index(a, mesh) for a in axes if a not in used):
                continue                   # another rank counts this copy
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    if specs is not None:
        if total is None:
            device = next(t for _, t in leaves(tree)).device
            total = torch.zeros((), device=device)
        total = rt.psum(total, axes, mesh)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / max(norm, 1e-9)), norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return map_tree(lambda g: g.float() * scale, grads), norm


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def adamw_update(params, grads, state: dict, cfg: AdamWConfig, *,
                 specs=None, mesh=None):
    """One AdamW step.  Returns (params, state, metrics {grad_norm, lr}):
    params, mu and nu are the given tensors, updated in place; the state's
    step counter is a new tensor.  Across ranks every tree holds this
    rank's shards, laid out by `specs` on `mesh` (the norm is global; the
    update is elementwise on the shards)."""
    step = state["step"] + 1
    lr = cfg.lr(step) if callable(cfg.lr) else cfg.lr
    gnorm = global_norm(grads, specs, mesh)
    scale = _clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip > 0 \
        else None
    b1, b2 = cfg.b1, cfg.b2
    c1, c2 = 1 - b1 ** step, 1 - b2 ** step
    mu, nu = state["mu"], state["nu"]
    for (_, p), (_, g), (_, m), (_, v) in zip(
            leaves(params), leaves(grads), leaves(mu), leaves(nu),
            strict=True):
        for ps, gs, ms, vs in zip(p.view(-1).split(CHUNK),
                                  g.reshape(-1).split(CHUNK),
                                  m.view(-1).split(CHUNK),
                                  v.view(-1).split(CHUNK), strict=True):
            _update_slice(ps, gs, ms, vs, scale, lr, c1, c2, cfg)
    return params, {"mu": mu, "nu": nu, "step": step}, \
        {"grad_norm": gnorm,
         "lr": torch.as_tensor(lr, dtype=torch.float32, device=step.device)}


@torch.no_grad()
def _update_slice(p, g, m, v, scale, lr, c1, c2, cfg: AdamWConfig) -> None:
    """The reference's per-leaf arithmetic on one slice, in place:
    m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g g;
    p = p - lr (m / c1 / (sqrt(v / c2) + eps) + wd p)."""
    g = g.float()
    if scale is not None:
        g = g * scale
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_(((1 - cfg.b2) * g).mul_(g))
    den = torch.sqrt(v / c2).add_(cfg.eps)
    delta = (m / c1).div_(den).add_(cfg.weight_decay * p.float())
    if p.dtype == torch.float32:
        p.sub_(delta.mul_(lr))
    else:
        p.copy_(p.float() - delta.mul_(lr))
