"""Logical-axis sharding rules with divisibility fallback (PyTorch port of
`repro.distributed.sharding`).

Model code annotates tensors with LOGICAL axis names ("batch", "embed",
"heads", ...).  A rules table maps each name to a tuple of mesh axes; this
module resolves names -> `PartitionSpec` per concrete shape with two safety
rules, the dims taken in priority order:

  1. divisibility — a mesh-axis group is only used if the dim size is an
     exact multiple of the group's device count; progressively shorter
     SUFFIXES of the group are tried (("pod","data") -> ("data",)), so a
     batch of 8 on a 2x16 (pod,data) sub-mesh falls back cleanly;
  2. no-reuse — a mesh axis claimed by an earlier dim of the same tensor is
     skipped for later dims (a KV cache can shard batch OR sequence over
     "data", never both).

Rules differ between training (FSDP on the weights' embed dim) and serving
(2-D weight sharding, cache sharded over batch/sequence).  A spec reads
only the mesh's axis sizes: `resolve_spec` takes a `launch.mesh.MeshShape`
(or anything with an ordered axis -> size `shape` mapping) as well as a
`torch.distributed.device_mesh.DeviceMesh`.  `to_placements` maps a spec
onto a DeviceMesh's dims as DTensor placements (`Shard(dim)` on every mesh
dim of a tensor dim's group, `Replicate()` elsewhere); `NamedSharding` is
a (mesh, spec) pair with those placements.

The active (mesh, rules) pair is installed with `use_sharding(...)`;
`shard_act` is a no-op outside any context, and inside one redistributes a
DTensor to its resolved placements and returns a plain tensor as it is.
No model call site uses it yet: sharded execution comes after the rules.

The reference's `shard_map_compat` (a shim over the renames of jax's
`shard_map`) has no counterpart.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch


class PartitionSpec(tuple):
    """jax's PartitionSpec: one entry per tensor dim (None, a mesh axis
    name, or a tuple of names), trailing Nones dropped by `resolve_spec`.
    As jax's does, it stores a one-name tuple as the name and an empty one
    as None."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            (p[0] if len(p) == 1 else p or None)
            if isinstance(p, tuple) else p for p in parts))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec

# ---------------------------------------------------------------------------
# Rules tables (the reference's)
# ---------------------------------------------------------------------------
TRAIN_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),        # DP over pods x data
    "embed": ("pod", "data"),        # FSDP / ZeRO-3 on weight d_model dims
    "heads": ("model",),             # TP
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),           # EP
    "vocab": ("model",),
    "cache_batch": ("pod", "data"),
    "cache_seq": ("pod", "data"),
    "act_seq": (),                   # train: sequence unsharded
}

# ZeRO-3 layout: batch data-parallel over the WHOLE mesh; weights stay 2-D
# sharded and are gathered layer by layer
ZERO3_TRAIN_RULES: dict[str, tuple[str, ...]] = dict(
    TRAIN_RULES, batch=("pod", "data", "model"))

SERVE_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "embed": ("pod", "data"),        # 2-D weight sharding for serving
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "cache_batch": ("pod", "data"),
    # KV sequence takes whatever axes the batch/kv_heads left unused —
    # batch=1 long-context cells shard 512-way over the whole mesh, while
    # decode_32k cells use "model" for whatever kv_heads couldn't cover.
    "cache_seq": ("pod", "data", "model"),
    "memory_seq": ("pod", "data", "model"),
    "act_seq": ("data",),            # prefill sequence parallelism
}

# Dims are assigned mesh axes in this order (cheap parallelism first: batch
# needs no collectives, kv_heads only an o-proj reduction, sequence
# sharding a softmax-stat combine).  Position in the tensor does not decide
# who wins a mesh axis — priority does.
_PRIORITY = ("cache_batch", "batch", "kv_heads", "heads", "experts",
             "vocab", "mlp", "cache_seq", "memory_seq", "act_seq", "embed",
             "state", "lora", "head_dim")


@dataclasses.dataclass
class ShardingCtx:
    mesh: Any
    rules: dict[str, tuple[str, ...]]


_STACK: list[ShardingCtx] = []


def current_ctx() -> ShardingCtx | None:
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def use_sharding(mesh, rules: dict[str, tuple[str, ...]]):
    _STACK.append(ShardingCtx(mesh, rules))
    try:
        yield _STACK[-1]
    finally:
        _STACK.pop()


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------
def mesh_axes(mesh) -> dict[str, int]:
    """The ordered axis -> size map of a DeviceMesh (its dim names and
    shape) or of anything with such a `shape` mapping (`MeshShape`)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def resolve_spec(shape: tuple[int, ...], axes: tuple[str | None, ...],
                 rules: dict[str, tuple[str, ...]], mesh) -> PartitionSpec:
    sizes = mesh_axes(mesh)
    used: set[str] = set()
    parts: list[Any] = [None] * len(shape)
    order = sorted(
        range(len(shape)),
        key=lambda i: _PRIORITY.index(axes[i])
        if axes[i] in _PRIORITY else len(_PRIORITY))
    for i in order:
        dim, name = shape[i], axes[i]
        group = tuple(a for a in (rules.get(name) or ())
                      if a in sizes) if name else ()
        for start in range(len(group)):
            cand = group[start:]
            size = math.prod(sizes[a] for a in cand)
            if size > 1 and dim % size == 0 \
                    and not any(a in used for a in cand):
                parts[i] = cand[0] if len(cand) == 1 else tuple(cand)
                used.update(cand)
                break
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def _group(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def to_placements(spec: PartitionSpec, mesh) -> list:
    """DTensor placements of `spec` on `mesh`'s dims: `Shard(i)` on every
    mesh dim of tensor dim i's group, `Replicate()` on the rest.  DTensor
    splits a dim sharded over several mesh dims in mesh-dim order, which is
    the group's order only when the group lies in mesh order: every group
    the rules tables can yield does, and any other is refused."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    out: list = [Replicate()] * len(names)
    for i, part in enumerate(spec):
        idx = [names.index(a) for a in _group(part)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the group {part} is not in the "
                             f"mesh's order {tuple(names)}")
        for j in idx:
            if out[j] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[j]!r} is used "
                                 "twice")
            out[j] = Shard(i)
    return out


def local_shape(shape: tuple[int, ...], spec: PartitionSpec,
                mesh) -> tuple[int, ...]:
    """One device's shard of a tensor of `shape` laid out by `spec` (each
    dim over its group's device count, which divides it)."""
    sizes = mesh_axes(mesh)
    out = list(shape)
    for i, part in enumerate(spec):
        n = math.prod(sizes[a] for a in _group(part))
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {part} ({n} devices)")
        out[i] //= n
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's `jax.sharding.NamedSharding`)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> list:
        return to_placements(self.spec, self.mesh)

    def shard_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        return local_shape(shape, self.spec, self.mesh)


def shard_act(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Redistribute a DTensor to the placements its logical axes resolve
    to under the active context; a no-op without one, and a plain tensor is
    returned as it is."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = resolve_spec(tuple(x.shape), axes, ctx.rules, ctx.mesh)
    return x.redistribute(ctx.mesh, to_placements(spec, ctx.mesh))


# ---------------------------------------------------------------------------
# Tree shardings
# ---------------------------------------------------------------------------
def param_shardings(skel, mesh, rules: dict[str, tuple[str, ...]]):
    """Skeleton of ParamDef -> nested dict of NamedSharding."""
    if isinstance(skel, dict):
        return {k: param_shardings(v, mesh, rules) for k, v in skel.items()}
    return NamedSharding(mesh, resolve_spec(skel.shape, skel.axes, rules,
                                            mesh))


def _zip(tree, axes_tree, fn):
    """`fn(leaf, axes)` at every tensor leaf of `tree` (dicts, tuples and
    lists), its logical axes from the same place in `axes_tree`."""
    if isinstance(tree, dict):
        return {k: _zip(v, axes_tree[k], fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip(t, a, fn)
                          for t, a in zip(tree, axes_tree, strict=True))
    return fn(tree, axes_tree)


def tree_shardings(shapes_tree, axes_tree, mesh,
                   rules: dict[str, tuple[str, ...]]):
    """Zip a tree of tensors with its logical-axes tree -> shardings."""
    return _zip(shapes_tree, axes_tree, lambda t, a: NamedSharding(
        mesh, resolve_spec(tuple(t.shape), a, rules, mesh)))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# ---------------------------------------------------------------------------
# Slot (serving batch) sharding: every state leaf sharded on its slot dim
# ---------------------------------------------------------------------------
def spec_on_dim(ndim: int, dim: int, axes: str | tuple[str, ...]
                ) -> PartitionSpec:
    """PartitionSpec placing `axes` on dimension `dim` of a rank-`ndim`
    tensor, every other dimension unsharded."""
    parts: list[Any] = [None] * ndim
    if not isinstance(axes, str) and len(axes) == 1:
        axes = axes[0]
    parts[dim] = axes
    return P(*parts)


def slot_dim_specs(axes_tree, template, mesh_axes: tuple[str, ...],
                   name: str = "cache_batch"):
    """Spec tree sharding every leaf's `name` logical dim over
    `mesh_axes`.  `template` fixes leaf ranks; `axes_tree` is the logical
    axes tree (`models.model.cache_axes` for a decode cache)."""
    return _zip(template, axes_tree, lambda t, a: spec_on_dim(
        t.ndim, a.index(name), mesh_axes))


# ---------------------------------------------------------------------------
# Expert-parallel param specs (see models/moe.py)
# ---------------------------------------------------------------------------
def ep_param_specs(p: dict, fsdp: tuple[str, ...] | None) -> dict:
    """PartitionSpecs of the MoE param dict on the expert-parallel path.

    Experts over `model`; d_model dims stay FSDP-sharded (gathered inside);
    the router is needed in full on every shard.
    """
    f = tuple(fsdp) if fsdp else None
    fs = (f if f else None)
    specs = {
        "router": P(None, None),
        "wi": P("model", fs, None, None),
        "wo": P("model", None, fs),
    }
    if "shared_wi" in p:
        specs["shared_wi"] = P(fs, None, "model")
        specs["shared_wo"] = P("model", fs)
    return specs
