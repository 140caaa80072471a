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

Sharded execution works on LOCAL tensors, each rank's shard as a plain
tensor (never a DTensor on the way into a kernel wrapper).  A context is
live when its mesh is a `DeviceMesh` over a real process group
(`live_mesh`); there `use_sharding(mesh, rules, sizes=)` names the global
size of every logical dim the caller laid out sharded (`{"cache_seq":
32768}`), and `local_spec` resolves a local tensor's spec on the global
shape those sizes give, sharding only the declared dims: a local shape
alone cannot tell a shard from a whole tensor.  `shard_local` cuts this
rank's shard of a global tensor by a spec.  The expert-parallel MoE
(`models.moe.moe_ep_local` from `transformer._ffn_apply`) and
`models.layers.flash_decode` read it.

Training and serving across ranks (`launch.steps.make_train_step(
layout=)`, `launch.steps.make_serve_step`) store the reference's layout:
every param leaf (and AdamW moment) as this rank's shard of its
`param_shardings(skel, mesh, rules)` spec under `TRAIN_RULES` or
`SERVE_RULES` (`shard_tree` cuts them, one leaf at a time, from whole
tensors or numpy arrays), so a rank holds exactly the `local_shape` bytes
of its shards.  Such a step's live context also names the spec tree of the
params the model is handed (`ShardingCtx.params`; `sharded_ctx`) and the
mesh axes its batch rows are split over (`ShardingCtx.batch_axes`;
`row_axes`).  The model then gathers a layer's leaves (`gather_tree`, a
differentiable tiled all_gather per sharded dim) where it uses them,
inside the recomputed block for a stacked layer (the spec of a layer
slice is the stacked spec without its leading dims, `drop_dims`), so
autograd never keeps a layer's gathered weights; the gathers' backward,
`psum_scatter`, hands each rank the summed gradient of its own shard.
The gathers leave local the dims split over the context's
tensor-parallel axes (`tp_axes`: the axes the rules give heads, KV heads,
MLP and vocab, unless the batch's rows take them, as under
`ZERO3_TRAIN_RULES`), and hand the layer the spec tree of what stays
split (`local_specs`): each rank computes its heads, MLP columns and
vocab rows, with the reference's GSPMD collectives written out (a `psum`
a projection pair, the vocab's softmax statistics or, serving, the
logits' blocks gathered).  An optical product on such shards
(`ProductSplit`, installed by `use_product_split` around the engine's
matmul) takes its full-scales over the ranks and its per-shot draws at
the global operand's shape, the rank keeping its block, so the ranks
compute the one-process product's numbers.

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
    # global sizes of the logical dims laid out sharded on a live mesh
    sizes: dict[str, int] = dataclasses.field(default_factory=dict)
    # a sharded train or serve step's: the spec tree of the (local)
    # params the model is handed, and the mesh axes its batch rows are
    # split over
    params: Any = None
    batch_axes: tuple[str, ...] = ()


_STACK: list[ShardingCtx] = []


def current_ctx() -> ShardingCtx | None:
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def use_sharding(mesh, rules: dict[str, tuple[str, ...]],
                 sizes: dict[str, int] | None = None, *, params=None,
                 batch_axes: tuple[str, ...] = ()):
    _STACK.append(ShardingCtx(mesh, rules, dict(sizes or {}), params,
                              tuple(batch_axes)))
    try:
        yield _STACK[-1]
    finally:
        _STACK.pop()


def live_mesh(ctx: ShardingCtx | None = None):
    """The active context's mesh when sharded execution can run on it: a
    `DeviceMesh` over an open process group other than a "fake" one (the
    dry run's); None otherwise (no context, a `MeshShape`, a fake
    group)."""
    ctx = current_ctx() if ctx is None else ctx
    if ctx is None or getattr(ctx.mesh, "mesh_dim_names", None) is None:
        return None
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_backend() == "fake":
        return None
    return ctx.mesh


def local_spec(ctx: ShardingCtx, shape: tuple[int, ...],
               axes: tuple[str | None, ...]) -> PartitionSpec:
    """The spec of a LOCAL tensor under a live context: resolved on the
    global shape (each dim named in `ctx.sizes` at its global size), with
    only those dims sharded; every other dim is whole on every rank."""
    glob = tuple(ctx.sizes.get(a, n) if a else n
                 for n, a in zip(shape, axes))
    spec = resolve_spec(glob, axes, ctx.rules, ctx.mesh)
    parts = [p if i < len(axes) and axes[i] in ctx.sizes else None
             for i, p in enumerate(spec)]
    for i, p in enumerate(parts):
        n = math.prod(mesh_axes(ctx.mesh)[a] for a in _group(p))
        if shape[i] * n != glob[i]:
            raise ValueError(f"local dim {i} ({axes[i]}) is {shape[i]}, "
                             f"not {glob[i]} over {n} devices")
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


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


def shard_local(t: torch.Tensor, spec: PartitionSpec,
                mesh) -> torch.Tensor:
    """This rank's shard of the global tensor `t` laid out by `spec` on the
    live `mesh` (a view; `.contiguous()` it to hold only the shard): each
    sharded dim cut to the block of the rank's index over its group."""
    from repro_torch.distributed.runtime import axis_index
    out = t
    for i, part in enumerate(spec):
        group = _group(part)
        if not group:
            continue
        n = math.prod(mesh_axes(mesh)[a] for a in group)
        if out.shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(t.shape)} does not divide "
                             f"over {part} ({n} devices)")
        size = out.shape[i] // n
        out = out.narrow(i, axis_index(group, mesh) * size, size)
    return out


def spec_axes(spec: PartitionSpec) -> tuple[str, ...]:
    """The mesh axes a spec shards over, in the spec's order."""
    return tuple(a for part in spec for a in _group(part))


def drop_dims(specs, n: int = 1):
    """The spec tree of a slice of stacked leaves: each spec without its
    first `n` dims (a stacked leaf's leading layer dims are whole)."""
    from repro_torch.models.module import map_tree

    def drop(spec):
        if any(_group(p) for p in spec[:n]):
            raise ValueError(f"{spec}: a sliced leading dim is sharded")
        return P(*spec[n:])
    return map_tree(drop, specs)


def gather(t: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """The whole tensor of this rank's shard `t` laid out by `spec`: a
    tiled all_gather along every sharded dim (differentiable: the backward
    is `psum_scatter`, each rank's summed gradient of its own shard)."""
    from repro_torch.distributed import runtime as rt
    for i, part in enumerate(spec):
        if _group(part):
            t = rt.all_gather(t, _group(part), axis=i, tiled=True,
                              mesh=mesh)
    return t


def gather_tree(tree, specs, mesh, skip=None, keep=None):
    """`gather` at every leaf of a nested dict of local shards, batched:
    one collective a mesh axis for the whole tree
    (`runtime.gather_many`); a leaf whose path `skip(path)` holds is left
    as it is, and so is every dim split over the axes `keep(path)` alone
    (a tensor-parallel dim).  The gathered leaves' bytes add to
    `GATHERED`."""
    from repro_torch.distributed import runtime as rt
    from repro_torch.models.module import leaves, unflatten
    spec_of = dict(leaves(specs))
    keep = keep or (lambda path: ())
    pairs = [(path, t) for path, t in leaves(tree)]
    plan = [() if skip is not None and skip(path) else
            tuple((i, _group(part)) for i, part in enumerate(spec_of[path])
                  if _group(part) and not _kept(part, keep(path)))
            for path, _ in pairs]
    got = rt.gather_many([t for _, t in pairs], plan, mesh)
    GATHERED["bytes"] += sum(t.numel() * t.element_size()
                             for t, pl in zip(got, plan) if pl)
    return unflatten((path, t) for (path, _), t in zip(pairs, got))


def shard_tree(tree, specs, mesh, device=None):
    """The tree (dicts, tuples and lists: a cache's (k, v) pairs too) of
    this rank's shards of whole tensors (or numpy arrays), one leaf at a
    time: each cut by its spec (`shard_local`) into a fresh tensor on
    `device` (default: the leaf's own), so the rank holds only its
    shards' bytes."""
    import numpy as np

    def cut(t, spec):
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(t)
        local = shard_local(t, spec, mesh)
        # a fresh tensor: a view would keep the whole leaf's storage alive
        return torch.empty(local.shape, dtype=local.dtype,
                           device=device or local.device).copy_(local)
    return zip_tree(tree, specs, cut)


def sharded_ctx() -> ShardingCtx | None:
    """The live context of a sharded train or serve step (its params a
    spec tree of this rank's shards), or None."""
    ctx = current_ctx()
    if ctx is None or ctx.params is None or live_mesh(ctx) is None:
        return None
    return ctx


def row_axes() -> tuple[str, ...]:
    """The mesh axes a live context splits its batch rows over (an
    activation's per-tensor full-scale and a masked loss reduce over
    them); () outside one."""
    ctx = current_ctx()
    if ctx is None or not ctx.batch_axes or live_mesh(ctx) is None:
        return ()
    return ctx.batch_axes


# the logical dims a sharded step splits over "model" as tensor
# parallelism (the experts' split is the expert-parallel MoE's own)
TP_NAMES = ("heads", "kv_heads", "mlp", "vocab")


def tp_axes() -> tuple[str, ...]:
    """The mesh axes a sharded step's context splits its tensor-parallel
    dims over (`TP_NAMES`' rules, the same under `TRAIN_RULES` and
    `SERVE_RULES`, axes of size > 1); () outside one, and for axes the
    layout splits the batch's rows over (`ZERO3_TRAIN_RULES`: there the
    ranks compute different rows and gather whole)."""
    ctx = sharded_ctx()
    if ctx is None:
        return ()
    sizes = mesh_axes(ctx.mesh)
    axes: list[str] = []
    for name in TP_NAMES:
        for a in ctx.rules.get(name) or ():
            if sizes.get(a, 1) > 1 and a not in ctx.batch_axes \
                    and a not in axes:
                axes.append(a)
    return tuple(axes)


def _kept(part, keep: tuple[str, ...]) -> bool:
    """A spec part whose group lies within the `keep` axes (a dim left
    split by a tensor-parallel gather)."""
    g = _group(part)
    return bool(g) and set(g) <= set(keep)


def local_specs(specs, keep):
    """The spec tree of what a gather that leaves local the dims split
    over the axes `keep(path)` gives a leaf (`gather_tree`) hands on: each
    spec with only those dims' groups."""
    from repro_torch.models.module import leaves, unflatten
    return unflatten((path, P(*(p if _kept(p, keep(path)) else None
                                for p in spec)))
                     for path, spec in leaves(specs))


def split_axes(spec) -> tuple[str, ...]:
    """The mesh axes a local spec (`local_specs`) splits its leaf over;
    () for a whole leaf (or no spec)."""
    return () if spec is None else spec_axes(spec)


GATHERED = {"bytes": 0}          # bytes `gather_tree` handed back, counted


@dataclasses.dataclass(frozen=True)
class OperandCut:
    """A rank's block of one 2-D operand of a tensor-parallel product:
    dim `dim`, viewed as `blocks` equal blocks (the MLP's gate | up
    columns), each split `n` ways over the mesh `axes`; the rank keeps
    part `index` of every block."""
    axes: tuple[str, ...]
    dim: int
    n: int
    index: int
    blocks: int = 1

    def whole(self, shape) -> tuple[int, ...]:
        """The global shape of a local operand of `shape`."""
        out = list(shape)
        out[self.dim] *= self.n
        return tuple(out)

    def cut(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of `t`, global along `dim` (contiguous)."""
        s = tuple(t.shape)
        part = s[self.dim] // (self.blocks * self.n)
        v = t.reshape(*s[:self.dim], self.blocks, s[self.dim] // self.blocks,
                      *s[self.dim + 1:])
        v = v.narrow(self.dim + 1, self.index * part, part)
        return v.reshape(*s[:self.dim], self.blocks * part,
                         *s[self.dim + 1:])


@dataclasses.dataclass(frozen=True)
class ProductSplit:
    """How the operands of a product x (M, K) @ w (K, N) a rank computes
    are cut from the global ones: `w` by its columns (an MLP's `wi`, x
    whole) or by its rows, with `x` by its columns (a K split, `wo`: the
    partial products `psum` over the axes)."""
    w: OperandCut
    x: OperandCut | None = None

    @classmethod
    def columns(cls, axes, blocks: int = 1) -> "ProductSplit":
        """`w`'s columns over `axes` (of the active context's mesh)."""
        return cls(_cut(axes, 1, blocks))

    @classmethod
    def rows(cls, axes) -> "ProductSplit":
        """`w`'s rows and `x`'s columns over `axes`."""
        return cls(_cut(axes, 0, 1), _cut(axes, 1, 1))

    def global_gemm(self, m: int, k: int, n: int) -> tuple[int, int, int]:
        """The (m, k, n) of the global product a rank's (m, k, n) is a
        block of (m as the rank has it)."""
        if self.x is not None:
            return m, k * self.x.n, n
        return m, k, n * self.w.n

    def cut_field(self, a: torch.Tensor, w_shape) -> torch.Tensor:
        """This rank's block of a field over the whole weight that
        broadcasts against it (a pinned chip's): a scalar as it is, the
        lane vector (K,) cut with a K split, a field of the whole weight's
        shape cut as the weight."""
        whole = self.w.whole(w_shape)
        if a.ndim == 0:
            return a
        if a.ndim == 1 and a.shape[0] == whole[0]:
            return self.w.cut(a) if self.w.dim == 0 else a
        if tuple(a.shape) == tuple(whole):
            return self.w.cut(a)
        raise ValueError(f"a field of shape {tuple(a.shape)} on a product "
                         f"split from {tuple(whole)}")


def _cut(axes, dim: int, blocks: int) -> OperandCut:
    from repro_torch.distributed.runtime import axis_index
    mesh = current_ctx().mesh
    axes = tuple(axes)
    n = math.prod(mesh_axes(mesh)[a] for a in axes)
    return OperandCut(axes, dim, n, axis_index(axes, mesh), blocks)


_PRODUCT: list[ProductSplit | None] = []


@contextlib.contextmanager
def use_product_split(split: ProductSplit | None):
    """Install `split` as the split of the optical product run inside
    (None: a whole product)."""
    _PRODUCT.append(split)
    try:
        yield split
    finally:
        _PRODUCT.pop()


def _operand_cut(operand: str) -> OperandCut | None:
    split = _PRODUCT[-1] if _PRODUCT else None
    if split is None:
        return None
    return split.w if operand == "w" else split.x


def scale_axes(operand: str, per_row: bool = False) -> tuple[str, ...]:
    """The mesh axes whose ranks hold the rest of the operand a full-scale
    spans, beyond this rank's block: for a weight ("w", per tensor) the
    ranks of the product's split; for an activation ("x") those that
    split its columns (a K split) and, for a per-tensor full-scale, a
    sharded step's row shards (`row_axes`)."""
    cut = _operand_cut(operand)
    axes = cut.axes if cut is not None else ()
    if operand == "x" and not per_row:
        axes = row_axes() + axes
    return axes


def operand_draws(draw, shape, operand: str) -> tuple[torch.Tensor, ...]:
    """This rank's block of per-shot draws for an operand of local
    `shape`: `draw(global_shape)` makes them at the global operand's
    shape (an activation's rows, its dim 0, over a train step's row
    shards; the dim the product's split cuts, over its ranks), and each
    is cut to the rank's block, so the ranks realize the one-process
    offsets (the layer's key is the same on every rank: drawn at the
    local shape, ranks would repeat each other's)."""
    cut = _operand_cut(operand)
    whole = cut.whole(shape) if cut is not None else tuple(shape)
    rows = row_axes() if operand == "x" else ()
    if rows:
        from repro_torch.distributed.runtime import axis_index
        sizes = mesh_axes(live_mesh(current_ctx()))
        r = shape[0]
        lo = axis_index(rows) * r
        whole = (r * math.prod(sizes[a] for a in rows), *whole[1:])
    out = tuple(draw(whole))
    if rows:
        out = tuple(t[lo:lo + r] for t in out)
    if cut is not None:
        out = tuple(cut.cut(t) for t in out)
    return out


def global_gemm(m: int, k: int, n: int,
                split: ProductSplit | None = None) -> tuple[int, int, int]:
    """The GEMM shape of the global product a rank computes a block of:
    its rows over a sharded step's row shards, and the dim `split`
    cuts."""
    axes = row_axes()
    if axes:
        sizes = mesh_axes(current_ctx().mesh)
        m *= math.prod(sizes[a] for a in axes)
    return split.global_gemm(m, k, n) if split is not None else (m, k, n)


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


def zip_tree(tree, axes_tree, fn):
    """`fn(leaf, axes)` at every tensor leaf of `tree` (dicts, tuples and
    lists), its logical axes (or spec) from the same place in
    `axes_tree`."""
    if isinstance(tree, dict):
        return {k: zip_tree(v, axes_tree[k], fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(zip_tree(t, a, fn)
                          for t, a in zip(tree, axes_tree, strict=True))
    return fn(tree, axes_tree)


def tree_shardings(shapes_tree, axes_tree, mesh,
                   rules: dict[str, tuple[str, ...]]):
    """Zip a tree of tensors with its logical-axes tree -> shardings."""
    return zip_tree(shapes_tree, axes_tree, lambda t, a: NamedSharding(
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
    return zip_tree(template, axes_tree, lambda t, a: spec_on_dim(
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
