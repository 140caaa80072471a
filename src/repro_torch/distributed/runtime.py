"""Ranks and collectives over named mesh axes (the port's counterpart of
jax's device runtime and of the `jax.lax` collectives inside `shard_map`).

A program that runs on several devices runs as one process a rank:
`spawn(fn, world, device_type=, backend=)` starts `world` processes
(`torch.multiprocessing`, spawn context), each of which opens the process
group with `init_ranks` and calls `fn(rank, world, device, *args)`.  The
caller names the backend; nothing picks one for it:

  nccl   one card a rank, rank r on `cuda:r` (refused, naming the count,
         when fewer than `world` cards are visible);
  gloo   on the CPU every rank on `cpu`; with device_type "cuda" every
         rank on `cuda:0`, the ranks sharing one card (NCCL refuses two
         ranks on one GPU), every tensor and kernel on the card.

A rank that raises brings the whole group down: `spawn` stops every rank
and raises, naming the rank and its traceback, and a group that does not
finish within `timeout` seconds is stopped the same way.  Nothing is
caught and carried on past.

The collectives mirror `jax.lax`'s over named mesh axes: `psum`, `pmax`,
`all_gather(tiled=)`, `all_to_all(split_axis, concat_axis, tiled=)` and
`axis_index`, each over one axis name or a tuple of them (the device
index over a tuple is row-major in the tuple's order, as jax's).  The
mesh is a `DeviceMesh` (`launch.mesh.make_test_mesh`), passed as `mesh=`
or taken from the active `distributed.sharding.use_sharding` context;
each axis reaches its group through `DeviceMesh.get_group(axis)` and its
coordinate through `get_local_rank(axis)`.  An axis of size 1 needs no
group: a collective over such axes returns its input itself (any other
returns a new tensor) and `axis_index` 0, so a body written for several
ranks runs as one rank with a plain `launch.mesh.MeshShape`.

Each collective has one data path, chosen from its tensor and its group:
a CPU tensor goes through gloo's own collective; under nccl, nccl's; a
CUDA tensor of a gloo group (its ranks share card 0) through card
buffers.  gloo would take CUDA tensors itself, but it stages them
through the host and moves 0.17-0.50 GB/s a rank there (over TCP on the
loopback; the card buffers 22-60 GB/s, `tools/rank_transfer_rates.py`
on an H100 host), while a train step gathers and reduces the whole
model.  So every rank writes its part of a collective into a card
buffer of its own (one a group), a barrier of the gloo group, each rank
reads the parts it needs from its peers' buffers, which it maps through
CUDA IPC (device-to-device copies), and combines them in the group's
rank order (so every rank gets the same bits), and a second barrier
frees the buffers for the next collective.  A collective moves its data in chunks
of at most 256 MiB a member, so a buffer never holds more.

Training differentiates through them.  The convention is `shard_map`'s:
each rank's loss is its CONTRIBUTION to the global loss (the global loss
is the `psum` of the contributions over every mesh axis), and a rank's
cotangent of a tensor is the derivative of the global loss through that
rank's copy only.  Under it the transposes are jax's:

  psum(x)                  backward: psum of the cotangent (every rank's
                           copy of the sum feeds the global loss);
  all_gather(tiled)        backward: psum_scatter over the same axes (the
                           rank keeps the summed block it contributed);
  all_to_all(split, cat)   backward: all_to_all(cat, split), the blocks
                           sent back where they came from;
  amax (a global max)      backward: the psum of the cotangent, shared
                           among the entries that hold the max (jnp.max's
                           rule, ties counted over every rank).

`psum`, `all_gather`, `all_to_all` and `amax` carry those backwards when a
gradient is asked for (`torch.autograd.Function`s around the collectives
above); `pmax` carries none (it stays a value-only reduction).
`gather_many` gathers many tensors at once (a layer's leaves: one
collective a mesh axis for the small ones, its backward one
reduce-scatter), and `psum_many` sums many gradients at once: a train
step's collectives are latency-bound where the leaves are small.  A tensor
held whole on several ranks (a leaf replicated over an axis, or an
activation every "model" rank computes alike) is several copies, each
with its own cotangent: the gradient of a leaf replicated over an axis is
the `psum` of its copies' over that axis (`launch.steps`).

`psum_scatter` is the sum's scattered form.  gloo has no reduce-scatter:
under gloo a CPU tensor's is an `all_reduce` and the rank's block of the
sum; under nccl, `reduce_scatter_tensor`; through the card buffers each
rank reads only its block of each peer's part.  This is a choice by
data path, not a fallback: under gloo both give the same sum.
"""

from __future__ import annotations

import math
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------
def rank_device(rank: int, world: int, device_type: str,
                backend: str) -> torch.device:
    """The device rank `rank` of `world` computes on (see the module's
    docstring); raises for a layout the backend cannot run."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if device_type == "cpu":
        if backend == "nccl":
            raise ValueError("ranks on the CPU need the gloo backend")
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device type {device_type!r}: cpu or cuda")
    if not torch.cuda.is_available():
        raise RuntimeError("device type 'cuda' but no CUDA device is "
                           "visible")
    if backend != "nccl":
        return torch.device("cuda", 0)          # the ranks share card 0
    n = torch.cuda.device_count()
    if world > n:
        raise RuntimeError(f"{world} ranks over nccl need {world} cards "
                           f"(one a rank); {n} visible")
    return torch.device("cuda", rank)


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_ranks(world: int, device_type: str, backend: str, *, rank: int,
               init_method: str, timeout_s: float = 300.0) -> torch.device:
    """Open the default process group of `world` ranks as rank `rank` at
    `init_method` (`tcp://localhost:<port>`); returns the rank's device,
    made current for CUDA."""
    import datetime
    device = rank_device(rank, world, device_type, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend != "nccl":
        # the ranks talk over the loopback interface (one host)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl" if backend == "nccl" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def _rank_main(fn, rank: int, world: int, device_type: str, backend: str,
               init_method: str, args: tuple, results) -> None:
    try:
        device = init_ranks(world, device_type, backend, rank=rank,
                            init_method=init_method)
        out = fn(rank, world, device, *args)
        if _CARD is not None:
            _CARD.drop_peers()
        dist.barrier()                 # every rank has dropped its peers'
        results.put(("ok", rank, out))
    except BaseException:                      # reported, then re-raised
        results.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankError(RuntimeError):
    """A rank raised, died or did not finish in time."""


def spawn(fn: Callable, world: int, *, device_type: str, backend: str,
          args: tuple = (), timeout: float = 600.0) -> list:
    """Run `fn(rank, world, device, *args)` in `world` fresh processes
    that form one process group; returns the ranks' results in rank
    order (each must pickle: hand back host values, not CUDA tensors).
    Raises `RankError` (after stopping every rank) when a rank raises,
    exits without a result, or the group runs past `timeout` seconds.
    `fn` must be importable by name (a module-level function)."""
    import torch.multiprocessing as mp
    rank_device(0, world, device_type, backend)      # refuse early
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, device_type, backend,
                               init_method, args, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                status, rank, val = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RankError(f"rank {dead[0]} of {world} exited with "
                                    f"code {procs[dead[0]].exitcode} "
                                    "without a result") from None
                if time.monotonic() > deadline:
                    raise RankError(f"{world - len(out)} of {world} ranks "
                                    f"did not finish in {timeout:.0f} s "
                                    f"(done: {sorted(out)})") from None
                continue
            if status != "ok":
                raise RankError(f"rank {rank} of {world} raised:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
        results.close()
    return [out[r] for r in range(world)]


# ---------------------------------------------------------------------------
# The card buffers: CUDA tensors of gloo ranks that share card 0
# ---------------------------------------------------------------------------
_CARD = None                    # this rank's `_CardBuffers`, made on first use
_MIN_BLOCK = 1 << 20
_CHUNK_BYTES = 1 << 28          # the most a member writes a collective step


class _CardBuffers:
    """This rank's card buffer of each group and the members' buffers it
    has mapped through CUDA IPC: one a group, grown (and mapped again) at
    the same collective on every member, whose parts are equal."""

    def __init__(self):
        self.cards: dict = {}        # group ranks -> (cap, own, members')

    def parts(self, x: torch.Tensor, group, ranks: list, me: int) -> list:
        """Write `x` into this rank's buffer of `group`; the members'
        buffers as `x`-shaped views (the peers' through CUDA IPC)."""
        from torch.multiprocessing.reductions import (reduce_tensor,
                                                      rebuild_cuda_tensor)
        nbytes = x.numel() * x.element_size()
        cap = max(_MIN_BLOCK, 1 << (max(nbytes, 1) - 1).bit_length())
        key = tuple(ranks)
        entry = self.cards.get(key)
        if entry is None or entry[0] < cap:
            self.cards.pop(key, None)
            own = torch.empty(cap, dtype=torch.uint8, device=x.device)
            handles: list = [None] * len(ranks)
            dist.all_gather_object(handles, reduce_tensor(own)[1],
                                   group=group)
            entry = (cap, own, [own if i == me else rebuild_cuda_tensor(*h)
                                for i, h in enumerate(handles)])
            self.cards[key] = entry
        _, own, bufs = entry
        own[:nbytes].view(x.dtype).view(x.shape).copy_(x)
        return [b[:nbytes].view(x.dtype).view(x.shape) for b in bufs]

    def drop_peers(self) -> None:
        """Unmap the members' buffers (a producer must outlive its
        buffer's users: the caller's barrier follows)."""
        for key in list(self.cards):
            cap, own, _ = self.cards[key]
            self.cards[key] = (cap, own, [])
        torch.cuda.synchronize()


def _card_path(x: torch.Tensor, group) -> bool:
    """A collective on `x` goes through the card buffers: a CUDA tensor
    of a gloo group (whose ranks share card 0)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _group_ranks(group) -> tuple[list[int], int]:
    """(the global ranks of `group` in its rank order, this rank's
    place)."""
    ranks = dist.get_process_group_ranks(group)
    return ranks, ranks.index(dist.get_rank())


def _exchange(x: torch.Tensor, group):
    """Write `x` (contiguous, on the card) into this rank's buffer and
    wait for the group: returns (the members' parts as views, this rank's
    place).  The caller reads them, then calls `_done`."""
    global _CARD
    if _CARD is None:
        _CARD = _CardBuffers()
    ranks, me = _group_ranks(group)
    parts = _CARD.parts(x, group, ranks, me)
    torch.cuda.current_stream(x.device).synchronize()
    dist.barrier(group=group)
    return parts, me


def _done(x: torch.Tensor, group) -> None:
    """The reads of a collective are done on every member."""
    torch.cuda.current_stream(x.device).synchronize()
    dist.barrier(group=group)


def _chunks(n: int, per: int):
    """[start, stop) ranges of at most `per` elements covering n."""
    per = max(1, per)
    return [(c, min(c + per, n)) for c in range(0, max(n, 1), per)]


def _chunk_elems(x: torch.Tensor, copies: int = 1) -> int:
    """Elements a chunk of a collective on `x` may hold so that a
    member's buffer (`copies` chunks) stays within _CHUNK_BYTES."""
    return _CHUNK_BYTES // (copies * x.element_size())


def _card_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    """Sum (or max) over the group, the parts combined in rank order,
    chunk by chunk."""
    flat = x.contiguous().reshape(-1)
    out = torch.empty_like(flat)
    for c0, c1 in _chunks(flat.numel(), _chunk_elems(x)):
        piece = flat[c0:c1]
        parts, me = _exchange(piece, group)
        acc = out[c0:c1]
        for i, p in enumerate(parts):
            p = piece if i == me else p
            if i == 0:
                acc.copy_(p)
            elif op == dist.ReduceOp.SUM:
                acc.add_(p)
            else:
                torch.maximum(acc, p, out=acc)
        _done(piece, group)
    return out.view(x.shape)


def _card_gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Every member's `x` concatenated along `axis` in rank order,
    written straight into the result (no copy of the parts besides it):
    `x` viewed as rows (the dims before `axis`) of the rest, a block of
    whole rows (or a piece of one row) at a time."""
    ranks, _ = _group_ranks(group)
    x = x.contiguous()
    pre, row = math.prod(x.shape[:axis]), math.prod(x.shape[axis:])
    src = x.reshape(pre, row)
    out = torch.empty((pre, len(ranks), row), dtype=x.dtype,
                      device=x.device)
    per = _chunk_elems(x)
    for r0, r1 in _chunks(pre, max(1, per // max(row, 1))):
        for c0, c1 in _chunks(row, min(row, per)):
            piece = src[r0:r1, c0:c1].contiguous()
            parts, me = _exchange(piece, group)
            for i, p in enumerate(parts):
                out[r0:r1, i, c0:c1].copy_(p)
            _done(piece, group)
    shape = list(x.shape)
    shape[axis] *= len(ranks)
    return out.view(shape)


def _card_by_block(x: torch.Tensor, group, reduce: bool) -> torch.Tensor:
    """Member i's block i (along dim 0) of every member's `x`: summed in
    rank order (`reduce`, a reduce-scatter) or stacked in rank order (an
    all_to_all of dim 0); chunk by chunk of the blocks."""
    ranks, me = _group_ranks(group)
    n = len(ranks)
    blocks = x.contiguous().reshape(n, -1)
    size = blocks.shape[1]
    out = torch.empty((1 if reduce else n, size), dtype=x.dtype,
                      device=x.device)
    for c0, c1 in _chunks(size, _chunk_elems(x, n)):
        piece = blocks[:, c0:c1].contiguous()
        parts, me = _exchange(piece, group)
        for i, p in enumerate(parts):
            mine = (piece if i == me else p)[me]
            if not reduce:
                out[i, c0:c1].copy_(mine)
            elif i == 0:
                out[0, c0:c1].copy_(mine)
            else:
                out[0, c0:c1].add_(mine)
        _done(piece, group)
    shape = (x.shape[0] // n, *x.shape[1:])
    return out.view(shape) if reduce else out.view(x.shape)


# ---------------------------------------------------------------------------
# Collectives over named mesh axes
# ---------------------------------------------------------------------------
def _mesh(mesh):
    if mesh is not None:
        return mesh
    from repro_torch.distributed.sharding import current_ctx
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None:
        raise RuntimeError("a collective needs a mesh: pass mesh= or run "
                           "under distributed.sharding.use_sharding")
    return ctx.mesh


def _names(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _size(mesh, axis: str) -> int:
    from repro_torch.distributed.sharding import mesh_axes
    sizes = mesh_axes(mesh)
    if axis not in sizes:
        raise ValueError(f"mesh axis {axis!r} not in {tuple(sizes)}")
    return sizes[axis]


def axis_index(axes, mesh=None) -> int:
    """This rank's index over the named axes (row-major in their order)."""
    mesh = _mesh(mesh)
    idx = 0
    for a in _names(axes):
        n = _size(mesh, a)
        idx = idx * n + (mesh.get_local_rank(a) if n > 1 else 0)
    return idx


def _all_reduce(x: torch.Tensor, axes, op, mesh) -> torch.Tensor:
    mesh = _mesh(mesh)
    out = x
    for a in _names(axes):
        if _size(mesh, a) == 1:
            continue
        group = mesh.get_group(a)
        if _card_path(out, group):
            out = _card_reduce(out, group, op)
            continue
        if out is x:
            out = x.clone()               # all_reduce works in place
        dist.all_reduce(out, op=op, group=group)
    return out


def _psum(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    return _all_reduce(x, axes, dist.ReduceOp.SUM, mesh)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return _psum(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return _psum(g.contiguous(), ctx.axes, ctx.mesh), None, None


def _trivial(axes, mesh) -> bool:
    """Every named axis has size 1 (a collective over them is the
    identity)."""
    return all(_size(mesh, a) == 1 for a in _names(axes))


def psum(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """Sum over the ranks of the named axes (`jax.lax.psum`); its
    backward is `psum` (see the module's docstring)."""
    mesh = _mesh(mesh)
    if _trivial(axes, mesh):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _PSum.apply(x, axes, mesh)
    return _psum(x, axes, mesh)


def pmax(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """Elementwise max over the ranks of the named axes (`jax.lax.pmax`)."""
    return _all_reduce(x, axes, dist.ReduceOp.MAX, mesh)


def _gather1(x: torch.Tensor, group, n: int, axis: int) -> torch.Tensor:
    """Every rank's `x` of one group, concatenated along `axis` in rank
    order."""
    if _card_path(x, group):
        return _card_gather(x, group, axis)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=axis)


def _all_gather_tiled(x: torch.Tensor, axes, axis: int,
                      mesh) -> torch.Tensor:
    out = x
    # the last (minor) axis first: blocks land in row-major order
    for a in reversed(_names(axes)):
        n = _size(mesh, a)
        if n > 1:
            out = _gather1(out, mesh.get_group(a), n, axis)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, axis, mesh):
        ctx.axes, ctx.axis, ctx.mesh = axes, axis, mesh
        return _all_gather_tiled(x, axes, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return (_psum_scatter(g, ctx.axes, ctx.axis, ctx.mesh), None, None,
                None)


def all_gather(x: torch.Tensor, axes, axis: int = 0, tiled: bool = False,
               mesh=None) -> torch.Tensor:
    """`jax.lax.all_gather`: every rank's `x` over the named axes, stacked
    on a new dim `axis` (concatenated along `axis` when `tiled`), in
    device-index order.  Its backward is `psum_scatter` over the same
    axes."""
    mesh = _mesh(mesh)
    axis = axis % (x.ndim + (0 if tiled else 1))
    out = x if tiled else x.unsqueeze(axis)
    if _trivial(axes, mesh):
        return out
    if torch.is_grad_enabled() and out.requires_grad:
        return _AllGather.apply(out, axes, axis, mesh)
    return _all_gather_tiled(out, axes, axis, mesh)


def _psum_scatter(x: torch.Tensor, axes, axis: int, mesh) -> torch.Tensor:
    names = _names(axes)
    n = math.prod(_size(mesh, a) for a in names)
    if x.shape[axis] % n:
        raise ValueError(f"psum_scatter: dim {axis} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    first = next(a for a in names if _size(mesh, a) > 1)
    card = _card_path(x, mesh.get_group(first))
    if not card and dist.get_backend(mesh.get_group(first)) != "nccl":
        # gloo has no reduce-scatter: the sum, then this rank's block
        size = x.shape[axis] // n
        return _psum(x.contiguous(), names, mesh).narrow(
            axis, axis_index(names, mesh) * size, size).contiguous()
    out = x
    # the first (major) axis first: the transpose of all_gather's order
    for a in names:
        k = _size(mesh, a)
        if k == 1:
            continue
        send = out.movedim(axis, 0).contiguous()
        if card:
            got = _card_by_block(send, mesh.get_group(a), reduce=True)
        else:
            got = send.new_empty((send.shape[0] // k, *send.shape[1:]))
            dist.reduce_scatter_tensor(got, send, group=mesh.get_group(a))
        out = got.movedim(0, axis)
    return out.contiguous()


def psum_scatter(x: torch.Tensor, axes, axis: int = 0,
                 mesh=None) -> torch.Tensor:
    """`jax.lax.psum_scatter(tiled=True)`: the sum over the ranks of the
    named axes, of which this rank keeps block `axis_index(axes)` along
    `axis` (the transpose of a tiled `all_gather`).  Under gloo an
    `all_reduce` and the rank's block; under nccl `reduce_scatter_tensor`
    axis by axis, the major one first."""
    mesh = _mesh(mesh)
    axis %= x.ndim
    if _trivial(axes, mesh):
        return x
    return _psum_scatter(x, axes, axis, mesh)


class _AMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        m = _all_reduce(x.amax(), axes, dist.ReduceOp.MAX, mesh)
        ctx.save_for_backward(x, m)
        ctx.axes, ctx.mesh = axes, mesh
        return m

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        hit = (x == m).to(g.dtype)
        count = _psum(hit.sum(), ctx.axes, ctx.mesh)
        total = _psum(g.contiguous(), ctx.axes, ctx.mesh)
        return hit * (total / count), None, None


def amax(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """The max of every entry of `x` over the ranks of the named axes (a
    0-d tensor: `jnp.max` of the global tensor whose shards the ranks
    hold).  Its backward shares the summed cotangent among the entries
    equal to the max on every rank, as `jnp.max`'s gradient does."""
    mesh = _mesh(mesh)
    if _trivial(axes, mesh):
        return x.amax()
    if torch.is_grad_enabled() and x.requires_grad:
        return _AMax.apply(x, axes, mesh)
    return _all_reduce(x.amax(), axes, dist.ReduceOp.MAX, mesh)


def _stage_gather(ts: list, dims: list, a: str, mesh) -> list:
    """Every tensor of `ts` gathered (tiled) along its dim of `dims` over
    the mesh axis `a`, all in one collective: the local pieces, each with
    its dim moved first and flattened, packed into one buffer."""
    n = _size(mesh, a)
    if len(ts) == 1:
        return [_all_gather_tiled(ts[0], (a,), dims[0], mesh)]
    moved = [t.movedim(d, 0) for t, d in zip(ts, dims)]
    lens = [m.numel() for m in moved]
    buf = torch.cat([m.reshape(-1) for m in moved])
    allb = _gather1(buf, mesh.get_group(a), n, 0)
    total, out, off = buf.numel(), [], 0
    for m, d, ln in zip(moved, dims, lens):
        # each rank's piece in the tensor's own layout: the cat along
        # `d` is contiguous (a kernel may need unit strides)
        parts = [allb[r * total + off:r * total + off + ln].view(m.shape)
                 .movedim(0, d) for r in range(n)]
        out.append(torch.cat(parts, d))
        off += ln
    return out


def _stage_scatter(gs: list, dims: list, a: str, mesh) -> list:
    """The transpose of `_stage_gather`: each whole gradient's block of
    this rank along its dim, summed over the axis, in one collective (the
    blocks packed by destination)."""
    n = _size(mesh, a)
    if len(gs) == 1:
        return [_psum_scatter(gs[0], (a,), dims[0], mesh)]
    moved = [g.movedim(d, 0) for g, d in zip(gs, dims)]
    blocks = [m.reshape(n, -1) for m in moved]
    pack = torch.cat(blocks, 1).reshape(-1)
    mine = _psum_scatter(pack, (a,), 0, mesh)
    out, off = [], 0
    for m, b, d in zip(moved, blocks, dims):
        ln = b.shape[1]
        out.append(mine[off:off + ln].view(m.shape[0] // n, *m.shape[1:])
                   .movedim(0, d).contiguous())
        off += ln
    return out


def _batches(idx: list, ts: list, n: int) -> list:
    """`idx` ((tensor, dim) pairs) cut into batches whose gathered bytes
    stay within _CHUNK_BYTES; a larger tensor goes alone (its collective
    is chunked by the transport)."""
    out, cur, size = [], [], 0
    for i, d in idx:
        nb = ts[i].numel() * ts[i].element_size() * n
        if cur and size + nb > _CHUNK_BYTES:
            out.append(cur)
            cur, size = [], 0
        cur.append((i, d))
        size += nb
    return out + ([cur] if cur else [])


class _GatherMany(torch.autograd.Function):
    """`gather_many`'s gathers, batched by mesh axis (small tensors
    share one collective); the backward is the matching
    reduce-scatters."""

    @staticmethod
    def forward(ctx, plan, mesh, *ts):
        stages = []
        out = list(ts)
        for a in reversed(list(_mesh_names(mesh))):
            idx = [(i, d) for i, pairs in enumerate(plan)
                   for d, group in pairs if a in group]
            if not idx or _size(mesh, a) == 1:
                continue
            for batch in _batches(idx, out, _size(mesh, a)):
                got = _stage_gather([out[i] for i, _ in batch],
                                    [d for _, d in batch], a, mesh)
                for (i, _), t in zip(batch, got):
                    out[i] = t
                stages.append((a, batch))
        ctx.stages, ctx.mesh = stages, mesh
        ctx.like = [(t.shape, t.dtype, t.device) for t in out]
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        gs = [g if g is not None else torch.zeros(sh, dtype=dt, device=dv)
              for g, (sh, dt, dv) in zip(gs, ctx.like)]
        for a, batch in reversed(ctx.stages):
            got = _stage_scatter([gs[i].contiguous() for i, _ in batch],
                                 [d for _, d in batch], a, ctx.mesh)
            for (i, _), g in zip(batch, got):
                gs[i] = g
        return (None, None, *gs)


def gather_many(ts: list, plan: list, mesh=None) -> list:
    """Each tensor of `ts` gathered whole: `plan[i]` lists its sharded
    (dim, mesh axes) pairs; tiled along each dim over its axes in
    device-index order, as `all_gather(tiled=True)` would.  One
    collective a mesh axis for all of them (the minor axis first), each
    dtype apart; differentiable, the backward one reduce-scatter a mesh
    axis."""
    mesh = _mesh(mesh)
    plan = [tuple((d % t.ndim, _names(g)) for d, g in pairs)
            for t, pairs in zip(ts, plan)]
    out = list(ts)
    for dt in dict.fromkeys(t.dtype for t in ts):
        idx = [i for i, t in enumerate(ts) if t.dtype == dt and plan[i]]
        if not idx:
            continue
        got = _GatherMany.apply([plan[i] for i in idx], mesh,
                                *[ts[i] for i in idx])
        for i, t in zip(idx, got):
            out[i] = t
    return out


def psum_many(ts: list, axes_of: list, mesh=None) -> list:
    """`psum(ts[i], axes_of[i])` for every i, without gradients: tensors
    of one dtype and the same axes share a collective (packed within
    _CHUNK_BYTES a member); an empty axes tuple leaves its tensor."""
    mesh = _mesh(mesh)
    out = list(ts)
    keys = {}
    for i, (t, axes) in enumerate(zip(ts, axes_of)):
        axes = tuple(a for a in _names(axes) if _size(mesh, a) > 1)
        if axes:
            keys.setdefault((t.dtype, t.device, axes), []).append(i)
    for (_, _, axes), idx in keys.items():
        batch, size = [], 0
        for i in idx + [None]:
            nb = 0 if i is None else ts[i].numel() * ts[i].element_size()
            if batch and (i is None or size + nb > _CHUNK_BYTES):
                flat = _psum(torch.cat([ts[j].reshape(-1) for j in batch]),
                             axes, mesh)
                off = 0
                for j in batch:
                    n = ts[j].numel()
                    out[j] = flat[off:off + n].view(ts[j].shape)
                    off += n
                batch, size = [], 0
            if i is not None:
                batch.append(i)
                size += nb
    return out


def _mesh_names(mesh) -> tuple[str, ...]:
    from repro_torch.distributed.sharding import mesh_axes
    return tuple(mesh_axes(mesh))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, split_axis, concat_axis, mesh):
        ctx.args = (axis_name, split_axis, concat_axis, mesh)
        out = _all_to_all(x, axis_name, split_axis, concat_axis, True, mesh)
        return out.clone() if out is x else out

    @staticmethod
    def backward(ctx, g):
        axis_name, split_axis, concat_axis, mesh = ctx.args
        return (_all_to_all(g, axis_name, concat_axis, split_axis, True,
                            mesh), None, None, None, None)


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int, tiled: bool = False,
               mesh=None) -> torch.Tensor:
    """`jax.lax.all_to_all` over one mesh axis of n ranks: `x` splits into
    n blocks along `split_axis`, block i goes to rank i, and the received
    blocks are concatenated along `concat_axis` in source order (`tiled`),
    or, untiled, `split_axis` (of size n) is removed and the blocks
    stacked on a new `concat_axis`.  A tiled one's backward is the
    all_to_all with the two axes swapped."""
    mesh = _mesh(mesh)
    if tiled and torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, axis_name, split_axis % x.ndim,
                               concat_axis % x.ndim, mesh)
    return _all_to_all(x, axis_name, split_axis, concat_axis, tiled, mesh)


def _all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
                concat_axis: int, tiled: bool, mesh) -> torch.Tensor:
    n = _size(mesh, axis_name)
    split_axis %= x.ndim
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)}"
                         f" does not split over {n} ranks")
    if n == 1:
        recv = x
    else:
        send = x.movedim(split_axis, 0).contiguous()
        group = mesh.get_group(axis_name)
        if _card_path(send, group):
            got = _card_by_block(send, group, reduce=False)
        else:
            got = torch.empty_like(send)
            dist.all_to_all_single(got, send, group=group)
        recv = got.movedim(0, split_axis)
    blocks = recv.chunk(n, dim=split_axis)
    if tiled:
        return torch.cat(blocks, dim=concat_axis % x.ndim)
    if x.shape[split_axis] != n:
        raise ValueError("untiled all_to_all: the split dim must equal the "
                         "axis size")
    blocks = [b.squeeze(split_axis) for b in blocks]
    return torch.stack(blocks, dim=concat_axis % x.ndim)



# ---------------------------------------------------------------------------
# A toy sharded step against its one-process gradient (for tests)
# ---------------------------------------------------------------------------
def toy_grads(mesh, *, seed: int = 0, weigh_copies: bool = True,
              device="cpu") -> dict:
    """One toy train step on a ("data", "model") mesh, sharded by the
    conventions above, and the same step in one process: {leaf: (this
    rank's gradient shard, the one-process gradient's block of it)}.

    The step covers each rule: W1 (8, 6) sharded over "data" and gathered
    (replicated over "model": its gradient `psum`-med there), b (6,)
    replicated on every rank, a global activation full-scale `amax` over
    the batch rows (its gradient reaches the rank that holds the max), a
    tensor-parallel pair over "model" (W2 (6, 6) split by its columns,
    W3 (6, 4) by its rows, the partial products `psum`-med), and a
    vocab-parallel cross entropy (W4 (4, 8) split by its vocab columns:
    `models.layers.softmax_xent(vocab_axes=)`).  The batch rows split
    over "data"; the "model" ranks compute the same rows, so each rank's
    contribution is weighed by 1 / (data * model), unless `weigh_copies`
    is False (every model rank's copy then counts whole, the fault a test
    must catch).  The tensors lie on `device`."""
    from repro_torch.distributed.sharding import mesh_axes, use_sharding
    from repro_torch.models.layers import softmax_xent
    sizes = mesh_axes(mesh)
    nd, nm = sizes["data"], sizes["model"]
    g = torch.Generator().manual_seed(seed)
    whole = {"w1": torch.randn(8, 6, generator=g) * 0.5,
             "b": torch.randn(6, generator=g) * 0.1,
             "w2": torch.randn(6, 6, generator=g) * 0.5,
             "w3": torch.randn(6, 4, generator=g) * 0.5,
             "w4": torch.randn(4, 8, generator=g)}
    whole = {k: v.to(device) for k, v in whole.items()}
    x = torch.randn(4 * nd, 8, generator=g).to(device)
    labels = torch.randint(0, 8, (4 * nd,), generator=g).to(device)

    def loss_of(p, x, labels, s_of, psum_model, vocab_axes):
        h = torch.tanh(x @ p["w1"] + p["b"])
        s = s_of(h.abs())
        u = torch.tanh((h / s) @ p["w2"])
        y = psum_model(u @ p["w3"])
        nll = softmax_xent((y @ p["w4"])[:, None], labels[:, None],
                           vocab_axes=vocab_axes)
        return nll + 0.1 * s

    one = {k: v.clone().requires_grad_() for k, v in whole.items()}
    torch.autograd.backward(loss_of(one, x, labels, torch.amax,
                                    lambda t: t, ()))
    d, m = axis_index("data", mesh), axis_index("model", mesh)
    rows, k, v = x.shape[0] // nd, 6 // nm, 8 // nm
    cols, vcols = slice(m * k, (m + 1) * k), slice(m * v, (m + 1) * v)
    local = {"w1": whole["w1"][d * (8 // nd):(d + 1) * (8 // nd)],
             "b": whole["b"], "w2": whole["w2"][:, cols],
             "w3": whole["w3"][cols], "w4": whole["w4"][:, vcols]}
    local = {n: t.clone().requires_grad_() for n, t in local.items()}
    p = dict(local, w1=all_gather(local["w1"], "data", axis=0, tiled=True,
                                  mesh=mesh))
    lo = d * rows
    with use_sharding(mesh, {}):
        part = loss_of(p, x[lo:lo + rows], labels[lo:lo + rows],
                       lambda t: amax(t, "data", mesh),
                       lambda t: psum(t, "model", mesh), ("model",))
    part = part / (nd * (nm if weigh_copies else 1))
    torch.autograd.backward(part)
    grads = {"w1": psum(local["w1"].grad, "model", mesh),
             "b": psum(local["b"].grad, ("data", "model"), mesh)}
    grads.update({n: psum(local[n].grad, "data", mesh)
                  for n in ("w2", "w3", "w4")})
    want = {"w1": one["w1"].grad[d * (8 // nd):(d + 1) * (8 // nd)],
            "b": one["b"].grad, "w2": one["w2"].grad[:, cols],
            "w3": one["w3"].grad[cols], "w4": one["w4"].grad[:, vcols]}
    return {n: (grads[n], want[n]) for n in grads}
