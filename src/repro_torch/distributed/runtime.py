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

Under gloo the collectives run on the card's tensors directly: gloo takes
`all_reduce`, `all_gather` and `all_to_all_single` on CUDA tensors (torch
2.11).  A gloo build that refused one would raise in the collective.
"""

from __future__ import annotations

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
        if backend != "gloo":
            raise ValueError("ranks on the CPU need the gloo backend")
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device type {device_type!r}: cpu or cuda")
    if not torch.cuda.is_available():
        raise RuntimeError("device type 'cuda' but no CUDA device is "
                           "visible")
    if backend == "gloo":
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
    if backend == "gloo":
        # the ranks talk over the loopback interface (one host)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def _rank_main(fn, rank: int, world: int, device_type: str, backend: str,
               init_method: str, args: tuple, results) -> None:
    try:
        device = init_ranks(world, device_type, backend, rank=rank,
                            init_method=init_method)
        out = fn(rank, world, device, *args)
        dist.barrier()
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
        if out is x:
            out = x.clone()               # all_reduce works in place
        dist.all_reduce(out, op=op, group=mesh.get_group(a))
    return out


def psum(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """Sum over the ranks of the named axes (`jax.lax.psum`)."""
    return _all_reduce(x, axes, dist.ReduceOp.SUM, mesh)


def pmax(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """Elementwise max over the ranks of the named axes (`jax.lax.pmax`)."""
    return _all_reduce(x, axes, dist.ReduceOp.MAX, mesh)


def _gather1(x: torch.Tensor, group, n: int, axis: int) -> torch.Tensor:
    """Every rank's `x` of one group, concatenated along `axis` in rank
    order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=axis)


def all_gather(x: torch.Tensor, axes, axis: int = 0, tiled: bool = False,
               mesh=None) -> torch.Tensor:
    """`jax.lax.all_gather`: every rank's `x` over the named axes, stacked
    on a new dim `axis` (concatenated along `axis` when `tiled`), in
    device-index order."""
    mesh = _mesh(mesh)
    axis = axis % (x.ndim + (0 if tiled else 1))
    out = x if tiled else x.unsqueeze(axis)
    # the last (minor) axis first: blocks land in row-major order
    for a in reversed(_names(axes)):
        n = _size(mesh, a)
        if n > 1:
            out = _gather1(out, mesh.get_group(a), n, axis)
    return out


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int, tiled: bool = False,
               mesh=None) -> torch.Tensor:
    """`jax.lax.all_to_all` over one mesh axis of n ranks: `x` splits into
    n blocks along `split_axis`, block i goes to rank i, and the received
    blocks are concatenated along `concat_axis` in source order (`tiled`),
    or, untiled, `split_axis` (of size n) is removed and the blocks
    stacked on a new `concat_axis`."""
    mesh = _mesh(mesh)
    n = _size(mesh, axis_name)
    split_axis %= x.ndim
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)}"
                         f" does not split over {n} ranks")
    if n == 1:
        recv = x
    else:
        send = x.movedim(split_axis, 0).contiguous()
        got = torch.empty_like(send)
        dist.all_to_all_single(got, send, group=mesh.get_group(axis_name))
        recv = got.movedim(0, split_axis)
    blocks = recv.chunk(n, dim=split_axis)
    if tiled:
        return torch.cat(blocks, dim=concat_axis % x.ndim)
    if x.shape[split_axis] != n:
        raise ValueError("untiled all_to_all: the split dim must equal the "
                         "axis size")
    blocks = [b.squeeze(split_axis) for b in blocks]
    return torch.stack(blocks, dim=concat_axis % x.ndim)

