"""Atomic, keep-K checkpointing in the reference's on-disk layout
(PyTorch port of `repro.checkpoint.checkpoint`), one directory per step:

    <root>/step_00000123.tmp-<nonce>/   written first
        arrays.npz                      flat {"a/b/c": ndarray}
        manifest.json                   step, keys, shapes, dtypes, meta
    <root>/step_00000123/               renamed on completion

The keys are the `/`-joined dict paths in sorted order, as the
reference's `tree_flatten_with_path` names them, so a checkpoint written
by either package restores in the other.  Arrays are stored whole
(gathered to the host); `restore` places them on the device asked for.
The npz is written as `np.savez` writes it (a stored zip of `<key>.npy`
members, zip64 forced), one array at a time, so the host holds one leaf
at most.

Across ranks (`specs`, the tree's `PartitionSpec`s on a live `mesh`)
every rank calls `save` and `restore` with its shards: `save` gathers one
leaf at a time whole and rank 0 writes it, so the files are the
one-process files (each member and the manifest byte for byte); `restore`
has each rank map a leaf (a stored member, read in place) and copy out
its shard, so a rank reads about its shard's bytes.  A checkpoint
therefore moves between device counts in both directions.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import tempfile
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.models.module import leaves, unflatten


def _key(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def _write_npz(path: str, items) -> dict:
    """`np.savez(path, **dict(items))` written one array at a time;
    returns {key: (shape, dtype)} in the order written."""
    import zipfile
    info = {}
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in items:
            arr = np.asanyarray(arr)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=True)
            info[key] = (list(arr.shape), str(arr.dtype))
    return info


def _host_items(tree, specs=None, mesh=None):
    """(key, host array) of every leaf, gathered whole leaf by leaf when
    the tree holds shards (every rank must draw the items)."""
    spec_of = dict(leaves(specs)) if specs is not None else None
    for path, t in leaves(tree):
        if spec_of is not None:
            from repro_torch.distributed.sharding import gather
            t = gather(t.detach(), spec_of[path], mesh)
        yield _key(path), t.detach().cpu().numpy()


def save(root: str, step: int, tree: Any, meta: dict | None = None, *,
         specs=None, mesh=None) -> str | None:
    """Atomic save; returns the final directory.  Across ranks (`specs`
    on `mesh`) every rank calls it with its shards and rank 0 writes
    (the others return None once it has)."""
    items = _host_items(tree, specs, mesh)
    if specs is None:
        return _save_items(root, step, items, meta)
    import torch.distributed as dist
    final = None
    if dist.get_rank() == 0:
        final = _save_items(root, step, items, meta)
    else:
        for _ in items:                 # the gathers every rank joins
            pass
    dist.barrier()
    return final


def _save_items(root: str, step: int, items, meta: dict | None) -> str:
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp-", dir=root)
    try:
        info = _write_npz(os.path.join(tmp, "arrays.npz"), items)
        manifest = {
            "step": step,
            "keys": sorted(info),
            "shapes": {k: v[0] for k, v in info.items()},
            "dtypes": {k: v[1] for k, v in info.items()},
            "meta": meta or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomicity boundary
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _steps(root: str) -> list[int]:
    """Completed steps under `root` (no `.tmp-` directory)."""
    return [int(d.split("_")[1]) for d in os.listdir(root)
            if d.startswith("step_") and ".tmp-" not in d]


def latest_step(root: str) -> int | None:
    if not os.path.isdir(root):
        return None
    steps = [s for s in _steps(root) if os.path.exists(
        os.path.join(root, f"step_{s:08d}", "manifest.json"))]
    return max(steps) if steps else None


def _mapped(path: str, zf: zipfile.ZipFile, name: str) -> np.ndarray | None:
    """The array of a stored `.npy` member of the npz at `path`, mapped
    where it lies in the file (copy-on-write: the file is never written;
    no copy, no CRC pass); None for a compressed or small member."""
    info = zf.getinfo(name)
    if info.compress_type != zipfile.ZIP_STORED or info.file_size < 1 << 20:
        return None
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        head = f.read(30)                 # the member's local header
        n, m = struct.unpack("<HH", head[26:30])
        f.seek(info.header_offset + 30 + n + m)
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read(f)
        offset = f.tell()
    if dtype.hasobject:
        return None
    return np.memmap(path, dtype=dtype, mode="c", offset=offset, shape=shape,
                     order="F" if fortran else "C")


def restore(root: str, step: int, like: Any, device=None, *, specs=None,
            mesh=None) -> Any:
    """Restore into the structure, shapes and dtypes of `like` (tensors,
    `meta` ones included), on `device` (default: each leaf's own device,
    the CPU for a `meta` leaf).  A shape that differs raises.  Across
    ranks (`specs` on `mesh`) `like` holds this rank's shards: each leaf,
    one at a time, is mapped (`_mapped`) and the rank's shard copied
    out."""
    from repro_torch.distributed.sharding import local_shape, shard_local
    d = os.path.join(root, f"step_{step:08d}")
    spec_of = dict(leaves(specs)) if specs is not None else None
    out = []
    npz = os.path.join(d, "arrays.npz")
    with np.load(npz) as z:
        for path, leaf in leaves(like):
            key = _key(path)
            arr = _mapped(npz, z.zip, key + ".npy") if spec_of is not None \
                else None
            if arr is None:
                arr = z[key]
            want = tuple(arr.shape) if spec_of is None else local_shape(
                arr.shape, spec_of[path], mesh)
            if want != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs model {tuple(leaf.shape)}")
            t = torch.from_numpy(arr)
            if spec_of is not None:
                # a view: the clone below reads the shard's pages only
                t = shard_local(t, spec_of[path], mesh)
            dev = device if device is not None else (
                "cpu" if leaf.device.type == "meta" else leaf.device)
            out.append((path, t.to(dev, leaf.dtype).clone()
                        if spec_of is not None else t.to(dev, leaf.dtype)))
    return unflatten(out)


def read_meta(root: str, step: int) -> dict:
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


class CheckpointManager:
    """save-every-N + keep-K policy around save/restore."""

    def __init__(self, root: str, every: int = 100, keep: int = 3):
        self.root, self.every, self.keep = root, every, keep

    def maybe_save(self, step: int, tree: Any, meta: dict | None = None,
                   *, specs=None, mesh=None) -> str | None:
        if step % self.every:
            return None
        path = save(self.root, step, tree, meta, specs=specs, mesh=mesh)
        if path is not None:
            self._gc()
        return path

    def _gc(self) -> None:
        for s in sorted(_steps(self.root))[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    def latest(self) -> int | None:
        return latest_step(self.root)
