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
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.models.module import leaves, unflatten


def _key(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_key(path): t.detach().cpu().numpy()
            for path, t in leaves(tree)}


def save(root: str, step: int, tree: Any, meta: dict | None = None) -> str:
    """Atomic save; returns the final directory."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp-", dir=root)
    try:
        flat = _flatten(tree)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
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


def restore(root: str, step: int, like: Any, device=None) -> Any:
    """Restore into the structure, shapes and dtypes of `like` (tensors,
    `meta` ones included), on `device` (default: each leaf's own device,
    the CPU for a `meta` leaf).  A shape that differs raises."""
    d = os.path.join(root, f"step_{step:08d}")
    with np.load(os.path.join(d, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    out = []
    for path, leaf in leaves(like):
        key = _key(path)
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"ckpt {arr.shape} vs model {tuple(leaf.shape)}")
        dev = device if device is not None else (
            "cpu" if leaf.device.type == "meta" else leaf.device)
        out.append((path, torch.from_numpy(arr).to(dev, leaf.dtype)))
    return unflatten(out)


def read_meta(root: str, step: int) -> dict:
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


class CheckpointManager:
    """save-every-N + keep-K policy around save/restore."""

    def __init__(self, root: str, every: int = 100, keep: int = 3):
        self.root, self.every, self.keep = root, every, keep

    def maybe_save(self, step: int, tree: Any,
                   meta: dict | None = None) -> str | None:
        if step % self.every:
            return None
        path = save(self.root, step, tree, meta)
        self._gc()
        return path

    def _gc(self) -> None:
        for s in sorted(_steps(self.root))[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    def latest(self) -> int | None:
        return latest_step(self.root)
