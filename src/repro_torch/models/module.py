"""Minimal functional module system: parameter skeletons (PyTorch port of
`repro.models.module`).

A model first builds a *skeleton* (nested dict of ParamDef) and derives:

  * init_params(skel, generator)  -> nested dict of tensors (real init)
  * abstract_params(skel)         -> nested dict of `meta` tensors (shapes
                                     only; tracing runs no arithmetic)
  * param_count(skel)

Leaves are visited in sorted-key order, the order of the reference's
pytree flattening.  Linear layers route their contractions through a
`rosa.Engine`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis per dim
    init: str = "normal"                  # normal | zeros | ones
    scale: float | None = None            # stddev override

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")

    @property
    def std(self) -> float:
        """Normal-init stddev: `scale`, else 1/sqrt(first dim) (last dim
        for vectors), as the reference initializes."""
        if self.scale is not None:
            return self.scale
        return 1.0 / math.sqrt(max(1, self.shape[0] if len(self.shape) > 1
                                   else self.shape[-1]))


def leaves(skel, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs of a nested dict, keys sorted at every level."""
    if isinstance(skel, dict):
        for k in sorted(skel):
            yield from leaves(skel[k], prefix + (k,))
    else:
        yield prefix, skel


def unflatten(pairs) -> dict:
    """The nested dict of (path, leaf) pairs (`leaves`' inverse)."""
    out: dict = {}
    for path, t in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def map_tree(fn: Callable, skel):
    """Nested dict with `fn(leaf)` at every leaf."""
    if isinstance(skel, dict):
        return {k: map_tree(fn, v) for k, v in skel.items()}
    return fn(skel)


def init_params(skel, generator: torch.Generator, dtype=torch.float32,
                device=None) -> dict:
    """Real parameters: zeros/ones, or N(0, std^2) drawn from `generator`
    leaf after leaf in sorted-key order.  The generator must live on
    `device` (or on the CPU when `device` is None)."""
    return unflatten(init_leaves(skel, generator, dtype, device))


def init_leaves(skel, generator: torch.Generator, dtype=torch.float32,
                device=None) -> Iterator[tuple[tuple, torch.Tensor]]:
    """`init_params`' (path, tensor) pairs, one leaf made at a time (a
    caller that keeps a shard of each holds one whole leaf at most)."""
    for path, d in leaves(skel):
        if d.init == "zeros":
            t = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            t = torch.ones(d.shape, dtype=dtype, device=device)
        else:
            t = torch.randn(d.shape, generator=generator, device=device)
            t = t.mul_(d.std).to(dtype)
        yield path, t


def abstract_params(skel, dtype=torch.bfloat16) -> dict:
    return map_tree(lambda d: torch.empty(d.shape, dtype=dtype,
                                          device="meta"), skel)


def param_count(skel) -> int:
    return sum(math.prod(d.shape) for _, d in leaves(skel))
