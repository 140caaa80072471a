"""Gradient compression: bfloat16 on the wire with float32 error feedback
(PyTorch port of `repro.distributed.compress`).

`compress` rounds each gradient, plus the residual carried from the last
step, to bfloat16 and keeps the rounding error as the new residual, so
the long-run update stays unbiased.  On one device there is no
all-reduce to halve: the step applies the same rounding and feedback,
elementwise, and the numbers are the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.models.module import leaves, map_tree, unflatten


def init_error_state(params) -> dict:
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress(grads, err_state):
    """-> (bfloat16 grads, new float32 error state)."""
    g16, err = [], []
    for (path, g), (_, e) in zip(leaves(grads), leaves(err_state),
                                 strict=True):
        g32 = g.float() + e
        q = g32.to(torch.bfloat16)
        g16.append((path, q))
        err.append((path, g32 - q.float()))
    return unflatten(g16), unflatten(err)


def decompress(grads16):
    return map_tree(lambda g: g.float(), grads16)
