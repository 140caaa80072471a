"""Wrapper of the SSD scan kernel (port of the reference's
`kernels/ssd_scan/ops.py`), with its plain PyTorch version beside it.

Shapes are model-land: x (B, L, H, P), loga (B, L, H), b and c (B, L, G, S)
with G head groups; the result is (y (B, L, H, P), state (B, H, S, P)).
The reference wrapper repeats b and c to heads, folds (B, H) and pads L to
the chunk multiple before its kernel; the CUDA kernel (`csrc/ssd_scan.cu`)
reads b and c by group and masks the ragged tail itself, so nothing is
copied here.  On CPU tensors `ssd_scan` runs the plain version
(`ref.ssd_chunked`); on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels
from repro_torch.kernels.ssd_scan import ref

QMAX = 128                      # longest chunk the kernel's tiles cover
LAUNCHES = kernels.LaunchCounter("ssd_scan")
plain = ref.ssd_chunked         # what the kernel computes, in PyTorch ops


def ssd_scan(x: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int = 128):
    """x: (B, L, H, P); loga: (B, L, H); b, c: (B, L, G, S), G dividing H
    (heads within a group share B/C, Mamba-2's GVA).

    Returns (y: (B, L, H, P), state: (B, H, S, P))."""
    if x.device.type == "cpu":
        return plain(x, loga, b, c, chunk)
    return launch(x, loga, b, c, chunk)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = kernels.library("ssd_scan")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [vp] * 6 + [i32] * 7 + [vp]
    lib.ssd_scan_launch.restype = i32
    lib.ssd_scan_smem_bytes.argtypes = [i32]
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def launch(x: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, chunk: int = 128):
    """Launch csrc/ssd_scan.cu on the current stream; raises on anything
    the kernel does not take or on a refused launch."""
    name = "ssd_scan"
    kernels.require_cuda(x, loga, b, c, name=name)
    if x.ndim != 4 or loga.ndim != 3 or b.ndim != 4 or c.ndim != 4:
        raise ValueError(f"{name}: expected x (B, L, H, P), loga (B, L, H), "
                         "b and c (B, L, G, S)")
    bsz, l, h, p = x.shape
    g, s_dim = b.shape[2], b.shape[3]
    if tuple(loga.shape) != (bsz, l, h) or tuple(b.shape) != \
            tuple(c.shape) or tuple(b.shape[:2]) != (bsz, l):
        raise ValueError(f"{name}: shapes disagree: x {tuple(x.shape)}, "
                         f"loga {tuple(loga.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)}")
    if h % g:
        raise ValueError(f"{name}: {g} groups do not divide {h} heads")
    if not 1 <= chunk <= QMAX:
        raise ValueError(f"{name}: chunk={chunk} outside 1..{QMAX}")
    if not all(t.is_contiguous() for t in (x, loga, b, c)):
        raise ValueError(f"{name}: operands must be contiguous")
    lib = _lib()
    if lib.ssd_scan_smem_bytes(s_dim) > 232448:
        raise ValueError(f"{name}: d_state={s_dim} needs more than the "
                         "227 KB of shared memory a block can have")
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, s_dim, p), dtype=torch.float32,
                        device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssd_scan_launch(
            x.data_ptr(), loga.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), state.data_ptr(), bsz, l, h, p, g, s_dim, chunk,
            stream)
    kernels.check_launch(rc, name)
    LAUNCHES.add()
    return y, state
