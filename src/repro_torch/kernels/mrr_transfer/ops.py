"""Wrapper of the MRR transfer kernel (port of the reference's
`kernels/mrr_transfer/ops.py`), with its plain PyTorch version beside it.

`mrr_transfer(w, key, sigma_dac, sigma_th, p, var=None, eps=None)` realizes
target weights of any shape on the noisy MRR chain.  The (DAC, thermal)
N(0, 1) draws come from `eps` or from `key`, split as `mrr.draw_eps` (and
so `core.mrr.realize_weights`) splits it: the kernel and the plain chain
consume the same draws from the same key.  The reference wrapper pads the
weights to an (8, 128)-tiled sheet for its TPU kernel and draws its noise
on that sheet; the CUDA kernel (`csrc/mrr_transfer.cu`) takes flat streams
of any length, so nothing is padded or copied here.

On CPU tensors `mrr_transfer` runs `plain` (`ref.mrr_transfer_ref`); on
CUDA tensors it launches the kernel or raises.  The CUDA path is a
`torch.autograd.Function` with no backward kernel: the reference has none
either (JAX differentiates its jnp chain), and gradients through the
realization on the card wait for variation-aware QAT.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels
from repro_torch.core import mrr
from repro_torch.kernels.mrr_transfer import ref

THREADS = 256            # threads per block of csrc/mrr_transfer.cu
BLOCKS_PER_SM = 8        # grid-stride cap: blocks per SM
LAUNCHES = kernels.LaunchCounter("mrr_transfer")
plain = ref.mrr_transfer_ref    # what the kernel computes, in PyTorch ops


def mrr_transfer(w: torch.Tensor, key: torch.Generator | None = None,
                 sigma_dac: float = 0.02, sigma_th: float = 0.04,
                 p: mrr.MRRParams = mrr.DEFAULT_PARAMS,
                 var: mrr.StaticVariation | None = None,
                 eps: tuple[torch.Tensor, torch.Tensor] | None = None
                 ) -> torch.Tensor:
    """Noisy MRR realization of target weights `w`, any shape.

    With a non-zero sigma the draws are `eps` or, without it, drawn from
    `key` on `w`'s device; `var` (a chip's static variation) broadcasts
    against `w`.  Returns the realized weights, `w`'s shape."""
    noise = mrr.NoiseModel(sigma_dac, sigma_th)
    if noise.is_ideal:
        eps = None
    elif eps is None:
        if key is None:
            raise ValueError("noisy realization requires a key or injected "
                             "draws")
        eps = mrr.draw_eps(key, w.shape, w.device, w.dtype)
    e_dac, e_th = eps if eps is not None else (None, None)
    if w.device.type == "cpu":
        return plain(w, e_dac, e_th, sigma_dac, sigma_th, p, var)
    return _Transfer.apply(w, e_dac, e_th, sigma_dac, sigma_th, p, var)


class _Transfer(torch.autograd.Function):
    """The kernel launch; no backward kernel exists."""

    @staticmethod
    def forward(ctx, w, e_dac, e_th, sigma_dac, sigma_th, p, var):
        return launch(w, e_dac, e_th, sigma_dac, sigma_th, p, var)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "mrr_transfer has no backward kernel on CUDA: gradients through "
            "the MRR realization on the card wait for variation-aware QAT "
            "(ROADMAP.md, Queue 1)")


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _lib():
    lib = kernels.library("mrr_transfer")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mrr_transfer_launch.argtypes = [
        vp, vp, vp, ctypes.POINTER(vp), ctypes.POINTER(i64), vp, i64, i64,
        ctypes.c_float, ctypes.c_float, ctypes.POINTER(ctypes.c_float), i32,
        i32, vp]
    lib.mrr_transfer_launch.restype = i32
    return lib


def _sheet(shape) -> tuple[int, int]:
    """(rows, cols) of the 2-D view the variation strides refer to."""
    cols = int(shape[-1]) if len(shape) else 1
    n = 1
    for d in shape:
        n *= int(d)
    return (n // cols if cols else 0), cols


def _variation(var: mrr.StaticVariation, w: torch.Tensor, name: str):
    """(pointer array, stride array, tensors) of the three static fields,
    each a broadcast view of `w`'s shape seen as (rows, cols): a per-lane
    field keeps stride 0 along the axis it is constant on.  (Against a
    weight of rank 3 or more the reshape may copy; the caller holds the
    returned tensors until the launch is enqueued.)"""
    rows, cols = _sheet(w.shape)
    ptrs = (ctypes.c_void_p * 3)()
    strides = (ctypes.c_longlong * 6)()
    fields = []
    for s, f in enumerate((var.dv, var.ddt, var.dlam)):
        kernels.require_cuda(f, name=name)
        v = torch.broadcast_to(f, w.shape).reshape(rows, cols)
        fields.append(v)
        ptrs[s] = v.data_ptr()
        strides[2 * s], strides[2 * s + 1] = v.stride()
    return ptrs, strides, fields


def launch(w: torch.Tensor, e_dac: torch.Tensor | None = None,
           e_th: torch.Tensor | None = None, sigma_dac: float = 0.02,
           sigma_th: float = 0.04, p: mrr.MRRParams = mrr.DEFAULT_PARAMS,
           var: mrr.StaticVariation | None = None) -> torch.Tensor:
    """Launch csrc/mrr_transfer.cu on the current stream; raises on anything
    the kernel does not take or on a refused launch."""
    name = "mrr_transfer"
    noisy = not mrr.NoiseModel(sigma_dac, sigma_th).is_ideal
    if noisy != (e_dac is not None) or (e_dac is None) != (e_th is None):
        raise ValueError(f"{name}: the draws must be given exactly when a "
                         "sigma is non-zero")
    streams = [w] + ([e_dac, e_th] if noisy else [])
    kernels.require_cuda(*streams, name=name)
    for t in streams[1:]:
        if t.shape != w.shape:
            raise ValueError(f"{name}: draws of shape {tuple(t.shape)} for "
                             f"weights of shape {tuple(w.shape)}")
    if not all(t.is_contiguous() for t in streams):
        raise ValueError(f"{name}: w and the draws must be contiguous")
    vp = vs = None
    if var is not None:
        vp, vs, fields = _variation(var, w, name)
    out = torch.empty_like(w)
    n = w.numel()
    _, cols = _sheet(w.shape)
    vec = int(all(t.data_ptr() % 16 == 0 for t in streams + [out]))
    values = mrr.chain_constants(p).values()
    chain = (ctypes.c_float * len(values))(*values)
    lib = _lib()
    n_sm = torch.cuda.get_device_properties(w.device).multi_processor_count
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mrr_transfer_launch(
            w.data_ptr(), e_dac.data_ptr() if noisy else None,
            e_th.data_ptr() if noisy else None, vp, vs, out.data_ptr(), n,
            max(cols, 1), sigma_dac, sigma_th, chain, vec, n_sm, stream)
    kernels.check_launch(rc, name)
    LAUNCHES.add()
    return out


def preflight(n_elements: int, *, n_sm: int = 132, noisy: bool = True
              ) -> dict:
    """What `launch` would run for `n_elements` weights on an H100, without
    launching: the grid-stride grid (four elements a thread), the bytes the
    kernel moves (w in, out, and the two draws when `noisy`), and no
    padding (the kernel bounds-checks flat streams)."""
    issues: list[str] = []
    if n_elements <= 0:
        issues.append(f"non-positive size n_elements={n_elements}")
        return {"kernel": "mrr_transfer", "grid": (0,), "smem_bytes": 0,
                "bytes": 0, "pad_waste": 0.0, "issues": issues}
    want = max(1, -(-(n_elements // 4) // THREADS))
    grid = min(want, n_sm * BLOCKS_PER_SM)
    return {"kernel": "mrr_transfer", "grid": (grid,), "smem_bytes": 0,
            "bytes": (16 if noisy else 8) * n_elements, "pad_waste": 0.0,
            "issues": issues}
