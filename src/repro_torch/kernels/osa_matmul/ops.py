"""Wrapper of the OSA matmul kernel (port of the reference's
`kernels/osa_matmul/ops.py`), with its plain PyTorch version beside it.

`osa_matmul` quantizes float activations (optionally per row), runs the
integer contract `osa_matmul_int` and dequantizes by scale / qmax.  The
integer contract is the kernel's:

    y = sum_t g_t * plane_t(q) @ w,   plane_t(q) = sign(q) * ((|q| >> t) & 1)

in the fused mode (the gains fold into one recombined operand before one
contraction) or the per-plane mode (one contraction per plane).  Like the
reference kernel it extracts binary planes whatever `pam_bits` is; with
pam_bits > 1 and the radix-2^k gain ladder that is not the PAM
decomposition of `ref.py` (a reference behaviour this port keeps).

On CPU tensors the wrapper runs `plain`; on CUDA tensors it launches
`csrc/osa_matmul.cu` or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels
from repro_torch.core import quant as Q

# Tile of the CUDA kernel (csrc/osa_matmul.cu): BM x BN outputs, BK lanes.
BM, BN, BK = 8, 128, 32
LAUNCHES = kernels.LaunchCounter("osa_matmul")


def osa_matmul(x: torch.Tensor, w: torch.Tensor,
               gains: torch.Tensor | None = None, *, quant_bits: int = 8,
               pam_bits: int = 1, fused: bool = True,
               per_vector: bool = False) -> torch.Tensor:
    """Float activations -> quantize -> OSA contraction -> dequantize.
    x (M, K), w (K, N); returns (M, N) float32."""
    cfg = Q.QuantConfig(bits=quant_bits)
    q, scale = Q.quantize(x.float(), cfg, per_vector=per_vector)
    n_planes = -(-cfg.n_planes // pam_bits)
    if gains is None:
        gains = Q.pam_plane_weights(pam_bits, cfg, device=x.device)
    y = osa_matmul_int(q, w, gains, n_planes=n_planes, fused=fused)
    return y * (scale / cfg.qmax)


def osa_matmul_int(q: torch.Tensor, w: torch.Tensor, gains: torch.Tensor,
                   *, n_planes: int, fused: bool = True) -> torch.Tensor:
    """Integer-activation entry point (the kernel's native contract)."""
    if q.device.type == "cpu":
        return plain(q.float(), w.float(), gains.float(), n_planes=n_planes,
                     fused=fused)
    return launch(q, w, gains, n_planes=n_planes, fused=fused)


def _planes(qf: torch.Tensor, n_planes: int) -> list[torch.Tensor]:
    sign = torch.sign(qf)
    mag = qf.abs().to(torch.int32)
    return [sign * ((mag >> t) & 1).to(qf.dtype) for t in range(n_planes)]


def plain(q: torch.Tensor, w: torch.Tensor, gains: torch.Tensor, *,
          n_planes: int, fused: bool = True) -> torch.Tensor:
    """What the kernel computes, in PyTorch ops."""
    planes = _planes(q, n_planes)
    if fused:
        x_eff = torch.zeros_like(q)
        for t, pl in enumerate(planes):
            x_eff = x_eff + gains[t] * pl
        return x_eff @ w
    y = torch.zeros((q.shape[0], w.shape[1]), dtype=q.dtype, device=q.device)
    for t, pl in enumerate(planes):
        y = y + gains[t] * (pl @ w)
    return y


@functools.lru_cache(maxsize=None)
def _lib():
    lib = kernels.library("osa_matmul")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.osa_matmul_splits.argtypes = [i32, i32, i32, i32]
    lib.osa_matmul_splits.restype = i32
    lib.osa_matmul_launch.argtypes = [vp] * 5 + [i32] * 9 + [vp]
    lib.osa_matmul_launch.restype = i32
    return lib


def launch(q: torch.Tensor, w: torch.Tensor, gains: torch.Tensor, *,
           n_planes: int, fused: bool = True) -> torch.Tensor:
    """Launch csrc/osa_matmul.cu on the current stream; raises on anything
    the kernel does not take or on a refused launch."""
    name = "osa_matmul"
    kernels.require_cuda(q, w, gains, name=name)
    if q.ndim != 2 or w.ndim != 2 or q.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: bad shapes {tuple(q.shape)} @ "
                         f"{tuple(w.shape)}")
    if q.stride(1) != 1 or w.stride(1) != 1:
        raise ValueError(f"{name}: q and w need unit column stride")
    if not 1 <= n_planes <= 8:
        raise ValueError(f"{name}: n_planes={n_planes} outside 1..8")
    if gains.ndim != 1 or gains.shape[0] < n_planes \
            or not gains.is_contiguous():
        raise ValueError(f"{name}: gains must hold {n_planes} values")
    m, k = q.shape
    n = w.shape[1]
    lib = _lib()
    out = torch.empty((m, n), dtype=torch.float32, device=q.device)
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = lib.osa_matmul_splits(m, k, n, n_sm)
    work = (torch.empty(splits * m * n, dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.osa_matmul_launch(
            q.data_ptr(), w.data_ptr(), gains.data_ptr(), out.data_ptr(),
            work.data_ptr() if work is not None else None, m, k, n,
            q.stride(0), w.stride(0), n, n_planes, int(fused), splits,
            stream)
    kernels.check_launch(rc, name)
    LAUNCHES.add()
    return out


def preflight(m: int, k: int, n: int, *, n_sm: int = 132,
              quant_bits: int = 8, pam_bits: int = 1) -> dict:
    """What `launch` would run for an (m, k, n) GEMM on an H100, without
    launching: grid (N tiles, M tiles, K splits), static shared memory per
    block against the 227 KB limit, and the fraction of multiply-adds the
    ragged tile edges waste."""
    n_planes = -(-Q.QuantConfig(bits=quant_bits).n_planes // pam_bits)
    issues: list[str] = []
    if min(m, k, n) <= 0:
        return {"kernel": "osa_matmul", "grid": (0, 0, 0), "smem_bytes": 0,
                "pad_waste": 0.0,
                "issues": [f"non-positive dimension in m,k,n={m},{k},{n}"]}
    if n_planes > 8:
        issues.append(f"{n_planes} planes exceed the kernel's 8")
    tiles = -(-m // BM) * -(-n // BN)
    splits = max(1, min(-(-2 * n_sm // tiles), -(-k // BK)))
    smem = 4 * (8 * BM * BK + BK * BN + 8)
    if smem > 232448:
        issues.append(f"{smem} bytes of shared memory exceed 227 KB")
    pad_waste = (-(-m // BM) * BM * -(-n // BN) * BN) / (m * n) - 1.0
    return {"kernel": "osa_matmul", "grid": (-(-n // BN), -(-m // BM), splits),
            "smem_bytes": smem, "pad_waste": pad_waste, "issues": issues}
