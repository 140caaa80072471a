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

On CPU and `meta` tensors the wrapper runs `plain`; on CUDA tensors it
launches `csrc/osa_matmul.cu` or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels
from repro_torch.kernels import skinny
from repro_torch.core import quant as Q

# Tile of the tall path of the CUDA kernel (csrc/osa_matmul.cu, M > 16):
# BM x BN outputs, BK lanes; M <= 16 takes the decode path (kernels.skinny).
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
    if kernels.runs_plain(q):
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
    lib.osa_matmul_launch.argtypes = [vp] * 6 + [i32] * 10 + [vp]
    lib.osa_matmul_launch.restype = i32
    return lib


@functools.lru_cache(maxsize=256)
def plan(m: int, k: int, n: int, *, n_sm: int = 132, fused: bool = True,
         n_planes: int = 7) -> dict:
    """The launch `launch` makes for an (m, k, n) contraction: the decode
    path for m <= 16 (`skinny.decode_plan`; the per-plane mode stages its
    planes), else the tall path (BM x BN tiles on grid (N tiles, M tiles
    capped at 65535, K splits); blocks take the M tiles past the cap in
    turn, and K splits until there are about two blocks per SM).  Cached
    per shape: do not modify the dict."""
    if m <= skinny.MAX_M:
        return skinny.decode_plan(m, k, n, n_sm=n_sm,
                                  planes=1 if fused else n_planes)
    cdiv = skinny.cdiv
    tiles = cdiv(m, BM) * cdiv(n, BN)
    splits = max(1, min(cdiv(2 * n_sm, tiles), cdiv(k, BK)))
    k_per_split = cdiv(cdiv(k, splits), BK) * BK
    splits = cdiv(k, k_per_split)
    return {"path": "tall",
            "grid": (cdiv(n, BN), min(cdiv(m, BM), skinny.MAX_GRID_Y),
                     splits),
            "splits": splits, "k_per_split": k_per_split, "n_tile": BN,
            "smem_bytes": 4 * (8 * BM * BK + BK * BN + 8),
            "operand_floats": 0,
            "part_floats": splits * m * n if splits > 1 else 0}


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    dev = q.device
    pl = plan(m, k, n, n_sm=_n_sm(dev.index), fused=fused,
              n_planes=n_planes)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    xr, part = (torch.empty(pl[key], dtype=torch.float32, device=dev)
                if pl[key] else None
                for key in ("operand_floats", "part_floats"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.osa_matmul_launch(
            q.data_ptr(), w.data_ptr(), gains.data_ptr(), out.data_ptr(),
            xr.data_ptr() if xr is not None else None,
            part.data_ptr() if part is not None else None, m, k, n,
            q.stride(0), w.stride(0), n, n_planes, int(fused),
            pl["splits"], pl["k_per_split"], stream)
    kernels.check_launch(rc, name)
    LAUNCHES.add()
    return out


def preflight(m: int, k: int, n: int, *, n_sm: int = 132,
              quant_bits: int = 8, pam_bits: int = 1,
              fused: bool = True) -> dict:
    """What `launch` would run for an (m, k, n) GEMM on an H100, without
    launching: the path (decode for m <= 16, else tall), grid (N tiles,
    K splits, 1) or (N tiles, M tiles, K splits), the K split, the N tile,
    shared memory per block against the 227 KB limit (dynamic on the
    decode path: the 6-stage ring; two fused blocks share an SM, so about
    twice that is in flight per SM), the workspaces and the fraction of
    multiply-adds the ragged tile edges waste (rows are never padded on
    the decode path: its kernel is templated on m)."""
    n_planes = -(-Q.QuantConfig(bits=quant_bits).n_planes // pam_bits)
    issues: list[str] = []
    if min(m, k, n) <= 0:
        return {"kernel": "osa_matmul", "grid": (0, 0, 0), "smem_bytes": 0,
                "pad_waste": 0.0,
                "issues": [f"non-positive dimension in m,k,n={m},{k},{n}"]}
    if n_planes > 8:
        issues.append(f"{n_planes} planes exceed the kernel's 8")
    pl = plan(m, k, n, n_sm=n_sm, fused=fused, n_planes=min(n_planes, 8))
    if pl["smem_bytes"] > skinny.SMEM_LIMIT:
        issues.append(f"{pl['smem_bytes']} bytes of shared memory exceed "
                      "227 KB")
    rows = m if pl["path"] == "decode" else -(-m // BM) * BM
    pad_waste = rows * -(-n // pl["n_tile"]) * pl["n_tile"] / (m * n) - 1.0
    return dict(pl, kernel="osa_matmul", pad_waste=pad_waste, issues=issues)
