"""Uniform quantization and signed-digit / PAM plane decomposition.

PyTorch port of `repro.core.quant`.  An 8-bit symmetric quantizer maps x
to integers q in [-qmax, qmax]; q splits into B-1 signed magnitude planes
(sign(q) * bit_t(|q|)), or into radix-2^k PAM digits, which are the time
slots the EO modulators stream (paper Sec. 3.1, Eq. 1-2).

Rounding is half-to-even on both sides (`torch.round` and `jnp.round`), so
codes agree bit for bit with the reference.  Integer codes are kept in the
floating dtype of their input.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    bits: int = 8          # total bits incl. sign

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1   # 127 for 8-bit

    @property
    def n_planes(self) -> int:
        return self.bits - 1              # magnitude digits (sign rides on each)


Q8 = QuantConfig(bits=8)


def absmax_scale(x: torch.Tensor, per_vector: bool = False) -> torch.Tensor:
    """Quantization full-scale: per-tensor absmax, or one per trailing-axis
    vector with `per_vector`.  The single source of the 1e-8 floor."""
    if per_vector and x.ndim >= 2:
        return torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-8)
    return torch.clamp_min(x.abs().amax(), 1e-8)


def act_absmax_scale(x: torch.Tensor,
                     per_vector: bool = False) -> torch.Tensor:
    """`absmax_scale` of an activation.  A per-tensor full-scale spans the
    global batch: under a live train or serve context whose rows are
    split over ranks (`distributed.sharding.row_axes`) the max is taken
    over every rank's rows, as `jnp.max` over a sharded batch is, its gradient
    (if any) shared as `jnp.max`'s (`distributed.runtime.amax`).  Under a
    tensor-parallel K split (`distributed.sharding.scale_axes`) the rank
    holds some of every row's columns, so both the per-tensor and the
    per-row full-scale take the max over the split's ranks too."""
    from repro_torch.distributed.sharding import scale_axes
    per_row = per_vector and x.ndim >= 2
    axes = scale_axes("x", per_row)
    if per_row:
        s = absmax_scale(x, True)
        if not axes:
            return s
        from repro_torch.distributed import runtime as rt
        return rt.pmax(s, axes)
    if not axes:
        return absmax_scale(x)
    from repro_torch.distributed import runtime as rt
    return torch.clamp_min(rt.amax(x.abs(), axes), 1e-8)


def weight_absmax_scale(w: torch.Tensor) -> torch.Tensor:
    """`absmax_scale` of a weight: the whole weight's, so under a
    tensor-parallel product (`distributed.sharding.scale_axes`) the max
    over the ranks that split it."""
    from repro_torch.distributed.sharding import scale_axes
    s = absmax_scale(w)
    axes = scale_axes("w")
    if not axes:
        return s
    from repro_torch.distributed import runtime as rt
    return rt.pmax(s, axes)


def quantize(x: torch.Tensor, cfg: QuantConfig = Q8,
             scale: torch.Tensor | None = None, per_vector: bool = False,
             act: bool = False):
    """Symmetric uniform quantization -> (integer-valued floats, scale);
    `act` marks an activation, whose full-scale `act_absmax_scale`
    takes; a per-tensor weight's is `weight_absmax_scale`."""
    if scale is None:
        if act:
            scale = act_absmax_scale(x, per_vector)
        elif per_vector:
            scale = absmax_scale(x, True)
        else:
            scale = weight_absmax_scale(x)
    q = torch.clamp(torch.round(x / scale * cfg.qmax), -cfg.qmax, cfg.qmax)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, cfg: QuantConfig = Q8):
    return q * (scale / cfg.qmax)


def fake_quant(x: torch.Tensor, cfg: QuantConfig = Q8,
               per_vector: bool = False, act: bool = False) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient.  The value is
    `x + (xq - x)`, evaluated as written, as the reference evaluates it
    (`act`: an activation, see `quantize`)."""
    q, scale = quantize(x, cfg, per_vector=per_vector, act=act)
    xq = dequantize(q, scale, cfg)
    return x + (xq - x).detach()


def decompose_planes(q: torch.Tensor, cfg: QuantConfig = Q8) -> torch.Tensor:
    """Integer-valued tensor -> (n_planes, *q.shape) signed bit-planes;
    plane t carries significance 2^t."""
    return decompose_pam(q, 1, cfg)


def plane_weights(cfg: QuantConfig = Q8, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Significance 2^t of each plane, t = 0..n_planes-1."""
    return pam_plane_weights(1, cfg, dtype, device)


def decompose_pam(q: torch.Tensor, pam_bits: int,
                  cfg: QuantConfig = Q8) -> torch.Tensor:
    """Signed radix-2^pam_bits digits; slot count ceil(n_planes/pam_bits);
    slot t has significance 2^(pam_bits*t)."""
    n_slots = -(-cfg.n_planes // pam_bits)
    sign = torch.sign(q)
    mag = q.abs().to(torch.int32)
    mask = (1 << pam_bits) - 1
    return torch.stack([sign * ((mag >> (pam_bits * t)) & mask).to(q.dtype)
                        for t in range(n_slots)])


def pam_plane_weights(pam_bits: int, cfg: QuantConfig = Q8,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    n_slots = -(-cfg.n_planes // pam_bits)
    return torch.tensor([2.0 ** (pam_bits * t) for t in range(n_slots)],
                        dtype=dtype, device=device)
