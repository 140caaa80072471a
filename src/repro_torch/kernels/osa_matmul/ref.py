"""Plain PyTorch oracle of the OSA bit-serial signed-digit matmul (port of
the reference's `kernels/osa_matmul/ref.py`).

    y[m, n] = sum_t gains[t] * sum_k digit_t(q)[m, k] * w[k, n]

digit_t(q) are the signed digit planes (radix 2 for pam_bits=1, radix
2^pam_bits otherwise) of integer-valued activations q; gains default to the
ideal ladder, under which y equals q @ w exactly.
"""

from __future__ import annotations

import torch

from repro_torch.core import quant as Q


def osa_matmul_ref(q: torch.Tensor, w: torch.Tensor,
                   gains: torch.Tensor | None = None, quant_bits: int = 8,
                   pam_bits: int = 1) -> torch.Tensor:
    """q: (M, K) integer-valued; w: (K, N) f32; gains: (T,) or None."""
    cfg = Q.QuantConfig(bits=quant_bits)
    qf = q.float()
    planes = Q.decompose_pam(qf, pam_bits, cfg)              # (T, M, K)
    g = (Q.pam_plane_weights(pam_bits, cfg, device=q.device)
         if gains is None else gains)
    per_slot = torch.matmul(planes, w.float())
    return torch.tensordot(g.float(), per_slot, dims=1)
