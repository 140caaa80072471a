"""Plain PyTorch oracle for the MRR transfer kernel (port of the
reference's `kernels/mrr_transfer/ref.py`).

Exactly `core.mrr.realize_weights`, with the two N(0, 1) noise draws as
operands, so the kernel and the oracle consume identical randomness.  It is
the port's folded chain (`core.mrr.Chain`), not the reference's written-out
`mrr_transfer_ref`, which cancels two ~1538 nm wavelengths in float32.
"""

from __future__ import annotations

import torch

from repro_torch.core import mrr


def mrr_transfer_ref(w_target: torch.Tensor, eps_dac: torch.Tensor | None,
                     eps_th: torch.Tensor | None, sigma_dac: float = 0.02,
                     sigma_th: float = 0.04,
                     p: mrr.MRRParams = mrr.DEFAULT_PARAMS,
                     var: mrr.StaticVariation | None = None) -> torch.Tensor:
    """w_target -> programming voltage -> perturbed chain -> realized w.

    eps_dac / eps_th: N(0, 1) draws of w_target's shape (unused, and may be
    None, when both sigmas are 0); `var` a chip's static variation,
    broadcast against w_target."""
    noise = mrr.NoiseModel(sigma_dac, sigma_th)
    eps = None if noise.is_ideal else (eps_dac, eps_th)
    return mrr.realize_weights(w_target, None, p, noise, var, eps)
