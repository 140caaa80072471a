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


def mrr_transfer_grad_ref(g: torch.Tensor, w_target: torch.Tensor,
                          eps_dac: torch.Tensor | None,
                          eps_th: torch.Tensor | None,
                          sigma_dac: float = 0.02, sigma_th: float = 0.04,
                          p: mrr.MRRParams = mrr.DEFAULT_PARAMS,
                          var: mrr.StaticVariation | None = None
                          ) -> torch.Tensor:
    """g * d realize(w_target) / d w_target, elementwise: what the backward
    kernel computes, op for op (each op one float32 rounding, no constant
    meets another before it meets a tensor).

    The forward chain is recomputed, then its derivative is taken from the
    output back.  Each distinct denominator is divided into 1 once, and the
    reciprocal serves every quotient by it: five IEEE divisions (1 / tdrop,
    1 / den, 1 / hd, 1 / den2 and 1 / (s sq), which gives 1 / s as sq times
    it and 1 / sq as s times it) and two IEEE square roots.  So the
    recomputed chain rounds a few quotients differently from
    `mrr_transfer_ref`'s; the derivative stays within a few ulps of the
    chain's own conditioning (tests/test_torch_mrr_transfer.py holds it to
    a float64 derivative).  The clamp keeps tdrop, r, sq and s away from 0
    for every target.  A clip passes the whole gradient at a tie, as
    `torch.clamp` does (JAX's `clip` halves it there, which only the end
    points q = -1 and v = v_max reach).  The chip's fields and the draws
    are constants."""
    c = mrr.chain_constants(p)
    noisy = sigma_dac != 0.0 or sigma_th != 0.0
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    # ---- the forward chain (mrr.voltage_of_chain ... weight_of_shift) ----
    wq = torch.clamp(w_target, c.q_min, c.q_max)
    tdrop = ((wq - c.q_min) * c.a_td + c.b_td) * 0.5
    it = mrr._rdiv(1.0, tdrop)
    r = it - 1.0
    sq = mrr._sqrt(torch.clamp_min(r, 0.0))
    dl = sq * c.gamma + c.c_dl
    den = (1.0 - dl * c.d_u) * c.beta
    iden = mrr._rdiv(1.0, den)
    dt = (dl * c.d_neff) * iden
    v2 = torch.clamp_min(dt, 0.0) * c.e_v2
    s = mrr._sqrt(torch.clamp_min(v2, 0.0))
    v = torch.clamp(s, c.v_min, c.v_max)
    if noisy:
        v = v + sigma_dac * eps_dac
    if var is not None:
        v = v + var.dv
    heat = (v * v) * c.f_dt
    if noisy:
        heat = heat + sigma_th * eps_th
    if var is not None:
        heat = heat + var.ddt
    ihd = mrr._rdiv(1.0, heat * c.beta + c.n_eff)
    shift = (heat * c.g_lam) * ihd
    if var is not None:
        shift = shift + var.dlam
    d2 = shift + c.h_det
    iden2 = mrr._rdiv(1.0, d2 * d2 + c.g2)
    t = iden2 * c.g2
    iss = mrr._rdiv(1.0, s * sq)
    # ---- its derivative, from the output back ----
    gt = (g * c.j_w) * 2.0                              # d/dt (2t + i) j
    gd2 = -((gt * t) * ((d2 + d2) * iden2))             # t = g2 / den2
    gheat = ((gd2 * c.g_lam) * c.n_eff) * (ihd * ihd)   # shift(heat)
    gv = (gheat * (v + v)) * c.f_dt                     # heat = v^2 f
    gs = torch.where((s >= c.v_min) & (s <= c.v_max), gv, zero)
    gv2 = torch.where(v2 >= 0.0, (gs * 0.5) * (sq * iss), zero)  # sqrt(v2)
    gdt = torch.where(dt >= 0.0, gv2 * c.e_v2, zero)
    gdl = (gdt * ((dt * c.d_u) * c.beta + c.d_neff)) * iden    # dt(dl)
    gr = torch.where(r >= 0.0, ((gdl * c.gamma) * 0.5) * (s * iss), zero)
    gwq = ((-gr * (it * it)) * 0.5) * c.a_td            # 1/tdrop, tdrop(wq)
    return torch.where((w_target >= c.q_min) & (w_target <= c.q_max), gwq,
                       zero)
