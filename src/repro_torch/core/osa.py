"""Optical Shift-and-Add (OSA) module semantics — paper Sec. 3.1, Fig. 3(c).

PyTorch port of `repro.core.osa`:

    y = sum_k sum_t 2^(t-N_T) * w_k * b_{k,t}        (Eq. 1)
      = sum_k w_k * x_k                              (Eq. 2)

The shift (power-of-two scaling of bit slot t) is a chain of splitters and
delay lines; the add is photodetection, so the ADC fires once per output.
`osa_matmul_ref` is the plain oracle of the `osa_matmul` kernel;
`slot_gains` folds splitter imbalance, delay-line loss and slot jitter
into the per-slot gain ladder.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import mrr
from repro_torch.core import quant as Q


@dataclasses.dataclass(frozen=True)
class OSAConfig:
    """Physical configuration of one OSA chain."""

    n_slots: int = 7               # N_T (+1 slots indexed 0..N_T in Eq. 1)
    pam_bits: int = 1              # 1 = balanced ternary; k>1 = PAM-2^k digits
    splitter_imbalance: float = 0.0   # eps: splits are (0.5+eps, 0.5-eps)
    odl_loss_db_per_stage: float = 0.0  # insertion loss per shift stage [dB]
    slot_jitter_sigma: float = 0.0      # std of per-slot gain error

    @property
    def is_ideal(self) -> bool:
        return (self.splitter_imbalance == 0.0
                and self.odl_loss_db_per_stage == 0.0
                and self.slot_jitter_sigma == 0.0)


IDEAL_OSA = OSAConfig()


def slot_gains(cfg: OSAConfig, key: torch.Generator | None = None,
               dtype=torch.float32, device=None,
               eps: torch.Tensor | None = None) -> torch.Tensor:
    """Effective gain of each bit slot: 2^(pam_bits*t) for slot t, with
    splitter imbalance, delay-line loss and slot jitter (`eps` N(0, 1) draws
    or `key`) folded multiplicatively on top."""
    t = torch.arange(cfg.n_slots, device=device)
    gains = (2.0 ** (cfg.pam_bits * t)).to(dtype)
    stages = (cfg.pam_bits * (cfg.n_slots - 1 - t)).to(dtype)
    if cfg.splitter_imbalance != 0.0:
        per_stage = (0.5 + cfg.splitter_imbalance) / 0.5
        gains = gains * per_stage ** stages
    if cfg.odl_loss_db_per_stage != 0.0:
        gains = gains * 10.0 ** (-cfg.odl_loss_db_per_stage * stages / 10.0)
    if cfg.slot_jitter_sigma != 0.0:
        if eps is None:
            if key is None:
                raise ValueError("slot jitter requires a key or draws")
            eps = mrr.normal(key, (cfg.n_slots,), device, dtype)
        gains = gains * (1.0 + cfg.slot_jitter_sigma * eps)
    return gains


def osa_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                   cfg: OSAConfig = IDEAL_OSA, quant: Q.QuantConfig = Q.Q8,
                   key: torch.Generator | None = None,
                   per_vector: bool = False) -> torch.Tensor:
    """Float x (M, K) @ w (K, N) through the optical path: quantize x,
    decompose into signed-digit (or PAM) slots, one wavelength-parallel
    product per slot, shift-and-add with the slot gains, rescale.  With an
    ideal OSAConfig this equals fake-quant(x) @ w to float precision."""
    # x is the activation side: its full-scale spans a train step's ranks
    q, scale = Q.quantize(x, quant, per_vector=per_vector, act=True)
    if cfg.pam_bits == 1:
        digits = Q.decompose_planes(q, quant)          # (T, M, K)
    else:
        digits = Q.decompose_pam(q, cfg.pam_bits, quant)
    g = slot_gains(dataclasses.replace(cfg, n_slots=digits.shape[0]),
                   key, w.dtype, w.device)
    per_slot = torch.matmul(digits.to(w.dtype), w)     # (T, M, N)
    y = torch.tensordot(g, per_slot, dims=1)
    return y * (scale / quant.qmax)
