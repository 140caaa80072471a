"""Plain PyTorch oracle for the fused ROSA kernel (port of the reference's
`kernels/rosa_fused/ref.py`).

Replicates from `repro_torch.core` primitives exactly what the composed
`rosa.backends._forward` pipeline computes with the "ref" contraction
backend: operand conditioning (digital EO path / noisy analog realization /
gate blend / mapping-gate superposition) followed by the OSA reference
matmul.  The kernel wrapper (ops.py) reuses `condition_x` for the
requantization full-scale, a global reduction a tile cannot see.

Key discipline matches `_forward`: with a mapping gate (or in ANALOG mode)
the key splits into (k_w, k_x); static WS sends the whole key to the
weight side, static IS to the activation side.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import mrr, osa
from repro_torch.core import quant as Q
from repro_torch.core.constants import ComputeMode, Mapping


def analog_operand(t: torch.Tensor, key, *, qcfg: Q.QuantConfig,
                   p: mrr.MRRParams, noise: mrr.NoiseModel,
                   var: mrr.StaticVariation | None, gate,
                   clean_per_vector: bool,
                   noisy_per_vector: bool, act: bool = False) -> torch.Tensor:
    """rosa.backends._analog_operand with the per-vector flags explicit
    (`act`: an activation's full-scales, `Q.act_absmax_scale`)."""
    clean = Q.fake_quant(t, qcfg, per_vector=clean_per_vector, act=act)
    if noise.is_ideal and var is None and gate is None:
        return clean
    scale = (Q.act_absmax_scale(t, noisy_per_vector) if act
             else Q.weight_absmax_scale(t))
    q = Q.fake_quant(t / scale, qcfg, act=act)
    # an activation's per-shot draws span a train step's global batch
    eps = (mrr.draw_act_eps(key, q.shape, q.device, q.dtype)
           if act and not noise.is_ideal and key is not None else None)
    noisy = mrr.realize_weights(q, key, p, noise, var, eps) * scale
    if gate is None:
        return noisy
    return clean + gate * (noisy - clean)


def condition_x(x: torch.Tensor, key, *, x_active: bool, use_mgate: bool,
                mgate, gate, var: mrr.StaticVariation | None,
                qcfg: Q.QuantConfig, p: mrr.MRRParams,
                noise: mrr.NoiseModel,
                act_per_vector: bool) -> torch.Tensor:
    """The MIXED-mode activation operand exactly as `_forward` builds it."""
    x_dig = Q.fake_quant(x, qcfg, per_vector=act_per_vector, act=True)
    if use_mgate:
        x_is = analog_operand(x, key, qcfg=qcfg, p=p, noise=noise, var=var,
                              gate=gate, clean_per_vector=act_per_vector,
                              noisy_per_vector=True, act=True)
        return (1.0 - mgate) * x_dig + mgate * x_is
    if x_active:
        return analog_operand(x, key, qcfg=qcfg, p=p, noise=noise, var=var,
                              gate=gate, clean_per_vector=act_per_vector,
                              noisy_per_vector=True, act=True)
    return x_dig


def condition_w(w: torch.Tensor, key, *, w_active: bool, use_mgate: bool,
                mgate, gate, var: mrr.StaticVariation | None,
                qcfg: Q.QuantConfig, p: mrr.MRRParams,
                noise: mrr.NoiseModel) -> torch.Tensor:
    """The MIXED-mode weight operand exactly as `_forward` builds it."""
    if use_mgate:
        w_ws = analog_operand(w, key, qcfg=qcfg, p=p, noise=noise,
                              var=mrr.expand_lanes(var, w), gate=gate,
                              clean_per_vector=False, noisy_per_vector=False)
        return (1.0 - mgate) * w_ws + mgate * Q.fake_quant(w, qcfg)
    if w_active:
        return analog_operand(w, key, qcfg=qcfg, p=p, noise=noise,
                              var=mrr.expand_lanes(var, w), gate=gate,
                              clean_per_vector=False, noisy_per_vector=False)
    return Q.fake_quant(w, qcfg)


def split_keys(key, *, both: bool, w_active: bool):
    """(k_w, k_x) as `_forward` hands them out: both sides draw from the two
    halves of the key under a mapping gate or in ANALOG mode; otherwise the
    whole key goes to the one side that realizes."""
    if both:
        return mrr.split(key) if key is not None else (None, None)
    return (key, None) if w_active else (None, key)


def rosa_fused_ref(x: torch.Tensor, w: torch.Tensor, key=None,
                   var: mrr.StaticVariation | None = None, gate=None,
                   mgate=None, *, mapping: Mapping = Mapping.WS,
                   mode: ComputeMode = ComputeMode.MIXED,
                   quant_bits: int = 8, pam_bits: int = 1,
                   act_per_vector: bool = False,
                   noise: mrr.NoiseModel = mrr.IDEAL,
                   osa_cfg: osa.OSAConfig = osa.IDEAL_OSA,
                   p: mrr.MRRParams = mrr.DEFAULT_PARAMS) -> torch.Tensor:
    """Composed quantize -> realize -> OSA -> dequantize chain."""
    qcfg = Q.QuantConfig(bits=quant_bits)
    use_mgate = mgate is not None and mode is ComputeMode.MIXED
    if mode is ComputeMode.ANALOG:
        k_w, k_x = split_keys(key, both=True, w_active=True)
        w_eff = analog_operand(w, k_w, qcfg=qcfg, p=p, noise=noise,
                               var=mrr.expand_lanes(var, w), gate=gate,
                               clean_per_vector=False,
                               noisy_per_vector=False)
        x_eff = analog_operand(x, k_x, qcfg=qcfg, p=p, noise=noise, var=var,
                               gate=gate, clean_per_vector=False,
                               noisy_per_vector=False)
        return x_eff @ w_eff
    if mode is not ComputeMode.MIXED:
        raise ValueError(f"unsupported mode for the fused path: {mode}")
    w_active = use_mgate or mapping in (Mapping.WS, Mapping.GEMM)
    x_active = use_mgate or not w_active
    k_w, k_x = split_keys(key, both=use_mgate, w_active=w_active)
    w_eff = condition_w(w, k_w, w_active=w_active, use_mgate=use_mgate,
                        mgate=mgate, gate=gate, var=var, qcfg=qcfg, p=p,
                        noise=noise)
    x_eff = condition_x(x, k_x, x_active=x_active, use_mgate=use_mgate,
                        mgate=mgate, gate=gate, var=var, qcfg=qcfg, p=p,
                        noise=noise, act_per_vector=act_per_vector)
    return osa.osa_matmul_ref(
        x_eff, w_eff, dataclasses.replace(osa_cfg, pam_bits=pam_bits),
        qcfg, per_vector=act_per_vector)
