"""Execution backends for the ROSA optical matmul + the `RosaConfig` knob
(PyTorch port of `repro.rosa.backends`).

A backend is the contraction that turns noise-placed operands into outputs:

    dense   exact contraction (the ideal-OSA closed form, Eq. 2)
    ref     plain OSA pipeline (signed-digit planes + slot gains, Eq. 1)
    pallas  the `osa_matmul` kernel (the name the reference gave its TPU
            kernel backend; here a CUDA kernel, plain version on the CPU)
    fused   RAW backend: the `rosa_fused` kernel, which conditions the
            operands itself

"auto" resolves to "fused" when the operands lie on a CUDA device and to
"ref" otherwise, as the reference resolves it to its megakernel on the
accelerator.

Forward semantics (mixed digital-analog mode, Sec. 2-3.1): WS realizes
weights on the noisy analog rings and streams activations digitally; IS
swaps the roles; ANALOG realizes both.  Backward: straight-through, two
plain matmuls (`torch.autograd.Function`).

A realized operand of the composed backends, and a depthwise weight
conditioned by `condition_weight`, goes through the `mrr_transfer` kernel
when it lies on a CUDA device (its plain chain on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import mrr, osa, quant
from repro_torch.core.constants import ComputeMode, Mapping
from repro_torch.kernels.mrr_transfer import ops as mrr_transfer_ops


@dataclasses.dataclass(frozen=True)
class RosaConfig:
    """Per-layer execution config for the optical backend."""

    mapping: Mapping = Mapping.WS
    mode: ComputeMode = ComputeMode.MIXED
    quant_bits: int = 8
    pam_bits: int = 1
    noise: mrr.NoiseModel = mrr.IDEAL
    osa_cfg: osa.OSAConfig = osa.IDEAL_OSA
    mrr_params: mrr.MRRParams = mrr.DEFAULT_PARAMS
    backend: str = "auto"   # registered backend name, or "auto" (device)
    act_per_vector: bool = False  # quantize each activation ROW at its own
    #   full-scale (serving: a request's numerics must not depend on which
    #   other requests share its decode batch)

    @property
    def qcfg(self) -> quant.QuantConfig:
        """Quantization config derived from `quant_bits`."""
        return quant.QuantConfig(bits=self.quant_bits)


DEFAULT = RosaConfig()

# Contraction backends take noise-placed operands (x_eff, w_eff, cfg);
# RAW backends take (x, w, cfg, *, key, var, gate, mgate) and condition the
# operands themselves.
Backend = Callable[..., torch.Tensor]

_BACKENDS: dict[str, Backend] = {}
_RAW_BACKENDS: set[str] = set()


def register_backend(name: str, raw: bool = False):
    """Decorator: register a backend under `name`."""
    def deco(fn: Backend) -> Backend:
        _BACKENDS[name] = fn
        if raw:
            _RAW_BACKENDS.add(name)
        return fn
    return deco


def backend_names() -> list[str]:
    """Registered backend names."""
    return sorted(_BACKENDS)


def is_raw_backend(name: str) -> bool:
    """Whether `name` registered as a raw (fully fused) backend."""
    return name in _RAW_BACKENDS


def resolve_backend(name: str, device: torch.device | str = "cpu"
                    ) -> tuple[str, Backend]:
    """Resolve a backend name ("auto": "fused" on CUDA, "ref" elsewhere)."""
    if name == "auto":
        name = "fused" if torch.device(device).type == "cuda" else "ref"
    try:
        return name, _BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; registered: "
                         f"{backend_names()}") from None


@register_backend("dense")
def _dense_backend(x, w, cfg=None):
    return x @ w


@register_backend("ref")
def _ref_backend(x, w, cfg: RosaConfig):
    return osa.osa_matmul_ref(x, w, cfg.osa_cfg, cfg.qcfg,
                              per_vector=cfg.act_per_vector)


@register_backend("pallas")
def _pallas_backend(x, w, cfg: RosaConfig):
    from repro_torch.kernels.osa_matmul import ops as osa_ops
    return osa_ops.osa_matmul(x, w, quant_bits=cfg.quant_bits,
                              pam_bits=cfg.pam_bits,
                              per_vector=cfg.act_per_vector)


@register_backend("fused", raw=True)
def _fused_backend(x, w, cfg: RosaConfig, *, key=None, var=None, gate=None,
                   mgate=None):
    from repro_torch.kernels.rosa_fused import ops as fused_ops
    # the decomposition radix follows osa_cfg (what the composed ref chain
    # uses), not RosaConfig.pam_bits (which only the "pallas" backend reads)
    return fused_ops.rosa_fused_matmul(
        x, w, key, var, gate, mgate, mapping=cfg.mapping, mode=cfg.mode,
        quant_bits=cfg.quant_bits, pam_bits=cfg.osa_cfg.pam_bits,
        act_per_vector=cfg.act_per_vector, noise=cfg.noise,
        osa_cfg=cfg.osa_cfg, p=cfg.mrr_params)


# ---------------------------------------------------------------------------
# Operand conditioning (noise placement)
# ---------------------------------------------------------------------------
def _noisy_realize(t, cfg: RosaConfig, key, var=None,
                   per_vector: bool = False, act: bool = False):
    """Quantize `t` and realize it on the analog MRRs (per-tensor full-scale
    for weights, per-row with `per_vector` for activations; `act`: an
    activation's, global over a train step's ranks), through the
    `mrr_transfer` kernel on CUDA and its plain chain on the CPU."""
    scale = (quant.act_absmax_scale(t, per_vector) if act
             else quant.weight_absmax_scale(t))
    q = quant.fake_quant(t / scale, cfg.qcfg, act=act)
    # an activation's per-shot draws span a train step's global batch
    eps = (mrr.draw_act_eps(key, q.shape, q.device, q.dtype)
           if act and not cfg.noise.is_ideal and key is not None else None)
    return mrr_transfer_ops.mrr_transfer(
        q, key, cfg.noise.sigma_dac, cfg.noise.sigma_th, cfg.mrr_params,
        var, eps) * scale


def _digital_path(t, cfg: RosaConfig, per_vector: bool = False,
                  act: bool = False):
    """Exact digital EO encoding: quantization is the only error source
    (`act`: `t` is an activation, see `quant.act_absmax_scale`)."""
    return quant.fake_quant(t, cfg.qcfg, per_vector=per_vector, act=act)


def _analog_operand(t, cfg: RosaConfig, key, var, gate,
                    per_vector: bool = False, act: bool = False):
    """Noisy realization of the analog-side operand, optionally blended
    against the exact digital path by `gate` in [0, 1]."""
    clean = _digital_path(t, cfg, per_vector and cfg.act_per_vector, act)
    if cfg.noise.is_ideal and var is None and gate is None:
        return clean
    noisy = _noisy_realize(t, cfg, key, var, per_vector, act)
    if gate is None:
        return noisy
    return clean + gate * (noisy - clean)


def realization_rms_error(t, cfg: RosaConfig,
                          var: mrr.StaticVariation | None = None,
                          per_vector: bool = False) -> torch.Tensor:
    """RMS programming error of realizing `t` on this chip (a 0-d tensor,
    no key): the noiseless realization of the quantized operand under the
    chip's static variation against the operand itself, in normalized
    weight units.  Per-shot noise is left out: it is i.i.d. across chips,
    so only the static part tells chips apart.  The control-variate
    surrogate of `robust.ensemble.estimate_ensemble`; one `mrr_transfer`
    (the kernel on CUDA) per (chip, layer)."""
    scale = quant.absmax_scale(t, per_vector)
    q = quant.fake_quant(t / scale, cfg.qcfg)
    w = mrr_transfer_ops.mrr_transfer(q, None, 0.0, 0.0, cfg.mrr_params,
                                      mrr.expand_lanes(var, t))
    return torch.sqrt(torch.mean((w - q) ** 2))


def condition_weight(w, cfg: RosaConfig | None, key,
                     var: mrr.StaticVariation | None = None, gate=None):
    """Weight conditioning outside the matmul path (per-channel contractions
    such as the depthwise conv): the analog realization of `w` under the
    layer's noise and pinned chip, whatever its mapping and mode, blended
    against `w` itself by `gate` in [0, 1].  Identity when the layer is
    dense or fully ideal (no fake-quant on that path)."""
    if cfg is None or (cfg.noise.is_ideal and var is None and gate is None):
        return w
    noisy = _noisy_realize(w, cfg, key, mrr.expand_lanes(var, w))
    if gate is None:
        return noisy
    return w + gate * (noisy - w)


def _forward(x, w, cfg: RosaConfig, key, var=None, gate=None, mgate=None):
    device = x.device
    if cfg.mode is ComputeMode.MIXED:
        if cfg.noise.is_ideal and cfg.osa_cfg.is_ideal \
                and cfg.backend in ("auto", "dense") \
                and var is None and gate is None and mgate is None:
            # ideal OSA over signed-digit planes == fake-quant matmul
            return _digital_path(x, cfg, cfg.act_per_vector, act=True) \
                @ _digital_path(w, cfg)
        bname, contract = resolve_backend(cfg.backend, device)
        if bname in _RAW_BACKENDS:
            return contract(x, w, cfg, key=key, var=var, gate=gate,
                            mgate=mgate)
        if mgate is not None:
            # mapping superposition: realize both orientations and blend the
            # operands (exact for mgate in {0, 1})
            k_w, k_x = mrr.split(key) if key is not None else (None, None)
            w_ws = _analog_operand(w, cfg, k_w, mrr.expand_lanes(var, w),
                                   gate)
            x_is = _analog_operand(x, cfg, k_x, var, gate, per_vector=True,
                                   act=True)
            w_eff = (1.0 - mgate) * w_ws + mgate * _digital_path(w, cfg)
            x_eff = (1.0 - mgate) * _digital_path(x, cfg,
                                                  cfg.act_per_vector,
                                                  act=True) \
                + mgate * x_is
        elif cfg.mapping in (Mapping.WS, Mapping.GEMM):
            w_eff = _analog_operand(w, cfg, key, mrr.expand_lanes(var, w),
                                    gate)
            x_eff = _digital_path(x, cfg, cfg.act_per_vector, act=True)
        else:  # IS: inputs on the analog rings, weights exact digital
            w_eff = _digital_path(w, cfg)
            x_eff = _analog_operand(x, cfg, key, var, gate, per_vector=True,
                                    act=True)
        return contract(x_eff, w_eff, cfg)
    if cfg.mode is ComputeMode.ANALOG:
        bname, contract = resolve_backend(cfg.backend, device)
        if bname in _RAW_BACKENDS:
            return contract(x, w, cfg, key=key, var=var, gate=gate,
                            mgate=None)
        k_w, k_x = mrr.split(key) if key is not None else (None, None)
        w_eff = _analog_operand(w, cfg, k_w, mrr.expand_lanes(var, w), gate)
        x_eff = _analog_operand(x, cfg, k_x, var, gate, act=True)
        return x_eff @ w_eff                      # single-shot analog readout
    if cfg.mode is ComputeMode.DIGITAL:
        return _digital_path(x, cfg, act=True) @ _digital_path(w, cfg)
    raise ValueError(cfg.mode)


class _RosaMatmul(torch.autograd.Function):
    """Forward through the configured pipeline; straight-through backward
    (gradients as if the matmul were exact)."""

    @staticmethod
    def forward(ctx, x, w, cfg, key, var, gate, mgate):
        ctx.save_for_backward(x, w)
        lead = x.shape[:-1]
        y = _forward(x.reshape(-1, x.shape[-1]), w, cfg, key, var, gate,
                     mgate)
        return y.reshape(*lead, w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        x2 = x.reshape(-1, x.shape[-1])
        dx = (g2 @ w.T).reshape(x.shape)
        dw = x2.T @ g2
        return dx, dw, None, None, None, None, None


def rosa_matmul(x: torch.Tensor, w: torch.Tensor, cfg: RosaConfig = DEFAULT,
                key: torch.Generator | None = None,
                var: mrr.StaticVariation | None = None, gate=None,
                mgate=None) -> torch.Tensor:
    """Optical matmul y = x @ w through the configured ROSA pipeline.

    x: (..., K); w: (K, N); returns (..., N).  `var` pins one chip's static
    variation; `gate` blends the analog path against the exact digital one;
    `mgate` ({0=WS, 1=IS}) superposes the two mappings.  Straight-through
    gradients w.r.t. x and w.
    """
    return _RosaMatmul.apply(x, w, cfg, key, var, gate, mgate)
