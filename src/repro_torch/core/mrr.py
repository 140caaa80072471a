"""Noise-aware behavioral model of MRR weight realization (paper Sec. 3.3).

PyTorch port of `repro.core.mrr`: the physical chain of Eqs. (3)-(8)

    V --(Eq.3)--> dT --(Eq.3)--> d_lambda --(Eq.4)--> T_drop(lambda_ref)
      --(Eq.5)--> T_diff --(Eq.7)--> w

with its closed-form inverse, the two per-shot noise injection points of
Eq. (8) (DAC noise on V, thermal crosstalk on dT) and a chip's static
variation (`StaticVariation`: driver offset dv, thermal bias ddt, fab
mismatch dlam).

A `torch.Generator` takes the place of the reference's PRNG key, split the
way the reference splits its key (`split`: one child for the DAC draw, one
for the thermal draw; `fold_in`: per-layer and per-step keys).  Children
are seeded from the parent's seed, so a key gives the same draws however
often it is split.  The draws are not the reference's: tests feed both
packages the same N(0, 1) draws through `eps=`.

Every op runs in float32 in the reference's order with correctly rounded
division and square root, so a realization fed the same N(0, 1) draws
(`eps=`) equals the reference's op-by-op evaluation bit for bit.  (Under
`jax.jit` XLA rewrites `x / const` into `x * (1 / const)` and contracts
multiply-adds into FMAs; the chain's subtraction of the ~1538 nm resonance
amplifies those last-bit changes to ~1e-4 in normalized weight units.)  
"""

from __future__ import annotations

import dataclasses
import functools
import zlib

import numpy as np
import torch

from repro_torch.core import constants as C


@dataclasses.dataclass(frozen=True)
class MRRParams:
    """Device parameters; defaults are paper Table 2."""

    lambda_0: float = C.LAMBDA_0_NM
    lambda_ref: float = C.LAMBDA_REF_NM
    n_eff: float = C.N_EFF
    gamma: float = C.GAMMA_HWHM_NM
    r_heater: float = C.R_HEATER_OHM
    r_thermal: float = C.R_THERMAL_K_PER_MW
    beta: float = C.BETA_TO_PER_K
    kappa: float = C.HEATER_COUPLING
    v_min: float = C.V_MIN
    v_max: float = C.V_MAX
    q_min: float = -1.0
    q_max: float = 1.0

    @property
    def q_rng(self) -> float:
        return self.q_max - self.q_min


DEFAULT_PARAMS = MRRParams()


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """Gaussian perturbations of Eq. (8)."""

    sigma_dac: float = C.SIGMA_DAC_DEFAULT   # volts on V
    sigma_th: float = C.SIGMA_TH_DEFAULT     # kelvin on dT

    @property
    def is_ideal(self) -> bool:
        return self.sigma_dac == 0.0 and self.sigma_th == 0.0


IDEAL = NoiseModel(sigma_dac=0.0, sigma_th=0.0)
PAPER_NOISE = NoiseModel()


@dataclasses.dataclass(frozen=True)
class StaticVariation:
    """Per-chip static perturbation of the chain.  Fields are tensors that
    broadcast against the realized operand: scalars, per-reduction-lane
    (K,) vectors, or full fields."""

    dv: torch.Tensor      # static driver/DAC voltage offset [V]
    ddt: torch.Tensor     # static thermal-crosstalk temperature bias [K]
    dlam: torch.Tensor    # fab mismatch of the resonance wavelength [nm]

    def to(self, device) -> "StaticVariation":
        return StaticVariation(self.dv.to(device), self.ddt.to(device),
                               self.dlam.to(device))

    def shift_ddt(self, offset) -> "StaticVariation":
        """Add a (scalar) thermal offset: the drift injection point."""
        return dataclasses.replace(self, ddt=self.ddt + offset)


def expand_lanes(var: StaticVariation | None, t: torch.Tensor):
    """Adapt per-lane (K,) variation to an operand's orientation: against a
    (K, N) weight a lane vector gains a trailing axis (lane k perturbs every
    output channel); against (M, K) activations it broadcasts as-is.  The
    result is a view; nothing is materialized."""
    if var is None:
        return None

    def fix(a):
        if a.ndim == 1 and t.ndim == 2 and a.shape[0] == t.shape[0]:
            return a[:, None]
        return a

    return StaticVariation(fix(var.dv), fix(var.ddt), fix(var.dlam))


def _const(c: float, t: torch.Tensor) -> torch.Tensor:
    return torch.full((), c, dtype=t.dtype, device=t.device)


def _rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """c / t, correctly rounded (`float / Tensor` is `c * t.reciprocal()`)."""
    return _const(c, t) / t


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """t / c, correctly rounded: on CUDA `Tensor / float` multiplies by the
    reciprocal, which the chain's cancellations amplify to ~1e-4."""
    return t / _const(c, t)


def _sqrt(t: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root; PyTorch's vectorized CPU sqrt
    is off by one ulp on some inputs."""
    if t.device.type == "cpu" and t.dtype == torch.float32:
        return torch.sqrt(t.double()).float()
    return torch.sqrt(t)


# --------------------------------------------------------------------------
# Forward chain  V -> w
# --------------------------------------------------------------------------
def delta_t(v, p: MRRParams = DEFAULT_PARAMS):
    """Eq. (3) left: heater temperature rise [K] for drive voltage V."""
    p_heater_mw = p.kappa * _div(v * v, p.r_heater) * 1e3
    return p_heater_mw * p.r_thermal


def delta_lambda(dt, p: MRRParams = DEFAULT_PARAMS):
    """Eq. (3) right: resonance shift [nm] for temperature rise dT [K]."""
    bdt = p.beta * dt
    return p.lambda_0 * bdt / (p.n_eff + bdt)


def t_drop(lam, p: MRRParams = DEFAULT_PARAMS):
    """Eq. (4): Lorentzian drop-port transmission probed at lambda_ref."""
    det = lam - p.lambda_ref
    g2 = p.gamma * p.gamma
    return _rdiv(g2, det * det + g2)


def t_diff(lam, p: MRRParams = DEFAULT_PARAMS):
    """Eq. (5): differential drop-through transmission in [-1, 1]."""
    return 2.0 * t_drop(lam, p) - 1.0


def _t_diff_of_v(v, p: MRRParams):
    return t_diff(p.lambda_0 + delta_lambda(delta_t(v, p), p), p)


def transmission_endpoints(p: MRRParams = DEFAULT_PARAMS, device=None):
    """Eq. (6) in float32: T_hi = T_diff(V_min), T_lo = T_diff(V_max)."""
    f = lambda v: _t_diff_of_v(torch.tensor(v, dtype=torch.float32,
                                            device=device), p)
    return f(p.v_min), f(p.v_max)


def transmission_endpoints_py(p: MRRParams = DEFAULT_PARAMS
                              ) -> tuple[float, float]:
    """Eq. (6) endpoints in Python floats (static kernel parameters)."""
    def td(v: float) -> float:
        p_mw = p.kappa * (v * v / p.r_heater) * 1e3
        dt = p_mw * p.r_thermal
        bdt = p.beta * dt
        lam = p.lambda_0 + p.lambda_0 * bdt / (p.n_eff + bdt)
        det = lam - p.lambda_ref
        g2 = p.gamma * p.gamma
        return 2.0 * g2 / (det * det + g2) - 1.0

    return td(p.v_min), td(p.v_max)


# --------------------------------------------------------------------------
# Keys: torch.Generators split and folded like the reference's PRNG keys
# --------------------------------------------------------------------------
_MASK = (1 << 63) - 1


def fold_in(key: torch.Generator, data: int) -> torch.Generator:
    """A child generator determined by (key's seed, data)."""
    h = zlib.crc32(f"{key.initial_seed()}:{int(data)}".encode())
    seed = (key.initial_seed() * 0x9E3779B97F4A7C15 + h) & _MASK
    return torch.Generator(key.device).manual_seed(seed)


def split(key: torch.Generator) -> tuple[torch.Generator, torch.Generator]:
    """Two independent children of `key`."""
    return fold_in(key, 0), fold_in(key, 1)


def split_keys(key: torch.Generator, n: int) -> list[torch.Generator]:
    """`n` independent children of `key` (the reference's
    `jax.random.split(key, n)`; the first two are `split(key)`)."""
    return [fold_in(key, i) for i in range(n)]


def rng_family(device) -> str:
    """The family of the random draws keyed on `device`: torch's generators
    ("torch-cpu", "torch-cuda"), not the reference's threefry.  A cached
    Monte-Carlo measurement names it in its spec, so numbers drawn by one
    family are never read back as another's."""
    return f"torch-{torch.device(device).type}"


def normal(key: torch.Generator, shape, device=None,
           dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) draws from `key`, on `device`."""
    out = torch.randn(shape, generator=key, device=key.device, dtype=dtype)
    return out.to(device) if device is not None else out


def _eps_pair(key: torch.Generator, shape, device, dtype):
    k_dac, k_th = split(key)
    return normal(k_dac, shape, device, dtype), normal(k_th, shape, device,
                                                       dtype)


def draw_eps(key: torch.Generator, shape, device=None, dtype=torch.float32):
    """The (DAC, thermal) pair of N(0, 1) draws one noisy realization of a
    weight takes, from the two halves of `key` as `weight_of_voltage`
    splits it.  Under a tensor-parallel product the draws are made at the
    whole weight's shape and the rank keeps its block
    (`distributed.sharding.operand_draws`), so the ranks realize the
    one-process weight's offsets."""
    from repro_torch.distributed.sharding import operand_draws
    return operand_draws(lambda s: _eps_pair(key, s, device, dtype), shape,
                         "w")


def draw_act_eps(key: torch.Generator, shape, device=None,
                 dtype=torch.float32):
    """`draw_eps` for an activation whose dim 0 holds a batch's rows: under
    a live train context whose rows are split over ranks the draws span
    the global batch's rows, and under a K-split product its whole
    columns; the rank keeps its block (`distributed.sharding.
    operand_draws`), so the ranks draw the one-process step's offsets."""
    from repro_torch.distributed.sharding import operand_draws
    return operand_draws(lambda s: _eps_pair(key, s, device, dtype), shape,
                         "x")


# --------------------------------------------------------------------------
# The realization chain in folded form
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Chain:
    """Float32 constants of the realization chain in its folded form.

    Written out, the chain subtracts two ~1538 nm wavelengths (the rest
    resonance and the probe), and in float32 each such subtraction leaves
    an error of one ulp of 1538 nm (1.2e-4 nm), which the Lorentzian turns
    into ~3e-4 of normalized weight.  The folded form adds the small
    detuning to the precomputed difference of the two wavelengths instead,
    and multiplies by precomputed ratios of the physical constants: it is
    the form XLA compiles the reference's chain into, so the two agree to
    rounding instead of to that cancellation error.  Constants combine
    float32 values in float32, as the compiler folds them.
    """

    q_min: float
    q_max: float
    a_td: float      # (t_hi - t_lo) / q_rng
    b_td: float      # 1 + t_lo
    gamma: float
    c_dl: float      # lambda_ref - lambda_0
    d_u: float       # 1 / lambda_0
    d_neff: float    # n_eff / lambda_0
    beta: float
    e_v2: float      # r_heater / (r_thermal * kappa * 1e3)
    v_min: float
    v_max: float
    f_dt: float      # kappa * 1e3 * r_thermal / r_heater
    g_lam: float     # lambda_0 * beta
    n_eff: float
    h_det: float     # lambda_0 - lambda_ref
    g2: float        # gamma^2
    i_td: float      # -(1 + t_lo)
    j_w: float       # q_rng / (t_hi - t_lo)

    def values(self) -> list[float]:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


@functools.lru_cache(maxsize=64)
def chain_constants(p: MRRParams = DEFAULT_PARAMS) -> Chain:
    """The folded chain's constants for device parameters `p`."""
    f = np.float32
    one = f(1.0)
    t_hi, t_lo = (f(t.item()) for t in transmission_endpoints(p))
    thl = t_hi - t_lo
    d_u = one / f(p.lambda_0)
    return Chain(
        q_min=float(f(p.q_min)), q_max=float(f(p.q_max)),
        a_td=float(one / f(p.q_rng) * thl), b_td=float(t_lo + one),
        gamma=float(f(p.gamma)),
        c_dl=float(f(p.lambda_ref) - f(p.lambda_0)),
        d_u=float(d_u), d_neff=float(f(p.n_eff) * d_u),
        beta=float(f(p.beta)),
        e_v2=float(one / f(p.r_thermal) * (one / f(p.kappa * 1e3))
                   * f(p.r_heater)),
        v_min=float(f(p.v_min)), v_max=float(f(p.v_max)),
        f_dt=float(one / f(p.r_heater) * f(p.kappa) * f(1e3)
                   * f(p.r_thermal)),
        g_lam=float(f(p.lambda_0) * f(p.beta)), n_eff=float(f(p.n_eff)),
        h_det=float(f(p.lambda_0) - f(p.lambda_ref)),
        g2=float(f(p.gamma * p.gamma)), i_td=float(-(one + t_lo)),
        j_w=float(f(p.q_rng) * (one / thl)))


def voltage_of_chain(w: torch.Tensor, c: Chain, dt_trim=0.0) -> torch.Tensor:
    """Inverse chain, folded: target weight -> programming voltage,
    clipped to [v_min, v_max]."""
    wq = torch.clamp(w, c.q_min, c.q_max)
    tdrop = ((wq - c.q_min) * c.a_td + c.b_td) * 0.5       # Eqs. (7), (5)
    det = _sqrt(torch.clamp_min(1.0 / tdrop - 1.0, 0.0)) * c.gamma  # (4)
    dl = det + c.c_dl                                   # shift from rest
    dt = (dl * c.d_neff) / ((1.0 - dl * c.d_u) * c.beta)  # Eq. (3) right
    if dt_trim:
        dt = dt - dt_trim        # heater supplies what drift doesn't
    v2 = torch.clamp_min(dt, 0.0) * c.e_v2                 # Eq. (3) left
    return torch.clamp(_sqrt(torch.clamp_min(v2, 0.0)), c.v_min, c.v_max)


def heat_of_chain(v: torch.Tensor, c: Chain) -> torch.Tensor:
    """Eq. (3) left, folded: heater temperature rise [K] for voltage V."""
    return (v * v) * c.f_dt


def shift_of_chain(dt: torch.Tensor, c: Chain) -> torch.Tensor:
    """Eq. (3) right, folded: resonance shift [nm] for dT [K]."""
    return (dt * c.g_lam) / (dt * c.beta + c.n_eff)


def weight_of_shift(dl: torch.Tensor, c: Chain) -> torch.Tensor:
    """Eqs. (4), (5), (7), folded: resonance shift -> realized weight."""
    det = dl + c.h_det                           # detuning from the probe
    t = _rdiv(c.g2, det * det + c.g2)
    return (2.0 * t + c.i_td) * c.j_w + c.q_min


def realize_offsets(w: torch.Tensor, v_off, t_off, l_off,
                    c: Chain) -> torch.Tensor:
    """`realize_weights` with the per-shot draws and the static variation
    folded into three additive offsets (on V, on dT, on the shift)."""
    v = voltage_of_chain(w, c) + v_off
    return weight_of_shift(shift_of_chain(heat_of_chain(v, c) + t_off, c)
                           + l_off, c)


def weight_of_voltage(v: torch.Tensor, p: MRRParams = DEFAULT_PARAMS,
                      noise: NoiseModel = IDEAL,
                      key: torch.Generator | None = None,
                      var: StaticVariation | None = None,
                      eps: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Full chain Eqs. (3)-(8): drive voltage(s) -> realized weight(s).

    With a non-ideal `noise`, `eps` holds the (DAC, thermal) N(0, 1) draws;
    without it they are drawn from `key`.  `var` adds a chip's static
    perturbation on top of the per-shot draws.
    """
    c = chain_constants(p)
    if not noise.is_ideal:
        if eps is None:
            if key is None:
                raise ValueError("noisy realization requires a key or "
                                 "injected draws")
            eps = draw_eps(key, v.shape, v.device, v.dtype)
        v = v + noise.sigma_dac * eps[0]
    if var is not None:
        v = v + var.dv
    dt = heat_of_chain(v, c)
    if not noise.is_ideal:
        dt = dt + noise.sigma_th * eps[1]
    if var is not None:
        dt = dt + var.ddt
    dl = shift_of_chain(dt, c)
    if var is not None:
        dl = dl + var.dlam
    return weight_of_shift(dl, c)


def voltage_of_weight(w: torch.Tensor, p: MRRParams = DEFAULT_PARAMS,
                      dt_trim=0.0):
    """Closed-form inverse of the forward chain (ideal programming): the
    programming voltage of target weight(s) `w`, clipped to the physical
    range [q_min, q_max] and to [v_min, v_max].  `dt_trim` is a known
    static temperature bias [K] the heater need not supply."""
    return voltage_of_chain(w, chain_constants(p), dt_trim)


def realize_weights(w_target: torch.Tensor,
                    key: torch.Generator | None = None,
                    p: MRRParams = DEFAULT_PARAMS, noise: NoiseModel = IDEAL,
                    var: StaticVariation | None = None,
                    eps: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Program target weights onto MRRs and read back the realization:
    `weight_of_voltage(clip(voltage_of_weight(w)))` under per-shot noise
    (`eps` draws or `key`) and a chip's static `var`."""
    return weight_of_voltage(voltage_of_weight(w_target, p), p, noise, key,
                             var, eps)
