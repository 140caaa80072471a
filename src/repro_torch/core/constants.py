"""Device constants for the ROSA MRR-ONN model (PyTorch port: the pure-Python
values of `repro.core.constants` that the port uses).

Sources: paper Table 2 (microring / thermo-optic model) and Table 3
(per-component static and dynamic energies).  All values are kept in SI with
the unit recorded next to each constant.

A note on internal consistency (documented, not hidden):  Table 2's published
constants (R_h = 50 ohm, R_th = 2 K/mW) reproduce the thermal tuning
efficiency eta_lambdaP ~= 0.238 nm/mW of Eq. (9) exactly, but they *cannot*
simultaneously reproduce Fig. 5(b)'s measured 0.740 nm resonance shift over
the 1 V..3 V drive range (they over-predict it by ~51x, because V^2/R_h over
that range sweeps 160 mW of electrical power while 0.740 nm only requires
~3.1 mW of *heater* power at 0.238 nm/mW).  Physical heaters never couple all
electrical power into the ring; we therefore introduce an explicit heater
coupling efficiency ``HEATER_COUPLING`` calibrated so that the 1->3 V sweep
produces exactly the paper's 0.740 nm shift while eta_lambdaP (per unit of
*coupled* heater power) stays at 0.238 nm/mW.  See DESIGN.md section 8.
"""

from __future__ import annotations

import dataclasses
import enum


# --------------------------------------------------------------------------
# Table 2 — microring and thermo-optic model
# --------------------------------------------------------------------------
LAMBDA_0_NM = 1538.74          # nominal resonance wavelength [nm]
LAMBDA_REF_NM = 1538.26        # probe (reference) wavelength [nm]
N_EFF = 2.4                    # effective refractive index [-]
GAMMA_HWHM_NM = 0.7534         # half-width at half-maximum [nm]
R_HEATER_OHM = 50.0            # heater resistance [ohm]
R_THERMAL_K_PER_MW = 2.0       # thermal resistance [K/mW]
BETA_TO_PER_K = 1.86e-4        # thermo-optic coefficient [1/K]

# Drive-voltage operating range used in Fig. 5(b).
V_MIN = 1.0                    # [V]
V_MAX = 3.0                    # [V]
MAX_SHIFT_NM = 0.740           # Fig. 5(b): max resonance shift over V range [nm]

# Calibrated heater coupling efficiency (see module docstring).  Solved so
# that delta_lambda(V_MAX) - delta_lambda(V_MIN) == MAX_SHIFT_NM given the
# Table 2 constants.  Solved in closed form below.


def _solve_heater_coupling() -> float:
    """kappa s.t. the 1->3 V sweep gives exactly MAX_SHIFT_NM of shift.

    delta_lambda(dT) = lambda0 * beta*dT / (n0 + beta*dT)  with
    dT(V) = kappa * (V^2 / R_h) * 1000 * R_th   [V^2/R_h in W -> mW].

    Since delta_lambda is the composition of two increasing maps, the sweep
    shift is f(kappa*P3) - f(kappa*P1) with P in mW; solve by bisection (the
    equation is scalar and monotone in kappa).
    """
    p1_mw = (V_MIN ** 2 / R_HEATER_OHM) * 1e3
    p3_mw = (V_MAX ** 2 / R_HEATER_OHM) * 1e3

    def shift(kappa: float) -> float:
        def dl(p_mw: float) -> float:
            dt = kappa * p_mw * R_THERMAL_K_PER_MW
            return LAMBDA_0_NM * BETA_TO_PER_K * dt / (N_EFF + BETA_TO_PER_K * dt)
        return dl(p3_mw) - dl(p1_mw)

    lo, hi = 0.0, 1.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if shift(mid) < MAX_SHIFT_NM:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


HEATER_COUPLING = _solve_heater_coupling()   # ~= 0.0194

# Thermal tuning efficiency, Eq. (9): d(lambda)/d(P_heater) [nm/mW].
ETA_LAMBDA_P_NM_PER_MW = LAMBDA_0_NM * BETA_TO_PER_K / N_EFF * R_THERMAL_K_PER_MW
assert abs(ETA_LAMBDA_P_NM_PER_MW - 0.238) < 2e-3, ETA_LAMBDA_P_NM_PER_MW

# --------------------------------------------------------------------------
# Table 3 — per-component static and dynamic energy
# --------------------------------------------------------------------------
LASER_STATIC_W = 1.38e-3            # per wavelength channel [W]
MRR_TO_STATIC_W = 1.58e-3           # avg thermal hold power per weight MRR [W]
#   (paper: resonance shift range = gamma/2 -> 0.5*gamma / eta_lambdaP = 1.58 mW)
assert abs(0.5 * GAMMA_HWHM_NM / ETA_LAMBDA_P_NM_PER_MW - 1.58) < 2e-2
MRR_EO_DYNAMIC_J_PER_BIT = 6.3e-15  # EO modulation energy [J/bit]
DAC_J_PER_BIT = 5.2e-12             # DAC conversion energy [J/bit]
PD_TIA_J_PER_BIT = 440e-15          # photodetector + TIA [J/bit]
SRAM_LEAK_W_PER_BIT = 48.1e-12      # SRAM leakage [W/bit]
SRAM_J_PER_BIT = 50e-15             # SRAM dynamic access [J/bit]
DRAM_J_PER_BIT = 20e-12             # main memory access [J/bit] (LPDDR-class)

# ADC: regression plug-in approach [Andrulis et al. 2024].  We model energy
# per conversion as FOM * 2^bits (Walden figure-of-merit form); 10 fJ/conv-step
# is representative of recent 5 GS/s SAR ADCs surveyed there.
ADC_FOM_J_PER_STEP = 10e-15


def adc_energy_per_conversion(bits: int) -> float:
    """Energy of one ADC conversion at the given resolution [J]."""
    return ADC_FOM_J_PER_STEP * (2 ** bits)


# --------------------------------------------------------------------------
# Timing
# --------------------------------------------------------------------------
F_OPERATING_HZ = 5e9            # paper Sec. 4: operating frequency 5 GHz
T_SLOT_S = 1.0 / F_OPERATING_HZ
T_TO_TUNING_S = 5e-6            # thermo-optic settle (5-10 us; lower bound)
T_EO_TUNING_S = 20e-12          # electro-optic update (20-40 ps; lower bound)

# --------------------------------------------------------------------------
# Noise (Sec. 4.2 experiment settings)
# --------------------------------------------------------------------------
SIGMA_DAC_DEFAULT = 0.02        # std of DAC-induced voltage error [V]
SIGMA_TH_DEFAULT = 0.04         # std of thermal crosstalk on dT [K]

# --------------------------------------------------------------------------
# Quantization defaults (Sec. 4: uniform 8-bit on inputs/weights/outputs)
# --------------------------------------------------------------------------
N_BITS_INPUT = 8
N_BITS_WEIGHT = 8
N_BITS_OUTPUT = 8

# --------------------------------------------------------------------------
# Architecture constraints (Sec. 3.5)
# --------------------------------------------------------------------------
MAX_WDM_CHANNELS = 8            # C <= 8
MAX_TOTAL_MRRS = 1024           # T * R * C <= 1024


class ComputeMode(enum.Enum):
    """Table 1 computing modes."""

    ANALOG = "analog"       # DEAP-CNNs: inputs and weights both analog, TO-tuned
    DIGITAL = "digital"     # HolyLight: binary inputs and weights, EO-tuned
    MIXED = "mixed"         # ROSA: analog weights (TO) + digital bit-serial inputs (EO)


class Mapping(enum.Enum):
    """Dataflow mapping of a layer onto the OPE array (Fig. 4)."""

    WS = "weight_stationary"
    IS = "input_stationary"
    GEMM = "gemm"           # transformer GEMM mapping (a WS variant over N_row)


@dataclasses.dataclass(frozen=True)
class OPEConfig:
    """One optical processing element array: R rows x C wavelength columns.

    ``tiles`` = number of such arrays on chip, subject to
    tiles * rows * cols <= MAX_TOTAL_MRRS.
    """

    rows: int
    cols: int
    tiles: int = 0  # 0 -> auto-fill to the MRR budget

    def __post_init__(self):
        if self.tiles == 0:
            object.__setattr__(
                self, "tiles", max(1, MAX_TOTAL_MRRS // (self.rows * self.cols))
            )

    @property
    def total_mrrs(self) -> int:
        return self.tiles * self.rows * self.cols


# Reference configurations used throughout the paper's experiments.
DEAP_HIGH_CHANNEL = OPEConfig(rows=113, cols=9, tiles=1)    # DEAP-CNNs [9]
ROSA_OPTIMAL = OPEConfig(rows=8, cols=8)                    # paper's winner
COMPACT_4X4 = OPEConfig(rows=4, cols=4)                     # [7, 27, 28]
