"""Event-count energy / latency / EDP model of the MRR-ONN (paper Sec. 3.4).

The paper extends Timeloop/CiMLoop with photonic primitives; this module is
the same idea in analytical closed form: for a layer's GEMM (M,K,N) mapped
onto a (T x R x C) OPE fleet under a given compute mode (Table 1), dataflow
mapping (Fig. 4) and OSA configuration, we count *every* energy event —

    weight-programming DACs, EO input modulation bits, photodetections,
    ADC conversions, partial-sum SRAM read-modify-writes, DRAM traffic —

and every latency contributor (thermo-optic settles, bit-slot streaming),
then integrate static power (lasers, TO holds, ODL stages, SRAM leakage)
over the layer runtime.  EDP = energy * latency.

Conventions:
  * conv layers are im2col'd to GEMM: M = output pixels, K = C_in*kh*kw,
    N = C_out; grouped/depthwise convs become `groups` independent
    sub-GEMMs of (M, K/g, N/g).
  * mixed mode (ROSA): weights analog on TO-tuned MRRs, inputs bit-serial
    signed digits on EO modulators, `n_slots = N_i - 1` slots per value.
  * without OSA the photocurrent is digitized once per bit slot; with OSA
    slots accumulate optically and the ADC fires once per `ode_len` slots
    (optimal ODE sizing: ode_len = n_slots -> exactly one conversion per
    output per K-tile).

All arithmetic is plain Python floats — this model is swept thousands of
times by the DSE and must stay trace-free.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

from repro_torch.core import constants as C
from repro_torch.core.constants import ComputeMode, Mapping, OPEConfig

PSUM_BITS = 24          # electronic partial-sum accumulator width
ODL_STATIC_W = 0.2e-3   # per ODL shift stage: SCISSOR thermal hold + phase
#                         calibration [17, 18] — passive spiral + trim heater,
#                         well below a full MRR resonance hold (1.58 mW).


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """One GEMM-lowered layer."""

    name: str
    m: int                 # streamed/output spatial dim (tokens or pixels)
    k: int                 # reduction dim
    n: int                 # output channels
    groups: int = 1
    kind: str = "conv"     # conv | dwconv | fc | gemm (bookkeeping only)

    @property
    def macs(self) -> int:
        return self.m * (self.k // self.groups) * (self.n // self.groups) \
            * self.groups

    def sub_gemm(self) -> tuple[int, int, int, int]:
        """(g, M, K, N) of the per-group sub-GEMM."""
        return (self.groups, self.m,
                max(1, self.k // self.groups), max(1, self.n // self.groups))


@dataclasses.dataclass(frozen=True)
class OSAEnergyConfig:
    """OSA presence and optical-delay-element sizing."""

    enabled: bool = True
    ode_len: int = 0       # max slots the ODL chain can align; 0 -> all slots
    #                        (paper's 'optimized ODE sizing'); Fig. 8's plain
    #                        OSA bar corresponds to a shorter default chain.

    def conversions_per_output(self, n_slots: int) -> int:
        if not self.enabled:
            return n_slots
        ode = self.ode_len if self.ode_len > 0 else n_slots
        return math.ceil(n_slots / ode)

    def stages_per_row(self, n_slots: int) -> int:
        if not self.enabled:
            return 0
        ode = self.ode_len if self.ode_len > 0 else n_slots
        return min(ode, n_slots) - 1


NO_OSA = OSAEnergyConfig(enabled=False)
OSA_DEFAULT = OSAEnergyConfig(enabled=True, ode_len=4)   # un-optimized chain
OSA_OPTIMAL = OSAEnergyConfig(enabled=True, ode_len=0)   # sized to n_slots


@dataclasses.dataclass
class EnergyBreakdown:
    """Per-component energies [J], latency [s], and the EDP [J*s]."""

    name: str = ""
    laser: float = 0.0
    mrr_static: float = 0.0
    odl_static: float = 0.0
    sram_leak: float = 0.0
    eo_mod: float = 0.0
    dac_prog: float = 0.0
    pd_tia: float = 0.0
    adc: float = 0.0
    sram_dyn: float = 0.0
    dram: float = 0.0
    latency: float = 0.0
    events: dict = dataclasses.field(default_factory=dict)

    @property
    def static(self) -> float:
        return self.laser + self.mrr_static + self.odl_static + self.sram_leak

    @property
    def dynamic(self) -> float:
        return (self.eo_mod + self.dac_prog + self.pd_tia + self.adc
                + self.sram_dyn + self.dram)

    @property
    def energy(self) -> float:
        return self.static + self.dynamic

    @property
    def edp(self) -> float:
        return self.energy * self.latency

    def __add__(self, o: "EnergyBreakdown") -> "EnergyBreakdown":
        out = EnergyBreakdown(name=self.name or o.name)
        for f in ("laser", "mrr_static", "odl_static", "sram_leak", "eo_mod",
                  "dac_prog", "pd_tia", "adc", "sram_dyn", "dram", "latency"):
            setattr(out, f, getattr(self, f) + getattr(o, f))
        out.events = {k: self.events.get(k, 0) + o.events.get(k, 0)
                      for k in set(self.events) | set(o.events)}
        return out

    def as_dict(self) -> dict:
        d = {f: getattr(self, f) for f in
             ("laser", "mrr_static", "odl_static", "sram_leak", "eo_mod",
              "dac_prog", "pd_tia", "adc", "sram_dyn", "dram")}
        d.update(energy=self.energy, latency=self.latency, edp=self.edp)
        return d


def _tiles(stationary_rows: int, stationary_cols: int, ope: OPEConfig):
    """Tile grid of the stationary operand over one R x C array."""
    return (math.ceil(stationary_rows / ope.rows),
            math.ceil(stationary_cols / ope.cols))


def layer_energy(shape: LayerShape,
                 ope: OPEConfig,
                 mapping: Mapping = Mapping.WS,
                 mode: ComputeMode = ComputeMode.MIXED,
                 osa: OSAEnergyConfig = OSA_OPTIMAL,
                 n_bits_in: int = C.N_BITS_INPUT,
                 n_bits_w: int = C.N_BITS_WEIGHT,
                 n_bits_out: int = C.N_BITS_OUTPUT,
                 pam_bits: int = 1,
                 batch: int = 1) -> EnergyBreakdown:
    """Energy/latency/EDP of one layer inference (see module docstring)."""
    g, m, k_pg, n_pg = shape.sub_gemm()           # per-group K, N
    m = m * batch
    n_total = shape.n
    bd = EnergyBreakdown(name=shape.name)

    n_slots = max(1, math.ceil((n_bits_in - 1) / pam_bits))

    # ---- tile grid of the stationary operand -----------------------------
    # Grouped/depthwise convs are GROUP-PACKED (the co-optimized mapper of
    # Sec. 4 packs different groups on different rows): all n_total output
    # channels tile over the rows, while WDM reduction parallelism is
    # bounded by the PER-GROUP reduction depth k/g.
    if mapping in (Mapping.WS, Mapping.GEMM):
        tiles_r, tiles_c = _tiles(n_total, k_pg, ope)   # weights stationary
        n_tiles = tiles_r * tiles_c
        stream_len = m                            # input vectors per tile
    elif mapping is Mapping.IS:
        tiles_r, tiles_c = _tiles(m, k_pg, ope)   # inputs stationary
        n_tiles = g * tiles_r * tiles_c
        stream_len = n_pg                         # weight vectors per tile
    else:
        raise ValueError(mapping)
    rounds = math.ceil(n_tiles / ope.tiles)

    # ---- per-mode timing and event structure -----------------------------
    if mode is ComputeMode.MIXED:
        t_program = C.T_TO_TUNING_S               # stationary operand is TO
        slots_per_value = n_slots
        t_stream = stream_len * slots_per_value * C.T_SLOT_S
        conv_per_out = osa.conversions_per_output(n_slots)
    elif mode is ComputeMode.ANALOG:
        # DEAP-CNNs: both operands analog + TO-tuned; every streamed vector
        # is itself a thermo-optic reprogramming (Table 1: update time t_TO).
        t_program = C.T_TO_TUNING_S
        slots_per_value = 1
        t_stream = stream_len * C.T_TO_TUNING_S
        conv_per_out = 1                          # single-shot analog readout
    elif mode is ComputeMode.DIGITAL:
        # HolyLight: 1-bit EO operands; N_i*N_w slot passes per value pair.
        t_program = C.T_EO_TUNING_S
        slots_per_value = n_bits_in * n_bits_w
        t_stream = stream_len * slots_per_value * C.T_SLOT_S
        conv_per_out = slots_per_value            # digitize every slot
    else:
        raise ValueError(mode)

    bd.latency = rounds * (t_program + t_stream)

    # ---- dynamic energy ---------------------------------------------------
    # stationary-operand programming: full array per tile (parked rings are
    # still driven to their off state), one DAC word per MRR.
    prog_events = n_tiles * ope.rows * ope.cols
    if mode is ComputeMode.DIGITAL:
        bd.dac_prog = 0.0
        bd.eo_mod = prog_events * n_bits_w * C.MRR_EO_DYNAMIC_J_PER_BIT
    else:
        bd.dac_prog = prog_events * n_bits_w * C.DAC_J_PER_BIT

    # streamed-operand encoding
    stream_values = n_tiles * stream_len * ope.cols
    if mode is ComputeMode.ANALOG:
        # analog amplitude needs a DAC sample per streamed value
        bd.dac_prog += stream_values * n_bits_in * C.DAC_J_PER_BIT
    else:
        bd.eo_mod += stream_values * slots_per_value * C.MRR_EO_DYNAMIC_J_PER_BIT

    # detection + digitization: per useful output, per K-tile, per conversion
    # (unused rows of a partially-filled tile are power-gated: no ADC fires)
    useful_outputs = m * n_total
    out_events = useful_outputs * tiles_c * conv_per_out
    bd.pd_tia = out_events * C.PD_TIA_J_PER_BIT
    bd.adc = out_events * C.adc_energy_per_conversion(n_bits_out)

    # partial-sum SRAM read-modify-write per digitized sample
    bd.sram_dyn = out_events * 2 * PSUM_BITS * C.SRAM_J_PER_BIT
    # tile staging traffic: stationary words in, streamed words in, outputs out
    sram_words = (prog_events * n_bits_w
                  + stream_values * n_bits_in
                  + useful_outputs * n_bits_out)
    bd.sram_dyn += sram_words * C.SRAM_J_PER_BIT

    # DRAM: each tensor moves once (per-group sub-tensors summed over groups)
    bd.dram = (m * k_pg * g * n_bits_in + k_pg * n_pg * g * n_bits_w
               + m * n_total * n_bits_out) * C.DRAM_J_PER_BIT

    # ---- static energy = power * runtime ----------------------------------
    p_laser = ope.tiles * ope.cols * C.LASER_STATIC_W
    p_mrr = ope.tiles * ope.rows * ope.cols * C.MRR_TO_STATIC_W \
        if mode is not ComputeMode.DIGITAL else 0.0
    p_odl = ope.tiles * ope.rows * osa.stages_per_row(n_slots) * ODL_STATIC_W \
        if mode is ComputeMode.MIXED else 0.0
    buf_bits = (ope.tiles * ope.rows * ope.cols * n_bits_w      # weight buffer
                + ope.tiles * ope.cols * stream_len * n_bits_in  # stream buffer
                + ope.tiles * ope.rows * PSUM_BITS)              # psum regs
    p_leak = buf_bits * C.SRAM_LEAK_W_PER_BIT

    bd.laser = p_laser * bd.latency
    bd.mrr_static = p_mrr * bd.latency
    bd.odl_static = p_odl * bd.latency
    bd.sram_leak = p_leak * bd.latency

    bd.events = dict(n_tiles=n_tiles, rounds=rounds, prog_events=prog_events,
                     stream_values=stream_values, out_events=out_events,
                     adc_conversions=out_events, macs=shape.macs * batch)
    return bd


def network_energy(layers: Iterable[LayerShape],
                   ope: OPEConfig,
                   mappings: dict[str, Mapping] | Mapping = Mapping.WS,
                   mode: ComputeMode = ComputeMode.MIXED,
                   osa: OSAEnergyConfig = OSA_OPTIMAL,
                   batch: int = 1,
                   **kw) -> EnergyBreakdown:
    """Whole-network energy: layers execute sequentially on the chip."""
    total = EnergyBreakdown(name="network")
    for layer in layers:
        mp = mappings if isinstance(mappings, Mapping) \
            else mappings.get(layer.name, Mapping.WS)
        total = total + layer_energy(layer, ope, mp, mode, osa,
                                     batch=batch, **kw)
    return total


# --------------------------------------------------------------------------
# Table 1 analytical throughput (OPS) formulas
# --------------------------------------------------------------------------
def ops_analog(ope: OPEConfig, n_i: int = 8, n_w: int = 8) -> float:
    return ope.tiles * ope.rows * ope.cols * n_i * n_w / C.T_TO_TUNING_S


def ops_digital(ope: OPEConfig) -> float:
    return ope.tiles * ope.rows * ope.cols / C.T_EO_TUNING_S


def ops_mixed(ope: OPEConfig, n_w: int = 8) -> float:
    return ope.tiles * ope.rows * ope.cols * n_w / C.T_EO_TUNING_S
