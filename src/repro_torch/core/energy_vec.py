"""Vectorized counterpart of the analytical energy model (PyTorch port of
`repro.core.energy_vec`).

`core.energy.layer_energy` prices one (layer, OPE config) pair in plain
Python floats.  The DSE evaluates a candidate-grid x workload
cross-product, which the model zoo pushes into the hundreds of thousands
of cells; this module writes the *same arithmetic* once over broadcast
float64 tensors, so the whole grid evaluates in one pass on the device:

    cand   = stack_candidates(opes)        # (P,) int64: rows/cols/tiles
    layers = stack_layers(shapes)          # (L,) int64: g/m/k_pg/n_pg/n_total
    energy, latency = grid_energy(cand, layers, spec)      # (P, L) float64

Candidates enter as a (P, 1) column and layers as a (1, L) row, where the
reference vmaps a scalar formula over both axes.  Compute mode, dataflow
mapping, OSA sizing and bit widths are *static* (they select formulas, not
values) and ride in an `EnergySpec`, whose branches stay Python `if`s.

Scalar-model invariants preserved here (see energy.layer_energy):
  * ceil-divisions are exact integer ceil-divs on int64 (`//` floors in
    torch, so `-(-a // b)` is the ceiling), not float ceils;
  * event counts (tiles, programming words, streamed values, ADC firings)
    are integers until they are cast to float64 *before* the multiply by
    per-event Joule constants: an int64 tensor times a Python float is
    float32 in torch, which would lose the 1e-9 parity;
  * static power integrates over the same `rounds * (t_prog + t_stream)`
    latency.

Entry points take `device=None`, meaning CUDA; without a card they raise
and name `device="cpu"` rather than fall back to the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import constants as C
from repro_torch.core.constants import ComputeMode, Mapping, OPEConfig
from repro_torch.core.energy import (LayerShape, ODL_STATIC_W,
                                     OSAEnergyConfig, PSUM_BITS)

F64 = torch.float64


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`device`, with None meaning CUDA; CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "energy model on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class EnergySpec:
    """Static (formula-selecting) knobs of one grid evaluation."""

    mapping: Mapping = Mapping.WS
    mode: ComputeMode = ComputeMode.MIXED
    osa_enabled: bool = False
    ode_len: int = 0
    n_bits_in: int = C.N_BITS_INPUT
    n_bits_w: int = C.N_BITS_WEIGHT
    n_bits_out: int = C.N_BITS_OUTPUT
    pam_bits: int = 1
    batch: int = 1

    @classmethod
    def make(cls, mapping: Mapping = Mapping.WS,
             mode: ComputeMode = ComputeMode.MIXED,
             osa: OSAEnergyConfig | None = None,
             batch: int = 1, **kw) -> "EnergySpec":
        osa = osa if osa is not None else OSAEnergyConfig(enabled=False)
        return cls(mapping=mapping, mode=mode, osa_enabled=osa.enabled,
                   ode_len=osa.ode_len, batch=batch, **kw)

    @property
    def osa(self) -> OSAEnergyConfig:
        return OSAEnergyConfig(enabled=self.osa_enabled, ode_len=self.ode_len)

    @property
    def n_slots(self) -> int:
        return max(1, math.ceil((self.n_bits_in - 1) / self.pam_bits))


def stack_candidates(opes: Sequence[OPEConfig]) -> dict[str, np.ndarray]:
    """(P,) int64 arrays of the candidate grid."""
    return {
        "rows": np.array([o.rows for o in opes], dtype=np.int64),
        "cols": np.array([o.cols for o in opes], dtype=np.int64),
        "tiles": np.array([o.tiles for o in opes], dtype=np.int64),
    }


def stack_layers(shapes: Sequence[LayerShape]) -> dict[str, np.ndarray]:
    """(L,) int64 arrays of GEMM-lowered layers (per-group dims pre-split)."""
    cols = {"g": [], "m": [], "k_pg": [], "n_pg": [], "n_total": []}
    for s in shapes:
        g, m, k_pg, n_pg = s.sub_gemm()
        cols["g"].append(g)
        cols["m"].append(m)
        cols["k_pg"].append(k_pg)
        cols["n_pg"].append(n_pg)
        cols["n_total"].append(s.n)
    return {k: np.array(v, dtype=np.int64) for k, v in cols.items()}


def _ceil_div(a, b):
    return -(-a // b)


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.to(F64)


def _layer_energy(cand: dict, layer: dict, spec: EnergySpec):
    """(energy [J], latency [s]) of every layer on every OPE config.

    `cand` holds (P, 1) and `layer` (1, L) int64 tensors; the formula of
    `energy.layer_energy` broadcasts them to (P, L).
    """
    rows, cols, tiles = cand["rows"], cand["cols"], cand["tiles"]
    g, m0, k_pg, n_pg = layer["g"], layer["m"], layer["k_pg"], layer["n_pg"]
    n_total = layer["n_total"]
    m = m0 * spec.batch

    n_slots = spec.n_slots
    mode, osa = spec.mode, spec.osa

    # ---- tile grid of the stationary operand -----------------------------
    if spec.mapping in (Mapping.WS, Mapping.GEMM):
        tiles_r = _ceil_div(n_total, rows)
        tiles_c = _ceil_div(k_pg, cols)
        n_tiles = tiles_r * tiles_c
        stream_len = m
    elif spec.mapping is Mapping.IS:
        tiles_r = _ceil_div(m, rows)
        tiles_c = _ceil_div(k_pg, cols)
        n_tiles = g * tiles_r * tiles_c
        stream_len = n_pg
    else:
        raise ValueError(spec.mapping)
    rounds = _ceil_div(n_tiles, tiles)

    # ---- per-mode timing and event structure -----------------------------
    if mode is ComputeMode.MIXED:
        t_program = C.T_TO_TUNING_S
        slots_per_value = n_slots
        t_stream = _f64(stream_len) * slots_per_value * C.T_SLOT_S
        conv_per_out = osa.conversions_per_output(n_slots)
    elif mode is ComputeMode.ANALOG:
        t_program = C.T_TO_TUNING_S
        slots_per_value = 1
        t_stream = _f64(stream_len) * C.T_TO_TUNING_S
        conv_per_out = 1
    elif mode is ComputeMode.DIGITAL:
        t_program = C.T_EO_TUNING_S
        slots_per_value = spec.n_bits_in * spec.n_bits_w
        t_stream = _f64(stream_len) * slots_per_value * C.T_SLOT_S
        conv_per_out = slots_per_value
    else:
        raise ValueError(mode)

    latency = _f64(rounds) * (t_program + t_stream)

    # ---- dynamic energy --------------------------------------------------
    prog_events = _f64(n_tiles * rows * cols)
    eo_mod = 0.0
    if mode is ComputeMode.DIGITAL:
        dac_prog = 0.0
        eo_mod = prog_events * spec.n_bits_w * C.MRR_EO_DYNAMIC_J_PER_BIT
    else:
        dac_prog = prog_events * spec.n_bits_w * C.DAC_J_PER_BIT

    stream_values = _f64(n_tiles) * _f64(stream_len) * _f64(cols)
    if mode is ComputeMode.ANALOG:
        dac_prog = dac_prog + stream_values * spec.n_bits_in * C.DAC_J_PER_BIT
    else:
        eo_mod = eo_mod + (stream_values * slots_per_value
                           * C.MRR_EO_DYNAMIC_J_PER_BIT)

    useful_outputs = _f64(m) * _f64(n_total)
    out_events = useful_outputs * _f64(tiles_c) * conv_per_out
    pd_tia = out_events * C.PD_TIA_J_PER_BIT
    adc = out_events * C.adc_energy_per_conversion(spec.n_bits_out)

    sram_dyn = out_events * 2 * PSUM_BITS * C.SRAM_J_PER_BIT
    sram_words = (prog_events * spec.n_bits_w
                  + stream_values * spec.n_bits_in
                  + useful_outputs * spec.n_bits_out)
    sram_dyn = sram_dyn + sram_words * C.SRAM_J_PER_BIT

    dram = (_f64(m) * _f64(k_pg * g) * spec.n_bits_in
            + _f64(k_pg * n_pg * g) * spec.n_bits_w
            + useful_outputs * spec.n_bits_out) * C.DRAM_J_PER_BIT

    dynamic = eo_mod + dac_prog + pd_tia + adc + sram_dyn + dram

    # ---- static energy = power * runtime ---------------------------------
    p_laser = _f64(tiles * cols) * C.LASER_STATIC_W
    p_mrr = (_f64(tiles * rows * cols) * C.MRR_TO_STATIC_W
             if mode is not ComputeMode.DIGITAL else 0.0)
    p_odl = (_f64(tiles * rows) * osa.stages_per_row(n_slots) * ODL_STATIC_W
             if mode is ComputeMode.MIXED else 0.0)
    buf_bits = (_f64(tiles * rows * cols) * spec.n_bits_w
                + _f64(tiles * cols) * _f64(stream_len) * spec.n_bits_in
                + _f64(tiles * rows) * PSUM_BITS)
    p_leak = buf_bits * C.SRAM_LEAK_W_PER_BIT

    energy = dynamic + (p_laser + p_mrr + p_odl + p_leak) * latency
    return energy, latency


def grid_energy(cand: dict, layers: dict, spec: EnergySpec,
                device: str | torch.device | None = None):
    """(P, L) float64 energy and latency on `device`: every candidate x
    every layer in one broadcast evaluation."""
    dev = resolve_device(device)

    def put(arrays: dict, shape: tuple[int, int]) -> dict:
        return {k: torch.as_tensor(np.asarray(v), dtype=torch.int64,
                                   device=dev).reshape(shape)
                for k, v in arrays.items()}

    return _layer_energy(put(cand, (-1, 1)), put(layers, (1, -1)), spec)
