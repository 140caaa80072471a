"""Layer-wise hybrid mapping strategy (paper Sec. 3.5, Fig. 6, Table 4).

For each layer l and mapping m in {IS, WS} we profile:
  d_l(m) — accuracy degradation (percentage points vs. the noise-free model)
           when ONLY layer l runs through the noisy analog path under m,
  e_l(m) — that layer's EDP under m (from the analytical energy model).

The per-layer choice minimizes the balanced metric

    M_l(m) = (d_l(m)/d_ref)^alpha_l * (e_l(m)/e_ref)^(1-alpha_l)
    d_ref = min_m d_l(m),  e_ref = min_m e_l(m)
    alpha_l = alpha_min + gamma * log(1 + d_ref/d_tol)

with the paper's hyperparameters alpha_min=0.01, gamma=0.1, d_tol=1.0 —
layers whose best-case degradation exceeds ~1% get their accuracy term
up-weighted logarithmically.

This module is model-agnostic and pure Python (PyTorch port of the
pure-Python part of `repro.core.mapping`).  With a zero degradation
callback alpha collapses to alpha_min and the plan is the per-layer EDP
argmin, which is what the reference's vectorized `profile_layers_fast`
computes on the same shapes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

from repro_torch.core import energy as E
from repro_torch.core.constants import ComputeMode, Mapping, OPEConfig

ALPHA_MIN = 0.01
GAMMA = 0.1
D_TOL = 1.0         # percentage points
_D_FLOOR = 1e-3     # numerical floor so ratios stay finite at zero degradation


@dataclasses.dataclass
class LayerProfile:
    """Measured IS/WS behaviour of one layer."""

    name: str
    d_is: float     # accuracy degradation [pp] with layer on IS analog path
    d_ws: float     # ... with layer on WS analog path
    e_is: float     # EDP [J*s] under IS
    e_ws: float     # EDP [J*s] under WS

    def d(self, m: Mapping) -> float:
        return self.d_is if m is Mapping.IS else self.d_ws

    def e(self, m: Mapping) -> float:
        return self.e_is if m is Mapping.IS else self.e_ws


def alpha_of(d_ref: float) -> float:
    """Layer-adaptive accuracy weight alpha_l."""
    return min(1.0, ALPHA_MIN + GAMMA * math.log(1.0 + max(d_ref, 0.0) / D_TOL))


def balanced_metric(p: LayerProfile, m: Mapping) -> float:
    d_ref = max(min(p.d_is, p.d_ws), _D_FLOOR)
    e_ref = max(min(p.e_is, p.e_ws), 1e-30)
    a = alpha_of(d_ref)
    d = max(p.d(m), _D_FLOOR)
    return (d / d_ref) ** a * (p.e(m) / e_ref) ** (1.0 - a)


def choose_mapping(p: LayerProfile) -> Mapping:
    """arg-min of the balanced metric for one layer."""
    m_is = balanced_metric(p, Mapping.IS)
    m_ws = balanced_metric(p, Mapping.WS)
    return Mapping.IS if m_is < m_ws else Mapping.WS


def hybrid_plan(profiles: Sequence[LayerProfile]) -> dict[str, Mapping]:
    """The paper's layer-wise hybrid mapping plan (pure balanced-metric
    argmin)."""
    return {p.name: choose_mapping(p) for p in profiles}


def profile_layers(layers: Sequence[E.LayerShape],
                   ope: OPEConfig,
                   degradation_fn: Callable[[str, Mapping], float],
                   mode: ComputeMode = ComputeMode.MIXED,
                   osa: E.OSAEnergyConfig = E.OSA_OPTIMAL,
                   batch: int = 1) -> list[LayerProfile]:
    """Build LayerProfiles: EDP from the analytical model, accuracy from a
    user callback `degradation_fn(layer_name, mapping) -> pp degradation`.

    The callback is where behavioural simulation happens (inject noise into
    exactly one layer, eval, diff against clean accuracy).
    """
    out = []
    for layer in layers:
        e_is = E.layer_energy(layer, ope, Mapping.IS, mode, osa, batch=batch).edp
        e_ws = E.layer_energy(layer, ope, Mapping.WS, mode, osa, batch=batch).edp
        out.append(LayerProfile(
            name=layer.name,
            d_is=degradation_fn(layer.name, Mapping.IS),
            d_ws=degradation_fn(layer.name, Mapping.WS),
            e_is=e_is, e_ws=e_ws,
        ))
    return out


def plan_edp(layers: Sequence[E.LayerShape], plan: dict[str, Mapping],
             ope: OPEConfig, mode: ComputeMode = ComputeMode.MIXED,
             osa: E.OSAEnergyConfig = E.OSA_OPTIMAL,
             batch: int = 1) -> float:
    """Network EDP under a given per-layer mapping plan.

    The trace-based counterpart is `rosa.EnergyLedger.edp`, which prices the
    matmuls an Engine actually routed; on the same layers/plan the two agree
    by construction.
    """
    return E.network_energy(layers, ope, plan, mode, osa, batch=batch).edp
