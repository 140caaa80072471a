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

This module is model-agnostic (PyTorch port of `repro.core.mapping`): the
CNN experiment (launch/table4) supplies accuracy callbacks; the LM zoo uses
the EDP side only, through the vectorized `profile_layers_fast`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch

from repro_torch.core import energy as E
from repro_torch.core import energy_vec as EV
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


def degradation_fn_from_matrix(deg) -> Callable[[str, Mapping], float]:
    """Adapt a `{layer: {mapping.value: pp}}` degradation matrix to the
    `degradation_fn(name, mapping)` callback the profilers take."""
    return lambda name, m: deg[name][m.value]


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


def profile_layers_fast(layers: Sequence[E.LayerShape],
                        ope: OPEConfig,
                        degradation_fn: Callable[[str, Mapping], float]
                        | None = None,
                        mode: ComputeMode = ComputeMode.MIXED,
                        osa: E.OSAEnergyConfig = E.OSA_OPTIMAL,
                        batch: int = 1,
                        device: str | torch.device | None = None
                        ) -> list[LayerProfile]:
    """Vectorized LayerProfile builder for model-zoo-scale networks.

    Both mappings' per-layer EDPs come from `core.energy_vec` in two
    broadcast evaluations on `device` (None: CUDA; raises without a card)
    instead of 2*L scalar ones.  Without a degradation callback (zoo
    workloads have no behavioural twin) degradations are 0, alpha collapses
    to alpha_min, and the hybrid plan reduces to the per-layer EDP argmin —
    the paper's search with the accuracy term muted.
    """
    cand = EV.stack_candidates([ope])
    stacked = EV.stack_layers(layers)
    edps = {}
    for mp in (Mapping.IS, Mapping.WS):
        spec = EV.EnergySpec.make(mapping=mp, mode=mode, osa=osa, batch=batch)
        en, lat = EV.grid_energy(cand, stacked, spec, device=device)
        edps[mp] = (en[0] * lat[0]).cpu().tolist()
    d_fn = degradation_fn if degradation_fn is not None \
        else (lambda name, m: 0.0)
    return [LayerProfile(
        name=layer.name,
        d_is=d_fn(layer.name, Mapping.IS),
        d_ws=d_fn(layer.name, Mapping.WS),
        e_is=edps[Mapping.IS][i], e_ws=edps[Mapping.WS][i])
        for i, layer in enumerate(layers)]


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


def execution_plan(profiles: Sequence[LayerProfile], default_cfg,
                   layers: Sequence[str] | None = None):
    """Lift profiled layers straight into an executable `rosa.ExecutionPlan`:
    per-layer balanced-metric argmin, overriding `default_cfg`'s mapping."""
    # local import: repro_torch.rosa initializes through repro_torch.core,
    # so a module-level import here would be circular
    from repro_torch.rosa.plan import ExecutionPlan
    return ExecutionPlan.from_mapping_plan(
        default_cfg, hybrid_plan(profiles),
        layers if layers is not None else [p.name for p in profiles])
