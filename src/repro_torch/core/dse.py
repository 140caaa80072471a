"""OPE array-size design-space exploration (paper Sec. 3.5, Fig. 7; PyTorch
port of `repro.core.dse`).

Sweeps (R, C) under the physical constraints C <= MAX_WDM_CHANNELS and
T*R*C <= MAX_TOTAL_MRRS (T auto-filled to the budget), evaluates the EDP of
every workload network, and aggregates with

    G     = (prod_n EDP_n)^(1/N)            # balanced geometric mean
    W_max = max_n EDP_n                      # worst case
    M     = (1-lambda) * G + lambda * W_max  # robust efficiency metric

EDPs are expressed *relative to a reference config per workload* before
aggregation (the paper reports "relative EDP" vs. the compact 4x4 array) so
no single heavy network dominates the geomean.

Two evaluation engines produce identical `DSEPoint`s; they keep the
reference's names, so scripts and tests read the same in both packages:

  * ``engine="vmap"`` (default) — candidates and layers are stacked
    (`core.energy_vec`) and the analytic EDP model is evaluated over the
    full candidate-grid x workload cross-product in one float64 pass on
    the device, reduced per workload by one (L, W) incidence product.
  * ``engine="scalar"`` — the nested-loop pure-Python path, kept as the
    parity reference (tests hold the two to 1e-6 relative).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.core import energy as E
from repro_torch.core import energy_vec as EV
from repro_torch.core.constants import (COMPACT_4X4, DEAP_HIGH_CHANNEL,
                                        ComputeMode, Mapping, MAX_TOTAL_MRRS,
                                        MAX_WDM_CHANNELS, OPEConfig)


@dataclasses.dataclass
class Workload:
    name: str
    layers: list[E.LayerShape]


@dataclasses.dataclass
class DSEPoint:
    ope: OPEConfig
    edp_per_workload: dict[str, float]
    rel_edp: dict[str, float]
    geomean: float
    worst: float
    metric: float

    @property
    def label(self) -> str:
        return f"R={self.ope.rows},C={self.ope.cols},T={self.ope.tiles}"


def default_candidates(include_baselines: bool = True) -> list[OPEConfig]:
    """The sweep grid: all power-of-two-ish (R, C) within constraints."""
    rs = [1, 2, 4, 8, 16, 32, 64, 128]
    cs = [1, 2, 4, 8]
    cands = []
    for r in rs:
        for c in cs:
            if r * c <= MAX_TOTAL_MRRS and c <= MAX_WDM_CHANNELS:
                cands.append(OPEConfig(rows=r, cols=c))
    if include_baselines:
        cands.append(DEAP_HIGH_CHANNEL)      # violates C<=8; kept for comparison
    return cands


def evaluate(ope: OPEConfig,
             workloads: Sequence[Workload],
             reference: OPEConfig = COMPACT_4X4,
             lam: float = 0.3,
             mapping: Mapping = Mapping.WS,
             mode: ComputeMode = ComputeMode.MIXED,
             osa: E.OSAEnergyConfig = E.NO_OSA,
             batch: int = 1) -> DSEPoint:
    """Scalar reference: EDP of every workload on `ope`, aggregated."""
    edp, rel = {}, {}
    for wl in workloads:
        e = E.network_energy(wl.layers, ope, mapping, mode, osa, batch=batch).edp
        e_ref = E.network_energy(wl.layers, reference, mapping, mode, osa,
                                 batch=batch).edp
        edp[wl.name] = e
        rel[wl.name] = e / e_ref
    g = math.exp(sum(math.log(v) for v in rel.values()) / len(rel))
    w = max(rel.values())
    return DSEPoint(ope=ope, edp_per_workload=edp, rel_edp=rel,
                    geomean=g, worst=w, metric=(1 - lam) * g + lam * w)


# ---------------------------------------------------------------------------
# Vectorized engine
# ---------------------------------------------------------------------------
def evaluate_grid(workloads: Sequence[Workload],
                  candidates: Sequence[OPEConfig],
                  reference: OPEConfig = COMPACT_4X4,
                  lam: float = 0.3,
                  mapping: Mapping = Mapping.WS,
                  mode: ComputeMode = ComputeMode.MIXED,
                  osa: E.OSAEnergyConfig = E.NO_OSA,
                  batch: int = 1,
                  device: str | torch.device | None = None
                  ) -> list[DSEPoint]:
    """Vectorized DSE: all candidates x all workloads in one float64 pass
    on `device` (None: CUDA; raises without a card).

    Returns DSEPoints in candidate order (unsorted) so callers can line the
    results up against `candidates`.
    """
    dev = EV.resolve_device(device)
    names = [w.name for w in workloads]
    shapes: list[E.LayerShape] = []
    wl_id: list[int] = []
    for wi, wl in enumerate(workloads):
        shapes.extend(wl.layers)
        wl_id.extend([wi] * len(wl.layers))
    if not shapes:
        raise ValueError("no workload layers to evaluate")

    spec = EV.EnergySpec.make(mapping=mapping, mode=mode, osa=osa, batch=batch)
    # the last candidate row is the reference config
    energy, latency = EV.grid_energy(
        EV.stack_candidates(list(candidates) + [reference]),
        EV.stack_layers(shapes), spec, device=dev)             # (P+1, L)
    onehot = torch.zeros(len(shapes), len(names), dtype=EV.F64, device=dev)
    onehot[torch.arange(len(shapes), device=dev),
           torch.tensor(wl_id, device=dev)] = 1.0
    e_net = energy @ onehot                                    # (P+1, W)
    t_net = latency @ onehot
    edp = e_net * t_net
    rel = edp[:-1] / edp[-1:]                                  # vs reference
    geo = torch.exp(torch.mean(torch.log(rel), dim=1))
    worst = torch.amax(rel, dim=1)
    metric = (1.0 - lam) * geo + lam * worst
    # one copy back to the host
    host = torch.cat([edp[:-1], rel, geo[:, None], worst[:, None],
                      metric[:, None]], dim=1).cpu().tolist()
    w = len(names)
    return [
        DSEPoint(
            ope=ope,
            edp_per_workload=dict(zip(names, row[:w])),
            rel_edp=dict(zip(names, row[w:2 * w])),
            geomean=row[2 * w], worst=row[2 * w + 1], metric=row[2 * w + 2])
        for ope, row in zip(candidates, host)
    ]


def sweep(workloads: Sequence[Workload],
          candidates: Sequence[OPEConfig] | None = None,
          lam: float = 0.3,
          engine: str = "vmap",
          device: str | torch.device | None = None,
          **kw) -> list[DSEPoint]:
    """Full DSE; returns points sorted by the robust metric M (best first).

    ``engine="vmap"`` evaluates the whole grid in one pass on `device`
    (None: CUDA); ``engine="scalar"`` is the pure-Python reference path,
    which runs on the host.
    """
    candidates = candidates or default_candidates()
    if engine == "vmap":
        pts = evaluate_grid(workloads, candidates, lam=lam, device=device,
                            **kw)
    elif engine == "scalar":
        pts = [evaluate(ope, workloads, lam=lam, **kw) for ope in candidates]
    else:
        raise ValueError(f"unknown DSE engine {engine!r}")
    pts.sort(key=lambda p: p.metric)
    return pts


def best(workloads: Sequence[Workload], **kw) -> DSEPoint:
    return sweep(workloads, **kw)[0]
