"""Per-device static variation: the chip-ensemble half of the noise model
(PyTorch port of `repro.robust.variation`).

Fabricated chips differ statically: driver/DAC offsets, thermal-crosstalk
bias and fab mismatch of each ring's resonance.  `sample_chip` draws those
fields once per chip, per layer, as per-reduction-lane (K,) vectors
(`rosa.backends` adapts the orientation per operand), from a
`torch.Generator`.  Layer draws are folded from the layer name, so adding
or removing layers never changes the others.

A chip is `{layer: mrr.StaticVariation}`; an ensemble (an "N-chip wafer")
is the same dict with a leading chip axis on every field, the layout of
the reference's pytree.  The draws are not the reference's (threefry bits
cannot be reproduced with torch generators); `from_reference` carries a
reference chip or ensemble across, so both packages can evaluate the same
chips.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Mapping as TMapping, Sequence

import numpy as np
import torch

from repro_torch.core import mrr
from repro_torch.core.constants import SIGMA_DAC_DEFAULT, SIGMA_TH_DEFAULT
from repro_torch.models.cnn import LITE_MODELS


@dataclasses.dataclass(frozen=True)
class VariationModel:
    """Standard deviations of the per-chip static fields."""

    sigma_v_static: float = 0.5 * SIGMA_DAC_DEFAULT    # [V] driver offset
    sigma_dt_static: float = SIGMA_TH_DEFAULT          # [K] thermal bias
    sigma_lambda_fab: float = 0.01                     # [nm] fab mismatch

    @property
    def is_zero(self) -> bool:
        return (self.sigma_v_static == 0.0 and self.sigma_dt_static == 0.0
                and self.sigma_lambda_fab == 0.0)

    def scaled(self, s: float) -> "VariationModel":
        """The model with every sigma multiplied by `s`."""
        return VariationModel(self.sigma_v_static * s,
                              self.sigma_dt_static * s,
                              self.sigma_lambda_fab * s)


NO_VARIATION = VariationModel(0.0, 0.0, 0.0)
PAPER_VARIATION = VariationModel()

# A chip: {layer_name: StaticVariation}; an ensemble is the same dict with
# a leading n_chips axis on every field.
Chip = dict[str, mrr.StaticVariation]


def _layer_fold(key: torch.Generator, name: str) -> torch.Generator:
    """Name-stable per-layer key (same CRC folding as rosa.layer_key)."""
    return mrr.fold_in(key, zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF)


def sample_layer(key: torch.Generator, model: VariationModel,
                 lanes: int | Sequence[int], device=None
                 ) -> mrr.StaticVariation:
    """One layer's static fields: (K,) lane vectors (or a full shape)."""
    shape = (lanes,) if isinstance(lanes, int) else tuple(lanes)
    k_v, k_t, k_l = mrr.split_keys(key, 3)
    return mrr.StaticVariation(
        dv=model.sigma_v_static * mrr.normal(k_v, shape, device),
        ddt=model.sigma_dt_static * mrr.normal(k_t, shape, device),
        dlam=model.sigma_lambda_fab * mrr.normal(k_l, shape, device))


def sample_chip(key: torch.Generator, dims: TMapping[str, int | Sequence[int]],
                model: VariationModel = PAPER_VARIATION, device=None) -> Chip:
    """Draw ONE fabricated chip: independent static fields per layer;
    `dims` maps layer name -> lane count K (or a full field shape)."""
    return {name: sample_layer(_layer_fold(key, name), model, lanes, device)
            for name, lanes in dims.items()}


def _stack(chips: Sequence[Chip]) -> Chip:
    return {name: mrr.StaticVariation(
        *(torch.stack([getattr(c[name], f) for c in chips])
          for f in ("dv", "ddt", "dlam"))) for name in chips[0]}


def _map(ensemble: Chip, fn) -> Chip:
    return {name: mrr.StaticVariation(fn(v.dv), fn(v.ddt), fn(v.dlam))
            for name, v in ensemble.items()}


def sample_ensemble(key: torch.Generator, n_chips: int,
                    dims: TMapping[str, int | Sequence[int]],
                    model: VariationModel = PAPER_VARIATION, *,
                    antithetic: bool = False, device=None) -> Chip:
    """An "N-chip wafer": `sample_chip` over `mrr.split_keys(key, n_chips)`,
    stacked on a leading chip axis.  With ``antithetic=True`` (even
    `n_chips`) only ``n_chips // 2`` chips are drawn and chip ``2i + 1``
    is the sign mirror of chip ``2i``: the same zero-mean marginal, but
    each pair's accuracy errors anticorrelate, which cuts the Monte-Carlo
    variance of ensemble means."""
    if not antithetic:
        return _stack([sample_chip(k, dims, model, device)
                       for k in mrr.split_keys(key, n_chips)])
    if n_chips % 2:
        raise ValueError(f"antithetic sampling pairs chips: n_chips must "
                         f"be even, got {n_chips}")
    half = sample_ensemble(key, n_chips // 2, dims, model, device=device)
    return _map(half, lambda a: torch.stack([a, -a], dim=1).reshape(
        n_chips, *a.shape[1:]))


def chip_at(ensemble: Chip, i: int) -> Chip:
    """Chip `i` of an ensemble."""
    return _map(ensemble, lambda a: a[i])


def chip_slice(ensemble: Chip, n: int) -> Chip:
    """The first `n` chips of an ensemble (the estimator's probe set)."""
    return _map(ensemble, lambda a: a[:n])


def ensemble_size(ensemble: Chip) -> int:
    """Number of chips in an ensemble (its leading axis)."""
    return int(next(iter(ensemble.values())).dv.shape[0])


def scale_ensemble(ensemble: Chip, s) -> Chip:
    """Scale every static field (the sigma-sweep knob)."""
    return _map(ensemble, lambda a: a * s)


def shift_thermal(ensemble: Chip, offset) -> Chip:
    """Add a global thermal offset [K] to every layer's ddt field: the
    injection point of drift schedules (`robust.drift`)."""
    return {name: v.shift_ddt(offset) for name, v in ensemble.items()}


def from_reference(chips, device=None) -> Chip:
    """A chip or ensemble sampled by the reference (`{name: StaticVariation}`
    of jax or numpy arrays), each field converted through numpy to a
    float32 tensor on `device`."""
    conv = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    return {name: mrr.StaticVariation(conv(v.dv), conv(v.ddt), conv(v.dlam))
            for name, v in chips.items()}


def cnn_lane_dims(model: str) -> dict[str, int]:
    """Reduction-lane count per layer of a lite CNN (weight K dimension;
    a depthwise conv has one ring per channel)."""
    return {s.name: s.c_in if s.kind in ("fc", "dwconv")
            else s.c_in * s.k * s.k for s in LITE_MODELS[model]}
