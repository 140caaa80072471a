"""Per-device static variation: the chip half of the noise model (PyTorch
port of the part of `repro.robust.variation` that serving uses).

Fabricated chips differ statically: driver/DAC offsets, thermal-crosstalk
bias and fab mismatch of each ring's resonance.  `sample_chip` draws those
fields once per chip, per layer, as per-reduction-lane (K,) vectors
(`rosa.backends` adapts the orientation per operand), from a
`torch.Generator`.  Layer draws are folded from the layer name, so adding
or removing layers never changes the others.  The draws are not the
reference's; `models.model.chip_from_reference` carries a reference chip
across.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Mapping as TMapping, Sequence

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


NO_VARIATION = VariationModel(0.0, 0.0, 0.0)
PAPER_VARIATION = VariationModel()

Chip = dict[str, mrr.StaticVariation]


def _layer_fold(key: torch.Generator, name: str) -> torch.Generator:
    """Name-stable per-layer key (same CRC folding as rosa.layer_key)."""
    return mrr.fold_in(key, zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF)


def sample_layer(key: torch.Generator, model: VariationModel,
                 lanes: int | Sequence[int], device=None
                 ) -> mrr.StaticVariation:
    """One layer's static fields: (K,) lane vectors (or a full shape)."""
    shape = (lanes,) if isinstance(lanes, int) else tuple(lanes)
    k_v = mrr.fold_in(key, 0)
    k_t = mrr.fold_in(key, 1)
    k_l = mrr.fold_in(key, 2)
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


def cnn_lane_dims(model: str) -> dict[str, int]:
    """Reduction-lane count per layer of a lite CNN (weight K dimension;
    a depthwise conv has one ring per channel)."""
    return {s.name: s.c_in if s.kind in ("fc", "dwconv")
            else s.c_in * s.k * s.k for s in LITE_MODELS[model]}
