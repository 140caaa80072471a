"""Thermal drift schedules and periodic re-trim (PyTorch port of
`repro.robust.drift`).

Deployed chips drift: ambient temperature and heater aging shift every
ring's operating point over minutes to hours.  Drift is a global thermal
offset d(t) [K] added to each chip's static `ddt` field; re-trim is the
controller re-invoking the programming calibration (`mrr.voltage_of_weight`
with its `dt_trim` hook) against the offset measured at trim time, so
between trims the residual is d(t) - d(t_trim).

`simulate` reuses one ensemble evaluator across the time grid: each step
only shifts the ensemble's ddt fields.  The reference's per-tick
`DriftModel.offsets_at` serves its drift-adaptive serving controller and
waits with it (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import mrr
from repro_torch.robust import variation as V
from repro_torch.robust.ensemble import (ApplyFn, EnsembleResult,
                                         cnn_apply_fn, cnn_eval_set,
                                         make_ensemble_eval)


@dataclasses.dataclass(frozen=True)
class DriftModel:
    """Thermal drift schedule d(t) [K], deterministic given a key."""

    kind: str = "sine"          # sine | linear | walk
    amp_k: float = 0.25         # peak offset [K]
    period_s: float = 3600.0    # sine period / linear ramp horizon [s]

    def offsets(self, t_grid, key: torch.Generator | None = None
                ) -> np.ndarray:
        """Offsets d(t) on the grid (float64); `walk` needs a key (Gaussian
        steps, the first 0, scaled so the horizon-end std is ~amp_k)."""
        t = np.asarray(t_grid, dtype=np.float64)
        if self.kind == "sine":
            return self.amp_k * np.sin(2.0 * np.pi * t / self.period_s)
        if self.kind == "linear":
            return self.amp_k * t / self.period_s
        if self.kind == "walk":
            if key is None:
                raise ValueError("random-walk drift requires a key")
            steps = mrr.normal(key, (len(t),)).cpu().numpy()
            steps[0] = 0.0
            return self.amp_k * np.cumsum(steps) / max(np.sqrt(len(t) - 1),
                                                       1.0)
        raise ValueError(f"unknown drift kind {self.kind!r}")


def trim_voltages(w_target, dt_known, p: mrr.MRRParams = mrr.DEFAULT_PARAMS):
    """Re-invoke the programming calibration against a measured thermal
    offset: voltages with which, the offset present, the realized weights
    hit their targets (clipping aside)."""
    return torch.clamp(mrr.voltage_of_weight(w_target, p, dt_trim=dt_known),
                       p.v_min, p.v_max)


def residual_offsets(offsets: np.ndarray, t_grid: np.ndarray,
                     retrim_every: float | None) -> np.ndarray:
    """Effective offset after periodic re-trim: d(t) - d(last trim <= t),
    the offset at trim time interpolated on the sampled schedule (exact
    when trims land on grid points).  `retrim_every=None`: no re-trim
    after the calibration at t = 0."""
    t = np.asarray(t_grid, dtype=np.float64)
    if retrim_every is None:
        return offsets - offsets[0]
    t_trims = (t // retrim_every) * retrim_every
    return offsets - np.interp(t_trims, t, offsets)


@dataclasses.dataclass
class DriftResult:
    """Time series of ensemble accuracy under a drift schedule."""
    times: np.ndarray               # (T,) [s]
    residual_k: np.ndarray          # (T,) effective thermal offset [K]
    mean_acc: np.ndarray            # (T,) ensemble-mean accuracy [%]
    min_acc: np.ndarray             # (T,)
    yield_2pp: np.ndarray           # (T,) yield at 2 pp drop
    clean_acc: float

    def worst_mean_acc(self) -> float:
        return float(self.mean_acc.min())

    def summary(self) -> dict:
        return {"clean_acc": self.clean_acc,
                "worst_mean_acc": self.worst_mean_acc(),
                "final_mean_acc": float(self.mean_acc[-1]),
                "min_yield_2pp": float(self.yield_2pp.min())}


def simulate(apply_fn: ApplyFn, params, x, y, engine, ensemble: V.Chip,
             key: torch.Generator, drift: DriftModel, t_grid,
             retrim_every: float | None = None, *,
             eval_batch: int = 128,
             yield_drop_pp: float = 2.0,
             evaluator=None) -> DriftResult:
    """Accuracy over time of a chip ensemble under a drift schedule, with
    optional periodic re-trim.  `evaluator` (a `make_ensemble_eval` of the
    same apply_fn / engine / eval_batch) is shared across simulations."""
    t = np.asarray(t_grid, dtype=np.float64)
    key, k_walk = mrr.split(key)
    resid = residual_offsets(drift.offsets(t, k_walk), t, retrim_every)
    n = V.ensemble_size(ensemble)
    run = evaluator if evaluator is not None \
        else make_ensemble_eval(apply_fn, engine, eval_batch=eval_batch)
    mean_acc, min_acc, yld = [], [], []
    clean = 0.0
    for i in range(len(t)):
        ens_t = V.shift_thermal(ensemble, float(resid[i]))
        keys = mrr.split_keys(mrr.fold_in(key, i), n)
        res = EnsembleResult(*run(params, x, y, ens_t, keys))
        clean = res.clean_acc
        mean_acc.append(res.mean_acc)
        min_acc.append(res.min_acc)
        yld.append(res.yield_frac(yield_drop_pp))
    return DriftResult(times=t, residual_k=resid,
                       mean_acc=np.asarray(mean_acc),
                       min_acc=np.asarray(min_acc),
                       yield_2pp=np.asarray(yld), clean_acc=clean)


def simulate_cnn(params, model: str, engine, ensemble: V.Chip,
                 key: torch.Generator, drift: DriftModel, t_grid,
                 retrim_every: float | None = None, *,
                 n_eval: int = 256, eval_batch: int = 128,
                 evaluator=None) -> DriftResult:
    """`simulate` on a lite CNN's synth-CIFAR evaluation set, on the
    device the parameters live on."""
    from repro_torch.training.cnn_train import params_device
    x, y = cnn_eval_set(n_eval, device=params_device(params))
    return simulate(cnn_apply_fn(model), params, x, y, engine, ensemble,
                    key, drift, t_grid, retrim_every,
                    eval_batch=eval_batch, evaluator=evaluator)
