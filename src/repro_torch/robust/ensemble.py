"""Monte-Carlo chip-ensemble evaluation, an "N-chip wafer" (PyTorch port of
`repro.robust.ensemble`).

An evaluator runs a model forward over N static-variation instances: each
chip is pinned on the engine with its own per-shot key, the evaluation set
streams through in micro-batches, and per-chip accuracy, clean-prediction
agreement and yield come back.  The reference `jax.vmap`s over chips and
`lax.map`s over micro-batches inside one jit; here both are loops under
`torch.no_grad()`, and the callables keep the reference's signatures.  Per-
chip keys follow the reference's split structure (`mrr.split_keys(key,
n)`, the probe prefix of it, ...) with the port's generators.

    ens = variation.sample_ensemble(key, 64, variation.cnn_lane_dims("alexnet"))
    res = ensemble.evaluate_cnn_ensemble(params, "alexnet", engine, ens, key)
    res.mean_acc, res.yield_frac(max_drop_pp=2.0)
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import mrr
from repro_torch.robust import variation as V

# apply_fn(params, x, engine) -> logits; the engine arrives with this
# chip's variation and per-shot key pinned.
ApplyFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    """Variance-reduced ensemble estimator settings.

    ``n_probe`` chips get real evaluation-set forwards; the other chips'
    accuracies are predicted by a control-variate regression on a cheap
    weight-realization surrogate (`surrogate_features`).  ``0`` probes is
    brute force.  ``antithetic`` records whether the ensemble was drawn
    with mirrored pairs, so the probe prefix covers whole pairs."""

    n_probe: int = 4
    antithetic: bool = True
    control_variate: bool = True


FULL_MC = EstimatorConfig(n_probe=0, antithetic=False, control_variate=False)


@dataclasses.dataclass
class EnsembleResult:
    """Per-chip statistics of one ensemble evaluation."""

    accs: np.ndarray           # (n_chips,) accuracy [%] (vs labels, or vs
    #                            clean predictions when labels are absent)
    agreement: np.ndarray      # (n_chips,) argmax agreement with clean [0,1]
    clean_acc: float           # noise-free reference accuracy [%]
    n_probe: int = 0           # chips with measured (not predicted) accs;
    #                            0 = all measured (brute-force MC)
    method: str = "mc"         # "mc" | "control-variate"

    @property
    def n_chips(self) -> int:
        return len(self.accs)

    @property
    def mean_acc(self) -> float:
        return float(self.accs.mean())

    @property
    def std_acc(self) -> float:
        return float(self.accs.std())

    @property
    def min_acc(self) -> float:
        return float(self.accs.min())

    @property
    def mean_drop_pp(self) -> float:
        """Clean minus ensemble-mean accuracy [pp]."""
        return self.clean_acc - self.mean_acc

    def yield_frac(self, max_drop_pp: float = 2.0) -> float:
        """Fraction of chips within `max_drop_pp` of the clean model."""
        return float((self.accs >= self.clean_acc - max_drop_pp).mean())

    def yield_curve(self, drops_pp: Sequence[float]
                    ) -> list[tuple[float, float]]:
        return [(float(d), self.yield_frac(d)) for d in drops_pp]

    def summary(self) -> dict:
        """One-level dict of the headline statistics (JSON-ready)."""
        out = {"n_chips": self.n_chips, "clean_acc": self.clean_acc,
               "mean_acc": self.mean_acc, "std_acc": self.std_acc,
               "min_acc": self.min_acc,
               "mean_agreement": float(self.agreement.mean()),
               "yield_2pp": self.yield_frac(2.0), "method": self.method}
        if self.n_probe:
            out["n_probe"] = self.n_probe
        return out


def clean_reference(engine):
    """The noise-free twin of an engine: the same plan with per-shot noise
    muted, no pinned chip, no gates, no key."""
    plan = engine.plan.map_configs(
        lambda c: dataclasses.replace(c, noise=mrr.IDEAL))
    return engine.with_plan(plan).with_variation(None).with_gates(None) \
        .with_mapping_gates(None).with_key(None)


def chunk_eval_set(x: torch.Tensor, size: int) -> torch.Tensor:
    """(N, ...) -> (N // size, size, ...) micro-batches.  A remainder that
    does not fill a chunk is dropped, with a warning."""
    size = min(size, x.shape[0])
    n = (x.shape[0] // size) * size
    if n < x.shape[0]:
        warnings.warn(
            f"evaluation set truncated {x.shape[0]} -> {n} samples "
            f"(not a multiple of eval_batch={size}); statistics cover the "
            f"truncated set", stacklevel=2)
    return x[:n].reshape(n // size, size, *x.shape[1:])


def chunked_argmax_preds(apply_fn: ApplyFn, params, xb: torch.Tensor,
                         engine) -> torch.Tensor:
    """Stream the (n_chunks, chunk, ...) batches through the engine; flat
    argmax predictions."""
    return torch.cat([torch.argmax(apply_fn(params, xc, engine), -1)
                      for xc in xb])


def _scores(preds: torch.Tensor, clean_pred: torch.Tensor, y):
    """(accs, agreement, clean_acc) from (n_chips, n_eval) predictions."""
    ref = clean_pred if y is None else y[:preds.shape[1]]
    accs = 100.0 * (preds == ref[None, :]).float().mean(dim=1)
    agreement = (preds == clean_pred[None, :]).float().mean(dim=1)
    clean_acc = 100.0 * (clean_pred == ref).float().mean()
    return accs.cpu().numpy(), agreement.cpu().numpy(), float(clean_acc)


def _floats(v) -> list[float]:
    return [float(a) for a in torch.as_tensor(v).reshape(-1).tolist()]


def make_ensemble_eval(apply_fn: ApplyFn, engine, *, eval_batch: int = 128):
    """The evaluator (params, x, y, ensemble, keys) -> (accs, agreement,
    clean_acc): numpy (n_chips,) arrays and a float.  Chips run in turn,
    each with its key from `keys`; the set streams in micro-batches of
    `eval_batch`.  Reuse it across calls (drift loops, sigma sweeps)."""
    clean_engine = clean_reference(engine)

    @torch.no_grad()
    def run(params, x, y, ens, keys):
        xb = chunk_eval_set(x, eval_batch)
        clean_pred = chunked_argmax_preds(apply_fn, params, xb, clean_engine)
        preds = torch.stack([
            chunked_argmax_preds(apply_fn, params, xb, engine.with_variation(
                V.chip_at(ens, c)).with_key(keys[c]))
            for c in range(V.ensemble_size(ens))])
        return _scores(preds, clean_pred, y)

    return run


def evaluate_ensemble(apply_fn: ApplyFn, params, x, y, engine,
                      ensemble: V.Chip, key: torch.Generator, *,
                      eval_batch: int = 128) -> EnsembleResult:
    """One-shot `make_ensemble_eval` (builds, runs, wraps).  `y=None`
    scores argmax agreement with the clean model."""
    keys = mrr.split_keys(key, V.ensemble_size(ensemble))
    run = make_ensemble_eval(apply_fn, engine, eval_batch=eval_batch)
    accs, agreement, clean_acc = run(params, x, y, ensemble, keys)
    return EnsembleResult(accs=accs, agreement=agreement, clean_acc=clean_acc)


# ---------------------------------------------------------------------------
# Variance-reduced estimation: antithetic pairs + control-variate surrogate
# ---------------------------------------------------------------------------
def layer_weights(params, names) -> dict:
    """Per-layer weights `{name: tensor}`: ``params[name]["w"]`` (the CNN
    convention) or ``params[name]`` itself; layers without one are
    skipped."""
    out = {}
    for n in names:
        p = params.get(n) if hasattr(params, "get") else None
        if isinstance(p, dict):
            p = p.get("w")
        if p is not None and getattr(p, "ndim", 0) >= 1:
            out[n] = p
    return out


@torch.no_grad()
def surrogate_features(weights: dict, ensemble: V.Chip, engine
                       ) -> np.ndarray:
    """Per-chip surrogate: the summed weight-realization RMS errors
    (`rosa.backends.realization_rms_error`) of every (chip, layer), with no
    evaluation-set forward.  Chips that distort their weights more degrade
    more, close enough to linearly for a two-parameter fit on a few
    probes (`estimate_ensemble`)."""
    from repro_torch.rosa.backends import realization_rms_error

    names = [n for n in weights if n in ensemble
             and engine.plan.resolve(n) is not None]
    n_chips = V.ensemble_size(ensemble)
    if not names:
        return np.zeros(n_chips)
    feats = torch.stack([
        torch.stack([realization_rms_error(
            weights[n], engine.plan.resolve(n), chip[n])
            for n in names]).sum()
        for chip in (V.chip_at(ensemble, c) for c in range(n_chips))])
    return feats.cpu().numpy()


def control_variate_accs(probe_accs: np.ndarray, features: np.ndarray,
                         n_probe: int) -> np.ndarray:
    """All-chip accuracies from `n_probe` measured ones: least squares of
    the probe accuracies on the surrogate, ``acc ~ b - a * s`` with
    ``a >= 0``; probes keep their measured values, the rest get the
    prediction clipped to [0, 100].  The mean of the result is the
    regression control-variate estimate of the ensemble mean."""
    s, f = features[:n_probe], probe_accs
    var_s = float(np.var(s))
    if var_s > 1e-12:
        a = max(0.0, -float(np.cov(s, f, bias=True)[0, 1]) / var_s)
    else:
        a = 0.0
    b = float(np.mean(f)) + a * float(np.mean(s))
    pred = np.clip(b - a * features, 0.0, 100.0)
    pred[:n_probe] = probe_accs
    return pred


def estimate_ensemble(apply_fn: ApplyFn, params, x, y, engine,
                      ensemble: V.Chip, key: torch.Generator, *,
                      estimator: EstimatorConfig = EstimatorConfig(),
                      weights: dict | None = None,
                      eval_batch: int = 128) -> EnsembleResult:
    """Variance-reduced `evaluate_ensemble`: real forwards for the first
    ``estimator.n_probe`` chips only, the rest predicted through the
    surrogate.  ``n_probe=0``, ``control_variate=False`` or n_probe >=
    n_chips is `evaluate_ensemble` itself."""
    n = V.ensemble_size(ensemble)
    n_probe = estimator.n_probe
    if not estimator.control_variate or n_probe <= 0 or n_probe >= n:
        return evaluate_ensemble(apply_fn, params, x, y, engine, ensemble,
                                 key, eval_batch=eval_batch)
    keys = mrr.split_keys(key, n)[:n_probe]
    run = make_ensemble_eval(apply_fn, engine, eval_batch=eval_batch)
    p_accs, p_agree, clean_acc = run(params, x, y,
                                     V.chip_slice(ensemble, n_probe), keys)
    if weights is None:
        weights = layer_weights(params, list(ensemble))
    feats = surrogate_features(weights, ensemble, engine)
    accs = control_variate_accs(p_accs, feats, n_probe)
    return EnsembleResult(accs=accs, agreement=p_agree, clean_acc=clean_acc,
                          n_probe=n_probe, method="control-variate")


def make_plan_eval(apply_fn: ApplyFn, engine, names, *,
                   eval_batch: int = 128, gated: bool = False):
    """One evaluator for every hybrid-plan candidate: like
    `make_ensemble_eval`, with the per-layer IS/WS choice as a vector
    ``sel`` of mapping gates (1 = IS, 0 = WS): ``(params, x, y, ens, keys,
    sel) -> (accs, agreement, clean_acc)``.

    ``gated=True`` adds a per-layer analog-gate vector ``g``
    (``(params, x, y, ens, keys, sel, g)``): layer i runs the analog path
    blended by ``g[i]`` in [0, 1] against the exact digital one.  One-hot
    ``g`` is a perturb-one-layer degradation cell, all-ones a whole plan."""
    clean_engine = clean_reference(engine)

    @torch.no_grad()
    def run(params, x, y, ens, keys, sel, g=None):
        xb = chunk_eval_set(x, eval_batch)
        clean_pred = chunked_argmax_preds(apply_fn, params, xb, clean_engine)
        mgates = dict(zip(names, _floats(sel)))
        gates = None if g is None else dict(zip(names, _floats(g)))
        eng = engine.with_mapping_gates(mgates).with_gates(gates)
        preds = torch.stack([
            chunked_argmax_preds(apply_fn, params, xb, eng.with_variation(
                V.chip_at(ens, c)).with_key(keys[c]))
            for c in range(V.ensemble_size(ens))])
        return _scores(preds, clean_pred, y)

    if gated:
        return run
    return lambda params, x, y, ens, keys, sel: \
        run(params, x, y, ens, keys, sel)


# ---------------------------------------------------------------------------
# CNN front-end (the paper's behavioural experiments)
# ---------------------------------------------------------------------------
def cnn_apply_fn(model: str) -> ApplyFn:
    """The apply function of a lite CNN."""
    from repro_torch.models.cnn import LITE_MODELS, LITE_SKIPS, cnn_apply
    specs, skips = LITE_MODELS[model], LITE_SKIPS.get(model)
    return lambda params, x, engine: cnn_apply(params, specs, x, engine,
                                               residual_from=skips)


def cnn_eval_set(n_eval: int = 512, seed: int = 0, device=None):
    """The first `n_eval` synth-CIFAR test images and labels, on
    `device`."""
    from repro_torch.data.synth_cifar import train_test_split
    (_, _), (xte, yte) = train_test_split(seed=seed)
    return (torch.from_numpy(xte[:n_eval]).to(device),
            torch.from_numpy(yte[:n_eval]).to(device))


def evaluate_cnn_ensemble(params, model: str, engine, ensemble: V.Chip,
                          key: torch.Generator, *, n_eval: int = 512,
                          eval_batch: int = 128, seed: int = 0,
                          estimator: EstimatorConfig | None = None
                          ) -> EnsembleResult:
    """Ensemble statistics of a lite CNN on the synth-CIFAR test set, on
    the device the parameters live on.  ``estimator=None`` is the exact
    brute-force MC, an `EstimatorConfig` the probe + control-variate
    path."""
    from repro_torch.training.cnn_train import params_device
    x, y = cnn_eval_set(n_eval, seed, params_device(params))
    if estimator is None:
        return evaluate_ensemble(cnn_apply_fn(model), params, x, y, engine,
                                 ensemble, key, eval_batch=eval_batch)
    return estimate_ensemble(cnn_apply_fn(model), params, x, y, engine,
                             ensemble, key, estimator=estimator,
                             eval_batch=eval_batch)
