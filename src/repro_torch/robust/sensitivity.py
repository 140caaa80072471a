"""Perturb-one-layer sensitivity profiling (paper Fig. 6; PyTorch port of
`repro.robust.sensitivity`).

"Which single layer runs the noisy analog path" is a one-hot vector of
per-layer gates blended inside `rosa.backends`, and "which mapping" a
vector of mapping gates, so one gated plan evaluator
(`ensemble.make_plan_eval`) serves the whole (mappings x chips x layers)
grid:

    accs[c, l] = accuracy with ONLY layer l analog-noisy on chip c

Degradations are Monte-Carlo averages over the chip ensemble (static
variation + per-shot noise) and feed `mapping.LayerProfile.d_is / d_ws`.
Models without labels profile on clean-prediction agreement.

`cnn_degradation_source` is the cacheable provider `rosa.compile` takes:
its `spec` is the reference's JSON for the same settings (`params_digest`
gives the reference's hex digest for the same parameters) plus the
random-number family that draws the chips (`mrr.rng_family`): the two
packages' Monte-Carlo matrices are different measurements and are cached
apart.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence

import numpy as np
import torch

from repro_torch import rosa
from repro_torch.core import energy as E
from repro_torch.core import mapping as M
from repro_torch.core import mrr
from repro_torch.core.constants import Mapping, OPEConfig
from repro_torch.robust import variation as V
from repro_torch.robust.ensemble import (ApplyFn, cnn_apply_fn,
                                         cnn_eval_set, make_plan_eval)

_D_CLIP = 0.0   # degradations are reported as max(clean - acc, 0), like
#                 the serial profiler


def _gated_evaluator(apply_fn, names, base_cfg, noise, eval_batch):
    cfg = dataclasses.replace(base_cfg, mapping=Mapping.WS, noise=noise)
    engine = rosa.Engine(rosa.ExecutionPlan.build(cfg, None, names))
    return make_plan_eval(apply_fn, engine, names, eval_batch=eval_batch,
                          gated=True)


def degradation_matrix(apply_fn: ApplyFn, params, x, y,
                       layer_names: Sequence[str],
                       base_cfg: rosa.RosaConfig,
                       ensemble: V.Chip, key: torch.Generator, *,
                       noise: mrr.NoiseModel = mrr.PAPER_NOISE,
                       mappings: Sequence[Mapping] = (Mapping.IS, Mapping.WS),
                       eval_batch: int = 128,
                       layers: Sequence[str] | None = None,
                       evaluator=None) -> dict[str, dict[str, float]]:
    """{layer: {mapping.value: degradation_pp}} over the chip ensemble.

    Every cell goes through one gated plan evaluator with a one-hot gate
    vector and a constant mapping-gate vector, so the cells share one
    clean reference (exact as long as ``act_per_vector`` is off: the
    digital paths of IS and WS are then identical).  ``layers`` restricts
    scoring to those columns (`refresh_degradation_matrix`); ``evaluator``
    takes a pre-built gated evaluator of the same layer names."""
    names = list(layer_names)
    scored = names if layers is None else [n for n in names
                                           if n in set(layers)]
    keys = mrr.split_keys(key, V.ensemble_size(ensemble))
    if evaluator is None:
        evaluator = _gated_evaluator(apply_fn, names, base_cfg, noise,
                                     eval_batch)
    eye = np.eye(len(names), dtype=np.float32)
    out: dict[str, dict[str, float]] = {n: {} for n in scored}
    for mp in mappings:
        sel = np.full(len(names), 0.0 if mp is Mapping.WS else 1.0,
                      dtype=np.float32)
        for n in scored:
            accs, _, clean_acc = evaluator(params, x, y, ensemble, keys,
                                           sel, eye[names.index(n)])
            out[n][mp.value] = max(float(clean_acc) - float(accs.mean()),
                                   _D_CLIP)
    return out


def refresh_degradation_matrix(prev: dict[str, dict[str, float]],
                               changed_layers: Sequence[str],
                               apply_fn: ApplyFn, params, x, y,
                               layer_names: Sequence[str],
                               base_cfg: rosa.RosaConfig,
                               ensemble: V.Chip, key: torch.Generator,
                               **kwargs) -> dict[str, dict[str, float]]:
    """Re-score only `changed_layers`, reusing `prev` rows: one layer runs
    the analog path per one-hot cell, so a row does not depend on the
    other layers.  Equal to a full `degradation_matrix` with the same
    ensemble and key."""
    fresh = degradation_matrix(apply_fn, params, x, y, layer_names,
                               base_cfg, ensemble, key,
                               layers=changed_layers, **kwargs)
    out = {n: dict(v) for n, v in prev.items()}
    out.update(fresh)
    return out


def plan_search(apply_fn: ApplyFn, params, x, y,
                layer_names: Sequence[str],
                base_cfg: rosa.RosaConfig,
                ensemble: V.Chip, key: torch.Generator,
                candidates: np.ndarray, *,
                noise: mrr.NoiseModel = mrr.PAPER_NOISE,
                eval_batch: int = 64, evaluator=None) -> np.ndarray:
    """MC-evaluate a (P, L) batch of hybrid-plan candidates (row p, column
    l: layer l on IS when 1, WS when 0) through one gated evaluator with
    the same keys for every row; the (P,) ensemble-mean accuracies [%]."""
    names = list(layer_names)
    keys = mrr.split_keys(key, V.ensemble_size(ensemble))
    if evaluator is None:
        evaluator = _gated_evaluator(apply_fn, names, base_cfg, noise,
                                     eval_batch)
    ones = np.ones(len(names), dtype=np.float32)
    return np.asarray([
        float(evaluator(params, x, y, ensemble, keys, row, ones)[0].mean())
        for row in np.asarray(candidates, dtype=np.float32)])


def searched_hybrid_plan(profiles: Sequence[M.LayerProfile],
                         apply_fn: ApplyFn, params, x, y,
                         base_cfg: rosa.RosaConfig,
                         ensemble: V.Chip, key: torch.Generator, *,
                         noise: mrr.NoiseModel = mrr.PAPER_NOISE,
                         max_extra_pp: float = 0.5,
                         max_candidates: int = 6,
                         eval_batch: int = 64, evaluator=None
                         ) -> tuple[dict[str, Mapping], dict]:
    """Accuracy-verified hybrid search: nested IS-prefix plans in profile
    order (robustness gain first, then EDP leverage), always with the pure
    WS row, MC-evaluated over the ensemble; the most IS-aggressive plan at
    the best measured accuracy wins, so it matches or beats pure WS under
    the search keys."""
    names = [p.name for p in profiles]
    by_name = {p.name: p for p in profiles}
    eligible = [p.name for p in profiles
                if p.d_is <= p.d_ws + max_extra_pp]
    order = sorted(eligible,
                   key=lambda n: (by_name[n].d_is - by_name[n].d_ws)
                   + 0.5 * np.log(max(by_name[n].e_is, 1e-30)
                                  / max(by_name[n].e_ws, 1e-30)))
    order = order[:max_candidates]
    cand = np.zeros((len(order) + 1, len(names)), dtype=np.float32)
    for k, layer in enumerate(order):
        cand[k + 1:, names.index(layer)] = 1.0

    accs = plan_search(apply_fn, params, x, y, names, base_cfg, ensemble,
                       key, cand, noise=noise, eval_batch=eval_batch,
                       evaluator=evaluator)
    best = accs.max()
    p_star = int(max(np.flatnonzero(accs >= best)))
    plan = {layer: Mapping.IS for layer in order[:p_star]}
    info = {"order": order, "accs": accs.tolist(),
            "ws_acc": float(accs[0]), "chosen_acc": float(accs[p_star]),
            "n_is": p_star}
    return plan, info


def accuracy_guarded_plan(profiles: Sequence[M.LayerProfile],
                          max_extra_pp: float = 0.5
                          ) -> dict[str, Mapping]:
    """The balanced-metric argmin (`mapping.choose_mapping`), vetoed when
    its degradation exceeds the layer's best mapping by more than
    `max_extra_pp`: the more robust mapping wins then."""
    plan: dict[str, Mapping] = {}
    for p in profiles:
        m = M.choose_mapping(p)
        if p.d(m) > min(p.d_is, p.d_ws) + max_extra_pp:
            m = Mapping.IS if p.d_is < p.d_ws else Mapping.WS
        plan[p.name] = m
    return plan


def profile_layers_mc(layers: Sequence[E.LayerShape], ope: OPEConfig,
                      degradation: dict[str, dict[str, float]], *,
                      batch: int = 1, **kwargs) -> list[M.LayerProfile]:
    """Join a Monte-Carlo degradation matrix with the vectorized EDP model
    (`device=` among the keywords) into `mapping.LayerProfile`s."""
    return M.profile_layers_fast(
        layers, ope,
        degradation_fn=M.degradation_fn_from_matrix(degradation),
        batch=batch, **kwargs)


# ---------------------------------------------------------------------------
# CNN front-end
# ---------------------------------------------------------------------------
def cnn_degradation_matrix(params, model: str, *,
                           n_chips: int = 16,
                           key: torch.Generator | None = None,
                           noise: mrr.NoiseModel = mrr.PAPER_NOISE,
                           var_model: V.VariationModel = V.PAPER_VARIATION,
                           ensemble: V.Chip | None = None,
                           n_eval: int = 256,
                           eval_batch: int = 128,
                           antithetic: bool = False,
                           layers: Sequence[str] | None = None,
                           evaluator=None) -> dict[str, dict[str, float]]:
    """Degradation matrix of a lite CNN over a chip ensemble (sampled from
    `key` unless one is passed), on the device the parameters live on."""
    from repro_torch.models.cnn import LITE_MODELS
    from repro_torch.training.cnn_train import QAT_CFG, params_device

    device = params_device(params)
    key = key if key is not None \
        else torch.Generator(device).manual_seed(42)
    k_ens, k_mc = mrr.split(key)
    names = [s.name for s in LITE_MODELS[model]]
    if ensemble is None:
        ensemble = V.sample_ensemble(k_ens, n_chips, V.cnn_lane_dims(model),
                                     var_model, antithetic=antithetic,
                                     device=device)
    x, y = cnn_eval_set(n_eval, device=device)
    return degradation_matrix(cnn_apply_fn(model), params, x, y, names,
                              QAT_CFG, ensemble, k_mc, noise=noise,
                              eval_batch=eval_batch, layers=layers,
                              evaluator=evaluator)


def _key_path(path: Sequence[str]) -> str:
    """`str` of a JAX key path of dict keys, as `tree_flatten_with_path`
    gives it: ``(DictKey(key='conv1'), DictKey(key='w'))``."""
    keys = ", ".join(f"DictKey(key={k!r})" for k in path)
    return f"({keys},)" if len(path) == 1 else f"({keys})"


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, (*prefix, k))
    else:
        yield prefix, tree


def params_digest(params) -> str:
    """Deterministic content hash of a parameter tree (nested dicts of
    tensors or arrays): the reference's digest for the same numbers, since
    it hashes the same key-path strings, dtypes, shapes and bytes."""
    h = hashlib.sha256()
    leaves = [(_key_path(p), leaf) for p, leaf in _flatten(params)]
    for path, leaf in sorted(leaves, key=lambda e: e[0]):
        h.update(path.encode())
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) \
            else np.asarray(leaf)
        h.update(str((arr.dtype.str, arr.shape)).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def cnn_degradation_source(params, model: str, *,
                           n_chips: int = 4,
                           noise: mrr.NoiseModel = mrr.PAPER_NOISE,
                           var_model: V.VariationModel = V.PAPER_VARIATION,
                           n_eval: int = 128, eval_batch: int = 64,
                           antithetic: bool = True,
                           seed: int = 42) -> "rosa.DegradationSource":
    """A cacheable degradation-matrix provider for `rosa.compile`.

    Bundles the measurement (`cnn_degradation_matrix` restricted to the
    layers the cache is missing, on the parameters' device) with a
    JSON-able ``spec`` of everything the numbers depend on: model,
    ensemble size and seed, antithetic pairing, eval-set size, noise
    model, variation spec and a digest of the trained parameters.
    `rosa.compile(autotune=...)` content-addresses cached matrices by
    (spec, RosaConfig) and calls ``measure`` only for absent layers."""
    from repro_torch.training.cnn_train import params_device

    device = params_device(params)
    spec = {"kind": "cnn-mc", "model": model, "n_chips": n_chips,
            "n_eval": n_eval, "eval_batch": eval_batch,
            "antithetic": antithetic, "seed": seed,
            "rng": mrr.rng_family(device),
            "noise": rosa.serialize.to_jsonable(noise),
            "variation": rosa.serialize.to_jsonable(var_model),
            "params": params_digest(params)}

    def measure(layer_names: Sequence[str]) -> dict:
        """DegradationSource hook: measure the named layers' rows."""
        return cnn_degradation_matrix(
            params, model, n_chips=n_chips,
            key=torch.Generator(device).manual_seed(seed), noise=noise,
            var_model=var_model, n_eval=n_eval, eval_batch=eval_batch,
            antithetic=antithetic, layers=list(layer_names))

    return rosa.DegradationSource(measure=measure, spec=spec)


def searched_cnn_hybrid_plan(profiles: Sequence[M.LayerProfile], params,
                             model: str, ensemble: V.Chip,
                             key: torch.Generator, *,
                             noise: mrr.NoiseModel = mrr.PAPER_NOISE,
                             n_eval: int = 256, eval_batch: int = 64,
                             **kwargs) -> tuple[dict[str, Mapping], dict]:
    """`searched_hybrid_plan` on a lite CNN's synth-CIFAR evaluation set."""
    from repro_torch.training.cnn_train import QAT_CFG, params_device

    x, y = cnn_eval_set(n_eval, device=params_device(params))
    return searched_hybrid_plan(profiles, cnn_apply_fn(model), params, x, y,
                                QAT_CFG, ensemble, key, noise=noise,
                                eval_batch=eval_batch, **kwargs)


def cnn_profiles_mc(params, model: str, ope: OPEConfig, *,
                    batch: int = 128, **kwargs) -> list[M.LayerProfile]:
    """MC degradation matrix + full-size EDP rows -> profiles for the
    layers in both the lite model and the paper table (the EDP model on
    the parameters' device)."""
    from repro_torch.configs.paper_cnns import CNN_WORKLOADS
    from repro_torch.training.cnn_train import params_device

    deg = cnn_degradation_matrix(params, model, **kwargs)
    rows = [l for l in CNN_WORKLOADS[model] if l.name in deg]
    return profile_layers_mc(rows, ope, deg, batch=batch,
                             device=params_device(params))
