"""Experiment runners behind ``python -m repro_torch.robust`` (PyTorch port
of `repro.robust.cli`): quick-train a lite CNN (or take `params=`), then
run the robustness study.  Every runner returns ``(summary_dict,
[Metric])``, at the reference's defaults, on `device` (CUDA unless the
caller asks for the CPU; there is no fallback when no card is there).
Stages run inside `obs.span`s, which cost nothing without a tracer.
`run_smoke` keeps its degradation matrix in `rosa.PlanCache`, so a warm
run skips the Monte-Carlo stage.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import rosa
from repro_torch.bench.schema import Metric
from repro_torch.core import mapping as M
from repro_torch.core import mrr
from repro_torch.core.constants import ROSA_OPTIMAL, Mapping
from repro_torch.obs import trace as obs
from repro_torch.robust import drift as D
from repro_torch.robust import ensemble as ENS
from repro_torch.robust import report as R
from repro_torch.robust import sensitivity as S
from repro_torch.robust import variation as V


def _params(model: str, steps: int, seed: int, device, params):
    """`params` on `device`, or a fresh QAT model of `steps` steps."""
    from repro_torch.models.module import map_tree
    from repro_torch.training.cnn_train import train_cnn
    if params is not None:
        return map_tree(lambda t: t.to(device), params)
    with obs.span("robust.train", cat="robust", model=model, steps=steps):
        return train_cnn(model, steps=steps, seed=seed, device=device)[0]


def _noisy_cfg(sigma_scale: float = 1.0) -> rosa.RosaConfig:
    from repro_torch.training.cnn_train import QAT_CFG
    noise = mrr.NoiseModel(sigma_dac=mrr.PAPER_NOISE.sigma_dac * sigma_scale,
                           sigma_th=mrr.PAPER_NOISE.sigma_th * sigma_scale)
    return dataclasses.replace(QAT_CFG, noise=noise)


def _names(model: str) -> list[str]:
    from repro_torch.models.cnn import LITE_MODELS
    return [s.name for s in LITE_MODELS[model]]


def _key(device, seed: int) -> torch.Generator:
    return torch.Generator(torch.device(device)).manual_seed(seed)


def run_ensemble(model: str = "alexnet", *, steps: int = 150,
                 n_chips: int = 64, n_eval: int = 512,
                 sigma_scale: float = 1.0, seed: int = 0,
                 n_probe: int = 4, antithetic: bool = True,
                 params=None, device: str | torch.device = "cuda"
                 ) -> tuple[dict, list[Metric]]:
    """N-chip wafer statistics of the QAT model under WS mapping: by
    default antithetic pairs with `n_probe` real forwards and the rest
    predicted by the control-variate surrogate; ``n_probe=0`` is
    brute-force MC over every chip."""
    params = _params(model, steps, seed, device, params)
    k_ens, k_mc = mrr.split(_key(device, seed + 1000))
    ens = V.sample_ensemble(k_ens, n_chips, V.cnn_lane_dims(model),
                            V.PAPER_VARIATION.scaled(sigma_scale),
                            antithetic=antithetic, device=device)
    engine = rosa.Engine.from_config(_noisy_cfg(sigma_scale),
                                     layers=_names(model))
    est = ENS.EstimatorConfig(n_probe=n_probe, antithetic=antithetic) \
        if n_probe else None
    with obs.span("robust.ensemble", cat="robust", n_chips=n_chips):
        res = ENS.evaluate_cnn_ensemble(params, model, engine, ens, k_mc,
                                        n_eval=n_eval, estimator=est)
    summary = {"model": model, **res.summary(),
               "yield_curve": res.yield_curve((1.0, 2.0, 5.0))}
    # ensemble_metrics already carries yield_2pp; add the curve endpoints
    metrics = R.ensemble_metrics(res, gate=True) \
        + R.yield_curve_metrics(res, drops_pp=(1.0, 5.0))
    return summary, metrics


def run_sensitivity(model: str = "alexnet", *, steps: int = 150,
                    n_chips: int = 16, n_eval: int = 256,
                    sigma_scale: float = 1.0, seed: int = 0,
                    antithetic: bool = True,
                    params=None, device: str | torch.device = "cuda"
                    ) -> tuple[dict, list[Metric]]:
    """Perturb-one-layer profile -> accuracy-verified hybrid plan, then the
    plan against pure WS on the same chip ensemble (Table 4's direction:
    hybrid accuracy >= WS, lower EDP)."""
    from repro_torch.configs.paper_cnns import CNN_WORKLOADS

    params = _params(model, steps, seed, device, params)
    k_ens, k_prof, k_mc = mrr.split_keys(_key(device, seed + 2000), 3)
    names = _names(model)
    ens = V.sample_ensemble(k_ens, n_chips, V.cnn_lane_dims(model),
                            V.PAPER_VARIATION.scaled(sigma_scale),
                            antithetic=antithetic, device=device)
    cfg = _noisy_cfg(sigma_scale)

    with obs.span("robust.degradation_matrix", cat="robust",
                  layers=len(names)):
        deg = S.cnn_degradation_matrix(params, model, key=k_prof,
                                       ensemble=ens, noise=cfg.noise,
                                       n_eval=n_eval)
    rows = [l for l in CNN_WORKLOADS[model] if l.name in deg]
    with obs.span("robust.plan_search", cat="robust", layers=len(rows)):
        profiles = S.profile_layers_mc(rows, ROSA_OPTIMAL, deg, batch=128,
                                       device=device)
        plan, search = S.searched_cnn_hybrid_plan(
            profiles, params, model, ens, k_mc, noise=cfg.noise,
            n_eval=n_eval)

    e_ws = rosa.Engine.from_config(cfg, layers=names)
    x, yl = ENS.cnn_eval_set(n_eval, device=device)
    keys = mrr.split_keys(k_mc, n_chips)
    evaluator = ENS.make_plan_eval(ENS.cnn_apply_fn(model), e_ws, names,
                                   eval_batch=128)

    def eval_sel(sel) -> ENS.EnsembleResult:
        return ENS.EnsembleResult(*evaluator(params, x, yl, ens, keys, sel))

    with obs.span("robust.final_eval", cat="robust"):
        res_h = eval_sel([1.0 if plan.get(n) is Mapping.IS else 0.0
                          for n in names])
        res_ws = eval_sel([0.0] * len(names))
    gain = res_h.mean_acc - res_ws.mean_acc
    if gain < 0.0 and plan:
        # the search verified under its own keys; a final evaluation that
        # disagrees (a sub-pp MC edge) falls back to pure WS
        plan, res_h, gain = {}, res_ws, 0.0
    edp_ratio = (M.plan_edp(rows, plan, ROSA_OPTIMAL, batch=128)
                 / M.plan_edp(rows, {}, ROSA_OPTIMAL, batch=128))
    n_is = sum(1 for v in plan.values() if v is Mapping.IS)

    summary = {"model": model, "plan": {k: v.value for k, v in plan.items()},
               "plan_is_layers": n_is, "clean_acc": res_h.clean_acc,
               "hybrid_mean_acc": res_h.mean_acc,
               "ws_mean_acc": res_ws.mean_acc,
               "hybrid_minus_ws_pp": gain,
               "hybrid_vs_ws_edp": edp_ratio,
               "search": search,
               "degradation": deg}
    metrics = [
        Metric("n_chips", n_chips, gate=True, rel_tol=0.0),
        Metric("hybrid_mean_acc", res_h.mean_acc, unit="%", gate=True,
               rel_tol=0.1, direction="higher_is_better"),
        # Table 4's direction: hybrid never below WS
        Metric("hybrid_minus_ws_pp", gain, unit="pp", gate=True,
               rel_tol=1.0, direction="higher_is_better"),
        # which prefix the search keeps can flip on sub-pp differences
        # and every prefix is accuracy-safe: recorded, not gated
        Metric("hybrid_vs_ws_edp", edp_ratio, unit="ratio",
               direction="lower_is_better"),
        Metric("hybrid_yield_2pp", res_h.yield_frac(2.0), unit="frac",
               gate=True, rel_tol=0.5, direction="higher_is_better"),
    ]
    return summary, metrics


def run_smoke(model: str = "alexnet", *, steps: int = 40,
              n_chips: int = 16, n_probe: int = 2, n_eval: int = 64,
              max_candidates: int = 3, seed: int = 0,
              params=None, cache: "rosa.PlanCache | None" = None,
              device: str | torch.device = "cuda"
              ) -> tuple[dict, list[Metric]]:
    """The whole robustness pipeline through ONE gated plan evaluator
    (`ensemble.make_plan_eval(gated=True)`): the ensemble's probe forwards,
    every degradation-matrix cell, every plan-search candidate and both
    final plan evaluations.  Wafer statistics use the variance-reduced
    estimator: ``n_chips`` antithetic chips, ``n_probe`` real forwards,
    the control-variate surrogate for the rest.  The degradation matrix
    is stored in the content-addressed `rosa.PlanCache` (``cache``; the
    default directory when None): a warm run skips the whole Monte-Carlo
    profiling stage and reports ``matrix_cached``."""
    from repro_torch.configs.paper_cnns import CNN_WORKLOADS
    from repro_torch.training.cnn_train import QAT_CFG

    params = _params(model, steps, seed, device, params)
    k_ens, k_prof, k_mc = mrr.split_keys(_key(device, seed + 5000), 3)
    names = _names(model)
    cfg = _noisy_cfg(1.0)
    cfg_ws = dataclasses.replace(cfg, mapping=Mapping.WS)
    engine = rosa.Engine(rosa.ExecutionPlan.build(cfg_ws, None, names))
    apply_fn = ENS.cnn_apply_fn(model)
    x, yl = ENS.cnn_eval_set(n_eval, device=device)
    evaluator = ENS.make_plan_eval(apply_fn, engine, names,
                                   eval_batch=n_eval, gated=True)
    ones = np.ones(len(names), dtype=np.float32)
    zeros = np.zeros(len(names), dtype=np.float32)

    # --- ensemble: n_probe real forwards + control-variate prediction ---
    with obs.span("robust.ensemble_probe", cat="robust", n_probe=n_probe):
        ens = V.sample_ensemble(k_ens, n_chips, V.cnn_lane_dims(model),
                                V.PAPER_VARIATION, antithetic=True,
                                device=device)
        probes = V.chip_slice(ens, n_probe)
        keys_mc = mrr.split_keys(k_mc, n_chips)[:n_probe]
        p_accs, p_agree, clean_acc = evaluator(params, x, yl, probes,
                                               keys_mc, zeros, ones)
        feats = ENS.surrogate_features(ENS.layer_weights(params, names),
                                       ens, engine)
        res_ens = ENS.EnsembleResult(
            accs=ENS.control_variate_accs(np.asarray(p_accs), feats,
                                          n_probe),
            agreement=np.asarray(p_agree), clean_acc=float(clean_acc),
            n_probe=n_probe, method="control-variate")

    # --- degradation matrix: PlanCache-backed, the same evaluator ---
    cache = cache if cache is not None else rosa.PlanCache()
    spec = {"kind": "cnn-smoke", "model": model, "n_probe": n_probe,
            "n_eval": n_eval, "antithetic": True, "seed": seed,
            "rng": mrr.rng_family(device),
            "noise": rosa.serialize.to_jsonable(cfg.noise),
            "variation": rosa.serialize.to_jsonable(V.PAPER_VARIATION),
            "params": S.params_digest(params)}
    mkey = cache.matrix_key(cfg_ws, spec)
    deg = cache.load_matrix(mkey)
    matrix_cached = deg is not None and all(n in deg for n in names)
    if not matrix_cached:
        with obs.span("robust.degradation_matrix", cat="robust",
                      layers=len(names)):
            deg = S.degradation_matrix(apply_fn, params, x, yl, names,
                                       QAT_CFG, probes, k_prof,
                                       evaluator=evaluator)
        cache.store_matrix(mkey, deg)

    # --- plan search + final evaluations, the same evaluator ---
    rows = [l for l in CNN_WORKLOADS[model] if l.name in deg]
    with obs.span("robust.plan_search", cat="robust", layers=len(rows)):
        profiles = S.profile_layers_mc(rows, ROSA_OPTIMAL, deg, batch=128,
                                       device=device)
        plan, search = S.searched_hybrid_plan(
            profiles, apply_fn, params, x, yl, cfg_ws, probes, k_mc,
            max_candidates=max_candidates, evaluator=evaluator)

    keys_f = mrr.split_keys(k_mc, n_probe)

    def eval_sel(sel) -> ENS.EnsembleResult:
        """One mapping-gate vector through the shared evaluator."""
        accs, agree, clean = evaluator(params, x, yl, probes, keys_f,
                                       np.asarray(sel, dtype=np.float32),
                                       ones)
        return ENS.EnsembleResult(accs=np.asarray(accs),
                                  agreement=np.asarray(agree),
                                  clean_acc=float(clean))

    with obs.span("robust.final_eval", cat="robust"):
        res_h = eval_sel([1.0 if plan.get(n) is Mapping.IS else 0.0
                          for n in names])
        res_ws = eval_sel([0.0] * len(names))
    gain = res_h.mean_acc - res_ws.mean_acc
    if gain < 0.0 and plan:
        # the search verified under the same evaluator and keys; a negative
        # final gain is MC noise on a sub-pp margin: fall back to pure WS
        plan, res_h, gain = {}, res_ws, 0.0
    edp_ratio = (M.plan_edp(rows, plan, ROSA_OPTIMAL, batch=128)
                 / M.plan_edp(rows, {}, ROSA_OPTIMAL, batch=128))

    summary = {"model": model, **{f"ens_{k}": v
                                  for k, v in res_ens.summary().items()},
               "plan": {k: v.value for k, v in plan.items()},
               "hybrid_mean_acc": res_h.mean_acc,
               "ws_mean_acc": res_ws.mean_acc,
               "hybrid_minus_ws_pp": gain,
               "hybrid_vs_ws_edp": edp_ratio,
               "matrix_cached": matrix_cached,
               "search": search, "degradation": deg}
    metrics = (
        [dataclasses.replace(m, name=f"ens_{m.name}")
         for m in R.ensemble_metrics(res_ens, gate=True)
         + R.yield_curve_metrics(res_ens, drops_pp=(1.0, 5.0))]
        + [
            Metric("sens_n_chips", n_probe, gate=True, rel_tol=0.0),
            Metric("sens_hybrid_mean_acc", res_h.mean_acc, unit="%",
                   gate=True, rel_tol=0.1, direction="higher_is_better"),
            Metric("sens_hybrid_minus_ws_pp", gain, unit="pp", gate=True,
                   rel_tol=1.0, direction="higher_is_better"),
            Metric("sens_hybrid_vs_ws_edp", edp_ratio, unit="ratio",
                   direction="lower_is_better"),
            Metric("sens_hybrid_yield_2pp", res_h.yield_frac(2.0),
                   unit="frac", gate=True, rel_tol=0.5,
                   direction="higher_is_better"),
        ])
    return summary, metrics


def run_drift(model: str = "alexnet", *, steps: int = 150,
              n_chips: int = 16, n_eval: int = 256, seed: int = 0,
              kind: str = "sine", amp_k: float = 0.25,
              period_s: float = 3600.0, t_end_s: float = 3600.0,
              n_t: int = 9, retrim_every: float | None = 900.0,
              params=None, device: str | torch.device = "cuda"
              ) -> tuple[dict, list[Metric]]:
    """Accuracy over time under thermal drift, with and without periodic
    re-trim (re-invoking the `voltage_of_weight` calibration)."""
    params = _params(model, steps, seed, device, params)
    k_ens, k_mc = mrr.split(_key(device, seed + 3000))
    ens = V.sample_ensemble(k_ens, n_chips, V.cnn_lane_dims(model),
                            device=device)
    engine = rosa.Engine.from_config(_noisy_cfg(), layers=_names(model))
    dm = D.DriftModel(kind=kind, amp_k=amp_k, period_s=period_s)
    t_grid = np.linspace(0.0, t_end_s, n_t)
    # one evaluator serves both simulations and every time step
    evaluator = ENS.make_ensemble_eval(ENS.cnn_apply_fn(model), engine,
                                       eval_batch=128)
    with obs.span("robust.drift", cat="robust", n_t=n_t):
        trimmed = D.simulate_cnn(params, model, engine, ens, k_mc, dm,
                                 t_grid, retrim_every, n_eval=n_eval,
                                 evaluator=evaluator)
        free = D.simulate_cnn(params, model, engine, ens, k_mc, dm, t_grid,
                              None, n_eval=n_eval, evaluator=evaluator)
    summary = {"model": model, "times_s": t_grid.tolist(),
               "retrim": trimmed.summary(), "no_retrim": free.summary(),
               "retrim_mean_acc": trimmed.mean_acc.tolist(),
               "no_retrim_mean_acc": free.mean_acc.tolist()}
    metrics = [
        Metric("worst_acc_retrim", trimmed.worst_mean_acc(), unit="%",
               gate=True, rel_tol=0.05, direction="higher_is_better"),
        Metric("worst_acc_no_retrim", free.worst_mean_acc(), unit="%"),
        Metric("retrim_gain_pp",
               trimmed.worst_mean_acc() - free.worst_mean_acc(), unit="pp",
               direction="higher_is_better"),
        Metric("min_yield_2pp_retrim", float(trimmed.yield_2pp.min()),
               unit="frac", direction="higher_is_better"),
    ]
    return summary, metrics


def run_sweep(model: str = "alexnet", *, steps: int = 150,
              n_chips: int = 32, n_eval: int = 256, seed: int = 0,
              scales: tuple = (0.0, 0.5, 1.0, 1.5, 2.0),
              params=None, device: str | torch.device = "cuda"
              ) -> tuple[dict, list[Metric]]:
    """Accuracy and yield vs sigma (per-shot and static sigmas scaled
    together)."""
    params = _params(model, steps, seed, device, params)
    k_ens, k_mc = mrr.split(_key(device, seed + 4000))
    names = _names(model)
    base_ens = V.sample_ensemble(k_ens, n_chips, V.cnn_lane_dims(model),
                                 device=device)

    def eval_at(s: float) -> ENS.EnsembleResult:
        engine = rosa.Engine.from_config(_noisy_cfg(s), layers=names)
        return ENS.evaluate_cnn_ensemble(
            params, model, engine, V.scale_ensemble(base_ens, s), k_mc,
            n_eval=n_eval)

    with obs.span("robust.sweep", cat="robust", scales=len(scales)):
        rows = R.sigma_sweep(eval_at, scales)
    return {"model": model, "rows": rows}, R.sweep_metrics(rows)


RUNNERS = {"ensemble": run_ensemble, "sensitivity": run_sensitivity,
           "smoke": run_smoke, "drift": run_drift, "sweep": run_sweep}
