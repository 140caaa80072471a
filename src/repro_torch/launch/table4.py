"""Table 4 / Fig. 10 pipeline for the reduced CNNs (PyTorch port of
`benchmarks/table4_hybrid.py`: `run_model` for one model, `run` over
`CNN_WORKLOADS`):

  1. QAT-train the 8-bit model on synth-CIFAR,
  2. profile d_l(m): the accuracy drop with ONLY layer l noisy-analog under
     mapping m in {IS, WS} (Fig. 6 protocol),
  3. e_l(m) from the full-size layer tables (configs/paper_cnns.py) on the
     optimized (8, 8) array with OSA, and the per-layer balanced-metric
     argmin -> hybrid plan,
  4. accuracies clean | WS | IS | hybrid | analog (DEAP), and EDP of WS,
     hybrid and DEAP-CNNs (high-channel array, fully analog, no OSA).

Over more than one model, `run` prints the three averages the paper
reports: hybrid - WS accuracy (paper +8.3 pp), hybrid EDP below DEAP-CNNs
(54.7 %) and accuracy loss vs clean (3.3 pp).

    python -m repro_torch.launch.table4 --models alexnet vgg16 resnet18 \\
        mobilenet_v3 --steps 400 --n-mc 3 --json chiprun_out/table4.json

Runs on CUDA unless `--device cpu`; the JSON file has the shape of the
reference's `run` result ({model: run_model result}), each model's entry
plus wall seconds per stage.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import rosa
from repro_torch.configs.paper_cnns import CNN_WORKLOADS
from repro_torch.core import energy as E
from repro_torch.core import mapping as M
from repro_torch.core import mrr
from repro_torch.core.constants import (DEAP_HIGH_CHANNEL, ROSA_OPTIMAL,
                                        ComputeMode, Mapping)
from repro_torch.launch import cli_device, write_json
from repro_torch.models.cnn import LITE_MODELS
from repro_torch.training.cnn_train import (QAT_CFG, cnn_program,
                                            evaluate_cnn,
                                            layer_noise_profile,
                                            params_device, train_cnn)

EDP_BATCH = 128


def _layer_names(model: str) -> list[str]:
    return [s.name for s in LITE_MODELS[model]]


def _eval_key(device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def acc_with(params, model: str, mode: ComputeMode, mp: Mapping,
             noise: mrr.NoiseModel, n_mc: int = 3, seed: int = 17) -> float:
    """Accuracy with every layer under one (mode, mapping, noise)."""
    cfg = dataclasses.replace(QAT_CFG, mode=mode, mapping=mp, noise=noise)
    program = cnn_program(
        model, rosa.Engine.from_config(cfg, layers=_layer_names(model)))
    return evaluate_cnn(params, model, program=program,
                        key=_eval_key(params_device(params), seed),
                        n_mc=n_mc)


def acc_with_plan(params, model: str, plan: dict, noise: mrr.NoiseModel,
                  n_mc: int = 3, seed: int = 17) -> float:
    """Accuracy under a {layer: Mapping} hybrid plan (default WS)."""
    cfg = dataclasses.replace(QAT_CFG, noise=noise)
    program = cnn_program(
        model, rosa.Engine.from_hybrid_plan(cfg, plan,
                                            layers=_layer_names(model)))
    return evaluate_cnn(params, model, program=program,
                        key=_eval_key(params_device(params), seed),
                        n_mc=n_mc)


def mapped_layers(model: str) -> list[E.LayerShape]:
    """The full-size layer rows of `model` that its lite net has."""
    lite = set(_layer_names(model))
    return [layer for layer in CNN_WORKLOADS[model] if layer.name in lite]


def plan_from_profile(model: str, prof: dict) -> dict[str, Mapping]:
    """Join a behavioural profile with the full-size EDP rows and take the
    per-layer balanced-metric argmin (the reference's hybrid plan)."""
    profiles = []
    for layer in mapped_layers(model):
        d = prof["layers"][layer.name]
        profiles.append(M.LayerProfile(
            layer.name, d_is=d[Mapping.IS.value], d_ws=d[Mapping.WS.value],
            e_is=E.layer_energy(layer, ROSA_OPTIMAL, Mapping.IS,
                                batch=EDP_BATCH).edp,
            e_ws=E.layer_energy(layer, ROSA_OPTIMAL, Mapping.WS,
                                batch=EDP_BATCH).edp))
    return M.hybrid_plan(profiles)


def plan_edps(model: str, plan: dict[str, Mapping]) -> dict[str, float]:
    """EDP [J*s] of WS, the hybrid plan and DEAP-CNNs on the full-size
    layer rows at batch 128."""
    layers = mapped_layers(model)
    return {
        "ws": M.plan_edp(layers, {}, ROSA_OPTIMAL, batch=EDP_BATCH),
        "hybrid": M.plan_edp(layers, plan, ROSA_OPTIMAL, batch=EDP_BATCH),
        "deap": E.network_energy(layers, DEAP_HIGH_CHANNEL, Mapping.WS,
                                 ComputeMode.ANALOG, E.NO_OSA,
                                 batch=EDP_BATCH).edp,
    }


def run_model(model: str, steps: int = 400, n_mc: int = 3,
              noise: mrr.NoiseModel = mrr.PAPER_NOISE, *,
              device: str | torch.device = "cuda",
              verbose: bool = True, keep_params: bool = False) -> dict:
    """The whole pipeline for one model; returns the reference's
    `run_model` dict plus `wall_s` {train, profile, eval} (and the trained
    `params` with `keep_params`)."""
    wall = {}
    t0 = time.perf_counter()
    params, clean = train_cnn(model, steps=steps, device=device)
    wall["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prof = layer_noise_profile(params, model, noise=noise, n_mc=n_mc)
    plan = plan_from_profile(model, prof)
    wall["profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    accs = {
        "clean": clean,
        "ws": acc_with(params, model, ComputeMode.MIXED, Mapping.WS, noise,
                       n_mc),
        "is": acc_with(params, model, ComputeMode.MIXED, Mapping.IS, noise,
                       n_mc),
        "hybrid": acc_with_plan(params, model, plan, noise, n_mc),
        "analog": acc_with(params, model, ComputeMode.ANALOG, Mapping.WS,
                           noise, n_mc),
    }
    wall["eval"] = time.perf_counter() - t0
    edp = plan_edps(model, plan)
    n_is = sum(1 for v in plan.values() if v is Mapping.IS)
    res = dict(model=model, accs=accs, edp=edp, plan_is_layers=n_is,
               plan={k: v.value for k, v in plan.items()},
               profile=prof, wall_s=wall)
    if keep_params:
        res["params"] = params
    if verbose:
        print(f"== {model} ({torch.device(device)}) ==")
        print("  acc[%]: " + "  ".join(f"{k}={v:.1f}"
                                       for k, v in accs.items()))
        print(f"  plan: {n_is}/{len(plan)} layers IS")
        print(f"  EDP[J*s]: WS={edp['ws']:.4g} hybrid={edp['hybrid']:.4g} "
              f"DEAP={edp['deap']:.4g}")
        print(f"  hybrid vs WS: {(1 - edp['hybrid'] / edp['ws']) * 100:+.1f}%"
              f" EDP, {accs['hybrid'] - accs['ws']:+.1f}pp acc")
        print(f"  hybrid vs DEAP-CNNs EDP: "
              f"{(1 - edp['hybrid'] / edp['deap']) * 100:.1f}% lower")
        print("  wall s: " + "  ".join(f"{k}={v:.1f}"
                                       for k, v in wall.items()))
    return res


def averages(results: dict) -> dict[str, float]:
    """The paper's three Table 4 averages over `run`'s per-model results:
    hybrid - WS accuracy [pp], hybrid EDP reduction vs DEAP-CNNs, and the
    hybrid plan's accuracy loss vs clean [pp]."""
    rs = list(results.values())
    return {
        "hybrid_vs_ws_pp": sum(r["accs"]["hybrid"] - r["accs"]["ws"]
                               for r in rs) / len(rs),
        "hybrid_vs_deap_edp_red": sum(1 - r["edp"]["hybrid"] / r["edp"]["deap"]
                                      for r in rs) / len(rs),
        "loss_vs_clean_pp": sum(r["accs"]["clean"] - r["accs"]["hybrid"]
                                for r in rs) / len(rs),
    }


def print_averages(avg: dict[str, float]) -> None:
    print(f"AVG hybrid-vs-WS acc: {avg['hybrid_vs_ws_pp']:+.2f}pp "
          "(paper: +8.3pp)")
    print(f"AVG hybrid-vs-DEAP EDP: {avg['hybrid_vs_deap_edp_red'] * 100:.1f}%"
          " lower (paper: 54.7%)")
    print(f"AVG acc loss vs clean: {avg['loss_vs_clean_pp']:.2f}pp "
          "(paper: 3.3pp)")


def run(models=None, steps: int = 400, n_mc: int = 3,
        sigma_scale: float = 1.0, *, device: str | torch.device = "cuda",
        verbose: bool = True, keep_params: bool = False) -> dict:
    """`run_model` over `models` (default: all of CNN_WORKLOADS) under the
    paper's noise scaled by `sigma_scale`; {model: result}."""
    models = models or list(CNN_WORKLOADS)
    noise = mrr.NoiseModel(sigma_dac=0.02 * sigma_scale,
                           sigma_th=0.04 * sigma_scale)
    out = {m: run_model(m, steps, n_mc, noise, device=device,
                        verbose=verbose, keep_params=keep_params)
           for m in models}
    if verbose and len(models) > 1:
        print_averages(averages(out))
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", nargs="+", default=None,
                    choices=list(CNN_WORKLOADS),
                    help="default: all four paper CNNs")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--n-mc", type=int, default=3)
    ap.add_argument("--sigma-scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, metavar="PATH")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = cli_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = run(args.models, args.steps, args.n_mc, args.sigma_scale,
              device=device)
    write_json(args.json, res)
    return res


if __name__ == "__main__":
    main()
