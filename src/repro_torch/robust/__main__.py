"""CLI: Monte-Carlo robustness studies on the lite CNNs (PyTorch port of
`python -m repro.robust`), on the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.robust ensemble    --model alexnet --n-chips 64
    PYTHONPATH=src python -m repro_torch.robust sensitivity --model alexnet
    PYTHONPATH=src python -m repro_torch.robust smoke       --steps 40
    PYTHONPATH=src python -m repro_torch.robust drift       --retrim-every 900
    PYTHONPATH=src python -m repro_torch.robust sweep       --scales 0 0.5 1 2

``smoke`` keeps its degradation matrix in the plan cache
(``$ROSA_PLAN_CACHE``), so a second run skips the Monte-Carlo stage.
``--json PATH`` writes the run as a schema-valid report
(`repro_torch.bench.schema`).
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.bench.schema import BenchResult
from repro_torch.launch import cli_device
from repro_torch.robust import cli


def main(argv: list[str] | None = None) -> int:
    """Parse args, run the chosen study, print and optionally save it."""
    ap = argparse.ArgumentParser(prog="repro_torch.robust",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("cmd", choices=sorted(cli.RUNNERS),
                    help="which robustness study to run")
    ap.add_argument("--model", default="alexnet")
    ap.add_argument("--steps", type=int, default=150,
                    help="QAT training steps before the study")
    ap.add_argument("--n-chips", type=int, default=None,
                    help="ensemble size (default: per-study)")
    ap.add_argument("--n-eval", type=int, default=None,
                    help="evaluation images (default: per-study)")
    ap.add_argument("--sigma-scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-probe", type=int, default=4,
                    help="[ensemble] chips given real forwards; the rest "
                         "are predicted by the control-variate surrogate")
    ap.add_argument("--exact", action="store_true",
                    help="[ensemble/sensitivity] brute-force MC: no "
                         "antithetic pairing, every chip evaluated")
    ap.add_argument("--scales", type=float, nargs="+", default=None,
                    help="[sweep] sigma scales")
    ap.add_argument("--retrim-every", type=float, default=900.0,
                    help="[drift] re-trim period [s]; <0 disables")
    ap.add_argument("--drift-kind", default="sine",
                    choices=("sine", "linear", "walk"))
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write a schema-valid robustness report")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    kw: dict = {"steps": args.steps, "seed": args.seed,
                "device": cli_device(args.device)}
    if args.n_chips is not None:
        kw["n_chips"] = args.n_chips
    if args.n_eval is not None:
        kw["n_eval"] = args.n_eval
    if args.cmd in ("ensemble", "sensitivity"):
        kw["sigma_scale"] = args.sigma_scale
        kw["antithetic"] = not args.exact
    if args.cmd in ("ensemble", "smoke"):
        kw["n_probe"] = 0 if args.exact and args.cmd == "ensemble" \
            else args.n_probe
    if args.cmd == "sweep" and args.scales is not None:
        kw["scales"] = tuple(args.scales)
    if args.cmd == "drift":
        kw["kind"] = args.drift_kind
        kw["retrim_every"] = None if args.retrim_every < 0 \
            else args.retrim_every

    summary, metrics = cli.RUNNERS[args.cmd](args.model, **kw)

    print(f"== robust.{args.cmd} [{args.model}] ==")
    for m in metrics:
        val = f"{m.value:.4g}" if isinstance(m.value, float) else m.value
        print(f"  {m.name:28s} {val}{' ' + m.unit if m.unit else ''}"
              f"{'  [gated]' if m.gate else ''}")
    print(json.dumps({k: v for k, v in summary.items()
                      if k not in ("degradation", "rows")},
                     indent=1, default=str))

    if args.json:
        from repro_torch.robust.report import save_report
        path = save_report(
            [BenchResult(name=f"robust_{args.cmd}", metrics=metrics)],
            args.json)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
