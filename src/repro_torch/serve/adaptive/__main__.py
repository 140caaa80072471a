"""CLI: `python -m repro_torch.serve.adaptive [--kind sine|linear|walk] ...`

Runs one drift-serving A/B (uncontrolled monitor vs closed-loop controller
over the same request stream and drift step) on the smoke config and
prints the scenario summary, on the CUDA card unless ``--device cpu``;
`--json` saves a BENCH-schema report of the `drift_serve` metrics of this
run, `--trace` a Chrome trace of the whole run (controller spans
included).
"""

from __future__ import annotations

import argparse
import contextlib
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.adaptive",
        description="closed-loop drift-adaptive serving scenario")
    ap.add_argument("--kind", default="sine",
                    choices=("sine", "linear", "walk"))
    ap.add_argument("--amp-k", type=float, default=1.2,
                    help="peak thermal offset [K]")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=0.5)
    ap.add_argument("--period-ticks", type=float, default=64.0)
    ap.add_argument("--probe-every", type=int, default=4)
    ap.add_argument("--force-replan-at", type=int, default=None,
                    help="deterministically trigger a plan swap at a tick")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, help="write a BENCH report")
    ap.add_argument("--trace", default=None, help="write a Chrome trace")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    from repro_torch.launch import cli_device
    from repro_torch.obs import trace as obs
    from repro_torch.serve.adaptive.scenario import (ScenarioConfig,
                                                     run_scenario,
                                                     scenario_metrics)

    device = cli_device(args.device)
    cfg = ScenarioConfig(kind=args.kind, amp_k=args.amp_k,
                         n_requests=args.requests, rate=args.rate,
                         period_ticks=args.period_ticks,
                         probe_every=args.probe_every,
                         force_replan_at=args.force_replan_at,
                         seed=args.seed)
    tracer = obs.Tracer() if args.trace else None
    ctx = obs.tracing(tracer) if tracer is not None \
        else contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx:
        res, reqs = run_scenario(cfg, device=device)
    wall_s = time.perf_counter() - t0
    if tracer is not None:
        tracer.save(args.trace)
        print(f"trace -> {args.trace}")

    s = res.summary()
    s["dropped_requests"] = res.dropped_requests(reqs)
    print(f"drift={cfg.kind} amp={cfg.amp_k}K  "
          f"requests={cfg.n_requests}  probes every {cfg.probe_every} ticks")
    for k, v in s.items():
        print(f"  {k:24s} {v}")
    if args.json:
        from repro_torch.bench.schema import BenchResult
        from repro_torch.robust.report import save_report
        save_report([BenchResult(name="drift_serve", wall_s=wall_s,
                                 metrics=scenario_metrics(res, reqs))],
                    args.json)
        print(f"report -> {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
