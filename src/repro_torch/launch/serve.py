"""Serving CLI over `repro_torch.serve` (continuous or one-shot batching of
a synthetic Poisson request stream).

  python -m repro_torch.launch.serve --arch qwen3-32b --n-layers 4 \\
      --rosa --rosa-backend fused --variation-seed 7 --requests 6
  python -m repro_torch.launch.serve --arch mamba2-1.3b --requests 8 \\
      --max-len 768 --prompt-range 200 700 --gen-range 8 32
  python -m repro_torch.launch.serve --arch deepseek-v2-236b --n-layers 3 \\
      --rosa --rosa-backend fused --variation-seed 7 --requests 6

`--smoke` takes the reduced CPU-sized config; `--n-layers` cuts the depth
of the full-width config.  Runs on CUDA unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import PORTED_ARCHS, get_config, get_smoke


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-32b", choices=PORTED_ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the model to this many layers")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--policy", default="continuous",
                    choices=["continuous", "oneshot"])
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=1.0,
                    help="Poisson arrivals per tick (<=0: all at tick 0)")
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=56)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--prompt-range", type=int, nargs=2, default=(4, 8))
    ap.add_argument("--gen-range", type=int, nargs=2, default=(2, 40))
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--rosa", action="store_true",
                    help="serve through the optical engine")
    ap.add_argument("--rosa-backend", default="ref")
    ap.add_argument("--variation-seed", type=int, default=None)
    ap.add_argument("--trace", default=None, metavar="PATH")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.devices > 1:
        raise SystemExit("--devices > 1: slot-sharded serving is not ported "
                         "to repro_torch yet (one device only)")
    if args.trace:
        raise SystemExit("--trace: the span tracer (repro.obs) is not "
                         "ported to repro_torch yet")

    from repro_torch.core.constants import ROSA_OPTIMAL
    from repro_torch.serve import (Scheduler, ServeConfig, poisson_requests,
                                   report_metrics)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    scfg = ServeConfig(n_slots=args.n_slots, max_len=args.max_len,
                       prefill_chunk=args.prefill_chunk,
                       temperature=args.temperature, seed=args.seed,
                       rosa=args.rosa, rosa_backend=args.rosa_backend,
                       variation_seed=args.variation_seed)
    sched = Scheduler(cfg, scfg, init_seed=args.seed, device=args.device)
    print(f"arch={cfg.name} layers={cfg.n_layers} "
          f"params={sched.bundle.n_params:,} slots={scfg.n_slots} "
          f"max_len={scfg.max_len} chunk={scfg.prefill_chunk} "
          f"policy={args.policy} device={args.device}"
          + (f" rosa backend={args.rosa_backend}" if args.rosa else ""))
    if sched.program is not None:
        plan = {n: m.name for n, m in sched.program.plan.mapping_plan()
                .items()}
        print(f"  plan {plan}")
    reqs = poisson_requests(args.requests, args.rate, vocab=cfg.vocab,
                            prompt_len=tuple(args.prompt_range),
                            gen_len=tuple(args.gen_range), seed=args.seed)
    rep = sched.run(reqs, policy=args.policy)
    for m in report_metrics(rep):
        v = f"{m.value:.4g}" if isinstance(m.value, float) else m.value
        print(f"  {m.name:24s} {v} {m.unit}")
    if sched.engine is not None and sched.engine.ledger is not None:
        e = sched.engine.ledger.per_token(ROSA_OPTIMAL, batch=scfg.n_slots)
        print(f"  {'energy_per_token':24s} {e:.4g} J (ledger)")
    for c in sorted(rep.completions.values(), key=lambda c: c.rid)[:3]:
        print(f"  rid={c.rid} prompt={c.prompt_len} "
              f"tokens={c.tokens[:8]}{'...' if len(c.tokens) > 8 else ''}")


if __name__ == "__main__":
    main()
