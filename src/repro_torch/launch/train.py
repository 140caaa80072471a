"""End-to-end LM training on one device (PyTorch port of
`repro.launch.train`):

  * the model from an arch config (full, `--smoke`, or cut with
    `--n-layers` / `--d-model` / `--d-ff` / `--vocab`), float32 params
    drawn from `torch.Generator(device).manual_seed(--seed)`;
  * the deterministic `TokenPipeline` (step -> batch, restart-safe);
  * AdamW with the cosine schedule, gradient clipping and optional
    bfloat16 error feedback (`--compress-grads`);
  * atomic keep-3 checkpoints every `--ckpt-every` steps and `--resume`
    from the latest one, in the reference's on-disk layout.

  python -m repro_torch.launch.train --arch qwen3-32b --n-layers 4 \\
      --steps 10 --batch 8 --seq 256 --warmup 2 --ckpt-every 100
  python -m repro_torch.launch.train --arch mamba2-1.3b --steps 10 \\
      --batch 8 --seq 256 --warmup 2 --ckpt-every 100
  python -m repro_torch.launch.train --arch zamba2-1.2b --steps 10 \\
      --batch 8 --seq 256 --warmup 2 --ckpt-every 100
  python -m repro_torch.launch.train --arch qwen3-32b --smoke \\
      --device cpu --batch 2 --seq 32 --steps 6 --ckpt-every 5

The ssm and hybrid families train at full width and depth on the card:
each scan runs the `ssd_scan` kernel forward (twice a step under remat
"full") and its backward kernel once.

Runs on CUDA unless `--device cpu`.  One device only: `--data-axis`
above 1 (data-parallel sharding) exits.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager, restore
from repro_torch.configs import PORTED_ARCHS, get_config, get_smoke
from repro_torch.data import TokenPipeline
from repro_torch.launch import cli_device
from repro_torch.launch.steps import init_opt_state, make_train_step
from repro_torch.models.model import build_model
from repro_torch.models.module import leaves
from repro_torch.optim import AdamWConfig, cosine_schedule


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-32b", choices=PORTED_ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config for this arch")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--data-axis", type=int, default=0,
                    help="data-parallel ways (0 or 1: this device)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed for init and data")
    ap.add_argument("--device", default="cuda")
    return ap


def model_config(args):
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    cuts = {"d_model": args.d_model, "n_layers": args.n_layers,
            "d_ff": args.d_ff, "vocab": args.vocab}
    return dataclasses.replace(cfg, **{k: v for k, v in cuts.items() if v})


def run(args) -> dict:
    """Train as the CLI does; returns the bundle, the final params and
    optimizer state, the first step run and each step's record {step,
    loss, grad_norm, lr, wall_s} (wall_s: host seconds of the step, read
    after its metrics reach the host)."""
    device = cli_device(args.device)
    if args.data_axis > 1:
        raise SystemExit("--data-axis > 1: data-parallel training is not "
                         "ported to repro_torch yet (one device only; the "
                         "sharding rules are ROADMAP.md Queue 1 item 4)")
    cfg = model_config(args)
    bundle = build_model(cfg)
    print(f"arch={cfg.name} params={bundle.n_params:,}")

    opt_cfg = AdamWConfig(lr=cosine_schedule(args.lr, args.warmup,
                                             args.steps))
    step_fn = make_train_step(bundle, opt_cfg,
                              grad_compress=args.compress_grads)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)
    ckpt = CheckpointManager(args.ckpt_dir, every=args.ckpt_every, keep=3)

    params = bundle.init(torch.Generator(device).manual_seed(args.seed),
                         device=device)
    opt = init_opt_state(params, args.compress_grads)
    start = 0
    if args.resume and ckpt.latest() is not None:
        start = ckpt.latest()
        state = {"params": params, "opt": opt}
        # through the host into the live tensors: the device holds one
        # training state, never two
        for (_, t), (_, r) in zip(leaves(state), leaves(restore(
                args.ckpt_dir, start, state, device="cpu")), strict=True):
            t.copy_(r)
        print(f"resumed from step {start}")

    history = []
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        ts = time.perf_counter()
        batch = pipe.batch(step, device)
        params, opt, metrics = step_fn(params, opt, batch)
        loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
        history.append({"step": step, "loss": loss, "grad_norm": gn,
                        "lr": float(metrics["lr"]),
                        "wall_s": time.perf_counter() - ts})
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {loss:7.4f}  |g| {gn:8.3f}  "
                  f"{time.perf_counter() - t0:6.1f}s", flush=True)
        ckpt.maybe_save(step + 1, {"params": params, "opt": opt},
                        meta={"arch": cfg.name})
    print(f"done: {args.steps - start} steps in "
          f"{time.perf_counter() - t0:.1f}s")
    return {"bundle": bundle, "params": params, "opt": opt, "start": start,
            "history": history}


def main(argv=None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
