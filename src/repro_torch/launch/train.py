"""End-to-end LM training on one device or across ranks (PyTorch port of
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

`--devices N` trains on N ranks, one process each
(`distributed.runtime.spawn`), on the reference's (data D, model N // D)
mesh, `--data-axis D` (0: D = N; an N that D does not divide is refused):
params and AdamW moments sharded as `TRAIN_RULES` lays them out, each
rank its rows of the global batch (`launch.steps.train_layout`; a batch
that does not divide over the data ranks is refused) and its share of
the heads, MLP units and vocab over the N // D model ranks.  Checkpoints are
the one-process files, so `--resume` moves a run between device counts.
Rank 0 prints, and `run` returns its history.  The ranks form a gloo
group: on the CPU its collectives carry the data; with `--device cuda`
the ranks share card 0 and their CUDA tensors' collectives go through
card buffers mapped across the ranks (`distributed.runtime`).  With
`--cards` they take one card a rank over nccl.

  python -m repro_torch.launch.train --smoke --device cpu --devices 4 \
      --data-axis 2 --batch 4 --seq 32 --steps 6

Runs on CUDA unless `--device cpu`.
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
from repro_torch.launch.steps import (init_opt_state, init_sharded,
                                      make_train_step, train_layout)
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
                    help="data-parallel ways (0 = all devices)")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks, one process each")
    ap.add_argument("--cards", action="store_true",
                    help="with --device cuda: one card a rank over nccl "
                         "(default: the ranks share card 0, their "
                         "collectives through card buffers)")
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


def mesh_shape(args) -> tuple[int, int]:
    """(data, model) of `--devices N --data-axis D`, as the reference's
    `make_test_mesh(data=dp, model=n_dev // dp)`; refuses an N that D does
    not divide."""
    n = args.devices
    if n < 1:
        raise SystemExit(f"--devices {n}: at least 1")
    dp = args.data_axis or n
    if dp < 1 or n % dp:
        raise SystemExit(f"--data-axis {args.data_axis} does not divide "
                         f"--devices {n}")
    return dp, n // dp


def run(args) -> dict:
    """Train as the CLI does.  On one device returns the bundle, the final
    params and optimizer state, the first step run and each step's record
    {step, loss, grad_norm, lr, wall_s} (wall_s: host seconds of the step,
    read after its metrics reach the host); across ranks, rank 0's
    {n_params, start, history, state_bytes}."""
    device = cli_device(args.device)
    mesh_shape(args)
    if args.devices == 1:
        return train(args, device)
    return run_ranks(args, device)


def run_ranks(args, device: str) -> dict:
    """`--devices N`: N ranks over gloo, on the CPU or sharing card 0
    (`--cards`: nccl, one card a rank); returns rank 0's result."""
    from repro_torch.distributed import runtime
    from repro_torch.launch import train as this      # importable by name
    device_type = torch.device(device).type
    backend = "nccl" if args.cards else "gloo"
    if args.cards and device_type != "cuda":
        raise SystemExit("--cards takes one card a rank: --device cuda")
    if device_type == "cuda":
        if args.cards and torch.cuda.device_count() < args.devices:
            raise SystemExit(f"--devices {args.devices} over nccl needs "
                             f"{args.devices} cards, one a rank; "
                             f"{torch.cuda.device_count()} visible")
        # every kernel built once, here, before any rank loads one
        from repro_torch import kernels
        kernels.build_all()
    return runtime.spawn(this.train_rank, args.devices,
                         device_type=device_type, backend=backend,
                         args=(args,), timeout=3600.0)[0]


def train_rank(rank: int, world: int, device, args) -> dict:
    """One rank of `--devices N`: its shards on the (data, model) mesh;
    hands back host values only."""
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(*mesh_shape(args), device.type)
    res = train(args, str(device), mesh=mesh, rank=rank)
    return {k: res[k] for k in ("n_params", "start", "history",
                                "state_bytes")}


def state_specs(layout, grad_compress: bool) -> dict:
    """The spec tree of {"params", "opt"} under a train layout: moments
    (and `err`) like their params, the step counter replicated
    (`steps.opt_state_shardings`)."""
    from repro_torch.distributed.sharding import P
    opt = {"adam": {"mu": layout.specs, "nu": layout.specs, "step": P()}}
    if grad_compress:
        opt["err"] = layout.specs
    return {"params": layout.specs, "opt": opt}


def train(args, device: str, mesh=None, rank: int = 0) -> dict:
    """The training loop on `device`, on this rank's shards of `mesh`
    when given (rank 0 prints)."""
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = model_config(args)
    bundle = build_model(cfg)
    say(f"arch={cfg.name} params={bundle.n_params:,}")

    layout = None if mesh is None else train_layout(bundle, mesh,
                                                    args.batch)
    opt_cfg = AdamWConfig(lr=cosine_schedule(args.lr, args.warmup,
                                             args.steps))
    step_fn = make_train_step(bundle, opt_cfg,
                              grad_compress=args.compress_grads,
                              layout=layout)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)
    ckpt = CheckpointManager(args.ckpt_dir, every=args.ckpt_every, keep=3)

    gen = torch.Generator(device).manual_seed(args.seed)
    params = (bundle.init(gen, device=device) if layout is None
              else init_sharded(bundle, gen, layout, device=device))
    opt = init_opt_state(params, args.compress_grads)
    specs = None if layout is None else state_specs(layout,
                                                    args.compress_grads)
    start = 0
    if args.resume and ckpt.latest() is not None:
        start = ckpt.latest()
        state = {"params": params, "opt": opt}
        # through the host into the live tensors: the device holds one
        # training state, never two
        for (_, t), (_, r) in zip(leaves(state), leaves(restore(
                args.ckpt_dir, start, state, device="cpu", specs=specs,
                mesh=mesh)), strict=True):
            t.copy_(r)
        say(f"resumed from step {start}")

    history = []
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        ts = time.perf_counter()
        batch = (pipe.batch(step, device) if layout is None
                 else layout.local_batch(pipe.batch(step), device))
        params, opt, metrics = step_fn(params, opt, batch)
        loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
        history.append({"step": step, "loss": loss, "grad_norm": gn,
                        "lr": float(metrics["lr"]),
                        "wall_s": time.perf_counter() - ts})
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d}  loss {loss:7.4f}  |g| {gn:8.3f}  "
                f"{time.perf_counter() - t0:6.1f}s", flush=True)
        ckpt.maybe_save(step + 1, {"params": params, "opt": opt},
                        meta={"arch": cfg.name}, specs=specs, mesh=mesh)
    say(f"done: {args.steps - start} steps in "
        f"{time.perf_counter() - t0:.1f}s")
    state_bytes = sum(t.numel() * t.element_size()
                      for _, t in leaves({"params": params, "opt": opt}))
    return {"bundle": bundle, "params": params, "opt": opt, "start": start,
            "history": history, "n_params": bundle.n_params,
            "layout": layout, "state_bytes": state_bytes}


def main(argv=None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
