"""Where a train step spends its device time, on one CUDA card.

    python -m repro_torch.launch.profile_train [--arch mamba2-1.3b]

Builds the model at full width and depth (random weights from seed 0),
runs `launch.steps.make_train_step` with the train CLI's AdamW and
cosine schedule on `TokenPipeline` batches of 8 x 256 (`--batch`,
`--seq`): two warm-up steps, one step timed without the profiler, then
one under `torch.profiler` with CUDA activity.  Prints both walls, the
device time by kernel family (`profile_serve.family`: the port's
kernels, cuBLAS GEMMs, reductions, everything else) and the device's
busy share, then the top kernels (`profile_serve.device_table`).  Writes
the table to `chiprun_out/profile_train_<arch>.txt`.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.launch.profile_serve import device_table


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import init_opt_state, make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig, cosine_schedule

    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = get_config(args.arch)
    bundle = build_model(cfg)
    step = make_train_step(bundle, AdamWConfig(
        lr=cosine_schedule(3e-4, 2, 4)))
    pipe = TokenPipeline(cfg.vocab, args.seq, args.batch, seed=0)
    params = bundle.init(torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    opt = init_opt_state(params)

    def run(i: int) -> float:
        t0 = time.perf_counter()
        nonlocal params, opt
        params, opt, metrics = step(params, opt, pipe.batch(i, "cuda"))
        float(metrics["loss"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    run(0)
    run(1)                                              # warm-up
    plain_wall_ms = run(2)                              # no profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = run(3)

    device_table(prof, f"card {torch.cuda.get_device_name(0)}; {args.arch} "
                 f"train step, {cfg.n_layers} layers, {bundle.n_params:,} "
                 f"params, batch {args.batch} x {args.seq}, remat "
                 f"{cfg.remat}", wall_ms, plain_wall_ms,
                 f"profile_train_{args.arch}.txt")


if __name__ == "__main__":
    main()
