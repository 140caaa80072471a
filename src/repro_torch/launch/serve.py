"""Serving CLI over `repro_torch.serve`.  Three policies:

  continuous  (default) continuous batching of a synthetic Poisson request
              stream over slots, chunked prefill beside the decode batch
  oneshot     static batching of the same stream
  batch       one fixed batch (random prompts; for the audio frontend
              random source embeddings, for the vision frontend 16 zero
              patch embeddings): prefill, then `--gen` tokens through
              `steps.make_sampling_decode_step`; the only policy that
              runs the encoder-decoder family, and the one that feeds a
              vision model its patches (the stream policies serve it
              text-only)

  python -m repro_torch.launch.serve --arch qwen3-32b --n-layers 4 \\
      --rosa --rosa-backend fused --variation-seed 7 --requests 6
  python -m repro_torch.launch.serve --arch mamba2-1.3b --requests 8 \\
      --max-len 768 --prompt-range 200 700 --gen-range 8 32
  python -m repro_torch.launch.serve --arch zamba2-1.2b --requests 8 \\
      --max-len 768 --prompt-range 200 700 --gen-range 8 32
  python -m repro_torch.launch.serve --arch deepseek-v2-236b --n-layers 3 \\
      --rosa --rosa-backend fused --variation-seed 7 --requests 6
  python -m repro_torch.launch.serve --arch seamless-m4t-medium \\
      --policy batch --batch 4 --prompt-len 32 --gen 16
  python -m repro_torch.launch.serve --arch gemma3-12b --rosa \\
      --rosa-backend fused --variation-seed 7 --requests 6
  python -m repro_torch.launch.serve --arch deepseek-67b --n-layers 4 \\
      --rosa --rosa-backend fused --variation-seed 7 --requests 6
  python -m repro_torch.launch.serve --arch mistral-large-123b \\
      --n-layers 4 --rosa --rosa-backend fused --variation-seed 7
  python -m repro_torch.launch.serve --arch phi-3-vision-4.2b \\
      --policy batch --batch 4 --prompt-len 32 --gen 16

`--smoke` takes the reduced CPU-sized config; `--n-layers` cuts the depth
of the full-width config.  `--trace PATH` saves a Chrome trace of a
stream policy's run (construction included), which `python -m
repro_torch.obs summarize PATH` reads (with `--devices N`, rank 0's).
Runs on CUDA unless `--device cpu`.

`--devices N` (stream policies) shards the slots over N ranks, one
process each (`distributed.runtime.spawn`), on a (N, 1) mesh: with
`--device cuda` over nccl, one card a rank (refused when fewer than N
cards are visible), with `--device cpu` over gloo.  Every rank serves
the same requests; rank 0 prints.

  python -m repro_torch.launch.serve --smoke --device cpu --devices 2
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import torch

from repro_torch.configs import PORTED_ARCHS, get_config, get_smoke
from repro_torch.launch import cli_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-32b", choices=PORTED_ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the model to this many layers")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--policy", default="continuous",
                    choices=["continuous", "oneshot", "batch"])
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
    # batch policy
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    return ap


def model_config(args):
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    return cfg


def batch_inputs(cfg, batch: int, prompt_len: int,
                 generator: torch.Generator, device) -> dict:
    """The fixed batch from `generator`: prompt ids (B, S); for the
    vision frontend 16 zero patch embeddings (B, 16, d_model) and for the
    audio frontend source embeddings (B, S, d_model), in bfloat16."""
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt_len),
                                   generator=generator, device=device,
                                   dtype=torch.int32)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = torch.zeros((batch, 16, cfg.d_model),
                                          dtype=torch.bfloat16, device=device)
    if cfg.frontend == "audio":
        out["src_embeds"] = torch.randn(
            (batch, prompt_len, cfg.d_model), generator=generator,
            device=device).to(torch.bfloat16)
    return out


@torch.inference_mode()
def generate(bundle, params, batch: dict, gen: int, temperature: float,
             generator: torch.Generator) -> dict:
    """Prefill, `pad_cache(gen + 1)`, then gen - 1 steps of
    `make_sampling_decode_step` (the first token is the prefill's argmax).
    Returns the tokens (B, gen), the prefill logits, the cache and the
    prefill and decode walls (s, the device synchronized)."""
    from repro_torch.launch.steps import make_sampling_decode_step
    from repro_torch.models.model import pad_cache

    dev = batch["tokens"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    logits, cache = bundle.prefill(params, batch)
    cache = pad_cache(bundle.cfg, cache, gen + 1)
    sync()
    prefill_s = time.perf_counter() - t0
    step = make_sampling_decode_step(bundle)
    tok = torch.argmax(logits, -1).to(torch.int32)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        tok, cache, generator = step(params, tok, cache, temperature,
                                     generator)
        out.append(tok)
    sync()
    return {"tokens": torch.stack(out, 1), "logits": logits, "cache": cache,
            "prefill_s": prefill_s, "decode_s": time.perf_counter() - t0}


def run_batch(args) -> dict:
    """The fixed-batch policy: params, prompts and (audio) source
    embeddings from one generator seeded with `--seed` (vision: zero
    patch embeddings), then `generate`.
    Returns its result with the bundle, params, inputs and tok/s."""
    from repro_torch.models.model import build_model

    device = cli_device(args.device)
    cfg = model_config(args)
    bundle = build_model(cfg)
    gen = torch.Generator(device).manual_seed(args.seed)
    params = bundle.init(gen, device=device)
    print(f"arch={cfg.name} layers={cfg.n_layers} "
          f"params={bundle.n_params:,} policy=batch device={device}")
    b, s = args.batch, args.prompt_len
    batch = batch_inputs(cfg, b, s, gen, device)
    res = generate(bundle, params, batch, args.gen, args.temperature, gen)
    res["tok_s"] = b * args.gen / max(res["decode_s"], 1e-9)
    print(f"prefill {b}x{s}: {res['prefill_s']:.2f}s")
    print(f"decoded {args.gen} tokens x {b} seqs in {res['decode_s']:.2f}s "
          f"({res['tok_s']:.1f} tok/s)")
    print("sample token ids:", res["tokens"][0, :12].tolist())
    return dict(res, bundle=bundle, params=params, batch=batch)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.policy == "batch":
        if args.devices > 1:
            raise SystemExit("--policy batch runs on one device; --devices "
                             "> 1 shards the stream policies' slots")
        run_batch(args)
        return
    if args.devices > 1:
        run_ranks(args)
        return
    run_stream(args)


def run_ranks(args) -> None:
    """`--devices N`: the stream policy on N ranks, slots sharded."""
    from repro_torch.distributed import runtime
    from repro_torch.launch import serve as this      # importable by name

    device = cli_device(args.device)
    device_type = torch.device(device).type
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        n = torch.cuda.device_count()
        if n < args.devices:
            raise SystemExit(f"--devices {args.devices} over nccl needs "
                             f"{args.devices} cards, one a rank; {n} "
                             "visible")
        if args.rosa:
            # every kernel built once, here, before any rank loads one
            from repro_torch import kernels
            kernels.build_all()
    runtime.spawn(this.serve_rank, args.devices, device_type=device_type,
                  backend=backend, args=(args,), timeout=3600.0)


def serve_rank(rank: int, world: int, device, args) -> None:
    """One rank of `--devices N`: the stream on a (N, 1) mesh."""
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(world, 1, device.type)
    run_stream(args, device=str(device), mesh=mesh, rank=rank)


def run_stream(args, device: str | None = None, mesh=None,
               rank: int = 0) -> None:
    """A stream policy (continuous or oneshot) on `device` (default
    `--device`), slots sharded over `mesh` when given; rank 0 prints and
    traces."""
    from repro_torch.core.constants import ROSA_OPTIMAL
    from repro_torch.serve import (Scheduler, ServeConfig, poisson_requests,
                                   report_metrics)

    device = args.device if device is None else device
    say = print if rank == 0 else (lambda *a, **k: None)
    tracer = None
    ctx = contextlib.nullcontext()
    if args.trace and rank == 0:
        from repro_torch import obs
        obs.install_kernel_hooks()
        tracer = obs.Tracer()
        # installed around construction too, so the compile, plan-cache and
        # kernel-build spans land in the same trace as the serving ticks
        ctx = obs.tracing(tracer)

    cfg = model_config(args)
    scfg = ServeConfig(n_slots=args.n_slots, max_len=args.max_len,
                       prefill_chunk=args.prefill_chunk,
                       temperature=args.temperature, seed=args.seed,
                       rosa=args.rosa, rosa_backend=args.rosa_backend,
                       variation_seed=args.variation_seed)
    with ctx:
        sched = Scheduler(cfg, scfg, init_seed=args.seed, device=device,
                          mesh=mesh)
        say(f"arch={cfg.name} layers={cfg.n_layers} "
            f"params={sched.bundle.n_params:,} slots={scfg.n_slots} "
            f"max_len={scfg.max_len} chunk={scfg.prefill_chunk} "
            f"policy={args.policy} device={device}"
            + (f" ranks={args.devices} x {sched.n_local} slots"
               if mesh is not None else "")
            + (f" rosa backend={args.rosa_backend}" if args.rosa else ""))
        if sched.program is not None:
            plan = {n: m.name for n, m in sched.program.plan.mapping_plan()
                    .items()}
            say(f"  plan {plan}")
        reqs = poisson_requests(args.requests, args.rate, vocab=cfg.vocab,
                                prompt_len=tuple(args.prompt_range),
                                gen_len=tuple(args.gen_range),
                                seed=args.seed)
        rep = sched.run(reqs, policy=args.policy)

    if tracer is not None:
        tracer.save(args.trace)
        say(f"trace: {len(tracer)} events -> {args.trace} "
            f"(load in https://ui.perfetto.dev, or summarize with "
            f"`python -m repro_torch.obs summarize {args.trace}`)")
    # computed on every rank (each served every request), printed by 0
    for m in report_metrics(rep):
        v = f"{m.value:.4g}" if isinstance(m.value, float) else m.value
        say(f"  {m.name:24s} {v} {m.unit}")
    say(f"  {'ticks':24s} {rep.ticks} ticks")
    if sched.engine is not None and sched.engine.ledger is not None:
        e = sched.engine.ledger.per_token(ROSA_OPTIMAL, batch=scfg.n_slots)
        say(f"  {'energy_per_token':24s} {e:.4g} J (ledger)")
    for c in sorted(rep.completions.values(), key=lambda c: c.rid)[:3]:
        say(f"  rid={c.rid} prompt={c.prompt_len} "
            f"tokens={c.tokens[:8]}{'...' if len(c.tokens) > 8 else ''}")


if __name__ == "__main__":
    main()
