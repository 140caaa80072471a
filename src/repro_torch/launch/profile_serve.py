"""Where a served decode stream spends its device time, on one CUDA card.

    python -m repro_torch.launch.profile_serve

Serves the same stream as `chip_smoke.py`'s serve phase (qwen3-32b at full
width, 4 of 64 layers, fused backend, chip 7, 4 slots, 6 requests) once to
warm up, then again under `torch.profiler` with CUDA activity.  Prints the
wall time,
the device time by kernel family (the `rosa_fused` kernel, cuBLAS GEMMs,
everything else) and the device's busy share (summed kernel time over
wall time: kernels on one stream do not overlap), then the top kernels.
Writes the table to `chiprun_out/profile_serve.txt`.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time


def family(name: str) -> str:
    """The kernel family a profiler event name belongs to."""
    n = name.lower()
    if "fused_kernel" in n or "flush_splits" in n:
        return "rosa_fused kernel"
    if "osa_kernel" in n or "sum_splits" in n:
        return "osa_matmul kernel"
    if "gemm" in n or "gemv" in n or "cutlass" in n or "matmul" in n:
        return "cuBLAS GEMM/GEMV"
    if "reduce" in n:
        return "reductions"
    return "elementwise and other"


OUT = pathlib.Path("chiprun_out/profile_serve.txt")


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.serve import Scheduler, ServeConfig, poisson_requests

    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = dataclasses.replace(get_config("qwen3-32b"), n_layers=4)
    scfg = ServeConfig(n_slots=4, max_len=56, prefill_chunk=8, rosa=True,
                       rosa_backend="fused", variation_seed=7)
    sched = Scheduler(cfg, scfg, init_seed=0, device="cuda")
    reqs = poisson_requests(6, 1.0, vocab=cfg.vocab,
                            prompt_len=(4, 8), gen_len=(2, 40), seed=0)
    sched.run(reqs)                                        # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = sched.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    by_family: dict[str, float] = {}
    kernels = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us <= 0 or evt.device_type.name != "CUDA":
            continue
        fam = family(evt.key)
        by_family[fam] = by_family.get(fam, 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, evt.count, evt.key))
    busy_ms = sum(by_family.values())
    lines = [f"card {torch.cuda.get_device_name(0)}; qwen3-32b, "
             f"{cfg.n_layers} layers, fused backend, {len(reqs)} requests: "
             f"{rep.total_tokens} tokens, "
             f"{rep.ticks} ticks, {rep.decode_steps} decode steps, "
             f"{rep.prefill_chunks} prefill chunks",
             f"wall {wall_ms:.1f} ms under the profiler; device busy "
             f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %), idle "
             f"{100 * (1 - busy_ms / wall_ms):.1f} %"]
    if busy_ms == 0:
        lines.append("the profiler recorded no device time: not measured")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {fam:24s} {ms:9.2f} ms  {100 * ms / busy_ms:5.1f} %"
                     " of device time")
    lines.append("top kernels (device ms, launches, name):")
    for ms, count, key in sorted(kernels, reverse=True)[:15]:
        lines.append(f"  {ms:9.2f} {count:6d}  {key[:100]}")
    text = "\n".join(lines)
    print(text)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(text + "\n")


if __name__ == "__main__":
    main()
