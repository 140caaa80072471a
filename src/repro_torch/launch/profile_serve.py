"""Where a served stream spends its device time, on one CUDA card.

    python -m repro_torch.launch.profile_serve [--arch mamba2-1.3b]

Serves the same stream as one of `chip_smoke.py`'s serve phases once to
warm up, once timed without the profiler, then again under
`torch.profiler` with CUDA activity:

  qwen3-32b    full width, 4 of 64 layers, fused backend, chip 7, 4 slots,
               6 requests (prompts 4-8, generations 2-40);
  mamba2-1.3b  full width and depth (48 layers), optical engine on (it
               routes nothing), 4 slots, 8 requests (prompts 200-700,
               generations 8-32), whole-prompt prefill through `ssd_scan`;
  zamba2-1.2b  full width and depth (38 layers), mamba2's stream (phase
               15(a));
  qwen3-moe-235b-a22b, deepseek-v2-236b
               full width, 3 layers, as qwen3-32b's stream (phase 14):
               qwen3-moe routes nothing, deepseek-v2 its layer-0 MLP;
  gemma3-12b, phi-3-vision-4.2b, deepseek-67b, mistral-large-123b
               full width, at phase 16's depths (48, 32, 4, 4 layers),
               qwen3-32b's stream (gemma3 without phase 16's long prompt).

Prints the wall time with and without the profiler, the device time by
kernel family (the port's kernels, cuBLAS GEMMs, everything else) and the
device's busy share (summed kernel time over wall time: kernels on one
stream do not overlap), then the top kernels.  Writes the table to
`chiprun_out/profile_serve_<arch>.txt`.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import time

# arch -> (depth, ServeConfig keywords, poisson_requests keywords)
STREAMS = {
    "qwen3-32b": (4, dict(n_slots=4, max_len=56, prefill_chunk=8, rosa=True,
                          rosa_backend="fused", variation_seed=7),
                  dict(n=6, prompt_len=(4, 8), gen_len=(2, 40))),
    "mamba2-1.3b": (48, dict(n_slots=4, max_len=768, rosa=True,
                             rosa_backend="fused", variation_seed=7),
                    dict(n=8, prompt_len=(200, 700), gen_len=(8, 32))),
}
STREAMS["qwen3-moe-235b-a22b"] = STREAMS["deepseek-v2-236b"] = \
    (3,) + STREAMS["qwen3-32b"][1:]
STREAMS["zamba2-1.2b"] = (38,) + STREAMS["mamba2-1.3b"][1:]
for _arch, _depth in (("gemma3-12b", 48), ("phi-3-vision-4.2b", 32),
                      ("deepseek-67b", 4), ("mistral-large-123b", 4)):
    STREAMS[_arch] = (_depth,) + STREAMS["qwen3-32b"][1:]


def family(name: str) -> str:
    """The kernel family a profiler event name belongs to."""
    n = name.lower()
    if any(k in n for k in ("osa_kernel", "sum_splits", "osa_operand",
                            "identity>")):
        return "osa_matmul kernel"
    if any(k in n for k in ("fused_kernel", "flush_splits", "weightop>",
                            "x_operand", "w_operand")):
        return "rosa_fused kernel"
    if "ssd_bwd_" in n:
        return "ssd_scan backward kernel"
    if any(k in n for k in ("ssd_chunk_state", "ssd_state_pass",
                            "ssd_chunk_out")):
        return "ssd_scan kernel"
    if "transfer_kernel" in n:
        return "mrr_transfer kernel"
    if "gemm" in n or "gemv" in n or "cutlass" in n or "matmul" in n:
        return "cuBLAS GEMM/GEMV"
    if "reduce" in n:
        return "reductions"
    return "elementwise and other"


OUT = pathlib.Path("chiprun_out")


def device_table(prof, header: str, wall_ms: float, plain_wall_ms: float,
                 out_name: str) -> str:
    """The profiled run's device time by kernel family and its busy share
    (summed kernel time over wall time: kernels on one stream do not
    overlap), then the top 15 kernels; printed, written to
    `chiprun_out/<out_name>` and returned."""
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
    lines = [header,
             f"wall {wall_ms:.1f} ms under the profiler; device busy "
             f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %), idle "
             f"{100 * (1 - busy_ms / wall_ms):.1f} %",
             f"wall {plain_wall_ms:.1f} ms without the profiler (the run "
             f"before); against it the same device time is "
             f"{100 * busy_ms / plain_wall_ms:.1f} % busy"]
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
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / out_name).write_text(text + "\n")
    return text


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-32b", choices=sorted(STREAMS))
    arch = ap.parse_args(argv).arch

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.serve import Scheduler, ServeConfig, poisson_requests

    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    depth, serve_kw, req_kw = STREAMS[arch]
    cfg = dataclasses.replace(get_config(arch), n_layers=depth)
    scfg = ServeConfig(**serve_kw)
    sched = Scheduler(cfg, scfg, init_seed=0, device="cuda")
    reqs = poisson_requests(req_kw["n"], 1.0, vocab=cfg.vocab,
                            prompt_len=req_kw["prompt_len"],
                            gen_len=req_kw["gen_len"], seed=0)
    sched.run(reqs)                                        # warm-up
    plain_wall_ms = sched.run(reqs).wall_s * 1e3           # no profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = sched.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    device_table(prof, f"card {torch.cuda.get_device_name(0)}; {arch}, "
                 f"{cfg.n_layers} layers, fused backend, {len(reqs)} "
                 f"requests: {rep.total_tokens} tokens, {rep.ticks} ticks, "
                 f"{rep.decode_steps} decode steps, {rep.prefill_chunks} "
                 f"prefill chunks", wall_ms, plain_wall_ms,
                 f"profile_serve_{arch}.txt")


if __name__ == "__main__":
    main()
