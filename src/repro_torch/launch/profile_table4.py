"""Where the Table 4 pipeline spends its time, on one CUDA card.

    python -m repro_torch.launch.profile_table4 [--model resnet18]

Times the pipeline's three kinds of work separately, each as
`launch.table4.run_model` runs it (batch 64 QAT steps, noisy evaluations
of the 512-image test split with n_mc 3):

  data  generating synth-CIFAR (4096 training images) on the host;
  qat   50 QAT steps (value_and_grad + Adam), after 50 warm-up steps;
  eval  the WS, IS and ANALOG evaluations with every layer noisy.

For qat and eval it prints the wall time with and without the profiler,
the device time by kernel family and the device's busy share (summed
kernel time over wall time: kernels on one stream do not overlap).
Writes the table to `chiprun_out/profile_table4_<model>.txt`
(mobilenet_v3 unless `--model` names another paper CNN).
"""

from __future__ import annotations

import argparse
import pathlib
import time

OUT = pathlib.Path("chiprun_out")
STEPS = 50


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="mobilenet_v3",
                    choices=["alexnet", "vgg16", "resnet18", "mobilenet_v3"])
    model = ap.parse_args(argv).model

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import mrr
    from repro_torch.core.constants import ComputeMode, Mapping
    from repro_torch.data.synth_cifar import train_test_split
    from repro_torch.launch.profile_serve import family
    from repro_torch.launch.table4 import acc_with
    from repro_torch.models.cnn import LITE_MODELS, LITE_SKIPS, cnn_def
    from repro_torch.models.module import init_params, map_tree
    from repro_torch.training import cnn_train as T

    if not torch.cuda.is_available():
        raise SystemExit("profile_table4 needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    specs, skips = LITE_MODELS[model], LITE_SKIPS.get(model)

    t0 = time.perf_counter()
    (xtr, ytr), _ = train_test_split(n_train=4096, seed=0)
    data_s = time.perf_counter() - t0
    xtr_t, ytr_t = torch.from_numpy(xtr).to(dev), torch.from_numpy(ytr).to(dev)
    params = init_params(cnn_def(specs), torch.Generator(dev).manual_seed(0),
                         device=dev)
    engine = T.cnn_program(model, T.qat_engine(model)).engine
    state = {"p": params, "m": map_tree(torch.zeros_like, params),
             "v": map_tree(torch.zeros_like, params), "i": 0}
    rng = np.random.default_rng(0)

    def qat(steps):
        for _ in range(steps):
            idx = torch.from_numpy(rng.integers(0, len(xtr), 64)).to(dev)
            _, g = T.value_and_grad(state["p"], specs, skips, xtr_t[idx],
                                    ytr_t[idx], engine)
            with torch.no_grad():
                state["p"], state["m"], state["v"] = T.adam_step(
                    state["p"], state["m"], state["v"], g, state["i"], 3e-3)
            state["i"] += 1
        torch.cuda.synchronize()

    def evals():
        for mode, mp in ((ComputeMode.MIXED, Mapping.WS),
                         (ComputeMode.MIXED, Mapping.IS),
                         (ComputeMode.ANALOG, Mapping.WS)):
            acc_with(state["p"], model, mode, mp, mrr.PAPER_NOISE, 3)
        torch.cuda.synchronize()

    lines = [f"card {torch.cuda.get_device_name(0)}; {model}: synth-CIFAR "
             f"4096 training images generated in {data_s:.2f} s (host)"]
    for stage, fn, what in (("qat", lambda: qat(STEPS),
                             f"{STEPS} QAT steps at batch 64"),
                            ("eval", evals, "WS, IS and ANALOG evaluations, "
                             "n_mc 3, 512 images")):
        fn()                                               # warm-up
        t0 = time.perf_counter()
        fn()
        plain_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_family: dict[str, float] = {}
        for evt in prof.key_averages():
            dev_us = getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0))
            if dev_us <= 0 or evt.device_type.name != "CUDA":
                continue
            fam = family(evt.key)
            by_family[fam] = by_family.get(fam, 0.0) + dev_us / 1e3
        busy = sum(by_family.values())
        lines += [f"{stage}: {what}",
                  f"  wall {plain_ms:.1f} ms without the profiler, "
                  f"{wall_ms:.1f} ms under it; device busy {busy:.1f} ms "
                  f"({100 * busy / plain_ms:.1f} % of the unprofiled wall)"]
        if busy == 0:
            lines.append("  the profiler recorded no device time: not "
                         "measured")
        for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
            lines.append(f"    {fam:24s} {ms:9.2f} ms  "
                         f"{100 * ms / busy:5.1f} % of device time")
    text = "\n".join(lines)
    print(text)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"profile_table4_{model}.txt").write_text(text + "\n")


if __name__ == "__main__":
    main()
