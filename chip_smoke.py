#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --kernels  # build, phases 2, 6, 8, 12(a) (no result)

Phases (any failure raises, so the exit code is non-zero):

  1. the card's name and power limit; build every CUDA kernel of
     `src/repro_torch/kernels/csrc/` with nvcc (sm_90a);
  2. kernel parity: each kernel against its plain PyTorch version on the
     same CUDA tensors, at the serving shapes (m in {4, 8} rows against the
     5120 x 51200 and 25600 x 5120 MLP projections), the largest im2col
     sheets of the four paper CNNs at eval batch 512 (mobilenet_v3
     conv_stem 524288 x 27 x 16, alexnet conv1 524288 x 27 x 24 and conv2
     131072 x 216 x 48, vgg16 conv1_2 524288 x 144 x 16, resnet18 l1
     524288 x 216 x 24; PAPER_NOISE, IS and WS), a ragged shape and, for
     osa_matmul, 524,289 rows (past the
     grid's y limit), the robust gated evaluator's cells (a chip,
     PAPER_NOISE, gate 0 / 1 and mgate 0 / 1 on alexnet conv2 at 128
     images, 32768 x 216 x 48), held to the flip-aware one-LSB bound; two
     launches
     on the same inputs must give equal bits.  Timed rows: the median of
     10 per-call CUDA-event times, a kernel-only time (one event pair
     around 20 back-to-back launches replayed from a CUDA graph, over 20:
     no wrapper host time between them), the plain version, the bound and, for
     osa_matmul fused, the one PyTorch call computing the same function
     (`torch.matmul(q, w)` under ideal gains);
  3. serve: qwen3-32b at full width, depth cut to 4 of 64 layers, random
     weights from seed 0, through the optical engine with the `rosa_fused`
     kernel and chip 7 pinned: 6 seeded Poisson requests, continuous
     batching over 4 slots.  The launch counts are reset just before the
     run and read just after; every routed MLP projection must have
     launched the kernel;
  4. a 2-request stream through the `osa_matmul` kernel ("pallas" backend);
  5. end-to-end cross-check: one prompt's prefill logits through the fused
     kernel and through the plain composed ("ref") pipeline, held within
     4x the float-order floor the script measures (see serve_phase);
  6. ssd_scan parity and times: the kernel against its plain version at
     mamba2-1.3b's served shape (B 1, H 64, P 64, G 1, S 128, chunk 128)
     for L in {1, 127, 128, 129, 512, 1000} (ragged tails), one case with
     G 2 and B 2 and one with G = H, held to 1e-4 of max|y| on y and of
     max|state| on the final state; two launches must give equal bits;
     per-call and kernel-only times as in phase 2, the bound and its
     share, the launches' resident blocks per SM;
  7. serve: mamba2-1.3b at full width and depth (48 layers, 1.34e9 params,
     random weights from seed 0) with the optical engine on (the block
     routes nothing), 8 seeded Poisson requests (prompts 200-700 tokens,
     generations 8-32), 4 slots, max_len 768, greedy; every prompt
     prefills whole through the `ssd_scan` kernel, 48 launches each.  The
     continuous stream's tokens must equal the sequential oracle's, and
     one prefill's logits on the kernel path must agree with the same
     prefill through the plain scan within 4x a measured float-order
     floor, with the same greedy token;
  8. mrr_transfer parity and times: the kernel against its plain version
     on the same CUDA tensors, bit for bit, at the mobilenet_v3 depthwise
     weight (60, 25) with noise and a chip (per row), the conv_stem IS
     activation sheet at eval batch 512 (524288, 27) without and with a
     chip (per column), qwen3-32b's mlp/wi (5120, 51200) with noise and
     with a chip only, and a ragged 1-D n = 1,000,003; per-call and
     kernel-only times as in phase 2, the bound and its share;
  9. the paper's Table 4 pipeline over the four paper CNNs (alexnet,
     vgg16, resnet18, mobilenet_v3) at the reference's widths through
     `launch.table4.run`, one model per main-path run: 400 QAT steps at
     batch 64 on 4096 synth-CIFAR images, the per-layer noise profile
     (n_mc 3), the hybrid plan, the five accuracies on the 512-image test
     split, and the EDP of WS, hybrid and DEAP-CNNs; then the paper's three
     averages.  The launch counts are reset just before each model and
     read just after: rosa_fused must have run every noisy conv/fc
     evaluation and mrr_transfer every noisy depthwise conditioning,
     counted from the specs and the plan; the WS and DEAP EDPs must equal
     the reference's floats (TABLE4_EDP);
 10. card vs the reference: the golden file of tests/test_torch_cnn.py
     (JAX-trained mobilenet_v3, a JAX chip, JAX's logits).  Clean accuracy
     within 2 images and chip-pinned WS / IS (per-shot noise ideal)
     within 5 images of 512 of the reference's; the kernel path's logits
     within 4x the float-order floor of the plain path on the card (the
     plain path with permuted channels, as in phase 5);
 11. the paper's energy model in float64 on the card: Figs. 7-9, Table 1,
     the model-zoo DSE sweep (16 workloads, 5176 layer rows, 33
     candidates), the EDP-only hybrid plan on five zoo architectures and
     Table 4's EDP-only averages, each within 1e-9 relative of the
     reference's value (ENERGY_REF; labels and counts equal); the zoo
     sweep's wall, the median of 10 after 2 warm-ups;
 12. robust: (a) the mrr_transfer backward kernel against its plain
     derivative on the same CUDA tensors, bit for bit, at mobilenet_v3's
     four depthwise weights with a chip (per row), with and without
     draws, a chip per column, a full-shape chip field, no chip, and the
     (5120, 51200) sheet with a chip, with and without draws; times and
     bound as in phase 8 (bytes: w, g and dq, and the draws);
     (b) variation-aware QAT: `train_cnn` of mobilenet_v3, 400 steps at
     batch 64 over an 8-chip antithetic wafer, every parameter finite and
     the launches exactly 400 x 11 rosa_fused and 400 x 4 mrr_transfer
     forward and backward (the clean evaluation after training launches
     nothing); then `evaluate_cnn_ensemble` of it and of phase 9's plainly
     trained mobilenet_v3 on a fresh 16-chip wafer at PAPER_NOISE, with
     launches counted from the specs; (c) the robust CLI runners on alexnet
     with phase 9's parameters at the reference's defaults (ensemble: 64
     chips, 4 probes, 512 images; sensitivity: 16 chips, 256 images;
     drift: 16 chips, 256 images, sine, re-trim every 900 s; sweep: 32
     chips, 5 scales), each a main-path run with launches counted from the
     run's shape, and the sensitivity plan and EDP ratio recomputed from
     its own degradation matrix in float64;
 13. compile once and drift-adaptive serving: (a) qwen3-32b's serving
     Program (full width, 4 of 64 layers, backend fused) compiled twice
     against one `rosa.PlanCache`: the first searches, the second loads
     the plan (cache_hit), both plans IS/IS as phase 3's, and `python -m
     repro_torch.rosa stats` counts one plan; (b) the reference bench's
     full-size drift_serve scenario (sine 0.6 K over 96 ticks, 16 Poisson
     requests at 0.5 a tick, 4 slots, max_len 56, chunk 8, probes of 16 x
     4 tokens every 2 ticks, warm-up 6, chip 0, a forced replan at tick 30)
     on qwen3-32b at full width, uncontrolled then controlled, each arm a
     main-path run: no request dropped, the requests done before the
     first actuator write bit-exact between the arms, and every decode
     step up to it too, no swap downtime, at least one replan, and
     rosa_fused launched exactly once per routed projection of every
     decode step, prefill chunk, warm-up step and chip-pinned probe
     forward; recovery and the agreements are recorded; (c) `run_smoke`
     twice on phase 9's alexnet with one cache: the second run finds the
     degradation matrix, and its launches show the Monte-Carlo stage did
     not run.

Every compile of the run goes through a fresh plan cache (a temporary
`ROSA_PLAN_CACHE` under build/, removed at the end), so each starts
cold.  It prints one JSON line summarizing the kernels, then the card's
name and power limit, then `{"ok": true, "device": {...}}` as the last
line.  Per-case numbers go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
M_ROWS = (4, 8)               # decode batch (4 slots) and a prefill chunk
PROJ = {"mlp/wi": (5120, 51200), "mlp/wo": (25600, 5120)}
RAGGED = (13, 1000, 300)
# ssd_scan cases (B, L, H, P, G, S, chunk): mamba2-1.3b's served shape at
# one step, a chunk's edges, the served L, a ragged 1000; G 2 at B 2; G = H
SSD_CASES = [(1, 1, 64, 64, 1, 128, 128), (1, 127, 64, 64, 1, 128, 128),
             (1, 128, 64, 64, 1, 128, 128), (1, 129, 64, 64, 1, 128, 128),
             (1, 512, 64, 64, 1, 128, 128), (1, 1000, 64, 64, 1, 128, 128),
             (2, 700, 64, 64, 2, 128, 128), (1, 512, 64, 64, 64, 128, 128)]
SSD_SERVED_L = 512
MAMBA_PARAMS = 1_343_532_032  # mamba2-1.3b at full width and depth


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of per-call times from CUDA events (device time of the work
    `fn` enqueues, host gaps included)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_only_ms(fn, n: int = 20) -> float:
    """Device time of `n` back-to-back calls of `fn` under one CUDA-event
    pair, over n.  The calls are captured once into a CUDA graph and the
    graph is replayed, so no host work (the wrapper's checks, allocations
    and ctypes call) sits between the kernels; the difference to
    `median_ms` is that host time."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    del graph
    torch.cuda.empty_cache()
    return a.elapsed_time(b) / n


def distinct_bytes(*tensors) -> int:
    """Bytes of the distinct elements of float32 operands (a stride-0
    broadcast view counts its stored extent once); None entries and
    tuples of tensors are taken as they come."""
    total = 0
    for t in tensors:
        if t is None:
            continue
        if isinstance(t, (tuple, list)):
            total += distinct_bytes(*t)
            continue
        total += 4 * math.prod(n for n, st in zip(t.shape, t.stride())
                               if st != 0)
    return total


def quantized_parity(y, y_ref, what: str, qmax: int = 127,
                     tight: float = 2e-4) -> float:
    """Flip-aware bound: deviations relative to the reference's full scale
    stay within one requantization LSB (2/qmax), and rows beyond float
    tightness (code flips at rounding boundaries) stay rare.  Returns the
    max absolute error."""
    import torch
    y = y.double().reshape(-1, y.shape[-1])
    r = y_ref.double().reshape(y.shape)
    if not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    scale = max(float(r.abs().max()), 1.0)
    d = (y - r).abs() / scale
    if float(d.max()) > 2.0 / qmax:
        raise AssertionError(f"{what}: deviation {float(d.max()):.3e} "
                             "exceeds the one-LSB flip bound")
    bad = int((d.amax(dim=1) > tight).sum())
    if bad > max(2, -(-y.shape[0] // 4)):
        raise AssertionError(f"{what}: {bad} of {y.shape[0]} rows beyond "
                             "the tight tolerance")
    return float((y - r).abs().max())


def _launch_counters():
    from repro_torch.kernels.mrr_transfer import ops as mrr_ops
    from repro_torch.kernels.osa_matmul import ops as osa_ops
    from repro_torch.kernels.rosa_fused import ops as fused_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"rosa_fused": fused_ops.LAUNCHES, "osa_matmul": osa_ops.LAUNCHES,
            "ssd_scan": ssd_ops.LAUNCHES, "mrr_transfer": mrr_ops.LAUNCHES,
            "mrr_transfer_bwd": mrr_ops.LAUNCHES_BWD}


def reset_launches() -> None:
    """Every kernel's launch count to 0 (just before a main path runs)."""
    for c in _launch_counters().values():
        c.reset()


def launch_counts() -> dict:
    return {name: c.count for name, c in _launch_counters().items()}


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    tb, tf = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernel parity and times
# ---------------------------------------------------------------------------
# the paper CNNs' largest im2col sheets at eval batch 512 on 32x32 inputs
# (rows, lanes, outs), from the traced lite nets (models/cnn.py)
CONV_STEM = (524288, 27, 16)           # mobilenet_v3
CNN_SHEETS = {"conv_stem": CONV_STEM,
              "alexnet conv1": (524288, 27, 24),
              "alexnet conv2": (131072, 216, 48),
              "vgg16 conv1_2": (524288, 144, 16),
              "resnet18 l1": (524288, 216, 24)}
GATED_SHEET = (32768, 216, 48)         # alexnet conv2, 128 images
PROBE_ROWS = 64                        # drift probes: 16 prompts x 4 tokens
PROBE_SHIFT_K = 0.3                    # a thermal residual on the chip


def fused_cases():
    """(m, k, n, what, keywords, timed)."""
    from repro_torch.core.constants import ComputeMode, Mapping
    is_apv = dict(mapping=Mapping.IS, act_per_vector=True)
    cases = [(m, k, n, f"IS realize_x {name}", is_apv, True)
             for name, (k, n) in PROJ.items() for m in M_ROWS]
    k, n = PROJ["mlp/wo"]
    cases += [(4, k, n, "WS realize_w mlp/wo", dict(mapping=Mapping.WS),
               True),
              (8, *PROJ["mlp/wi"], "mgate 0.5 mlp/wi",
               dict(mapping=Mapping.WS, mgate=0.5, act_per_vector=True),
               False),
              (4, *PROJ["mlp/wi"], "ANALOG mlp/wi",
               dict(mode=ComputeMode.ANALOG), False)]
    # the Table 4 evaluations' largest sheets: PAPER_NOISE, no chip
    cases += [(*sheet, f"{mp} {name} noisy",
               dict(mapping=Mapping[mp], noisy=True, chip=False), True)
              for name, sheet in CNN_SHEETS.items() for mp in ("IS", "WS")]
    # the gated evaluator's cells (robust.sensitivity): a chip,
    # PAPER_NOISE, one-hot analog gates (0 or 1) and constant mapping gates
    # (0 = WS, 1 = IS), at one micro-batch of 128 images
    cases += [(*GATED_SHEET, f"gate {g:g} mgate {mg:g} alexnet conv2 b128",
               dict(mapping=Mapping.WS, noisy=True, gate=g, mgate=mg), False)
              for g in (0.0, 1.0) for mg in (0.0, 1.0)]
    # the drift probes' and replan cells' forwards (phase 13(b)): the gated
    # evaluator at qwen3-32b width, IDEAL per-shot noise, per-layer analog
    # and mapping gates of 0 or 1, the pinned chip shifted by a residual
    cases += [(PROBE_ROWS, k, n, f"{mp} gate {g:g} mgate {mg:g} probe "
               f"{name}", dict(mapping=Mapping[mp], act_per_vector=True,
                               gate=g, mgate=mg, shift_k=PROBE_SHIFT_K),
               False)
              for name, (k, n) in PROJ.items() for mp in ("IS", "WS")
              for g in (0.0, 1.0) for mg in (0.0, 1.0)]
    m, k, n = RAGGED
    cases += [(m, k, n, "IS ragged", is_apv, False),
              (m, k, n, "WS gate 0.3 ragged",
               dict(mapping=Mapping.WS, gate=0.3), False),
              (m, k, n, "ANALOG gate 0.7 ragged",
               dict(mode=ComputeMode.ANALOG, gate=0.7), False),
              (m, k, n, "WS noisy pam2 ragged",
               dict(mapping=Mapping.WS, noisy=True, pam_bits=2), False)]
    return cases


def fused_flops(m, k, n, static) -> int:
    """Float operations of one call: the contraction, the conditioning of
    each activation (~12, ~40 with the realization chain) and of each
    weight (~6, ~46 with the chain)."""
    return (2 * m * k * n + (40 if static["realize_x"] else 12) * m * k
            + (46 if static["realize_w"] else 6) * k * n)


def time_row(row, fn, plain_fn, nbytes, flops) -> None:
    """Per-call median, kernel-only time, plain version and bound."""
    row["ms"] = median_ms(fn)
    row["kernel_ms"] = kernel_only_ms(fn)
    row["plain_ms"] = median_ms(plain_fn, reps=5)
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]


def timing_text(row) -> str:
    if "ms" not in row:
        return ""
    return (f"  kernel {row['ms']:.4f} ms (kernel only "
            f"{row['kernel_ms']:.4f})  plain {row['plain_ms']:.3f} ms"
            + (f"  matmul {row['library_ms']:.4f} ms (kernel only "
               f"{row['library_kernel_ms']:.4f})"
               if row.get("library_ms") is not None else "")
            + f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
            f"{100 * row['bound_share']:.1f} %)")


def fused_phase(report: dict) -> dict:
    import torch
    from repro_torch.core import mrr
    from repro_torch.core.constants import Mapping
    from repro_torch.kernels.rosa_fused import ops

    g = torch.Generator(DEVICE).manual_seed(1)
    err, rows, served = 0.0, [], None
    for m, k, n, what, kw, timed in fused_cases():
        kw = dict(kw)
        gate, mgate = kw.pop("gate", None), kw.pop("mgate", None)
        with_chip = kw.pop("chip", True)
        shift_k = kw.pop("shift_k", None)
        key = None
        if kw.pop("noisy", False):
            kw["noise"] = mrr.PAPER_NOISE
            key = torch.Generator(DEVICE).manual_seed(2)
        x = torch.randn(m, k, device=DEVICE, generator=g)
        w = torch.randn(k, n, device=DEVICE, generator=g)
        var = mrr.StaticVariation(
            0.01 * torch.randn(k, device=DEVICE, generator=g),
            0.04 * torch.randn(k, device=DEVICE, generator=g),
            0.01 * torch.randn(k, device=DEVICE, generator=g)) \
            if with_chip else None
        if shift_k is not None:
            var = var.shift_ddt(shift_k)
        args, static = ops.operands(x, w, key, var, gate, mgate, **kw)
        y = ops.launch(*args, **static)
        y_plain = ops.plain(*args, **static)
        torch.cuda.synchronize()
        e = quantized_parity(y, y_plain, f"rosa_fused {what} {m}x{k}x{n}")
        err = max(err, e)
        row = {"case": what, "m": m, "k": k, "n": n, "max_abs_err": e}
        if timed:
            if not torch.equal(y, ops.launch(*args, **static)):
                raise AssertionError(f"rosa_fused {what}: two launches on "
                                     "the same inputs differ")
            nbytes = distinct_bytes(*args) + 4 * m * n
            time_row(row, lambda: ops.launch(*args, **static),
                     lambda: ops.plain(*args, **static), nbytes,
                     fused_flops(m, k, n, static))
            if what == "IS realize_x mlp/wi" and m == 4:
                served = row             # the decode tick's larger launch
        rows.append(row)
        print(f"  rosa_fused {what:24s} {m}x{k}x{n}: max_abs_err {e:.3e}"
              + timing_text(row), flush=True)
        del x, w, args, y, y_plain
        torch.cuda.empty_cache()
    # the requantized 8-bit codes, read back through an identity weight:
    # the kernel's realization must equal the plain version's bit for bit
    k = PROJ["mlp/wi"][0]
    x = 3 * torch.randn(8, k, device=DEVICE, generator=g)
    var = mrr.StaticVariation(
        *(s * torch.randn(k, device=DEVICE, generator=g)
          for s in (0.01, 0.04, 0.01)))
    args, static = ops.operands(x, torch.eye(k, device=DEVICE), None, var,
                                mapping=Mapping.IS, act_per_vector=True)
    s2 = args[3][:, 2:3]
    codes = [torch.round(y * 127 / s2) for y in
             (ops.launch(*args, **static), ops.plain(*args, **static))]
    flips = int((codes[0] != codes[1]).sum())
    print(f"  rosa_fused IS codes through an identity weight 8x{k}: "
          f"{flips} of {codes[0].numel()} differ")
    if flips:
        raise AssertionError("rosa_fused: the kernel's requantized codes "
                             "differ from the plain version's")
    report["rosa_fused_cases"] = rows
    report["rosa_fused_code_flips"] = flips
    return dict(served, max_abs_err=err)


def osa_phase(report: dict) -> dict:
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.kernels.osa_matmul import ops

    g = torch.Generator(DEVICE).manual_seed(3)
    gains = Q.plane_weights(device=DEVICE)
    shapes = [(m, k, n) for (k, n) in PROJ.values() for m in M_ROWS]
    # past the grid's y limit of 65535 row tiles: no ported path runs
    # osa_matmul this tall, the launcher must take it all the same
    tall = (CONV_STEM[0] + 1, *CONV_STEM[1:])
    err, rows, served = 0.0, [], None
    for m, k, n in shapes + [RAGGED, tall]:
        x = torch.randn(m, k, device=DEVICE, generator=g)
        w = torch.randn(k, n, device=DEVICE, generator=g)
        q, _ = Q.quantize(x, per_vector=True)
        for fused in (True, False):
            y = ops.launch(q, w, gains, n_planes=7, fused=fused)
            y_plain = ops.plain(q, w, gains, n_planes=7, fused=fused)
            torch.cuda.synchronize()
            what = f"osa_matmul {'fused' if fused else 'per-plane'}"
            e = quantized_parity(y, y_plain, f"{what} {m}x{k}x{n}")
            err = max(err, e)
            row = {"case": what, "m": m, "k": k, "n": n, "max_abs_err": e}
            if (m, k, n) in shapes:
                if not torch.equal(y, ops.launch(q, w, gains, n_planes=7,
                                                 fused=fused)):
                    raise AssertionError(f"{what} {m}x{k}x{n}: two launches "
                                         "on the same inputs differ")
                # per-plane: one contraction per plane, 7x the operations
                planes = 1 if fused else 7
                time_row(row,
                         lambda: ops.launch(q, w, gains, n_planes=7,
                                            fused=fused),
                         lambda: ops.plain(q, w, gains, n_planes=7,
                                           fused=fused),
                         4 * (m * k + k * n + m * n + 7),
                         planes * 2 * m * k * n + 21 * m * k)
                row["library_ms"] = row["library_kernel_ms"] = None
                if fused:
                    row["library_ms"] = median_ms(lambda: torch.matmul(q, w))
                    row["library_kernel_ms"] = kernel_only_ms(
                        lambda: torch.matmul(q, w))
                if (m, k, n) == (4, *PROJ["mlp/wi"]) and fused:
                    served = row
            rows.append(row)
            print(f"  {what:25s} {m}x{k}x{n}: max_abs_err {e:.3e}"
                  + timing_text(row), flush=True)
        del x, w, q, y, y_plain
        torch.cuda.empty_cache()
    report["osa_matmul_cases"] = rows
    return dict(served, max_abs_err=err)


# ---------------------------------------------------------------------------
# Phases 3-5: serving
# ---------------------------------------------------------------------------
def check_run(rep, reqs, vocab: int, what: str) -> None:
    for r in reqs:
        toks = rep.completions[r.rid].tokens
        if len(toks) != r.max_new_tokens:
            raise AssertionError(f"{what}: request {r.rid} got {len(toks)} "
                                 f"tokens, wanted {r.max_new_tokens}")
        if not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"{what}: token id out of range")


def prefill_logits(sched, prompt):
    import torch
    from repro_torch.serve.decode import PrefillTask
    with torch.inference_mode():
        task = PrefillTask(sched.bundle, sched.scfg, prompt, sched.chunk_fn,
                           sched.device, sched.whole_fn)
        while not task.advance(sched.params):
            pass
    torch.cuda.synchronize()
    return task.logits.float()


def permuted_params(sched, sizes: dict, seed: int):
    """The scheduler's params with the named logical axes permuted (one
    random permutation per axis, `sizes` {axis: length}): the same
    function, every reduction over those axes summed in another order.
    Returns (params, {axis: permutation})."""
    import torch
    from repro_torch.models.module import leaves

    g = torch.Generator().manual_seed(seed)
    perm = {name: torch.randperm(n, generator=g).to(DEVICE)
            for name, n in sizes.items()}
    params: dict = {}
    for path, d in leaves(sched.bundle.skeleton):
        t = sched.params
        for k in path:
            t = t[k]
        for ax, name in enumerate(d.axes):
            if name in perm:
                t = t.index_select(ax, perm[name])
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return params, perm


def permuted(sched, seed: int):
    """The scheduler's params and pinned chip with the hidden ("embed") and
    MLP ("mlp") dimensions permuted."""
    from repro_torch.core import mrr

    params, perm = permuted_params(
        sched, {"embed": sched.cfg.d_model, "mlp": sched.cfg.d_ff}, seed)
    lanes = {"mlp/wi": perm["embed"], "mlp/wo": perm["mlp"]}
    chip = {name: mrr.StaticVariation(v.dv[lanes[name]], v.ddt[lanes[name]],
                                      v.dlam[lanes[name]])
            for name, v in sched.engine.variation.items()}
    return params, chip


def serve_phase(report: dict) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.constants import ROSA_OPTIMAL
    from repro_torch.serve import (Scheduler, ServeConfig, poisson_requests,
                                   report_metrics)

    cfg = dataclasses.replace(get_config("qwen3-32b"), n_layers=4)
    scfg = ServeConfig(n_slots=4, max_len=56, prefill_chunk=8, rosa=True,
                       rosa_backend="fused", variation_seed=7)
    t0 = time.perf_counter()
    sched = Scheduler(cfg, scfg, init_seed=0, device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    plan = {k: v.name for k, v in sched.program.plan.mapping_plan().items()}
    print(f"  qwen3-32b full width, 4 of 64 layers, "
          f"{sched.bundle.n_params:,} params (f32), set-up {setup_s:.1f} s")
    print(f"  plan {plan}")
    if plan != {"mlp/wi": "IS", "mlp/wo": "IS"}:
        raise AssertionError(f"unexpected plan {plan}")
    reqs = poisson_requests(6, 1.0, vocab=cfg.vocab, prompt_len=(4, 8),
                            gen_len=(2, 40), seed=0)

    # ---- the main path: counts from 0, read right after ------------------
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    rep = sched.run(reqs)
    n = launch_counts()
    n_fused, n_osa = n["rosa_fused"], n["osa_matmul"]
    check_run(rep, reqs, cfg.vocab, "fused serve")
    routed = 2 * cfg.n_layers * (rep.decode_steps + rep.prefill_chunks)
    energy = sched.engine.ledger.per_token(ROSA_OPTIMAL, batch=scfg.n_slots)
    metrics = {m.name: m.value for m in report_metrics(rep)}
    print(f"  served {rep.total_tokens} tokens in {rep.wall_s:.2f} s: "
          f"{rep.tokens_per_s:.2f} tok/s, {rep.ticks} ticks, "
          f"{rep.decode_steps} decode steps, {rep.prefill_chunks} prefill "
          f"chunks, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    print(f"  energy_per_token {energy!r} J (ledger)")
    print(f"  rosa_fused launches {n_fused} (routed projections {routed}), "
          f"osa_matmul launches {n_osa}, mrr_transfer launches "
          f"{n['mrr_transfer']} (the fused kernel realizes inside)")
    if n_fused == 0 or n_fused != routed or n_osa != 0 or n["ssd_scan"] \
            or n["mrr_transfer"]:
        raise AssertionError("the served path did not run every routed "
                             "projection through rosa_fused")

    # ---- phase 4: the osa_matmul path -------------------------------------
    pallas = Scheduler(cfg, dataclasses.replace(scfg, rosa_backend="pallas"),
                       params=sched.params, device=DEVICE)
    reqs2 = poisson_requests(2, 1.0, vocab=cfg.vocab, prompt_len=(4, 8),
                             gen_len=(2, 40), seed=1)
    reset_launches()
    rep2 = pallas.run(reqs2)
    n = launch_counts()
    n_osa2, n_fused2 = n["osa_matmul"], n["rosa_fused"]
    check_run(rep2, reqs2, cfg.vocab, "pallas serve")
    routed2 = 2 * cfg.n_layers * (rep2.decode_steps + rep2.prefill_chunks)
    print(f"  pallas stream: {rep2.total_tokens} tokens, osa_matmul launches "
          f"{n_osa2} (routed {routed2}), rosa_fused launches {n_fused2}, "
          f"mrr_transfer launches {n['mrr_transfer']} (one per routed "
          "projection: the IS activation under chip 7)")
    if n_osa2 == 0 or n_osa2 != routed2 or n_fused2 != 0 \
            or n["mrr_transfer"] != routed2:
        raise AssertionError("the pallas path did not run osa_matmul and "
                             "mrr_transfer on every routed projection")

    # ---- phase 5: fused vs the plain composed pipeline, end to end --------
    # Bound.  Both backends realize and requantize the activations bit for
    # bit alike (phase 2 checks the 8-bit codes through an identity weight),
    # so they differ only in the summation order of their contractions.  A
    # different order moves a sum by ~1e-6, which flips a requantization
    # code wherever a value sits on a rounding boundary; a flipped code of
    # the heavy-tailed SwiGLU activation moves its row by one LSB of the
    # row's full scale, and the flips cascade through the layers.  How far
    # that moves this model's logits is measured, not assumed: the same
    # "ref" pipeline runs again with the model's hidden and MLP dimensions
    # permuted (a function-preserving reordering of every reduction, the
    # chip's per-lane variation permuted alike).  The fused kernel must
    # stay within 4x the largest such float-order deviation over two
    # permutations (plus 1e-5 of full scale).
    ref = Scheduler(cfg, dataclasses.replace(scfg, rosa_backend="ref"),
                    params=sched.params, device=DEVICE)
    prompt = reqs[0].prompt
    lf, lr = prefill_logits(sched, prompt), prefill_logits(ref, prompt)
    if not bool(torch.isfinite(lf).all()) or lf.shape != (cfg.vocab,):
        raise AssertionError("fused prefill logits not finite / bad shape")
    scale = float(lr.abs().max())
    rel = float((lf - lr).abs().max()) / scale
    floor = 0.0
    for seed in (1, 2):
        params_p, chip_p = permuted(ref, seed)
        ref_p = Scheduler(cfg, ref.scfg, params=params_p, chip=chip_p,
                          device=DEVICE)
        dev = float((prefill_logits(ref_p, prompt) - lr).abs().max()) / scale
        floor = max(floor, dev)
        print(f"  ref vs ref with permuted reductions (seed {seed}): "
              f"max rel dev {dev:.3e}")
        del params_p, chip_p, ref_p
        torch.cuda.empty_cache()
    bound = 4 * floor + 1e-5
    print(f"  fused vs ref prefill logits: max rel dev {rel:.3e} (bound "
          f"{bound:.3e}), argmax {int(lf.argmax())} vs {int(lr.argmax())}")
    if rel > bound:
        raise AssertionError("fused and ref logits disagree beyond the bound")

    report["serve"] = dict(metrics, energy_per_token_j=energy, plan=plan,
                           rosa_fused_launches=n_fused, routed=routed,
                           osa_matmul_launches=n_osa2, setup_s=setup_s,
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                           fused_vs_ref_logits_rel=rel,
                           ref_float_order_floor_rel=floor)
    return {"rosa_fused": n_fused, "osa_matmul": n_osa2}


# ---------------------------------------------------------------------------
# Phases 6-7: the SSD scan and mamba2-1.3b serving
# ---------------------------------------------------------------------------
def ssd_bound(bsz, l, h, p, g, s, q) -> tuple[float, str]:
    """Least time of one scan: the bytes of x, loga, b, c in and y, state
    out, against the float32 operations the chunked form needs on these
    inputs: per chunk of n valid steps, C B^T on the causal triangle once
    per group; per head the decay mask, att X on the triangle, C S_in (from
    the second chunk on: the first state is zero), the carry (B w)^T X and
    the state decay."""
    nbytes = 4 * (2 * bsz * l * h * p + bsz * l * h + 2 * bsz * l * g * s
                  + bsz * h * s * p)
    flops = 0
    for lo in range(0, l, q):
        n = min(q, l - lo)
        tri = n * (n + 1) // 2
        flops += bsz * g * 2 * tri * s
        per_head = (2 * tri + 2 * tri * p + 2 * n * s * p + n * s
                    + s * p + (2 * n * s * p + n * p if lo else 0))
        flops += bsz * h * per_head
    return bound_ms(nbytes, flops)


def ssd_inputs(bsz, l, h, p, g, s, gen):
    """Scan operands as the served model makes them: log a = -dt with dt
    a softplus (mean ~0.8, so l reaches about -100 within a 128-step chunk
    and exp(l) leaves float32's normal range)."""
    import torch
    x = torch.randn(bsz, l, h, p, device=DEVICE, generator=gen)
    loga = -torch.nn.functional.softplus(
        torch.randn(bsz, l, h, device=DEVICE, generator=gen))
    b = torch.randn(bsz, l, g, s, device=DEVICE, generator=gen)
    c = torch.randn(bsz, l, g, s, device=DEVICE, generator=gen)
    return x, loga, b, c


def ssd_phase(report: dict) -> dict:
    import torch
    from repro_torch.kernels.ssd_scan import ops

    if hasattr(ops, "plan"):         # the chunk-parallel launches' plan
        lib = ops._lib()
        smem = {n: lib.ssd_scan_smem_bytes(i)
                for i, n in enumerate(ops.LAUNCH_NAMES)}
        if smem != ops.SMEM:
            raise AssertionError(f"ssd_scan: the kernels' shared memory "
                                 f"{smem} disagrees with the plan's")
        report["ssd_scan_occupancy"] = ops.occupancy()
        print(f"  resident blocks per SM: {report['ssd_scan_occupancy']}")
    gen = torch.Generator(DEVICE).manual_seed(4)
    rows, served, err = [], None, 0.0
    for bsz, l, h, p, g, s, q in SSD_CASES:
        args = ssd_inputs(bsz, l, h, p, g, s, gen)
        y, st = ops.launch(*args, q)
        y_plain, st_plain = ops.plain(*args, q)
        y2, st2 = ops.launch(*args, q)
        torch.cuda.synchronize()
        what = f"ssd_scan B{bsz} L{l} H{h} P{p} G{g} S{s} Q{q}"
        rel = {}
        for name, a, r in (("y", y, y_plain), ("state", st, st_plain)):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{what}: non-finite {name}")
            rel[name] = float((a - r).abs().max() / r.abs().max())
            if rel[name] > 1e-4:
                raise AssertionError(f"{what}: {name} deviates by "
                                     f"{rel[name]:.3e} of its max > 1e-4")
        if not (torch.equal(y, y2) and torch.equal(st, st2)):
            raise AssertionError(f"{what}: two launches on the same inputs "
                                 "differ")
        e = max(float((y - y_plain).abs().max()),
                float((st - st_plain).abs().max()))
        err = max(err, e)
        row = {"case": what, "B": bsz, "L": l, "H": h, "P": p, "G": g,
               "S": s, "Q": q, "rel_err_y": rel["y"],
               "rel_err_state": rel["state"], "max_abs_err": e,
               "ms": median_ms(lambda: ops.launch(*args, q)),
               "kernel_ms": kernel_only_ms(lambda: ops.launch(*args, q)),
               "plain_ms": median_ms(lambda: ops.plain(*args, q), reps=5)}
        row["bound_ms"], row["bound_by"] = ssd_bound(bsz, l, h, p, g, s, q)
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        if hasattr(ops, "plan"):
            row["executed_flops"] = ops.plan(bsz, l, h, p, g, s, q)["flops"]
        rows.append(row)
        if (bsz, l, g) == (1, SSD_SERVED_L, 1):
            served = row
        print(f"  {what}: rel err y {rel['y']:.3e} state "
              f"{rel['state']:.3e}, two launches equal" + timing_text(row))
        del args, y, st, y_plain, st_plain, y2, st2
    report["ssd_scan_cases"] = rows
    return dict(served, max_abs_err=err)


def mamba_phase(report: dict) -> int:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import ssm as SSM
    from repro_torch.serve import (Scheduler, ServeConfig, poisson_requests,
                                   report_metrics, run_sequential)

    cfg = get_config("mamba2-1.3b")
    scfg = ServeConfig(n_slots=4, max_len=768, rosa=True,
                       rosa_backend="fused", variation_seed=7)
    t0 = time.perf_counter()
    sched = Scheduler(cfg, scfg, init_seed=0, device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sched.bundle.n_params
    print(f"  mamba2-1.3b full width and depth, {cfg.n_layers} layers, "
          f"{n_params:,} params (f32), set-up {setup_s:.1f} s; routed "
          f"projections {len(sched.program.trace)}")
    if n_params != MAMBA_PARAMS:
        raise AssertionError("not mamba2-1.3b at full width and depth")
    reqs = poisson_requests(8, 1.0, vocab=cfg.vocab, prompt_len=(200, 700),
                            gen_len=(8, 32), seed=0)

    # ---- the main path: counts from 0, read right after ------------------
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    rep = sched.run(reqs)
    n = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check_run(rep, reqs, cfg.vocab, "mamba2 serve")
    metrics = {m.name: m.value for m in report_metrics(rep)}
    want = cfg.n_layers * rep.prefill_chunks
    print(f"  served {rep.total_tokens} tokens in {rep.wall_s:.2f} s: "
          f"{rep.tokens_per_s:.2f} tok/s, {rep.ticks} ticks, "
          f"{rep.decode_steps} decode steps, {rep.prefill_chunks} whole "
          f"prefills (prompts {min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)} tokens), peak "
          f"{peak_gib:.1f} GiB")
    print(f"  ssd_scan launches {n['ssd_scan']} ({cfg.n_layers} x "
          f"{rep.prefill_chunks} "
          f"prefills = {want}), rosa_fused {n['rosa_fused']}, osa_matmul "
          f"{n['osa_matmul']}")
    if rep.prefill_chunks != len(reqs) or n["ssd_scan"] != want \
            or n["rosa_fused"] or n["osa_matmul"] or n["mrr_transfer"]:
        raise AssertionError("the mamba2 prefills did not each run the "
                             "ssd_scan kernel once per layer")

    # ---- continuous batching against the per-request oracle ---------------
    seq = run_sequential(cfg, scfg, sched.params, reqs, device=DEVICE)
    same = sum(rep.completions[r].tokens == v["tokens"]
               for r, v in seq.items())
    print(f"  continuous vs sequential oracle: {same} of {len(reqs)} "
          "requests give identical tokens")
    if same != len(reqs):
        raise AssertionError("continuous tokens differ from the sequential "
                             "oracle's")

    # ---- the kernel against the plain scan, end to end --------------------
    # Bound: the same prefill with the model's hidden, head and state
    # dimensions permuted (a function-preserving reordering of every
    # reduction, the scan's included) through the plain scan measures the
    # float-order floor; the kernel path must stay within 4x its largest
    # deviation over two permutations (plus 1e-5 of full scale).
    prompt = reqs[0].prompt
    lk = prefill_logits(sched, prompt)
    if not bool(torch.isfinite(lk).all()) or lk.shape != (cfg.vocab,):
        raise AssertionError("mamba2 prefill logits not finite / bad shape")
    SSM.ssd_scan = ssd_ops.plain       # the plain scan, on the card
    try:
        lp = prefill_logits(sched, prompt)
        scale = float(lp.abs().max())
        floor = 0.0
        for seed in (1, 2):
            params_p, _ = permuted_params(
                sched, {"embed": cfg.d_model, "heads": cfg.ssm.n_heads,
                        "state": cfg.ssm.d_state}, seed)
            perm = Scheduler(cfg, scfg, params=params_p, device=DEVICE)
            dev = float((prefill_logits(perm, prompt) - lp).abs().max())
            floor = max(floor, dev / scale)
            print(f"  plain vs plain with permuted reductions (seed {seed}):"
                  f" max rel dev {dev / scale:.3e}")
            del params_p, perm
            torch.cuda.empty_cache()
    finally:
        SSM.ssd_scan = ssd_ops.ssd_scan
    rel = float((lk - lp).abs().max()) / scale
    bound = 4 * floor + 1e-5
    print(f"  ssd_scan kernel vs plain scan, prefill of {len(prompt)} "
          f"tokens: logits max rel dev {rel:.3e} (bound {bound:.3e}), "
          f"argmax {int(lk.argmax())} vs {int(lp.argmax())}")
    if rel > bound or int(lk.argmax()) != int(lp.argmax()):
        raise AssertionError("kernel and plain-scan logits disagree")

    report["mamba2_serve"] = dict(
        metrics, n_params=n_params, setup_s=setup_s,
        prompt_lens=[len(r.prompt) for r in reqs],
        ssd_scan_launches=n["ssd_scan"], peak_gib=peak_gib,
        kernel_vs_plain_logits_rel=rel, plain_float_order_floor_rel=floor)
    return n["ssd_scan"]


# ---------------------------------------------------------------------------
# Phase 8: mrr_transfer
# ---------------------------------------------------------------------------
# (what, shape, per-shot noise, the axis a chip's per-lane fields run
# along: 0 per row, as against a (K, N) weight; 1 per column, as against
# (M, K) activations; None without a chip)
MRR_CASES = [("mobilenet_v3 mb6_dw weight", (60, 25), True, 0),
             ("conv_stem IS sheet, batch 512", (524288, 27), True, None),
             ("conv_stem IS sheet, chip per column", (524288, 27), True, 1),
             ("qwen3-32b mlp/wi", (5120, 51200), True, None),
             ("qwen3-32b mlp/wi, chip only", (5120, 51200), False, 0),
             ("ragged 1-D", (1_000_003,), True, None)]
MRR_SERVED = "mobilenet_v3 mb6_dw weight"     # the main path's largest
# float operations per element of the chain (a division or square root
# counted as one): 38, plus 4 for the draws and 3 for a chip's fields
MRR_OPS = (38, 4, 3)


def mrr_bound(n: int, noisy: bool, lanes: int) -> tuple[float, str]:
    """Least time of one realization: w in and the result out (and the two
    draws in when noisy), the chip's three per-lane fields once, against
    the chain's float operations."""
    nbytes = 4 * n * (4 if noisy else 2) + (12 * lanes)
    ops = n * (MRR_OPS[0] + MRR_OPS[1] * noisy + MRR_OPS[2] * bool(lanes))
    return bound_ms(nbytes, ops)


SASS_INSTR = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_fast_path(sass: str, func: str) -> tuple[int, int]:
    """(instructions, elements stored) of one pass of the innermost loop
    that stores, in `cuobjdump -sass` output, along the fast path: each
    in-loop branch is taken when the code it skips calls a slow-path
    subroutine (IEEE division and square root) or, in a kernel with
    16-byte accesses, holds the ragged edge's scalar loads and stores."""
    start = sass.index(func)
    end = sass.find("Function :", start + len(func))
    ins = [(int(a, 16), p.strip(), op, x) for a, p, op, x in
           SASS_INSTR.findall(sass[start:end if end > 0 else None])]
    at = {a: i for i, (a, *_) in enumerate(ins)}

    def target(x):
        return int(re.findall(r"0x[0-9a-f]+", x)[-1], 16)

    def scalar_mem(op):
        return op.split(".")[0] in ("LDG", "STG") and ".128" not in op

    wide = any(".128" in op for _, _, op, _ in ins)
    loops = [(at[target(x)], i) for i, (a, _, op, x) in enumerate(ins)
             if op == "BRA" and target(x) < a
             and any(o.startswith("STG") for _, _, o, _ in
                     ins[at[target(x)]:i])]
    head, back = min(loops, key=lambda hb: hb[1] - hb[0])
    i, count, stored = head, 0, 0
    while True:
        a, p, op, x = ins[i]
        count += 1
        if op.startswith("STG"):
            stored += 4 if op.endswith(".128") else 1
        if i == back:
            return count, stored
        j = at.get(target(x), -1) if op == "BRA" else -1
        if op == "BRA" and not p and "P" not in x:
            i = j
        elif head < j <= back and j > i:
            seg = ins[i + 1:j]
            slow = any(o.startswith("CALL") for _, _, o, _ in seg)
            ragged = wide and any(scalar_mem(o) for _, _, o, _ in seg)
            i = j if slow or ragged else i + 1
        else:
            i += 1


# the kernels of the wide sheets: noise without a chip (one stream), a
# chip (per row) without noise (tiles), both with 16-byte accesses
# (mangled template arguments: NOISE, [VAR,] BWD, V)
MRR_SASS = {
    "qwen3-32b mlp/wi": "transfer_kernel_flatILb1ELb0ELi4E",
    "qwen3-32b mlp/wi, chip only": "transfer_kernel_tilesILb0ELi1ELb0ELi4E"}


def mrr_instruction_floor(rows: list, kernels_by_case: dict = MRR_SASS,
                          label: str = "mrr_transfer") -> None:
    """The chain's instruction floor on the wide sheets: SASS instructions
    a thread issues per element on the fast path (`sass_fast_path` over
    the built library), times n, over 132 SMs x 128 lanes x the SM's
    maximum clock (4 warp schedulers issue one warp instruction a cycle
    each).  `kernels_by_case` names each wide case's kernel."""
    import os
    from repro_torch import kernels
    lib = kernels.build_all(["mrr_transfer"])["mrr_transfer"]
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    import torch
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for row in rows:
        func = kernels_by_case.get(row["case"])
        if func is None or func not in sass:    # not a wide sheet's kernel
            continue
        count, stored = sass_fast_path(sass, func)
        n = math.prod(row["shape"])
        row["instr_per_element"] = count / stored
        row["instr_floor_ms"] = n * count / stored / (
            n_sm * 128 * mhz * 1e6) * 1e3
        print(f"  {label} {row['case']}: {count} SASS instructions per "
              f"{stored} elements on the fast path, floor "
              f"{row['instr_floor_ms']:.4f} ms at {mhz:.0f} MHz x {n_sm} "
              f"SMs (kernel only {row['kernel_ms']:.4f} ms)")


def mrr_phase(report: dict) -> dict:
    import torch
    from repro_torch.core import mrr
    from repro_torch.kernels.mrr_transfer import ops

    g = torch.Generator(DEVICE).manual_seed(5)
    rows, served = [], None
    for what, shape, noisy, axis in MRR_CASES:
        w = 2 * torch.rand(shape, device=DEVICE, generator=g) - 1
        var, lanes = None, 0
        if axis is not None:
            lanes = shape[axis]
            var = mrr.StaticVariation(
                *(s * torch.randn(lanes, device=DEVICE, generator=g)
                  for s in (0.01, 0.04, 0.01)))
            if axis == 0:
                var = mrr.expand_lanes(var, w)
        sig = (mrr.PAPER_NOISE.sigma_dac, mrr.PAPER_NOISE.sigma_th) \
            if noisy else (0.0, 0.0)
        eps = mrr.draw_eps(torch.Generator(DEVICE).manual_seed(6), shape,
                           DEVICE) if noisy else (None, None)
        y = ops.launch(w, *eps, *sig, var=var)
        y_plain = ops.plain(w, *eps, *sig, var=var)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"mrr_transfer {what}: non-finite output")
        e = float((y - y_plain).abs().max())
        if not torch.equal(y, y_plain):
            raise AssertionError(f"mrr_transfer {what}: kernel differs from "
                                 f"the plain version by {e:.3e}")
        row = {"case": what, "shape": list(shape), "noise": noisy,
               "chip_axis": axis, "max_abs_err": e,
               "ms": median_ms(lambda: ops.launch(w, *eps, *sig, var=var)),
               "kernel_ms": kernel_only_ms(
                   lambda: ops.launch(w, *eps, *sig, var=var)),
               "plain_ms": median_ms(
                   lambda: ops.plain(w, *eps, *sig, var=var))}
        row["bound_ms"], row["bound_by"] = mrr_bound(w.numel(), noisy, lanes)
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        rows.append(row)
        if what == MRR_SERVED:
            served = row
        print(f"  mrr_transfer {what:36s} {tuple(shape)}: bitwise equal"
              + timing_text(row), flush=True)
        del w, var, eps, y, y_plain
        torch.cuda.empty_cache()
    mrr_instruction_floor(rows)
    report["mrr_transfer_cases"] = rows
    return dict(served, max_abs_err=max(r["max_abs_err"] for r in rows))


# ---------------------------------------------------------------------------
# Phases 9-10: the Table 4 pipeline over the four paper CNNs, and the
# mobilenet_v3 golden file
# ---------------------------------------------------------------------------
CNNS = ("alexnet", "vgg16", "resnet18", "mobilenet_v3")
CNN = "mobilenet_v3"                   # the golden file's network
TABLE4 = dict(steps=400, n_mc=3)       # QAT at batch 64 on 4096 images
# EDP [J*s] of WS and of DEAP-CNNs on each network's full-size rows at
# batch 128: the reference's floats (core.mapping.plan_edp and
# core.energy.network_energy of src/repro), which
# tests/test_torch_table4.py holds equal to the reference's
TABLE4_EDP = {"alexnet": (0.09528840575672215, 38968.06817541521),
              "vgg16": (0.04198542905483209, 119085.41858453903),
              "resnet18": (0.06639472322351758, 435459.5256307617),
              "mobilenet_v3": (1.794560881706427e-05, 52.23022904750444)}
GOLDEN = ROOT / "tests" / "data" / "torch_cnn_mobilenet_v3.npz"
TRAINED: dict = {}                     # phase 9's parameters, by model


def noisy_launches(specs, noisy: set[str], evals: int) -> dict:
    """Launches of `evals` evaluations with the layers `noisy` noisy on the
    card: one rosa_fused per noisy conv/fc matmul, one mrr_transfer per
    noisy depthwise weight (its conditioning ignores the mapping)."""
    dw = sum(1 for s in specs if s.name in noisy and s.kind == "dwconv")
    routed = sum(1 for s in specs if s.name in noisy and s.kind != "dwconv")
    return {"rosa_fused": evals * routed, "mrr_transfer": evals * dw}


def table4_launches(specs, plan: dict, n_mc: int) -> dict:
    """What the pipeline must launch: the profile makes each layer alone
    noisy under IS and under WS (n_mc evaluations each); WS, IS, the
    hybrid plan and ANALOG make every layer noisy (n_mc each); training
    and the clean evaluations take the ideal fake-quant path."""
    total = {"rosa_fused": 0, "mrr_transfer": 0}

    def add(c):
        for k in total:
            total[k] += c[k]

    for s in specs:
        add(noisy_launches(specs, {s.name}, 2 * n_mc))
    every = {s.name for s in specs}
    for _ in ("ws", "is", "analog"):
        add(noisy_launches(specs, every, n_mc))
    add(noisy_launches(specs, set(plan), n_mc))       # hybrid
    return total


def table4_phase(report: dict) -> dict:
    """`launch.table4.run` over the four CNNs, one model per main-path run
    (counts from 0 before each, read right after); returns the launches
    summed over the four runs."""
    import torch
    from repro_torch.launch import table4
    from repro_torch.models.cnn import LITE_MODELS

    results, total = {}, {"rosa_fused": 0, "mrr_transfer": 0}
    print(f"  {TABLE4['steps']} QAT steps at batch 64, n_mc "
          f"{TABLE4['n_mc']}, eval batch 512")
    for model in CNNS:
        specs = LITE_MODELS[model]
        # ---- the main path: counts from 0, read right after --------------
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = table4.run([model], TABLE4["steps"], TABLE4["n_mc"],
                         device=DEVICE, verbose=False,
                         keep_params=True)[model]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        TRAINED[model] = res.pop("params")       # for phase 12
        want = table4_launches(specs, res["plan"], TABLE4["n_mc"])
        accs, edp = res["accs"], res["edp"]
        print(f"  {model}: {len(specs)} layers; plan "
              f"{res['plan_is_layers']}/{len(res['plan'])} layers IS "
              f"{sorted(k for k, v in res['plan'].items() if v == 'input_stationary')}")
        print("    acc[%]: " + "  ".join(f"{k}={v:.2f}"
                                         for k, v in accs.items())
              + f"  hybrid - WS {accs['hybrid'] - accs['ws']:+.2f} pp")
        print(f"    EDP[J*s]: WS={edp['ws']!r} hybrid={edp['hybrid']!r} "
              f"DEAP={edp['deap']!r}; hybrid below WS by "
              f"{(1 - edp['hybrid'] / edp['ws']) * 100:.1f}%, below DEAP by "
              f"{(1 - edp['hybrid'] / edp['deap']) * 100:.4f}%")
        print("    wall s: " + "  ".join(f"{k}={v:.2f}"
                                         for k, v in res["wall_s"].items())
              + f"  (total {wall:.2f}, peak {peak:.2f} GiB)")
        print(f"    launches {n} (want rosa_fused {want['rosa_fused']}, "
              f"mrr_transfer {want['mrr_transfer']})", flush=True)
        if n["rosa_fused"] != want["rosa_fused"] or n["mrr_transfer"] \
                != want["mrr_transfer"] or n["osa_matmul"] or n["ssd_scan"] \
                or n["mrr_transfer_bwd"]:
            # every noisy evaluation must launch these kernels, so equal
            # counts also show that the QAT training launched neither
            raise AssertionError(f"{model}: the Table 4 pipeline did not run "
                                 "its noisy evaluations through "
                                 "rosa_fused/mrr_transfer")
        if not all(math.isfinite(a) and 0.0 <= a <= 100.0
                   for a in accs.values()):
            raise AssertionError(f"{model}: accuracies out of range: {accs}")
        if (edp["ws"], edp["deap"]) != TABLE4_EDP[model]:
            raise AssertionError(f"{model}: EDP differs from the reference's:"
                                 f" WS, DEAP {edp['ws']!r}, {edp['deap']!r} "
                                 f"vs {TABLE4_EDP[model]!r}")
        results[model] = res
        report.setdefault("table4", {})[model] = dict(
            res, launches=n, want_launches=want, total_wall_s=wall,
            peak_gib=peak)
        for k in total:
            total[k] += n[k]
    avg = table4.averages(results)
    table4.print_averages(avg)
    report["table4_averages"] = avg
    return total


def load_golden(device):
    """(params, chip, labels, {name: logits}) of the golden file."""
    import numpy as np
    import torch
    from repro_torch.core import mrr

    params: dict = {}
    fields: dict = {}
    logits: dict = {}
    with np.load(GOLDEN) as z:
        labels = torch.from_numpy(z["labels"]).to(device)
        for k in z.files:
            kind, *rest = k.split(".")
            t = torch.from_numpy(z[k]).to(device)
            if kind == "params":
                params.setdefault(rest[0], {})[rest[1]] = t
            elif kind == "chip":
                fields.setdefault(rest[0], {})[rest[1]] = t
            elif kind == "logits":
                logits[rest[0]] = t
    chip = {k: mrr.StaticVariation(v["dv"], v["ddt"], v["dlam"])
            for k, v in fields.items()}
    return params, chip, labels, logits


def permuted_cnn(params, chip, specs, seed: int):
    """The CNN's parameters and chip with every channel axis permuted (one
    random permutation per layer output, the input's RGB included): the
    same function, every reduction summed in another order.  Returns
    (params, chip, input channel permutation)."""
    import torch
    from repro_torch.core import mrr

    g = torch.Generator().manual_seed(seed)
    perm = lambda n: torch.randperm(n, generator=g).to(DEVICE)
    p_in = p0 = perm(3)
    out_p, out_c = {}, {}
    for i, s in enumerate(specs):
        w, b = params[s.name]["w"], params[s.name]["b"]
        if s.kind == "dwconv":
            p_out = lanes = p_in
            w2 = w[p_in]
        else:
            p_out = (torch.arange(s.c_out, device=DEVICE)
                     if i == len(specs) - 1 else perm(s.c_out))
            kk = s.k * s.k if s.kind == "conv" else 1
            lanes = (p_in[:, None] * kk
                     + torch.arange(kk, device=DEVICE)).reshape(-1)
            w2 = w[lanes][:, p_out]
        out_p[s.name] = {"w": w2, "b": b[p_out]}
        v = chip[s.name]
        out_c[s.name] = mrr.StaticVariation(v.dv[lanes], v.ddt[lanes],
                                            v.dlam[lanes])
        p_in = p_out
    return out_p, out_c, p0


def plain_kernels():
    """Context: route the rosa_fused and mrr_transfer wrappers to their
    plain versions on the card (the plain path)."""
    import contextlib

    from repro_torch.kernels.mrr_transfer import ops as mrr_ops
    from repro_torch.kernels.rosa_fused import ops as fused_ops

    @contextlib.contextmanager
    def ctx():
        saved = fused_ops.launch, mrr_ops.launch
        fused_ops.launch, mrr_ops.launch = fused_ops.plain, mrr_ops.plain
        try:
            yield
        finally:
            fused_ops.launch, mrr_ops.launch = saved

    return ctx()


def golden_phase(report: dict) -> dict:
    import dataclasses as dc

    import torch
    from repro_torch import rosa
    from repro_torch.core.constants import Mapping
    from repro_torch.data.synth_cifar import synth_cifar
    from repro_torch.models.cnn import LITE_MODELS
    from repro_torch.training.cnn_train import QAT_CFG, cnn_program

    specs = LITE_MODELS[CNN]
    names = [s.name for s in specs]
    params, chip, labels, gold = load_golden(DEVICE)
    xte, yte = synth_cifar(512, seed=1, noise=0.35)    # the test split
    x = torch.from_numpy(xte).to(DEVICE)
    if not torch.equal(torch.from_numpy(yte).to(DEVICE), labels):
        raise AssertionError("the golden labels are not the test split's")
    progs = {"clean": cnn_program(CNN, rosa.Engine.from_config(
                 QAT_CFG, layers=names)),
             "ws": cnn_program(CNN, rosa.Engine.from_config(
                 dc.replace(QAT_CFG, mapping=Mapping.WS), layers=names)),
             "is": cnn_program(CNN, rosa.Engine.from_config(
                 dc.replace(QAT_CFG, mapping=Mapping.IS), layers=names))}
    out: dict = {}
    for name, prog in progs.items():
        var = None if name == "clean" else chip
        reset_launches()
        with torch.no_grad():
            lk = prog(params, x, variation=var)
        torch.cuda.synchronize()
        n = launch_counts()
        want = noisy_launches(specs, set() if var is None else set(names), 1)
        if not bool(torch.isfinite(lk).all()) or lk.shape != (512, 10):
            raise AssertionError(f"{name}: logits not finite / bad shape")
        if n["rosa_fused"] != want["rosa_fused"] \
                or n["mrr_transfer"] != want["mrr_transfer"]:
            raise AssertionError(f"{name}: launches {n}, want {want}")
        right = int((lk.argmax(-1) == labels).sum())
        right_ref = int((gold[name].argmax(-1) == labels).sum())
        scale = float(gold[name].abs().max())
        vs_ref = float((lk - gold[name]).abs().max()) / scale
        row = {"correct": right, "correct_reference": right_ref,
               "acc": 100.0 * right / 512, "launches": n,
               "logits_vs_reference_rel": vs_ref}
        tol = 2 if name == "clean" else 5
        print(f"  {name:5s}: {right}/512 right (reference {right_ref}), "
              f"logits vs reference max rel dev {vs_ref:.3e}, launches "
              f"rosa_fused {n['rosa_fused']} mrr_transfer "
              f"{n['mrr_transfer']}")
        if abs(right - right_ref) > tol:
            raise AssertionError(f"{name}: {right} right vs the reference's "
                                 f"{right_ref} (more than {tol} apart)")
        if var is not None:
            # kernel path vs the plain path on the card, within 4x the
            # float-order floor of the plain path under permuted channels
            with plain_kernels(), torch.no_grad():
                lp = prog(params, x, variation=var)
                sc = float(lp.abs().max())
                floor = 0.0
                for seed in (1, 2):
                    pp, cp, p0 = permuted_cnn(params, chip, specs, seed)
                    dev = float((prog(pp, x[..., p0], variation=cp)
                                 - lp).abs().max()) / sc
                    floor = max(floor, dev)
            rel = float((lk - lp).abs().max()) / sc
            bound = 4 * floor + 1e-5
            row.update(kernel_vs_plain_rel=rel, plain_floor_rel=floor)
            print(f"         kernel vs plain path logits max rel dev "
                  f"{rel:.3e} (bound {bound:.3e}, float-order floor "
                  f"{floor:.3e})")
            if rel > bound:
                raise AssertionError(f"{name}: kernel and plain logits "
                                     "disagree beyond the bound")
        out[name] = row
    report["golden"] = out
    return out


# ---------------------------------------------------------------------------
# Phase 11: the paper's energy model on the card, in float64
# ---------------------------------------------------------------------------
# The reference's values: benchmarks/fig7_array_dse, fig8_osa,
# fig9_power_breakdown, table1_modes, the dse_zoo and hybrid_zoo benches of
# benchmarks/run.py and tests/test_paper_golden.py::_table4_edp_reductions,
# run on src/repro in float64; tests/test_torch_dse.py holds every entry
# equal to the reference's.
ENERGY_REF = {
    "fig7_best_label": "R=8,C=8,T=16",
    "fig7_reduction_vs_deap": 0.33517400209471915,
    "fig7_reduction_vs_compact": 0.22607095668842447,
    "fig8_geomean_reduction_osa": 0.28580986529830166,
    "fig8_geomean_reduction_osa_ode": 0.33332575119641483,
    "fig9_n_workloads": 4,
    "fig9_alexnet_adc_power_reduction": 0.8571428571428571,
    "table1_ops_mixed_vs_analog": 31250.000000000004,
    "table1_mixed_edp": 2.180631443342872e-05,
    "table1_mixed_oadc_energy": 1.5925248e-05,
    "zoo_n_workloads": 16,
    "zoo_n_layer_rows": 5176,
    "zoo_n_candidates": 33,
    "zoo_best_label": "R=16,C=8,T=8",
    "zoo_best_metric": 0.7640359493852568,
    "hybrid_zoo_qwen3-32b": 0.5225714748299136,
    "hybrid_zoo_mamba2-1.3b": 0.9408820185426022,
    "hybrid_zoo_gemma3-12b": 0.5698857465373174,
    "hybrid_zoo_zamba2-1.2b": 0.8661936049304755,
    "hybrid_zoo_seamless-m4t-medium": 0.4955234548765315,
    "table4_avg_hybrid_vs_ws_edp_red": 0.2850777915075481,
    "table4_avg_hybrid_vs_deap_edp_red": 0.9999997594171288,
}
ENERGY_REL = 1e-9     # only the order of the per-workload sums may differ
HYBRID_ZOO = ("qwen3-32b", "mamba2-1.3b", "gemma3-12b", "zamba2-1.2b",
              "seamless-m4t-medium")
ZOO_BATCH = 8


def hybrid_zoo(device) -> dict:
    """EDP of the per-layer hybrid plan over all-WS on zoo architectures
    (accuracy term muted: no behavioural twin for the LLM stacks)."""
    from repro_torch.configs import get_workload_zoo
    from repro_torch.core import mapping as M
    from repro_torch.core.constants import ROSA_OPTIMAL, Mapping

    out = {}
    for wl in get_workload_zoo(include_paper=False, archs=list(HYBRID_ZOO)):
        profs = M.profile_layers_fast(wl.layers, ROSA_OPTIMAL,
                                      batch=ZOO_BATCH, device=device)
        plan = M.hybrid_plan(profs)
        e_h = M.plan_edp(wl.layers, plan, ROSA_OPTIMAL, batch=ZOO_BATCH)
        e_ws = M.plan_edp(wl.layers, {p.name: Mapping.WS for p in profs},
                          ROSA_OPTIMAL, batch=ZOO_BATCH)
        out[f"hybrid_zoo_{wl.name}"] = e_h / e_ws
    return out


def table4_edp_only(device) -> dict:
    """Table 4's EDP side without the behavioural profile: the per-layer
    EDP argmin on each CNN's lite layers (vectorized profile), priced by
    the scalar model; averages over the four CNNs."""
    from repro_torch.core import energy as E
    from repro_torch.core import mapping as M
    from repro_torch.core.constants import (DEAP_HIGH_CHANNEL, ROSA_OPTIMAL,
                                            ComputeMode, Mapping)
    from repro_torch.launch.table4 import mapped_layers

    ws_red, deap_red = [], []
    for model in CNNS:
        mapped = mapped_layers(model)
        plan = M.hybrid_plan(M.profile_layers_fast(
            mapped, ROSA_OPTIMAL, batch=128, device=device))
        e_h = M.plan_edp(mapped, plan, ROSA_OPTIMAL, batch=128)
        e_ws = M.plan_edp(mapped, {}, ROSA_OPTIMAL, batch=128)
        e_deap = E.network_energy(mapped, DEAP_HIGH_CHANNEL, Mapping.WS,
                                  ComputeMode.ANALOG, E.NO_OSA,
                                  batch=128).edp
        ws_red.append(1 - e_h / e_ws)
        deap_red.append(1 - e_h / e_deap)
    return {"table4_avg_hybrid_vs_ws_edp_red": sum(ws_red) / len(ws_red),
            "table4_avg_hybrid_vs_deap_edp_red":
                sum(deap_red) / len(deap_red)}


def energy_values(device) -> dict:
    """Every value of ENERGY_REF, computed by the port on `device`."""
    from repro_torch.configs import get_workload_zoo
    from repro_torch.core import dse
    from repro_torch.launch import (fig7_array_dse, fig8_osa,
                                    fig9_power_breakdown, table1_modes)

    f7 = fig7_array_dse.run(verbose=False, device=device)
    f8 = fig8_osa.run(verbose=False, device=device)
    f9 = fig9_power_breakdown.run(verbose=False, device=device)
    t1 = table1_modes.run(verbose=False, device=device)
    alex = f9["alexnet"]
    wls = get_workload_zoo()
    pts = dse.sweep(wls, batch=ZOO_BATCH, device=device)
    return {
        "fig7_best_label": f7["best"].label,
        "fig7_reduction_vs_deap": f7["reduction_vs_deap"],
        "fig7_reduction_vs_compact": f7["reduction_vs_compact"],
        "fig8_geomean_reduction_osa": f8["geomean_reduction_osa"],
        "fig8_geomean_reduction_osa_ode": f8["geomean_reduction_osa_ode"],
        "fig9_n_workloads": len(f9),
        "fig9_alexnet_adc_power_reduction":
            1 - alex["osa"]["adc"] / alex["no_osa"]["adc"],
        "table1_ops_mixed_vs_analog":
            t1["mixed"]["ops"] / t1["analog"]["ops"],
        "table1_mixed_edp": t1["mixed"]["edp"],
        "table1_mixed_oadc_energy": t1["mixed"]["oadc_energy"],
        "zoo_n_workloads": len(wls),
        "zoo_n_layer_rows": sum(len(w.layers) for w in wls),
        "zoo_n_candidates": len(pts),
        "zoo_best_label": pts[0].label,
        "zoo_best_metric": pts[0].metric,
        **hybrid_zoo(device),
        **table4_edp_only(device),
    }


def energy_mismatches(got: dict, want: dict) -> tuple[list, float]:
    """([keys that differ], largest relative difference of the floats):
    labels and counts must be equal, floats within ENERGY_REL."""
    bad, worst = [], 0.0
    for k, v in want.items():
        g = got.get(k)
        if isinstance(v, float) and isinstance(g, float):
            rel = abs(g - v) / abs(v)
            worst = max(worst, rel)
            if not rel <= ENERGY_REL:
                bad.append(k)
        elif g != v:
            bad.append(k)
    return bad + sorted(set(got) - set(want)), worst


def energy_phase(report: dict) -> dict:
    import torch

    got = energy_values(DEVICE)
    bad, worst = energy_mismatches(got, ENERGY_REF)
    for k, v in got.items():
        print(f"  {k:36s} {v!r}" + ("" if k not in bad else
                                    f"   REFERENCE {ENERGY_REF.get(k)!r}"))
    print(f"  largest relative difference from the reference: {worst:.3e} "
          f"(bound {ENERGY_REL:g})")
    if bad:
        raise AssertionError(f"energy model differs from the reference: "
                             f"{bad}")
    # the zoo sweep's wall on the card (the workloads built once, as the
    # reference's dse_zoo bench times it): median of 10 after 2 warm-ups
    from repro_torch.configs import get_workload_zoo
    from repro_torch.core import dse

    wls, times = get_workload_zoo(), []
    for i in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dse.sweep(wls, batch=ZOO_BATCH, device=DEVICE)
        torch.cuda.synchronize()
        if i >= 2:
            times.append(time.perf_counter() - t0)
    wall = statistics.median(times)
    print(f"  zoo sweep (16 workloads x 5176 rows x 33 candidates, float64):"
          f" median {wall:.4f} s of 10 on {report['card']}")
    report["energy"] = dict(values=got, max_rel_diff=worst,
                            zoo_sweep_s=wall, zoo_sweep_runs_s=times)
    return got


# ---------------------------------------------------------------------------
# Phase 12: robust — the mrr_transfer backward kernel, variation-aware QAT,
# chip ensembles and the robust CLI runners
# ---------------------------------------------------------------------------
MOBILENET_DW = ((16, 9), (36, 9), (48, 25), (60, 25))   # mb1/2/4/6_dw
# (what, shape, draws, the chip's layout as in MRR_CASES, or "any" for a
# full-shape field)
MRR_BWD_CASES = [
    *(((f"mobilenet_v3 dw {r}x{c}, chip" + (", draws" if noisy else "")),
       (r, c), noisy, 0) for r, c in MOBILENET_DW for noisy in (False, True)),
    ("conv_stem IS sheet, chip per column, draws", (524288, 27), True, 1),
    ("full-shape chip field", (4096, 100), False, "any"),
    ("ragged 1-D, draws, no chip", (1_000_003,), True, None),
    ("(5120, 51200), chip", (5120, 51200), False, 0),
    ("(5120, 51200), chip, draws", (5120, 51200), True, 0)]
MRR_BWD_SERVED = "mobilenet_v3 dw 60x25, chip"   # QAT's largest dw weight
MRR_BWD_SASS = {                         # the wide sheets' kernels
    "(5120, 51200), chip": "transfer_kernel_tilesILb0ELi1ELb1ELi4E",
    "(5120, 51200), chip, draws": "transfer_kernel_tilesILb1ELi1ELb1ELi4E"}
# float operations per element: the recomputed chain and its derivative
# (a division or square root counted as one), plus 4 for the draws and 3
# for a chip's fields
MRR_BWD_OPS = (73, 4, 3)
ROBUST_QAT = dict(steps=400, batch=64, n_chips=8)
ROBUST_EVAL_CHIPS = 16
ROBUST_MODEL = "alexnet"
ROBUST_RUNS = {"ensemble": dict(n_chips=64, n_probe=4, n_eval=512),
               "sensitivity": dict(n_chips=16, n_eval=256),
               "drift": dict(n_chips=16, n_eval=256, kind="sine",
                             retrim_every=900.0),
               "sweep": dict(n_chips=32, n_eval=256,
                             scales=(0.0, 0.5, 1.0, 1.5, 2.0))}


def mrr_bwd_bound(n: int, noisy: bool, lanes: int) -> tuple[float, str]:
    """Least time of one backward: w and g in, dq out (and the two draws
    in when noisy), the chip's three fields once, against the float
    operations of the recomputed chain and its derivative."""
    nbytes = 4 * n * (5 if noisy else 3) + 12 * lanes
    ops = n * (MRR_BWD_OPS[0] + MRR_BWD_OPS[1] * noisy
               + MRR_BWD_OPS[2] * bool(lanes))
    return bound_ms(nbytes, ops)


def mrr_bwd_phase(report: dict) -> dict:
    """12(a): the backward kernel against its plain derivative, bit for
    bit, with per-call and kernel-only times, the bound and its share."""
    import torch
    from repro_torch.core import mrr
    from repro_torch.kernels.mrr_transfer import ops

    g = torch.Generator(DEVICE).manual_seed(12)
    rows, served = [], None
    for what, shape, noisy, axis in MRR_BWD_CASES:
        w = 2.2 * torch.rand(shape, device=DEVICE, generator=g) - 1.1
        gr = torch.randn(shape, device=DEVICE, generator=g)
        var, lanes = None, 0
        if axis == "any":
            var = mrr.StaticVariation(
                *(s * torch.randn(shape, device=DEVICE, generator=g)
                  for s in (0.01, 0.04, 0.01)))
            lanes = math.prod(shape)
        elif axis is not None:
            lanes = shape[axis]
            var = mrr.StaticVariation(
                *(s * torch.randn(lanes, device=DEVICE, generator=g)
                  for s in (0.01, 0.04, 0.01)))
            if axis == 0:
                var = mrr.expand_lanes(var, w)
        sig = (mrr.PAPER_NOISE.sigma_dac, mrr.PAPER_NOISE.sigma_th) \
            if noisy else (0.0, 0.0)
        eps = mrr.draw_eps(torch.Generator(DEVICE).manual_seed(13), shape,
                           DEVICE) if noisy else (None, None)

        def kernel():
            return ops.launch_backward(gr, w, *eps, *sig, var=var)

        def plain():
            return ops.plain_grad(gr, w, *eps, *sig, var=var)

        y, y_plain = kernel(), plain()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"mrr_transfer_bwd {what}: non-finite")
        e = float((y - y_plain).abs().max())
        if not torch.equal(y, y_plain):
            raise AssertionError(f"mrr_transfer_bwd {what}: kernel differs "
                                 f"from the plain derivative by {e:.3e}")
        del y, y_plain
        row = {"case": what, "shape": list(shape), "noise": noisy,
               "chip_axis": axis, "max_abs_err": e, "ms": median_ms(kernel),
               "kernel_ms": kernel_only_ms(kernel),
               "plain_ms": median_ms(plain, reps=5)}
        row["bound_ms"], row["bound_by"] = mrr_bwd_bound(w.numel(), noisy,
                                                         lanes)
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        rows.append(row)
        if what == MRR_BWD_SERVED:
            served = row
        print(f"  mrr_transfer_bwd {what:44s}: bitwise equal"
              + timing_text(row), flush=True)
        del w, gr, var, eps
        torch.cuda.empty_cache()
    mrr_instruction_floor(rows, MRR_BWD_SASS, "mrr_transfer_bwd")
    report["mrr_transfer_bwd_cases"] = rows
    return dict(served, max_abs_err=max(r["max_abs_err"] for r in rows))


def qat_launches(specs, steps: int) -> dict:
    """Variation-aware QAT with a chip pinned on every step: one rosa_fused
    per conv/fc forward, one mrr_transfer forward and one backward per
    depthwise weight; the clean evaluation after training takes the ideal
    fake-quant path and launches nothing."""
    dw = sum(1 for s in specs if s.kind == "dwconv")
    return {"rosa_fused": steps * (len(specs) - dw),
            "mrr_transfer": steps * dw, "mrr_transfer_bwd": steps * dw,
            "osa_matmul": 0, "ssd_scan": 0}


def robust_qat(report: dict) -> dict:
    """12(b): variation-aware QAT of mobilenet_v3 over an 8-chip
    antithetic wafer, then both it and phase 9's plainly trained
    mobilenet_v3 over a fresh 16-chip wafer at PAPER_NOISE."""
    import dataclasses as dc

    import torch
    from repro_torch import rosa
    from repro_torch.core import mrr
    from repro_torch.models.cnn import LITE_MODELS
    from repro_torch.robust import ensemble as ENS
    from repro_torch.robust import variation as V
    from repro_torch.training.cnn_train import QAT_CFG, train_cnn

    specs = LITE_MODELS[CNN]
    dims = V.cnn_lane_dims(CNN)
    wafer = V.sample_ensemble(torch.Generator(DEVICE).manual_seed(17),
                              ROBUST_QAT["n_chips"], dims, antithetic=True,
                              device=DEVICE)
    # ---- the main path: counts from 0, read right after ------------------
    reset_launches()
    t0 = time.perf_counter()
    params, clean = train_cnn(CNN, steps=ROBUST_QAT["steps"],
                              batch=ROBUST_QAT["batch"], ensemble=wafer,
                              device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = launch_counts()
    want = qat_launches(specs, ROBUST_QAT["steps"])
    print(f"  variation-aware QAT {CNN}: {ROBUST_QAT['steps']} steps over "
          f"{ROBUST_QAT['n_chips']} chips in {wall:.2f} s, clean acc "
          f"{clean:.2f} %; launches {n} (want {want})", flush=True)
    if n != want:
        raise AssertionError("variation-aware QAT did not run each step's "
                             "conv/fc through rosa_fused and its depthwise "
                             "weights through mrr_transfer forward and "
                             "backward")
    if not all(bool(torch.isfinite(t).all()) for layer in params.values()
               for t in layer.values()):
        raise AssertionError("variation-aware QAT: non-finite parameters")
    names = [s.name for s in specs]
    engine = rosa.Engine.from_config(
        dc.replace(QAT_CFG, noise=mrr.PAPER_NOISE), layers=names)
    k_ens, k_mc = mrr.split(torch.Generator(DEVICE).manual_seed(18))
    fresh = V.sample_ensemble(k_ens, ROBUST_EVAL_CHIPS, dims, device=DEVICE)
    out = {"qat_wall_s": wall, "qat_clean_acc": clean, "qat_launches": n,
           "qat_want_launches": want}
    for label, p in (("variation-aware", params), ("plain", TRAINED[CNN])):
        reset_launches()
        t0 = time.perf_counter()
        res = ENS.evaluate_cnn_ensemble(p, CNN, engine, fresh, k_mc)
        torch.cuda.synchronize()
        ev_wall, ev_n = time.perf_counter() - t0, launch_counts()
        forwards = ROBUST_EVAL_CHIPS * 512 // 128
        ev_want = noisy_launches(specs, set(names), forwards)
        print(f"  {label:15s} {CNN} on {ROBUST_EVAL_CHIPS} fresh chips, "
              f"PAPER_NOISE: clean {res.clean_acc:.2f} %, mean "
              f"{res.mean_acc:.2f} %, min {res.min_acc:.2f} %, yield(2pp) "
              f"{res.yield_frac(2.0):.3f}; {ev_wall:.2f} s, launches "
              f"rosa_fused {ev_n['rosa_fused']} mrr_transfer "
              f"{ev_n['mrr_transfer']}", flush=True)
        if ev_n["rosa_fused"] != ev_want["rosa_fused"] \
                or ev_n["mrr_transfer"] != ev_want["mrr_transfer"]:
            raise AssertionError(f"{label} ensemble evaluation: launches "
                                 f"{ev_n}, want {ev_want}")
        if not (len(res.accs) == ROBUST_EVAL_CHIPS and all(
                math.isfinite(a) and 0.0 <= a <= 100.0 for a in res.accs)):
            raise AssertionError(f"{label}: accuracies out of range")
        out[label] = dict(res.summary(), wall_s=ev_wall, launches=ev_n)
    return out


def check_sensitivity(summary: dict) -> dict:
    """The sensitivity runner's plan and EDP ratio recomputed from its own
    degradation matrix: the search order (`searched_hybrid_plan`'s key over
    `profile_layers_mc`'s profiles), the plan as that order's prefix of
    the chosen length, and the ratio of `mapping.plan_edp` in float64."""
    import numpy as np
    from repro_torch.configs.paper_cnns import CNN_WORKLOADS
    from repro_torch.core import mapping as M
    from repro_torch.core.constants import ROSA_OPTIMAL, Mapping
    from repro_torch.robust import sensitivity as S

    deg, search = summary["degradation"], summary["search"]
    rows = [l for l in CNN_WORKLOADS[ROBUST_MODEL] if l.name in deg]
    prof = {p.name: p for p in S.profile_layers_mc(
        rows, ROSA_OPTIMAL, deg, batch=128, device=DEVICE)}
    order = sorted((n for n, p in prof.items() if p.d_is <= p.d_ws + 0.5),
                   key=lambda n: (prof[n].d_is - prof[n].d_ws) + 0.5 * np.log(
                       max(prof[n].e_is, 1e-30) / max(prof[n].e_ws, 1e-30)))
    order = order[:6]
    plan = set(summary["plan"])
    # an empty plan is also the runner's fallback to pure WS
    want_plan = set(order[:search["n_is"]]) if plan else set()
    is_plan = {n: Mapping.IS for n in plan}
    ratio = (M.plan_edp(rows, is_plan, ROSA_OPTIMAL, batch=128)
             / M.plan_edp(rows, {}, ROSA_OPTIMAL, batch=128))
    if order != search["order"] or plan != want_plan \
            or ratio != summary["hybrid_vs_ws_edp"]:
        raise AssertionError(
            f"sensitivity: order {search['order']} / plan {sorted(plan)} / "
            f"EDP ratio {summary['hybrid_vs_ws_edp']!r} differ from the "
            f"recomputed {order} / {sorted(want_plan)} / {ratio!r}")
    return {"order": order, "plan": sorted(plan), "edp_ratio": ratio}


def cli_launches(name: str, kw: dict, summary: dict) -> dict:
    """What a runner must launch on alexnet (8 conv/fc layers, no
    depthwise): one rosa_fused per layer and noisy forward of a
    micro-batch (the clean references take the ideal path); the ensemble's
    surrogate one mrr_transfer per (chip, layer).  Micro-batches are 128
    images, 64 in the plan search; the drift grid has 9 times, twice."""
    from repro_torch.models.cnn import LITE_MODELS
    layers = len(LITE_MODELS[ROBUST_MODEL])
    chips, chunks = kw["n_chips"], kw["n_eval"] // 128
    if name == "ensemble":
        return {"rosa_fused": kw["n_probe"] * chunks * layers,
                "mrr_transfer": chips * layers, "mrr_transfer_bwd": 0,
                "osa_matmul": 0, "ssd_scan": 0}
    if name == "sensitivity":
        cells = 2 * layers * chunks                      # IS, WS x layers
        search = (len(summary["search"]["order"]) + 1) * (kw["n_eval"] // 64)
        forwards = chips * (cells + search + 2 * chunks)  # + hybrid, WS
    elif name == "drift":
        forwards = 2 * 9 * chips * chunks
    else:
        forwards = len(kw["scales"]) * chips * chunks
    return {"rosa_fused": forwards * layers, "mrr_transfer": 0,
            "mrr_transfer_bwd": 0, "osa_matmul": 0, "ssd_scan": 0}


def robust_cli(report: dict) -> dict:
    """12(c): the four CLI runners on alexnet at the reference's defaults,
    with phase 9's alexnet parameters; each a main-path run of its own
    (counts from 0 before, read right after)."""
    import torch
    from repro_torch.robust import cli

    out = {}
    for name, kw in ROBUST_RUNS.items():
        reset_launches()
        t0 = time.perf_counter()
        summary, metrics = cli.RUNNERS[name](
            ROBUST_MODEL, params=TRAINED[ROBUST_MODEL], device=DEVICE, **kw)
        torch.cuda.synchronize()
        wall, n = time.perf_counter() - t0, launch_counts()
        head = {m.name: m.value for m in metrics}
        print(f"  robust.{name} {ROBUST_MODEL}: " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in head.items()) + f"; {wall:.2f} s; launches "
            f"rosa_fused {n['rosa_fused']} mrr_transfer "
            f"{n['mrr_transfer']}", flush=True)
        if "n_chips" in head and head["n_chips"] != kw["n_chips"]:
            raise AssertionError(f"robust.{name}: n_chips {head['n_chips']}")
        if not all(math.isfinite(v) for v in head.values()
                   if isinstance(v, float)):
            raise AssertionError(f"robust.{name}: non-finite metric")
        want = cli_launches(name, kw, summary)
        if {k: n[k] for k in want} != want:
            raise AssertionError(f"robust.{name}: launches {n}, want {want}")
        row = {"metrics": head, "wall_s": wall, "launches": n}
        if name == "sensitivity":
            row["recomputed"] = check_sensitivity(summary)
            row["plan"] = summary["plan"]
            row["degradation"] = summary["degradation"]
            print(f"    plan {sorted(summary['plan'])}, search order "
                  f"{summary['search']['order']}, EDP ratio "
                  f"{summary['hybrid_vs_ws_edp']!r} (recomputed equal)")
        if name == "sweep":
            row["rows"] = summary["rows"]
        out[name] = row
    return out


def robust_phase(report: dict) -> dict:
    """12(b) and 12(c); returns the mrr_transfer_bwd launches of the
    variation-aware QAT run."""
    print(f"phase 12(b): variation-aware QAT, {CNN}")
    qat = robust_qat(report)
    print(f"phase 12(c): the robust CLI runners, {ROBUST_MODEL}")
    cli_rows = robust_cli(report)
    report["robust"] = {"qat": qat, "cli": cli_rows}
    return qat["qat_launches"]


# ---------------------------------------------------------------------------
# Phase 13: compile-once Programs with the plan cache, drift-adaptive
# serving of qwen3-32b at full width, and the robust smoke run
# ---------------------------------------------------------------------------
SMOKE_RUN = dict(n_chips=16, n_probe=2, n_eval=64, max_candidates=3)


def qwen_cfg():
    """qwen3-32b at full width, depth cut to 4 of 64 layers (phase 3)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-32b"), n_layers=4)


def compile_once(report: dict) -> dict:
    """13(a): the serving Program compiled twice against one PlanCache:
    cold searches (on the card's energy model), warm loads."""
    import os
    import torch
    from repro_torch import rosa
    from repro_torch.models.model import build_model
    from repro_torch.serve import (ServeConfig, build_serving_program,
                                   serving_model_config)

    bundle = build_model(serving_model_config(qwen_cfg(), rosa=True))
    scfg = ServeConfig(n_slots=4, max_len=56, prefill_chunk=8, rosa=True,
                       rosa_backend="fused")
    root = pathlib.Path(os.environ["ROSA_PLAN_CACHE"]) / "13a"
    progs, walls = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        progs.append(build_serving_program(bundle, scfg, device=DEVICE,
                                           cache=rosa.PlanCache(root)))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    cold, warm = progs
    plans = [{k: v.name for k, v in p.plan.mapping_plan().items()}
             for p in progs]
    stats = json.loads(subprocess.run(
        [sys.executable, "-m", "repro_torch.rosa", "stats", "--root",
         str(root)], capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"))).stdout)
    print(f"  compile walls: cold {walls[0] * 1e3:.2f} ms (searched "
          f"{cold.searched}), warm {walls[1] * 1e3:.2f} ms (cache_hit "
          f"{warm.cache_hit}); plan {plans[1]}; stats: {stats['plans']} "
          f"plan(s), {stats['bytes']} bytes")
    if not (cold.searched and not cold.cache_hit and warm.cache_hit
            and not warm.searched and cold.cache_key == warm.cache_key):
        raise AssertionError("13(a): cold compile must search, warm hit")
    if plans[0] != plans[1] or plans[1] != {"mlp/wi": "IS", "mlp/wo": "IS"}:
        raise AssertionError(f"13(a): plans {plans} differ from phase 3's")
    if stats["plans"] != 1:
        raise AssertionError(f"13(a): cache stats {stats}")
    return {"cold_ms": walls[0] * 1e3, "warm_ms": walls[1] * 1e3,
            "plan": plans[1], "stats": stats}


def arm_launches(rep, routed: int, chip_forwards: int,
                 warm_steps: int) -> int:
    """rosa_fused launches of one A/B arm: every routed projection of every
    decode step, prefill chunk, warm-up step of a swapped-in program and
    chip-pinned probe forward (a probe's clean reference is the ideal
    digital path and launches nothing)."""
    return routed * (rep.decode_steps + rep.prefill_chunks + warm_steps
                     + chip_forwards)


SPANS = {"serve.decode_step": "decode", "serve.prefill_chunk": "prefill",
         "adaptive.probe": "probes", "adaptive.replan": "replans"}


def span_walls(tracer) -> dict:
    """Host walls [s] of one arm by span: decode steps (each up to the read
    of its tokens), prefill chunks, health probes and replans (each ending
    in a read of the device's result, so it covers its device work)."""
    walls = dict.fromkeys(SPANS.values(), 0.0)
    for ev in tracer.events:
        if ev.get("ph") == "X" and ev["name"] in SPANS:
            walls[SPANS[ev["name"]]] += ev["dur"] * 1e-6
    return walls


def tokens_through(rep, tick: int) -> dict:
    """Each request's tokens emitted at or before `tick`: the prefill's
    token at first_token_tick, then one a decode step from admit_tick
    through done_tick."""
    out = {}
    for rid, c in rep.completions.items():
        if len(c.tokens) != c.done_tick - c.admit_tick + 2:
            raise AssertionError(f"13(b): request {rid} did not emit one "
                                 "token a tick from admission to done")
        n = int(c.first_token_tick <= tick) \
            + max(0, min(tick, c.done_tick) - c.admit_tick + 1)
        out[rid] = c.tokens[:n]
    return out


def drift_serve(report: dict) -> dict:
    """13(b): the reference bench's full-size drift_serve scenario
    (`drift_serve_metrics(quick=False)`) on qwen3-32b at full width, built
    as `run_scenario` builds it; each arm (`run_arm`) a main-path run of
    its own, its walls from the scheduler's and the controller's spans."""
    import torch
    from repro_torch.obs.trace import Tracer, tracing
    from repro_torch.serve.adaptive import (ScenarioConfig, ScenarioResult,
                                            run_arm, scenario_metrics,
                                            scenario_parts)

    cfg = ScenarioConfig(force_replan_at=30)
    model_cfg = qwen_cfg()
    t0 = time.perf_counter()
    parts = scenario_parts(model_cfg, cfg, device=DEVICE)
    torch.cuda.synchronize()
    sched, reqs, probes = parts.sched, parts.requests, parts.probes
    routed = 2 * model_cfg.n_layers
    names = len(probes.names)
    plan = {k: v.name for k, v in sched.program.plan.mapping_plan().items()}
    print(f"  set-up {time.perf_counter() - t0:.1f} s; {cfg.n_requests} "
          f"requests at {cfg.rate}/tick, sine {cfg.amp_k} K over "
          f"{cfg.period_ticks:g} ticks, probes every {cfg.probe_every} "
          f"ticks ({cfg.n_probes} x {cfg.prompt_len} tokens), forced "
          f"replan at tick {cfg.force_replan_at}; plan {plan}")

    arms, launches, walls = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    for arm in ("uncontrolled", "controlled"):
        tracer = Tracer()
        reset_launches()                  # counts from 0, read right after
        with tracing(tracer):
            arms[arm] = run_arm(parts, controlled=arm == "controlled")
        launches[arm] = launch_counts()
        walls[arm] = span_walls(tracer)
    peak = torch.cuda.max_memory_allocated() / 2**30
    (monitor, rep_u), (controller, rep_c) = arms.values()
    want = {
        # golden, ref and the probes
        "uncontrolled": arm_launches(rep_u, routed,
                                     2 + len(monitor.series), 0),
        # ref, the probes and every replan's (mapping x layer) cells
        "controlled": arm_launches(
            rep_c, routed, 1 + len(controller.series)
            + controller.replans * 2 * names, controller.replans)}

    res = ScenarioResult.from_arms(cfg, sched, arms["uncontrolled"],
                                   arms["controlled"])
    s = res.summary()
    s["dropped_requests"] = res.dropped_requests(reqs)
    metrics = {m.name: m.value for m in scenario_metrics(res, reqs)}
    for arm, (_, rep) in arms.items():
        n, w = launches[arm], walls[arm]
        w["rest"] = rep.wall_s - sum(w.values())
        print(f"  {arm} wall {rep.wall_s:.2f} s: decode steps "
              f"{w['decode']:.2f}, prefill chunks {w['prefill']:.2f}, "
              f"health probes {w['probes']:.2f}, replans "
              f"{w['replans']:.2f}, host {w['rest']:.2f}")
        print(f"  {arm}: {rep.total_tokens} tokens in {rep.wall_s:.2f} s "
              f"({rep.tokens_per_s:.2f} tok/s), {rep.ticks} ticks, "
              f"{rep.decode_steps} decode steps, {rep.prefill_chunks} "
              f"prefill chunks; rosa_fused launches {n['rosa_fused']} "
              f"(want {want[arm]}), osa_matmul {n['osa_matmul']}, "
              f"mrr_transfer {n['mrr_transfer']}", flush=True)
        if n["rosa_fused"] != want[arm] or n["osa_matmul"] \
                or n["mrr_transfer"] or n["ssd_scan"]:
            raise AssertionError(f"13(b) {arm}: launches {n}, want "
                                 f"rosa_fused {want[arm]} and nothing else")
    print(f"  agreements: ref {s['ref_agreement']!r}, uncontrolled "
          f"{s['uncontrolled_agreement']!r}, controlled "
          f"{s['controlled_agreement']!r}; recovery {s['recovery']!r}; "
          f"retrims {s['retrims']}, trim updates {s['trim_updates']}, "
          f"replans {s['replans']} (plans "
          f"{[w['plan'] for w in controller.swaps]})")
    print(f"  swap wall {s['swap_wall_ms']:.2f} ms, downtime "
          f"{s['swap_downtime_ticks']} ticks; p99 tick {s['p99_tick_ms']:.2f}"
          f" ms; epoch requests {s['epoch_requests']} bit-exact "
          f"{s['epoch_bitexact']}; dropped {s['dropped_requests']}; peak "
          f"{peak:.1f} GiB")
    # both arms run the same ticks; every token emitted up to the first
    # actuator write must be the same bit for bit, finished or not
    tick = res.first_action_tick
    epoch = tokens_through(rep_u, tick)
    n_epoch = sum(map(len, epoch.values()))
    first_done = min(c.done_tick for c in rep_u.completions.values())
    same = epoch == tokens_through(rep_c, tick)
    print(f"  pre-action epoch: {n_epoch} tokens through tick {tick}, "
          f"equal in both arms {same}; first request done at tick "
          f"{first_done}")
    if s["dropped_requests"] != 0 or not s["epoch_bitexact"] \
            or s["swap_downtime_ticks"] != 0 or s["replans"] < 1:
        raise AssertionError(f"13(b): scenario gates failed: {s}")
    if not n_epoch or not same:
        raise AssertionError("13(b): the arms' tokens differ before the "
                             "first actuator write")
    if not all(math.isfinite(v) for v in (
            s["ref_agreement"], s["uncontrolled_agreement"],
            s["controlled_agreement"], s["recovery"])):
        raise AssertionError("13(b): non-finite agreement")
    return {"summary": s, "metrics": metrics, "peak_gib": peak,
            "epoch_tokens": n_epoch, "first_done_tick": first_done,
            "walls_s": walls,
            "tokens_per_s": {a: r.tokens_per_s for a, (_, r) in arms.items()},
            "launches": launches,
            "rosa_fused": sum(n["rosa_fused"] for n in launches.values())}


def smoke_launches(order: int, cold: bool) -> dict:
    """What `run_smoke` launches on alexnet (8 conv/fc layers, no
    depthwise): one rosa_fused per layer and chip-pinned forward (the
    ensemble probes, the degradation cells when the matrix is not cached,
    the search's candidates, the two final plans; each at one micro-batch
    of n_eval images), one mrr_transfer per (chip, layer) for the
    surrogate."""
    from repro_torch.models.cnn import LITE_MODELS
    layers = len(LITE_MODELS[ROBUST_MODEL])
    cells = 2 * layers if cold else 0
    forwards = SMOKE_RUN["n_probe"] * (1 + cells + order + 1 + 2)
    return {"rosa_fused": forwards * layers,
            "mrr_transfer": SMOKE_RUN["n_chips"] * layers,
            "mrr_transfer_bwd": 0, "osa_matmul": 0, "ssd_scan": 0}


def robust_smoke(report: dict) -> dict:
    """13(c): `run_smoke` twice on phase 9's alexnet with one cache: the
    second run finds the degradation matrix and launches none of the
    Monte-Carlo stage."""
    import os
    import torch
    from repro_torch import rosa
    from repro_torch.robust import cli

    root = pathlib.Path(os.environ["ROSA_PLAN_CACHE"]) / "13c"
    rows, total = [], 0
    for i in range(2):
        reset_launches()
        t0 = time.perf_counter()
        summary, metrics = cli.run_smoke(
            ROBUST_MODEL, params=TRAINED[ROBUST_MODEL],
            cache=rosa.PlanCache(root), device=DEVICE, **SMOKE_RUN)
        torch.cuda.synchronize()
        wall, n = time.perf_counter() - t0, launch_counts()
        want = smoke_launches(len(summary["search"]["order"]), i == 0)
        head = {m.name: m.value for m in metrics}
        print(f"  run {i + 1}: matrix_cached {summary['matrix_cached']}, "
              f"plan {sorted(summary['plan'])}, hybrid "
              f"{summary['hybrid_mean_acc']:.2f} % vs WS "
              f"{summary['ws_mean_acc']:.2f} %; {wall:.2f} s; launches "
              f"rosa_fused {n['rosa_fused']} mrr_transfer "
              f"{n['mrr_transfer']} (want {want['rosa_fused']}, "
              f"{want['mrr_transfer']})", flush=True)
        if summary["matrix_cached"] != (i == 1):
            raise AssertionError(f"13(c) run {i + 1}: matrix_cached "
                                 f"{summary['matrix_cached']}")
        if {k: n[k] for k in want} != want:
            raise AssertionError(f"13(c) run {i + 1}: launches {n}, want "
                                 f"{want}")
        if not all(math.isfinite(v) for v in head.values()
                   if isinstance(v, float)):
            raise AssertionError(f"13(c) run {i + 1}: non-finite metric")
        rows.append({"matrix_cached": summary["matrix_cached"],
                     "plan": summary["plan"], "wall_s": wall,
                     "launches": n, "metrics": head})
        total += n["rosa_fused"]
    if rows[0]["plan"] != rows[1]["plan"]:
        raise AssertionError("13(c): the warm run chose another plan")
    return {"runs": rows, "rosa_fused": total}


def adaptive_phase(report: dict) -> int:
    """13(a)-(c); returns phase 13's rosa_fused launches."""
    print("phase 13(a): compile once, the plan cache")
    report["compile_once"] = compile_once(report)
    print("phase 13(b): drift-adaptive serving, qwen3-32b full width")
    drift = drift_serve(report)
    report["drift_serve"] = drift
    print(f"phase 13(c): the robust smoke run twice, {ROBUST_MODEL}")
    smoke = robust_smoke(report)
    report["robust_smoke"] = smoke
    return drift["rosa_fused"] + smoke["rosa_fused"]


def write_report(report: dict, t_start: float) -> int:
    report["wall_s"] = time.perf_counter() - t_start
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "CUDA card (all phases by default).")
    ap.add_argument("--kernels", action="store_true",
                    help="build and run the kernel phases 2, 6, 8 and "
                    "12(a) only (parity and times of all five kernels); "
                    "prints no summary and no result line")
    opts = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # a fresh plan cache for this run: every compile starts cold
    import os
    import shutil
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    plan_cache = tempfile.mkdtemp(prefix="plan-cache-", dir=ROOT / "build")
    os.environ["ROSA_PLAN_CACHE"] = plan_cache
    try:
        return run_phases(opts)
    finally:
        shutil.rmtree(plan_cache, ignore_errors=True)


def run_phases(opts) -> int:
    import torch
    from repro_torch import kernels

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    print("phase 1: build")
    t0 = time.perf_counter()
    libs = kernels.build_all()
    print(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in sorted(libs):
        log = kernels.build_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in
                     re.findall(r"(\d+) bytes spill stores", log))
        print(f"  {name}: {len(regs)} kernels, at most {max(regs, default=0)}"
              f" registers a thread, {spills} bytes of spill stores")

    report: dict = {"card": card, "phase_s": {}}

    def phase(name, fn):
        t = time.perf_counter()
        out = fn(report)
        report["phase_s"][name] = time.perf_counter() - t
        print(f"  ({name}: {report['phase_s'][name]:.1f} s)", flush=True)
        return out

    print("phase 2: kernel parity against the plain versions")
    fused = phase("2 rosa_fused", fused_phase)
    osa = phase("2 osa_matmul", osa_phase)
    if opts.kernels:
        print("phase 6: ssd_scan parity against the plain version")
        phase("6", ssd_phase)
        print("phase 8: mrr_transfer parity against the plain version")
        phase("8", mrr_phase)
        print("phase 12(a): the mrr_transfer backward against its plain "
              "derivative")
        phase("12a", mrr_bwd_phase)
        return write_report(report, t_start)
    print("phases 3-5: serving")
    launches = phase("3-5", serve_phase)
    print("phase 6: ssd_scan parity against the plain version")
    ssd = phase("6", ssd_phase)
    print("phase 7: serving mamba2-1.3b")
    launches["ssd_scan"] = phase("7", mamba_phase)
    print("phase 8: mrr_transfer parity against the plain version")
    mrr_row = phase("8", mrr_phase)
    print(f"phase 9: the Table 4 pipeline, {', '.join(CNNS)}")
    launches["mrr_transfer"] = phase("9", table4_phase)["mrr_transfer"]
    print(f"phase 10: {CNN} on the card against the reference's golden file")
    phase("10", golden_phase)
    print("phase 11: the paper's energy model on the card (float64)")
    phase("11", energy_phase)
    print("phase 12(a): the mrr_transfer backward against its plain "
          "derivative")
    bwd = phase("12a", mrr_bwd_phase)
    launches["mrr_transfer_bwd"] = phase("12bc", robust_phase)[
        "mrr_transfer_bwd"]
    launches["rosa_fused"] += phase("13", adaptive_phase)

    summary = {"kernels": [
        {"name": "rosa_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rosa_fused.cu",
         "replaces": "src/repro/kernels/rosa_fused/rosa_fused.py:193",
         "launches": launches["rosa_fused"],
         "max_abs_err": fused["max_abs_err"], "ms": fused["ms"],
         "plain_ms": fused["plain_ms"], "bound_ms": fused["bound_ms"],
         "bound_by": fused["bound_by"], "library_ms": None},
        {"name": "osa_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/osa_matmul.cu",
         "replaces": "src/repro/kernels/osa_matmul/osa_matmul.py:90",
         "launches": launches["osa_matmul"],
         "max_abs_err": osa["max_abs_err"], "ms": osa["ms"],
         "plain_ms": osa["plain_ms"], "bound_ms": osa["bound_ms"],
         "bound_by": osa["bound_by"], "library_ms": osa["library_ms"]},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:73",
         "launches": launches["ssd_scan"],
         "max_abs_err": ssd["max_abs_err"], "ms": ssd["ms"],
         "plain_ms": ssd["plain_ms"], "bound_ms": ssd["bound_ms"],
         "bound_by": ssd["bound_by"], "library_ms": None},
        {"name": "mrr_transfer", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mrr_transfer.cu",
         "replaces": "src/repro/kernels/mrr_transfer/mrr_transfer.py:69",
         "launches": launches["mrr_transfer"],
         "max_abs_err": mrr_row["max_abs_err"], "ms": mrr_row["ms"],
         "plain_ms": mrr_row["plain_ms"], "bound_ms": mrr_row["bound_ms"],
         "bound_by": mrr_row["bound_by"], "library_ms": None},
        {"name": "mrr_transfer_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mrr_transfer.cu",
         "replaces": "src/repro/core/mrr.py:265",
         "launches": launches["mrr_transfer_bwd"],
         "max_abs_err": bwd["max_abs_err"], "ms": bwd["ms"],
         "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
         "bound_by": bwd["bound_by"], "library_ms": None},
    ]}
    report["summary"] = summary
    write_report(report, t_start)
    for k in summary["kernels"]:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(k[key]):
                raise AssertionError(f"{k['name']}: {key} not finite")
    print(f"total {report['wall_s']:.1f} s")
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
