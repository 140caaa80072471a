"""`python -m repro_torch.analysis` — scan the zoo + serving steps, gate on
new findings (PyTorch port of `repro.analysis.cli`).

Default target set:

  * every model-zoo workload's GEMM table (and the ssm archs' scans)
    through the four kernels' preflights (shape math only — the full zoo
    costs nothing);
  * the smoke arch's decode step, run once;
  * the smoke serving stack: decode / admit / evict / prefill-chunk steps
    and the drift step built from ONE autotuned `rosa.Program` (declared
    in-place state verified, hot-path purity enforced), plus the Program.

The model and serving targets run on `--device` (default: the card).

Output: findings to stdout, a bench-schema JSON report (--json), and an
exit code that is non-zero iff WARNING+ findings exist that the baseline
(--baseline, default the package's committed `baseline.json`) does not
acknowledge.  --write-baseline regenerates the baseline from the current
findings.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import torch

from repro_torch.analysis.baseline import load_baseline, write_baseline
from repro_torch.analysis.findings import AnalysisReport, Severity
from repro_torch.analysis.registry import run_checks
from repro_torch.analysis.target import (AnalysisTarget, materialize,
                                         program_target)
from repro_torch.launch import cli_device

DEFAULT_ARCH = "qwen3-32b"
BASELINE = pathlib.Path(__file__).with_name("baseline.json")


# ---------------------------------------------------------------------------
# Target construction
# ---------------------------------------------------------------------------
def zoo_shape_targets() -> list[AnalysisTarget]:
    """One shapes-only target per zoo workload (plus ssd workloads for the
    ssm-family archs) — feeds the kernel preflight."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs.model_zoo import ZOO_SEQ_LEN, zoo_workloads

    targets = []
    for w in zoo_workloads():
        gemms = tuple((ls.name, ls.m, ls.k, ls.n)
                      for ls in w.layers if ls.kind == "gemm")
        targets.append(AnalysisTarget(name=f"zoo:{w.name}",
                                      gemm_shapes=gemms))
    ssd = []
    for arch in ARCHS:
        cfg = get_config(arch)
        ssm = getattr(cfg, "ssm", None)
        if ssm is None:
            continue
        ssd.append((cfg.name, 1, ZOO_SEQ_LEN, ssm.n_heads,
                    ssm.d_inner // ssm.n_heads, ssm.d_state))
    if ssd:
        targets.append(AnalysisTarget(name="zoo:ssd_scan",
                                      ssd_shapes=tuple(ssd)))
    return targets


def _serve_config():
    from repro_torch.serve.config import ServeConfig
    return ServeConfig(n_slots=4, max_len=56, prefill_chunk=8)


def model_targets(arch: str, device) -> list[AnalysisTarget]:
    """The smoke model's decode step as a plain target."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import build_model
    from repro_torch.serve.metrics import abstract_decode_batch

    cfg = get_smoke(arch)
    bundle = build_model(cfg)
    args = materialize((bundle.abstract(torch.float32),
                        abstract_decode_batch(cfg, _serve_config())), device)
    return [AnalysisTarget(name=f"model:{arch}:decode_step",
                           fn=bundle.decode_step, example_args=args)]


def serving_targets(arch: str, device) -> list[AnalysisTarget]:
    """The full smoke serving stack from one autotuned Program."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model
    from repro_torch.serve import decode as D
    from repro_torch.serve.adaptive import make_drift_step
    from repro_torch.serve.config import serving_model_config
    from repro_torch.serve.metrics import (abstract_decode_batch,
                                           build_serving_program)

    cfg = get_smoke(arch)
    bundle = build_model(serving_model_config(cfg, rosa=True))
    scfg = _serve_config()
    program = build_serving_program(bundle, scfg, device=device)
    abstract = bundle.abstract(torch.float32)
    params = materialize(abstract, device)
    temp = scfg.temperature

    def state():
        return D.init_state(bundle.cfg, scfg, device)

    def cache1():
        return T.init_cache(bundle.cfg, 1, scfg.max_len, device)

    pre = f"serve:{arch}:"
    targets = [
        AnalysisTarget(
            name=pre + "decode_step",
            fn=D.make_serve_step(bundle, scfg, program=program),
            example_args=(params, state(), D.null_admit(), temp),
            state_argnums=(1,), hot_path=True),
        AnalysisTarget(
            name=pre + "admit_step",
            fn=D.make_admit_step(bundle, scfg, program=program),
            example_args=(state(), D.make_admit(cache1(), 0, 1, 0, 2)),
            state_argnums=(0,), hot_path=True),
        AnalysisTarget(
            name=pre + "evict",
            fn=D.make_evict(bundle, scfg, program=program),
            example_args=(state(), 0), state_argnums=(0,), hot_path=True),
        program_target(
            program, (abstract, abstract_decode_batch(bundle.cfg, scfg)),
            name=pre + "program", device=device),
        # the adaptive controller's drift step: the decode step with one
        # extra residual scalar — as pure and in place as the base step
        AnalysisTarget(
            name=pre + "drift_step",
            fn=make_drift_step(bundle, scfg, program),
            example_args=(params, state(), D.null_admit(), temp, 0.0),
            state_argnums=(1,), hot_path=True),
    ]
    if bundle.cfg.family not in ("ssm", "hybrid"):
        c = scfg.prefill_chunk
        targets.append(AnalysisTarget(
            name=pre + "chunk_fn",
            fn=D.make_chunk_fn(bundle, program=program),
            example_args=(params,
                          torch.zeros((1, c), dtype=torch.int32,
                                      device=device),
                          torch.full((1,), c, dtype=torch.int32,
                                     device=device),
                          cache1()),
            state_argnums=(3,), hot_path=True))
    return targets


def build_targets(arch: str = DEFAULT_ARCH, *, zoo: bool = True,
                  models: bool = True, serve: bool = True,
                  device: str | torch.device = "cuda"
                  ) -> list[AnalysisTarget]:
    targets: list[AnalysisTarget] = []
    if zoo:
        targets += zoo_shape_targets()
    if models:
        targets += model_targets(arch, device)
    if serve:
        targets += serving_targets(arch, device)
    return targets


# ---------------------------------------------------------------------------
# Bench-schema report
# ---------------------------------------------------------------------------
def bench_report(report: AnalysisReport, new_count: int, wall_s: float):
    from repro_torch.bench.schema import BenchReport, BenchResult, Metric

    per_check: dict[str, int] = {}
    for f in report.findings:
        per_check[f.check] = per_check.get(f.check, 0) + 1
    metrics = [
        Metric("findings_new", new_count, gate=True, rel_tol=0.0,
               direction="lower_is_better"),
        Metric("findings_error", len(report.errors)),
        Metric("findings_warning", len(report.warnings)),
        Metric("findings_total", len(report)),
    ]
    metrics += [Metric(f"findings_{check}", n)
                for check, n in sorted(per_check.items())]
    return BenchReport(
        bench_seq=0, mode="quick",
        created_utc=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        env={}, results=[BenchResult(name="static_analysis",
                                     wall_s=round(wall_s, 3),
                                     metrics=metrics)])


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=DEFAULT_ARCH,
                    help="smoke arch for the model/serving targets")
    ap.add_argument("--device", default="cuda",
                    help="where the model and serving targets run")
    ap.add_argument("--baseline", default=str(BASELINE),
                    help="committed findings baseline (missing = empty)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline from current findings "
                         "and exit 0")
    ap.add_argument("--json", default=None,
                    help="write a bench-schema JSON report here")
    ap.add_argument("--checks", default=None,
                    help="comma-separated subset of checks to run")
    ap.add_argument("--no-zoo", action="store_true")
    ap.add_argument("--no-models", action="store_true")
    ap.add_argument("--no-serve", action="store_true")
    args = ap.parse_args(argv)

    device = args.device
    if not (args.no_models and args.no_serve):
        device = cli_device(device)
    t0 = time.monotonic()
    targets = build_targets(args.arch, zoo=not args.no_zoo,
                            models=not args.no_models,
                            serve=not args.no_serve, device=device)
    checks = args.checks.split(",") if args.checks else None
    report = run_checks(targets, checks=checks)
    wall = time.monotonic() - t0

    if args.write_baseline:
        path = write_baseline(args.baseline, report)
        print(f"wrote {len(load_baseline(path))} acknowledged findings "
              f"to {path}")
        return 0

    baseline = load_baseline(args.baseline)
    new = report.new_against(baseline, Severity.WARNING)

    for f in sorted(report.findings,
                    key=lambda f: (-f.severity, f.subject, f.code)):
        mark = "NEW " if f in new else ""
        print(f"{mark}{f}")
    print(f"-- {len(targets)} targets, {report.summary()}, "
          f"{len(new)} new vs baseline ({wall:.1f}s)")

    if args.json:
        from repro_torch.bench.schema import save
        save(bench_report(report, len(new), wall), args.json)
        print(f"wrote {args.json}")

    if new:
        print(f"FAIL: {len(new)} finding(s) not in {args.baseline} — fix "
              "them, or acknowledge deliberately with --write-baseline",
              file=sys.stderr)
        return 1
    return 0
