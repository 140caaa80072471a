"""Regression gate: baseline vs. current ``BENCH_<n>.json`` (the port's
copy of `repro.bench.compare`, over the port's `bench.schema`: a report
either package writes is judged alike by both).

Per gated metric the verdict is:

  * ``direction="lower_is_better"``  — regression when current exceeds
    baseline by more than `rel_tol` relative;
  * ``direction="higher_is_better"`` — regression when current falls short
    of baseline by more than `rel_tol` relative;
  * ``direction="both"``             — regression when |current-baseline|
    drifts past `rel_tol` relative (deterministic reproduction metrics);
  * string values                    — regression on any mismatch (e.g. the
    DSE winner's config label).

A gated metric present in the baseline but missing from the current report
is a regression (a silently dropped bench must not pass CI), as is any
current bench with ``status: failed``.  Tolerances come from the *baseline*
metric (the committed file is the contract); `--rel-tol` scales them all.

CLI (non-zero exit on regression):

    PYTHONPATH=src python -m repro_torch.bench.compare \\
        benchmarks/baseline.json BENCH_2.json
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.bench.schema import BenchReport, Metric, load


@dataclasses.dataclass
class MetricVerdict:
    bench: str
    metric: str
    baseline: float | int | str
    current: float | int | str | None
    rel_delta: float | None         # None for strings / missing
    rel_tol: float
    direction: str
    ok: bool
    note: str = ""

    @property
    def key(self) -> str:
        return f"{self.bench}.{self.metric}"


@dataclasses.dataclass
class CompareResult:
    verdicts: list[MetricVerdict]
    failed_benches: list[str]       # current benches with status=failed
    mode_mismatch: str = ""         # set when baseline/current modes differ

    @property
    def regressions(self) -> list[MetricVerdict]:
        return [v for v in self.verdicts if not v.ok]

    @property
    def ok(self) -> bool:
        return (not self.regressions and not self.failed_benches
                and not self.mode_mismatch)


def _judge(base: Metric, cur: Metric | None, bench: str,
           tol_scale: float) -> MetricVerdict:
    tol = base.rel_tol * tol_scale
    kw = dict(bench=bench, metric=base.name, baseline=base.value,
              rel_tol=tol, direction=base.direction)
    if cur is None:
        return MetricVerdict(current=None, rel_delta=None, ok=False,
                             note="gated metric missing from current", **kw)
    if isinstance(base.value, str) or isinstance(cur.value, str):
        ok = base.value == cur.value
        return MetricVerdict(current=cur.value, rel_delta=None, ok=ok,
                             note="" if ok else "value mismatch", **kw)
    denom = abs(base.value) if base.value else 1.0
    delta = (cur.value - base.value) / denom
    if base.direction == "lower_is_better":
        ok = delta <= tol
    elif base.direction == "higher_is_better":
        ok = delta >= -tol
    else:
        ok = abs(delta) <= tol
    return MetricVerdict(current=cur.value, rel_delta=delta, ok=ok,
                         note="" if ok else "outside tolerance", **kw)


def compare(baseline: BenchReport, current: BenchReport,
            tol_scale: float = 1.0) -> CompareResult:
    """Judge every gated baseline metric against the current report."""
    if baseline.mode != current.mode:
        # quick and full runs gate different bench scopes (e.g. table4's
        # n_models); comparing across modes produces spurious regressions,
        # so fail loudly instead of confusingly.
        return CompareResult(
            verdicts=[], failed_benches=[],
            mode_mismatch=f"baseline is a {baseline.mode!r} run but current "
                          f"is {current.mode!r} — regenerate the baseline "
                          f"in the same mode")
    verdicts = []
    for (bench, _), base_m in baseline.gated_metrics().items():
        cur_r = current.result(bench)
        cur_m = cur_r.metric(base_m.name) if cur_r is not None else None
        verdicts.append(_judge(base_m, cur_m, bench, tol_scale))
    failed = [r.name for r in current.results if r.status == "failed"]
    return CompareResult(verdicts=verdicts, failed_benches=failed)


def format_result(res: CompareResult) -> str:
    if res.mode_mismatch:
        return f"MODE MISMATCH: {res.mode_mismatch} -> FAIL"
    lines = [f"{'metric':44s} {'baseline':>12s} {'current':>12s} "
             f"{'delta':>8s} {'tol':>6s}  verdict"]
    for v in res.verdicts:
        if isinstance(v.baseline, str) or v.current is None:
            base_s, cur_s, d_s = str(v.baseline)[:12], str(v.current)[:12], "-"
        else:
            base_s = f"{v.baseline:12.5g}"
            cur_s = f"{v.current:12.5g}"
            d_s = f"{v.rel_delta * 100:+.2f}%"
        mark = "ok" if v.ok else f"REGRESSION ({v.note})"
        lines.append(f"{v.key:44s} {base_s:>12s} {cur_s:>12s} "
                     f"{d_s:>8s} {v.rel_tol * 100:5.1f}%  {mark}")
    for b in res.failed_benches:
        lines.append(f"{b:44s} {'-':>12s} {'-':>12s} {'-':>8s} {'':>6s}  "
                     f"FAILED in current run")
    lines.append(f"\n{len(res.verdicts)} gated metrics, "
                 f"{len(res.regressions)} regressions, "
                 f"{len(res.failed_benches)} failed benches -> "
                 + ("PASS" if res.ok else "FAIL"))
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Compare two BENCH_<n>.json reports; exit 1 on "
                    "regression.")
    ap.add_argument("baseline", help="committed baseline report")
    ap.add_argument("current", help="freshly produced report")
    ap.add_argument("--rel-tol", type=float, default=1.0, metavar="SCALE",
                    help="scale every metric's tolerance (default 1.0)")
    args = ap.parse_args(argv)

    res = compare(load(args.baseline), load(args.current),
                  tol_scale=args.rel_tol)
    print(format_result(res))
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())
