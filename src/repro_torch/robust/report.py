"""Robustness reports in the bench schema (PyTorch port of
`repro.robust.report`).

Accuracy-vs-sigma sweeps and yield curves are serialized as schema-valid
``BENCH_<n>.json`` documents (`repro_torch.bench.schema`, one `BenchResult`
per experiment, typed `Metric`s inside), which the reference's
`repro.bench.compare` gate reads as it reads its own: yield and accuracy
metrics are ``higher_is_better``, degradations ``lower_is_better``.
"""

from __future__ import annotations

import datetime
import platform
from pathlib import Path
from typing import Callable, Sequence

import torch

from repro_torch.bench.schema import BenchReport, BenchResult, Metric, save
from repro_torch.robust.ensemble import EnsembleResult


def ensemble_metrics(res: EnsembleResult, *, prefix: str = "",
                     yield_drop_pp: float = 2.0,
                     gate: bool = False,
                     acc_rel_tol: float = 0.1,
                     yield_rel_tol: float = 0.5) -> list[Metric]:
    """Typed metrics of one ensemble evaluation (gated on request; yields
    are quantized to 1 / n_chips, so their tolerance absorbs a few chips
    flipping)."""
    p = f"{prefix}_" if prefix else ""
    return [
        Metric(f"{p}n_chips", res.n_chips, gate=gate, rel_tol=0.0),
        Metric(f"{p}clean_acc", res.clean_acc, unit="%"),
        Metric(f"{p}mean_acc", res.mean_acc, unit="%", gate=gate,
               rel_tol=acc_rel_tol, direction="higher_is_better"),
        Metric(f"{p}min_acc", res.min_acc, unit="%"),
        Metric(f"{p}mean_drop_pp", res.mean_drop_pp, unit="pp"),
        Metric(f"{p}yield_{yield_drop_pp:g}pp", res.yield_frac(yield_drop_pp),
               unit="frac", gate=gate, rel_tol=yield_rel_tol,
               direction="higher_is_better"),
    ]


def yield_curve_metrics(res: EnsembleResult,
                        drops_pp: Sequence[float] = (1.0, 2.0, 5.0),
                        prefix: str = "") -> list[Metric]:
    """Ungated yield metrics over a drop-threshold grid."""
    p = f"{prefix}_" if prefix else ""
    return [Metric(f"{p}yield_{d:g}pp", y, unit="frac",
                   direction="higher_is_better")
            for d, y in res.yield_curve(drops_pp)]


def sigma_sweep(eval_at: Callable[[float], EnsembleResult],
                scales: Sequence[float], *,
                yield_drop_pp: float = 2.0) -> list[dict]:
    """Accuracy / yield vs noise-scale rows: `eval_at(s)` evaluates the
    ensemble with per-shot and static sigmas scaled by `s`."""
    rows = []
    for s in scales:
        res = eval_at(float(s))
        rows.append({"scale": float(s), **res.summary(),
                     "yield": res.yield_frac(yield_drop_pp)})
    return rows


def sweep_metrics(rows: Sequence[dict]) -> list[Metric]:
    """Accuracy / yield metrics of a sigma sweep."""
    out = []
    for r in rows:
        tag = f"s{r['scale']:g}".replace(".", "p")
        out.append(Metric(f"acc_{tag}", r["mean_acc"], unit="%",
                          direction="higher_is_better"))
        out.append(Metric(f"yield_{tag}", r["yield"], unit="frac",
                          direction="higher_is_better"))
    return out


def build_report(results: Sequence[BenchResult], *, seq: int = 0,
                 mode: str = "quick") -> BenchReport:
    """Wrap results in a schema-valid BenchReport (environment stamped)."""
    return BenchReport(
        bench_seq=seq, mode=mode,
        created_utc=datetime.datetime.now(datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%SZ"),
        env={"python": platform.python_version(),
             "torch": torch.__version__, "platform": platform.platform()},
        results=list(results))


def save_report(results: Sequence[BenchResult], path: str | Path, *,
                seq: int = 0, mode: str = "quick") -> Path:
    """Validate and write a robustness report."""
    return save(build_report(results, seq=seq, mode=mode), Path(path))
