"""Versioned ``BENCH_<n>.json`` schema: dataclasses + validation + I/O
(the port's own copy of `repro.bench.schema`, which imports no JAX: a
report either package writes validates in both).

Layout (schema_version = 1):

    {
      "schema_version": 1,
      "bench_seq": 2,                  # the <n> in BENCH_<n>.json
      "created_utc": "2026-07-30T12:00:00Z",
      "mode": "quick" | "full",
      "env": {"python": "...", "torch": "...", "platform": "..."},
      "results": [
        {
          "name": "fig7_array_dse",
          "status": "ok" | "failed" | "skipped",
          "wall_s": 1.23,
          "error": "",                 # traceback tail when status=failed
          "metrics": [
            {"name": "reduction_vs_deap", "value": 0.64, "unit": "frac",
             "gate": true, "rel_tol": 0.05, "direction": "higher_is_better"}
          ]
        }, ...
      ]
    }

Gating semantics live on the metric: only ``gate: true`` metrics are
compared by `bench.compare`; ``direction`` says which way a change
counts as a regression, ``rel_tol`` how much drift is tolerated.  Wall
times and stochastic metrics (tiny-step training accuracies) ship with
``gate: false`` — recorded for trend plots, never gating CI.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

SCHEMA_VERSION = 1

_STATUSES = ("ok", "failed", "skipped")
_DIRECTIONS = ("both", "higher_is_better", "lower_is_better")


class SchemaError(ValueError):
    """A report violated the BENCH_<n>.json schema."""


@dataclasses.dataclass
class Metric:
    name: str
    value: float | int | str
    unit: str = ""
    gate: bool = False
    rel_tol: float = 0.05
    direction: str = "both"         # both | higher_is_better | lower_is_better


@dataclasses.dataclass
class BenchResult:
    name: str
    status: str = "ok"              # ok | failed | skipped
    wall_s: float = 0.0
    error: str = ""
    metrics: list[Metric] = dataclasses.field(default_factory=list)

    def metric(self, name: str) -> Metric | None:
        for m in self.metrics:
            if m.name == name:
                return m
        return None


@dataclasses.dataclass
class BenchReport:
    bench_seq: int
    mode: str = "quick"
    created_utc: str = ""
    env: dict[str, str] = dataclasses.field(default_factory=dict)
    results: list[BenchResult] = dataclasses.field(default_factory=list)
    schema_version: int = SCHEMA_VERSION

    def result(self, name: str) -> BenchResult | None:
        for r in self.results:
            if r.name == name:
                return r
        return None

    def gated_metrics(self) -> dict[tuple[str, str], Metric]:
        """{(bench, metric): Metric} for every gate=true metric."""
        return {(r.name, m.name): m for r in self.results
                for m in r.metrics if m.gate}

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------
def _expect(cond: bool, msg: str) -> None:
    if not cond:
        raise SchemaError(msg)


def validate(doc: dict | BenchReport) -> None:
    """Raise `SchemaError` unless `doc` is a schema-valid report."""
    if isinstance(doc, BenchReport):
        doc = doc.to_dict()
    _expect(isinstance(doc, dict), "report must be a JSON object")
    _expect(doc.get("schema_version") == SCHEMA_VERSION,
            f"schema_version must be {SCHEMA_VERSION}, "
            f"got {doc.get('schema_version')!r}")
    _expect(isinstance(doc.get("bench_seq"), int) and doc["bench_seq"] >= 0,
            "bench_seq must be a non-negative int")
    _expect(doc.get("mode") in ("quick", "full"),
            f"mode must be quick|full, got {doc.get('mode')!r}")
    _expect(isinstance(doc.get("env"), dict), "env must be an object")
    _expect(isinstance(doc.get("results"), list), "results must be a list")
    seen = set()
    for r in doc["results"]:
        _expect(isinstance(r, dict), "each result must be an object")
        name = r.get("name")
        _expect(isinstance(name, str) and name, "result.name must be set")
        _expect(name not in seen, f"duplicate bench name {name!r}")
        seen.add(name)
        _expect(r.get("status") in _STATUSES,
                f"{name}: status must be one of {_STATUSES}")
        _expect(isinstance(r.get("wall_s"), (int, float))
                and r["wall_s"] >= 0, f"{name}: wall_s must be >= 0")
        _expect(r.get("status") != "failed" or r.get("error"),
                f"{name}: failed result must carry an error")
        _expect(isinstance(r.get("metrics", []), list),
                f"{name}: metrics must be a list")
        mseen = set()
        for m in r.get("metrics", []):
            _expect(isinstance(m, dict), f"{name}: each metric must be "
                                         f"an object")
            mname = m.get("name")
            _expect(isinstance(mname, str) and mname,
                    f"{name}: metric.name must be set")
            _expect(mname not in mseen,
                    f"{name}: duplicate metric {mname!r}")
            mseen.add(mname)
            _expect(isinstance(m.get("value"), (int, float, str)),
                    f"{name}.{mname}: value must be number or string")
            _expect(m.get("direction", "both") in _DIRECTIONS,
                    f"{name}.{mname}: direction must be one of {_DIRECTIONS}")
            rel_tol = m.get("rel_tol", 0.0)
            _expect(isinstance(rel_tol, (int, float)) and rel_tol >= 0,
                    f"{name}.{mname}: rel_tol must be >= 0")
            _expect(not (m.get("gate") and isinstance(m["value"], float)
                         and m["value"] != m["value"]),
                    f"{name}.{mname}: gated metric value is NaN")


# ---------------------------------------------------------------------------
# I/O
# ---------------------------------------------------------------------------
def from_dict(doc: dict) -> BenchReport:
    validate(doc)
    results = [
        BenchResult(
            name=r["name"], status=r["status"], wall_s=float(r["wall_s"]),
            error=r.get("error", ""),
            # rel_tol omitted in hand-edited JSON means EXACT (0.0), the
            # same default validate() checks against — only metrics that
            # declare a tolerance get one
            metrics=[Metric(name=m["name"], value=m["value"],
                            unit=m.get("unit", ""),
                            gate=bool(m.get("gate", False)),
                            rel_tol=float(m.get("rel_tol", 0.0)),
                            direction=m.get("direction", "both"))
                     for m in r.get("metrics", [])])
        for r in doc["results"]
    ]
    return BenchReport(bench_seq=doc["bench_seq"], mode=doc["mode"],
                       created_utc=doc.get("created_utc", ""),
                       env=dict(doc["env"]), results=results)


def load(path: str | Path) -> BenchReport:
    with open(path) as f:
        return from_dict(json.load(f))


def save(report: BenchReport, path: str | Path) -> Path:
    validate(report)
    path = Path(path)
    with open(path, "w") as f:
        json.dump(report.to_dict(), f, indent=1, sort_keys=False)
        f.write("\n")
    return path
