"""Check registry: name -> check function (PyTorch port of
`repro.analysis.registry`).

A check is `check(target: AnalysisTarget) -> list[Finding]`.  Each check
decides its own applicability (a target with no callable skips the run
checks; one with no gemm_shapes skips the kernel preflight) and returns
[] rather than raising when it has nothing to say.  A check that itself
crashes becomes an ERROR finding with code CHECKFAIL — the verifier must
never mask a target's real findings behind its own stack trace.
"""

from __future__ import annotations

import traceback
from typing import Callable, Iterable, Sequence

from repro_torch.analysis.findings import AnalysisReport, Finding, Severity
from repro_torch.analysis.target import AnalysisTarget

CheckFn = Callable[[AnalysisTarget], "list[Finding]"]

_REGISTRY: dict[str, CheckFn] = {}


def register(name: str) -> Callable[[CheckFn], CheckFn]:
    """Register a check under `name` (its Finding.check namespace)."""

    def deco(fn: CheckFn) -> CheckFn:
        if name in _REGISTRY:
            raise ValueError(f"check {name!r} already registered")
        _REGISTRY[name] = fn
        return fn

    return deco


def all_checks() -> dict[str, CheckFn]:
    # importing the package registers every check
    from repro_torch.analysis import checks as _checks  # noqa: F401
    return dict(_REGISTRY)


def run_checks(targets: Iterable[AnalysisTarget],
               checks: Sequence[str] | None = None) -> AnalysisReport:
    """Run `checks` (default: all registered) over every target."""
    table = all_checks()
    if checks is not None:
        unknown = set(checks) - set(table)
        if unknown:
            raise ValueError(
                f"unknown checks {sorted(unknown)}; "
                f"registered: {sorted(table)}")
        table = {k: table[k] for k in checks}
    findings: list[Finding] = []
    for target in targets:
        for cname, check in table.items():
            try:
                findings.extend(check(target))
            except Exception:
                findings.append(Finding(
                    check=cname, code="CHECKFAIL", severity=Severity.ERROR,
                    subject=target.name, location=cname,
                    message=("check crashed: "
                             + traceback.format_exc(limit=3).strip())))
    return AnalysisReport(tuple(findings))
