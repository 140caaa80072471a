"""Promotion hazards (the port's counterpart of
`repro.analysis.checks.recompile`).

  REC002 WARNING  a float64 tensor is produced while every floating input
                  is <= float32: a silent promotion doubles bandwidth (and
                  diverges from the float32 analog-path numerics the paper
                  calibrates); one finding a target, at the first such op

The reference's REC001 (a weak-typed Python scalar reaching a jit trace)
and REC003 (an unhashable `static_argnums` value) are hazards of `jax.jit`
retracing and caching; eager PyTorch has no trace and no static
arguments, so they have no counterpart.
"""

from __future__ import annotations

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.registry import register
from repro_torch.analysis.target import AnalysisTarget, leaves


@register("recompile")
def check_recompile(target: AnalysisTarget) -> list[Finding]:
    if target.fn is None:
        return []
    floats = [t.dtype.itemsize for _, t in leaves(target.example_args)
              if t.dtype.is_floating_point]
    if not floats or max(floats) > 4:
        return []
    f64 = target.run().f64
    if not f64:
        return []
    op, site = f64[0]
    return [Finding(
        check="recompile", code="REC002", severity=Severity.WARNING,
        subject=target.name, location=f"{site} {op}",
        message=(f"float64 value produced by `{op}` from <= float32 "
                 "inputs: silent promotion doubles bandwidth — check for "
                 "float64 numpy arrays or dtype=torch.float64 on this "
                 "path"))]
