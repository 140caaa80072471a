"""RNG discipline: generator provenance of every draw (the port's
counterpart of `repro.analysis.checks.prng`).

The paper's robustness numbers assume every noise draw (DAC quantization,
thermal crosstalk, per-layer variation) is statistically independent; one
reused generator state silently correlates the Monte-Carlo ensemble.  The
port's keys are `torch.Generator`s, split and folded into fresh
generators (`core.mrr.fold_in`), so reuse is visible at run time: the
target's run records, for every ATen op that takes a generator, the state
of the generator it drew from (device, seed, digest of `get_state()`).
Two draws at one state draw the same numbers — whether the generator was
reset, cloned, or two layers folded the same key.

Findings:

  PRNG001 ERROR    two or more draws in one call consume the same generator
                   state
  PRNG002 WARNING  a draw in a hot-path step from the global default
                   generator, where the port's rule is an explicit
                   generator (a key) per draw

The reference's PRNG003 (a key seeded from a compile-time constant inside
traced code) and PRNG004 (a loop-invariant key consumed in a scan body)
read the loop and constant structure of a jaxpr, which eager PyTorch does
not have; they have no counterpart yet.
"""

from __future__ import annotations

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.registry import register
from repro_torch.analysis.target import AnalysisTarget


@register("prng")
def check_prng(target: AnalysisTarget) -> list[Finding]:
    if target.fn is None:
        return []
    draws = target.run().draws
    findings: list[Finding] = []
    by_state: dict[tuple, list] = {}
    for d in draws:
        by_state.setdefault(d.state, []).append(d)
        if d.default and target.hot_path:
            findings.append(Finding(
                check="prng", code="PRNG002", severity=Severity.WARNING,
                subject=target.name, location=f"{d.site} {d.op}",
                message=("draw from the global default generator in a "
                         "hot-path step: its numbers depend on every other "
                         "draw in the process — pass an explicit "
                         "generator")))
    for state, ds in by_state.items():
        if len(ds) < 2:
            continue
        shown = ", ".join(f"{d.site} {d.op}" for d in ds[:4]) + \
            ("..." if len(ds) > 4 else "")
        findings.append(Finding(
            check="prng", code="PRNG001", severity=Severity.ERROR,
            subject=target.name, location=f"{ds[0].site} {ds[0].op}",
            message=(f"one {state[0]} generator state (seed {state[1]}) "
                     f"consumed by {len(ds)} draws ({shown}): the draws "
                     "are identical — fold a fresh key per draw")))
    # dedupe (one site can consume several reused states)
    seen: set[str] = set()
    out = []
    for f in findings:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            out.append(f)
    return out
