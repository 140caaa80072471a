"""RNG discipline: generator provenance of every draw (the port's
counterpart of `repro.analysis.checks.prng`).

The paper's robustness numbers assume every noise draw (DAC quantization,
thermal crosstalk, per-layer variation) is statistically independent; one
reused generator state silently correlates the Monte-Carlo ensemble.  The
port's keys are `torch.Generator`s, split and folded into fresh
generators (`core.mrr.fold_in`), so reuse is visible at run time: the
target's run records, for every ATen op that takes a generator, the state
of the generator it drew from (device, seed, digest of `get_state()`) and
the call path that drew (every frame of the model code with its
instruction offset).  Two draws at one state draw the same numbers —
whether the generator was reset, cloned, or two layers folded the same
key.

Findings:

  PRNG001 ERROR    two or more draws in one call, from distinct call
                   paths, consume the same generator state
  PRNG002 WARNING  a draw in a hot-path step from the global default
                   generator, where the port's rule is an explicit
                   generator (a key) per draw
  PRNG003 WARNING  a generator seeded inside the target's call from a
                   constant: a `manual_seed` (or `torch.manual_seed`)
                   whose seed stays the same when the target's keys (the
                   generators among its arguments) are replaced — every
                   run draws the same stream.  A fold (`core.mrr.fold_in`,
                   and so `split` / `split_keys`) derives its child's seed
                   from its parent's: it is a derivation, as the
                   reference's `random_fold_in` is, and not flagged.  A
                   target without keys has nothing to vary, and is not
                   checked
  PRNG004 ERROR    a loop-invariant key: one call path draws at the same
                   generator state on two iterations of one call, or in
                   two calls of a step with declared state (which
                   advances between its warm-up call and the recorded
                   one) — every iteration or step draws the SAME noise

The reference decides PRNG003 and PRNG004 from a jaxpr's constants and
scan bodies; eager PyTorch has neither, so the port reads them from
what the calls did.
"""

from __future__ import annotations

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.registry import register
from repro_torch.analysis.target import AnalysisTarget, generators

# seedings that derive a child from a parent generator
_DERIVE_SITES = {"repro_torch/core/mrr.py:fold_in"}


def _loop_invariant(target: AnalysisTarget, draws, prior) -> list[Finding]:
    """PRNG004: one call path at one state twice in a call, or in the
    warm-up and the recorded call of a step with declared state."""
    out = []
    seen: set[tuple] = set()
    repeated = []
    for d in draws:
        k = (d.path, d.state)
        if k in seen:
            repeated.append((d, "on two iterations of one call"))
        seen.add(k)
    if target.state_argnums:
        before = {(d.path, d.state) for d in prior}
        repeated += [(d, "in two steps") for d in draws
                     if (d.path, d.state) in before]
    for d, when in repeated:
        out.append(Finding(
            check="prng", code="PRNG004", severity=Severity.ERROR,
            subject=target.name, location=f"{d.site} {d.op}",
            message=(f"one {d.state[0]} generator state (seed "
                     f"{d.state[1]}) drawn at this call path {when}: a "
                     "loop-invariant key draws the SAME noise each time — "
                     "fold the iteration or step into the key")))
    return out


def _constant_seeds(target: AnalysisTarget, seeds) -> list[Finding]:
    """PRNG003: seedings whose seed the target's keys do not move."""
    if not generators(target.example_args):
        return []
    again: dict[tuple, list[int]] = {}
    for s in target.rekeyed_seeds():
        again.setdefault(s.path, []).append(s.seed)
    out, nth = [], {}
    for s in seeds:
        i = nth[s.path] = nth.get(s.path, -1) + 1
        other = again.get(s.path, [])
        if s.site in _DERIVE_SITES or i >= len(other) \
                or other[i] != s.seed:
            continue
        out.append(Finding(
            check="prng", code="PRNG003", severity=Severity.WARNING,
            subject=target.name, location=f"{s.site} manual_seed",
            message=(f"generator seeded from a constant ({s.seed}) inside "
                     "the call: the seed ignores the target's keys, so "
                     "every run draws the same stream — fold a fresh key "
                     "from an argument")))
    return out


@register("prng")
def check_prng(target: AnalysisTarget) -> list[Finding]:
    if target.fn is None:
        return []
    run = target.run()
    findings: list[Finding] = []
    by_state: dict[tuple, list] = {}
    for d in run.draws:
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
        first = {}
        for d in ds:
            first.setdefault(d.path, d)
        if len(first) < 2:
            continue
        ds = list(first.values())
        shown = ", ".join(f"{d.site} {d.op}" for d in ds[:4]) + \
            ("..." if len(ds) > 4 else "")
        findings.append(Finding(
            check="prng", code="PRNG001", severity=Severity.ERROR,
            subject=target.name, location=f"{ds[0].site} {ds[0].op}",
            message=(f"one {state[0]} generator state (seed {state[1]}) "
                     f"consumed by {len(ds)} draws ({shown}): the draws "
                     "are identical — fold a fresh key per draw")))
    findings += _constant_seeds(target, run.seeds)
    findings += _loop_invariant(target, run.draws, run.prior_draws)
    # dedupe (one site can consume several reused states)
    seen: set[str] = set()
    out = []
    for f in findings:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            out.append(f)
    return out
