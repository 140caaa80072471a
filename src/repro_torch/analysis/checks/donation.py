"""State verification: declared in-place state vs what the call did (the
port's counterpart of `repro.analysis.checks.donation`).

The port's steps keep their state in its own storage where the reference
donates it to a jitted step; `state_argnums` declares the arguments a step
must update in place.  A refactor that rebuilds a state tensor instead of
writing into it keeps working and doubles that tensor's footprint, with
no warning.  The target's run compares every tensor of a declared state
argument (`untyped_storage().data_ptr()`) before the call with the same
tensor where the state comes back in the result.

Findings:

  DON001 ERROR    a tensor of a declared state argument came back in a new
                  storage (or the state did not come back at all)
  DON002 WARNING  a hot-path step that takes a multi-tensor argument
                  declares no state at all
"""

from __future__ import annotations

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.registry import register
from repro_torch.analysis.target import AnalysisTarget, leaves


@register("donation")
def check_donation(target: AnalysisTarget) -> list[Finding]:
    if target.fn is None:
        return []
    if not target.state_argnums:
        if target.hot_path and any(len(leaves(a)) > 1
                                   for a in target.example_args):
            return [Finding(
                check="donation", code="DON002",
                severity=Severity.WARNING, subject=target.name,
                location="state_argnums=()",
                message=("hot-path step declares no state: nothing holds "
                         "it to updating its per-step tensors in place — "
                         "declare the state argument"))]
        return []

    findings: list[Finding] = []
    for i, fresh in sorted(target.run().fresh_state.items()):
        if fresh is None:
            findings.append(Finding(
                check="donation", code="DON001", severity=Severity.ERROR,
                subject=target.name, location=f"state arg {i}",
                message=("the declared state does not come back in the "
                         "step's result: its update cannot be in place")))
            continue
        for path in fresh:
            findings.append(Finding(
                check="donation", code="DON001", severity=Severity.ERROR,
                subject=target.name, location=f"state arg {i}{path}",
                message=("state tensor came back in a new storage: the "
                         "step rebuilt it instead of writing in place, so "
                         "it holds two copies — write into the argument")))
    return findings
