"""Hot-loop purity: no host round trips where the step rate lives (the
port's counterpart of `repro.analysis.checks.purity`).

A `.item()`, `bool(t)`, a device→host copy or a `torch.cuda.synchronize`
inside a serving step stalls the host until the card drains; in a loop
(one per layer or per iteration) it serializes the pipeline the
continuous-batching scheduler exists to keep full.  The target's run sees
them as ATen ops (`aten._local_scalar_dense`, a `_to_copy` / `copy_` from
CUDA into host memory), through a patched `torch.cuda.synchronize`, and,
on the card, as the warnings of `torch.cuda.set_sync_debug_mode("warn")`
(what no op shows: a device tensor built from a host scalar, the
implicit syncs of data-dependent ops).  Eager PyTorch has no loop
structure to read, so a loop is a call site (module and function) that
round-trips more than once in one call.

Findings:

  PUR001 ERROR    a host round trip that recurs within one call: one sync
                  per iteration
  PUR002 WARNING  a host round trip anywhere in a hot-path step: it syncs
                  the card every tick
"""

from __future__ import annotations

from collections import Counter

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.registry import register
from repro_torch.analysis.target import AnalysisTarget


@register("purity")
def check_purity(target: AnalysisTarget) -> list[Finding]:
    if target.fn is None:
        return []
    run = target.run()
    # one sync the recorder saw as an op may also have raised a sync
    # warning at the same site: a site counts the larger of the two
    ops: dict[str, set] = {}
    for op, site in run.host_syncs:
        ops.setdefault(site, set()).add(op)
    seen, warned = Counter(s for _, s in run.host_syncs), \
        Counter(run.sync_warnings)
    findings: list[Finding] = []
    for site in sorted(set(seen) | set(warned)):
        n = max(seen[site], warned[site])
        op = ", ".join(sorted(ops.get(site, ()))) or "implicit sync"
        loc = f"{site} {op}"
        if n > 1:
            findings.append(Finding(
                check="purity", code="PUR001", severity=Severity.ERROR,
                subject=target.name, location=loc,
                message=(f"host round trip `{op}` runs {n} times in one "
                         "call: one device->host sync PER ITERATION — "
                         "hoist it out of the loop")))
        elif target.hot_path:
            findings.append(Finding(
                check="purity", code="PUR002", severity=Severity.WARNING,
                subject=target.name, location=loc,
                message=(f"host round trip `{op}` in a hot-path step: "
                         "syncs the device every tick")))
    return findings
