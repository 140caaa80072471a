"""Committed findings baseline: acknowledge, don't silence (PyTorch port of
`repro.analysis.baseline`: the same schema, so a baseline written by either
package loads in the other).

The baseline file maps finding fingerprints to human-readable labels.  CI
fails on findings NOT in the baseline, so a new hazard blocks merge while
the acknowledged backlog doesn't; deleting an entry re-arms its finding.
Fingerprints exclude the message text, so re-wording a check never
invalidates the file.
"""

from __future__ import annotations

import json
import pathlib

from repro_torch.analysis.findings import AnalysisReport, Severity

BASELINE_SCHEMA = 1


def load_baseline(path: str | pathlib.Path) -> set[str]:
    """Acknowledged fingerprints; a missing file is an empty baseline."""
    p = pathlib.Path(path)
    if not p.exists():
        return set()
    doc = json.loads(p.read_text())
    if doc.get("schema") != BASELINE_SCHEMA:
        raise ValueError(
            f"{p}: baseline schema {doc.get('schema')!r} != "
            f"{BASELINE_SCHEMA} — regenerate with "
            "`python -m repro_torch.analysis --write-baseline`")
    return set(doc.get("findings", {}))


def write_baseline(path: str | pathlib.Path,
                   report: AnalysisReport) -> pathlib.Path:
    """Write every WARNING+ finding's fingerprint (INFO never gates, so
    it is never baselined)."""
    p = pathlib.Path(path)
    entries = {
        f.fingerprint: f"{f.check} {f.code} {f.subject} ({f.location})"
        for f in report.findings if f.severity >= Severity.WARNING}
    doc = {"schema": BASELINE_SCHEMA, "findings": dict(sorted(
        entries.items(), key=lambda kv: kv[1]))}
    p.write_text(json.dumps(doc, indent=1, sort_keys=False) + "\n")
    return p
