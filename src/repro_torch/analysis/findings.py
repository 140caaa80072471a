"""Typed findings: what every check emits (PyTorch port of
`repro.analysis.findings`; fingerprints are the reference's, so a
baseline written by either package gates the other).

A `Finding` is one decided fact about one analysis target — "two draws of
this step consume one generator state", "this state tensor came back in a
new storage".  Findings are value objects with a stable
`fingerprint` (check, code, subject, location) so a committed baseline can
acknowledge known findings without pinning their human-readable messages,
and CI can gate on *new* findings only.

Severity semantics:

  ERROR    — the artifact is wrong (correlated Monte-Carlo noise, a decode
             step silently double-buffering its state); `verify="error"`
             refuses to return the Program.
  WARNING  — probably wrong or fragile (a draw from the global generator,
             >50% padding waste); surfaced, baselined, never fatal by
             default.
  INFO     — noteworthy but expected (a kernel shape that pads); recorded
             in reports, never gates.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json


class Severity(enum.IntEnum):
    """Ordered so max(severities) is the report's worst finding."""

    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:           # "ERROR", not "Severity.ERROR"
        return self.name


@dataclasses.dataclass(frozen=True)
class Finding:
    """One statically-decided fact about one analysis target.

    check:    registry name of the emitting check ("prng", "donation", ...)
    code:     stable machine code within the check ("PRNG001")
    severity: ERROR / WARNING / INFO
    subject:  the analysis target's name ("serve:decode_step", "zoo:...")
    location: where inside the subject (call site, state leaf, shape)
    message:  the human-readable explanation (NOT part of the fingerprint)
    """

    check: str
    code: str
    severity: Severity
    subject: str
    location: str
    message: str

    @property
    def fingerprint(self) -> str:
        """Stable identity for baselining: message text excluded so wording
        improvements don't invalidate a committed baseline."""
        raw = json.dumps([self.check, self.code, self.subject, self.location])
        return hashlib.sha256(raw.encode("utf-8")).hexdigest()[:16]

    def to_json(self) -> dict:
        return {"check": self.check, "code": self.code,
                "severity": str(self.severity), "subject": self.subject,
                "location": self.location, "message": self.message,
                "fingerprint": self.fingerprint}

    @classmethod
    def from_json(cls, doc: dict) -> "Finding":
        return cls(check=doc["check"], code=doc["code"],
                   severity=Severity[doc["severity"]],
                   subject=doc["subject"], location=doc["location"],
                   message=doc["message"])

    def __str__(self) -> str:
        return (f"[{self.severity}] {self.code} {self.subject} "
                f"({self.location}): {self.message}")


@dataclasses.dataclass(frozen=True)
class AnalysisReport:
    """All findings of one analysis run, with baseline bookkeeping."""

    findings: tuple[Finding, ...] = ()

    def __len__(self) -> int:
        return len(self.findings)

    def __iter__(self):
        return iter(self.findings)

    def by_severity(self, severity: Severity) -> tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == severity)

    @property
    def errors(self) -> tuple[Finding, ...]:
        return self.by_severity(Severity.ERROR)

    @property
    def warnings(self) -> tuple[Finding, ...]:
        return self.by_severity(Severity.WARNING)

    def fingerprints(self) -> set[str]:
        return {f.fingerprint for f in self.findings}

    def new_against(self, baseline: set[str],
                    min_severity: Severity = Severity.WARNING
                    ) -> tuple[Finding, ...]:
        """Findings at or above `min_severity` absent from the baseline —
        the set a CI gate fails on.  INFO findings never gate by default."""
        return tuple(f for f in self.findings
                     if f.severity >= min_severity
                     and f.fingerprint not in baseline)

    def merged(self, other: "AnalysisReport") -> "AnalysisReport":
        return AnalysisReport(self.findings + other.findings)

    def to_json(self) -> dict:
        return {"findings": [f.to_json() for f in self.findings]}

    @classmethod
    def from_json(cls, doc: dict) -> "AnalysisReport":
        return cls(tuple(Finding.from_json(f) for f in doc["findings"]))

    def summary(self) -> str:
        if not self.findings:
            return "no findings"
        return (f"{len(self.findings)} findings "
                f"({len(self.errors)} error, {len(self.warnings)} warning, "
                f"{len(self.by_severity(Severity.INFO))} info)")


class VerificationError(RuntimeError):
    """`rosa.compile(verify="error")` found ERROR-severity findings.

    Carries the full `AnalysisReport` on `.report` so callers (and tests)
    can inspect exactly which invariants the program violated."""

    def __init__(self, report: AnalysisReport):
        self.report = report
        lines = [str(f) for f in report.errors] or [str(f) for f in report]
        super().__init__(
            "static verification failed: " + report.summary() + "\n  "
            + "\n  ".join(lines))
