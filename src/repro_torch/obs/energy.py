"""`EnergyLedger` → trace-timeline bridge (PyTorch port of
`repro.obs.energy`).

The port's `rosa.EnergyLedger` keeps one event per distinct (layer,
shape, mapping, mode, scope) however often a step runs, so per-tick
energy cannot be read off the ledger as it grows.  `EnergyTrack` instead
prices each attribution scope's step energy ONCE (lazily, after the first
step has populated the ledger for that tag) and then accumulates it
analytically every tick, emitting cumulative counter ("C") events onto the
ambient trace: an ``energy.<tag>`` counter track per scope (e.g.
``energy.prefill`` / ``energy.decode``) that Perfetto renders alongside the
latency spans.

All emission goes through the module-level helpers of
`repro_torch.obs.trace`, so the bridge is a no-op when no tracer is
installed.
"""

from __future__ import annotations

from repro_torch.core import energy as E
from repro_torch.core.constants import ROSA_OPTIMAL, OPEConfig
from repro_torch.obs import trace as _trace


class EnergyTrack:
    """Emit per-scope cumulative energy as counter events on the trace.

    One instance watches one ledger.  Call `tick(tag)` once per executed
    step attributed to `tag`; the step energy for a tag is priced from the
    ledger's deduped events (batch=1: the recorded shapes already carry
    slot concurrency) the first time the ledger holds events for that tag,
    and re-used afterwards.
    """

    def __init__(self, ledger, ope: OPEConfig = ROSA_OPTIMAL,
                 osa: E.OSAEnergyConfig = E.OSA_OPTIMAL):
        self.ledger = ledger
        self.ope = ope
        self.osa = osa
        self._step_j: dict[str, float] = {}     # tag -> priced step energy
        self._cum_j: dict[str, float] = {}      # tag -> cumulative energy

    def _price(self, tag: str) -> float | None:
        j = self._step_j.get(tag)
        if j is None:
            if self.ledger is None or not any(
                    ev.tag == tag for ev in self.ledger.events):
                return None                     # tag not recorded yet
            j = self.ledger.breakdown(self.ope, self.osa, batch=1,
                                      tag=tag).energy
            self._step_j[tag] = j
        return j

    def tick(self, tag: str, n: int = 1) -> None:
        """Account `n` executed steps of scope `tag` and emit the counter."""
        if not _trace.enabled():
            return
        j = self._price(tag)
        if j is None:
            return
        cum = self._cum_j.get(tag, 0.0) + j * n
        self._cum_j[tag] = cum
        _trace.counter(f"energy.{tag}", {"J": cum}, cat="energy")

    def total_j(self, tag: str | None = None) -> float:
        """Cumulative accounted energy [J] (all scopes when tag is None)."""
        if tag is not None:
            return self._cum_j.get(tag, 0.0)
        return sum(self._cum_j.values())
