"""`EnergyLedger` — trace-based energy accounting for the optical path
(PyTorch port of `repro.rosa.ledger`).

Every matmul routed through `rosa.Engine` records a `MatmulEvent` (layer
name, GEMM shape, mapping, compute mode) at trace time.  The ledger then
prices the *recorded* trace with the analytical event-count model
(core.energy.layer_energy), so EDP numbers are derived from the same call
sequence that produced the numerics — they cannot drift from a separately
maintained `LayerShape` list.

The reference records while JAX traces a step, so a jitted step records
once however often it runs, and a scanned layer stack records its body's
projections once.  The port runs eagerly and calls `record` on every
routed matmul; `record` keeps the first event of each (name, shape,
mapping, mode, tag) and drops its repeats, which is the event list the
reference's trace-time recording produces.  Canonical usage:

    ledger = EnergyLedger()
    engine = Engine.from_hybrid_plan(cfg, plan).with_ledger(ledger)
    forward(params, x)                        # meta tensors run no FLOPs
    print(ledger.edp(ROSA_OPTIMAL))
"""

from __future__ import annotations

import contextlib
import dataclasses

from repro_torch.core import energy as E
from repro_torch.core.constants import ComputeMode, Mapping, OPEConfig
from repro_torch.rosa.backends import RosaConfig


@dataclasses.dataclass(frozen=True)
class MatmulEvent:
    """One routed optical matmul, as seen at trace time."""

    name: str
    m: int
    k: int
    n: int
    mapping: Mapping
    mode: ComputeMode
    backend: str
    tag: str = ""          # attribution scope (e.g. "prefill" / "decode")

    def layer_shape(self) -> E.LayerShape:
        """This event as an energy-model LayerShape."""
        return E.LayerShape(self.name, m=self.m, k=self.k, n=self.n,
                            kind="gemm")


class EnergyLedger:
    """Accumulates MatmulEvents and prices them with core.energy.

    `scope(tag)` attributes every matmul recorded inside it to `tag` —
    serving traces its prefill and decode steps under distinct scopes, so
    per-request energy (prompt energy + tokens x decode-step energy) can be
    re-aggregated from one ledger without re-tracing.
    """

    def __init__(self):
        self.events: list[MatmulEvent] = []
        self._seen: set[tuple] = set()
        self._tag = ""

    @contextlib.contextmanager
    def scope(self, tag: str):
        """Attribute events recorded inside to `tag` (trace-time, nestable)."""
        prev, self._tag = self._tag, tag
        try:
            yield self
        finally:
            self._tag = prev

    def record(self, name: str, m: int, k: int, n: int,
               cfg: RosaConfig) -> None:
        """Append one matmul event, unless an identical one (same name,
        shape, mapping, mode and tag) is already recorded."""
        key = (name, m, k, n, cfg.mapping, cfg.mode, self._tag)
        if key in self._seen:
            return
        self._seen.add(key)
        self.events.append(MatmulEvent(
            name=name, m=m, k=k, n=n,
            mapping=cfg.mapping, mode=cfg.mode, backend=cfg.backend,
            tag=self._tag))

    # -- views --------------------------------------------------------------
    def unique_events(self, tag: str | None = None) -> list[MatmulEvent]:
        """The 'network' view used for EDP: one event per distinct
        (name, GEMM shape, mapping, mode, tag), order preserved.  Re-traces
        and MC loops of the same layer dedupe to one event; the same name
        traced at a DIFFERENT shape (e.g. a prefill trace then a decode
        trace) is a distinct workload and keeps its own event rather than
        being silently discarded — clear() between traces if you want only
        the latest.  `tag` filters to one attribution scope.
        """
        seen: dict[tuple, MatmulEvent] = {}
        for ev in self.events:
            if tag is not None and ev.tag != tag:
                continue
            seen[(ev.name, ev.m, ev.k, ev.n, ev.mapping, ev.mode,
                  ev.tag)] = ev
        return list(seen.values())

    # -- pricing ------------------------------------------------------------
    def breakdown(self, ope: OPEConfig,
                  osa: E.OSAEnergyConfig = E.OSA_OPTIMAL,
                  batch: int = 1, dedupe: bool = True,
                  tag: str | None = None) -> E.EnergyBreakdown:
        """Price the trace on an OPE fleet.  With dedupe (default) each named
        layer counts once — the sequential-network semantics of
        core.energy.network_energy; without it every recorded call counts.
        `tag` restricts pricing to one attribution scope.
        """
        if dedupe:
            events = self.unique_events(tag)
        else:
            events = [ev for ev in self.events
                      if tag is None or ev.tag == tag]
        total = E.EnergyBreakdown(name="trace")
        for ev in events:
            total = total + E.layer_energy(ev.layer_shape(), ope,
                                           ev.mapping, ev.mode, osa,
                                           batch=batch)
        return total

    def per_token(self, ope: OPEConfig,
                  osa: E.OSAEnergyConfig = E.OSA_OPTIMAL,
                  batch: int = 1, tag: str | None = "decode") -> float:
        """Energy [J] attributed to ONE generated token of ONE sequence.

        Prices the (deduped) events under `tag` — canonically the serving
        decode-step trace, which computes one token for each of `batch`
        concurrent slots — and splits the step energy evenly across the
        slots.  The traced events ALREADY carry the slot concurrency in
        their m dimension, so the trace is priced as-is (batch=1 —
        passing `batch` into layer_energy again would double-count it)
        and only the division spreads it over the slots.
        """
        bd = self.breakdown(ope, osa, batch=1, tag=tag)
        return bd.energy / max(batch, 1)

    def edp(self, ope: OPEConfig, osa: E.OSAEnergyConfig = E.OSA_OPTIMAL,
            batch: int = 1, dedupe: bool = True) -> float:
        """Energy-delay product [J*s] of the recorded trace; equals
        core.mapping.plan_edp on the same layers/plan by construction.
        """
        return self.breakdown(ope, osa, batch=batch, dedupe=dedupe).edp
