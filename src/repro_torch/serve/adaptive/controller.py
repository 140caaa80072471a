"""The closed loop: drift step, HEALTHY→DEGRADED→RETRIM→REPLAN controller
(PyTorch port of `repro.serve.adaptive.controller`).

`make_drift_step` is the plant model: the scheduler's decode step with the
thermal residual as one extra argument.  Each tick the pinned chip's
`StaticVariation` is shifted by the residual (`robust.variation.
shift_thermal`) and goes into the optical backend through the same chip
operands as an unshifted one.

`AdaptiveController` is a `serve.TickHook`.  Per tick it feeds the
residual into the decode step (`step_args`) and, between ticks
(`on_tick_end`), folds a temperature-sensor reading into the detector,
probes on idle slots, and acts:

  HEALTHY   probes agree with the golden reference; no action
  DEGRADED  CUSUM fired: apply `trim_voltages` at the predicted
            temperature (an actuator write: the programmed voltages absorb
            the estimated offset, leaving only tracking error as residual)
            and ENGAGE the thermal servo: from here on the trim follows the
            alpha-beta prediction every tick (within a deadband)
  RETRIM    servo engaged, validating: back to HEALTHY once probes
            re-enter the slack band (the servo stays engaged); REPLAN if
            agreement stays below the guard floor even with a fresh trim
  REPLAN    re-measure the degradation matrix at the live residual, store
            it in the `PlanCache`, re-run the accuracy-aware plan search,
            and swap the serving `Program` double-buffered: the new decode
            step is built and warmed BEFORE the pointer swap, which happens
            between ticks; in-flight slots carry over untouched and no
            request is dropped or perturbed.

`DriftMonitor` is the uncontrolled arm of the A/B: the same drift
injection and probe cadence, no actions.
"""

from __future__ import annotations

import dataclasses
import enum
import time

import numpy as np
import torch

from repro_torch.core import mrr
from repro_torch.core.constants import ROSA_OPTIMAL
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs
from repro_torch.robust import variation as V
from repro_torch.rosa.engine import engine_context
from repro_torch.serve.adaptive.detector import DetectorConfig, DriftDetector
from repro_torch.serve.adaptive.probes import ProbeSet
from repro_torch.serve.decode import (DecodeState, _step_body,
                                      make_admit_step, make_chunk_fn,
                                      make_evict, make_whole_fn, null_admit)
from repro_torch.serve.scheduler import TickHook, _ledger_scope


def make_drift_step(bundle, scfg, program):
    """The serving decode step with a thermal residual [K].

    Signature: `step(params, state, admit, temperature, resid_k)`, a
    drop-in for `Scheduler.step` when a `TickHook.step_args` supplies the
    trailing scalar.  The engine is installed around the body (as
    `Program.bind` does) with the pinned chip shifted by `resid_k`."""
    engine = program.engine
    chip = dict(engine.variation or {})

    def step(params, state, admit, temperature, resid_k):
        eng = engine
        if chip:
            eng = engine.with_variation(V.shift_thermal(chip, resid_k))
        with engine_context(eng):
            return _step_body(bundle, scfg, params, state, admit,
                              temperature)

    return step


class ControllerState(enum.IntEnum):
    """Gauge-friendly controller states (`serve.adaptive.state`)."""

    HEALTHY = 0
    DEGRADED = 1
    RETRIM = 2
    REPLAN = 3


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Closed-loop policy knobs."""

    probe_every: int = 4        # ticks between probe attempts
    starve_factor: int = 4      # probe anyway after this many skipped
    #                             windows with no idle slot (never go blind)
    warmup_ticks: int = 4       # no probes before this tick: lets the
    #                             temperature filter settle and keeps an
    #                             epoch of bit-exact pre-action traffic
    guard_agreement: float = 0.60   # post-retrim floor: below this a FRESH
    #                                 trim did not save us -> REPLAN
    trim_slack_k: float = 0.08      # REPLAN only once the applied trim
    #                                 matches the temperature estimate this
    #                                 closely (a stale trim means re-trim)
    trim_deadband_k: float = 0.005   # the servo writes the trim only when
    #                                 the prediction moved this far
    allow_replan: bool = True
    force_replan_at: int | None = None   # deterministic swap trigger


def _residual_arg(resid_k: float) -> float:
    """The residual as the decode step takes it: rounded to float32, the
    precision of the chip fields it shifts."""
    return float(np.float32(resid_k))


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zeros_like(v) for v in tree)
    return torch.zeros_like(tree)


class DriftMonitor(TickHook):
    """Uncontrolled arm: inject drift, probe, record; never act.

    Owns everything the A/B shares with the controller: the drift step
    installation, the probe cadence and the telemetry series, so the two
    arms differ ONLY in the corrective actions."""

    def __init__(self, sched, env, probes: ProbeSet | None = None,
                 cfg: ControllerConfig = ControllerConfig()):
        if sched.program is None:
            raise ValueError("adaptive serving needs scfg.rosa=True "
                             "(the scheduler must carry a rosa.Program)")
        self.env = env
        self.cfg = cfg
        self.probes = probes if probes is not None \
            else ProbeSet(sched.bundle, sched.program)
        # idempotent install: the A/B harness runs two hooks over ONE
        # scheduler, and both arms must share the same step
        if getattr(sched, "_drift_program", None) is not sched.program:
            sched.step = make_drift_step(sched.bundle, sched.scfg,
                                         sched.program)
            sched._drift_program = sched.program
        self.trim_k = 0.0
        self.first_action_tick = 10 ** 9    # no action yet
        # drift-free reference: the health bar every probe is scored against
        self.ref_agreement = self.probes.agreement(sched.params, 0.0)
        self.series: list[dict] = []        # one row per executed probe
        self.tick_wall_s: list[float] = []
        self.retrims = 0
        self.replans = 0
        self.swaps: list[dict] = []
        self._last_probe = -10 ** 9
        self._last_wall: float | None = None

    # -- TickHook protocol --------------------------------------------------
    def step_args(self, tick: int) -> tuple:
        """The plant: physical residual = true drift minus applied trim."""
        return (_residual_arg(self.env.residual(tick, self.trim_k)),)

    def on_tick_end(self, sched, tick, state, idle_slots) -> None:
        now = time.perf_counter()
        if self._last_wall is not None:
            self.tick_wall_s.append(now - self._last_wall)
        self._last_wall = now
        if self._probe_due(tick, idle_slots):
            self._last_probe = tick
            resid = self.env.residual(tick, self.trim_k)
            with obs.span("adaptive.probe", "adaptive", tick=tick):
                agree = self.probes.agreement(sched.params, resid,
                                              tick=tick)
            self.series.append({"tick": tick, "resid_k": resid,
                                "agreement": agree,
                                "trim_k": self.trim_k,
                                "energy_per_token_j": _energy(sched)})
            self._after_probe(sched, tick, state, agree)

    # -- shared helpers -----------------------------------------------------
    def _probe_due(self, tick: int, idle_slots: int) -> bool:
        """Piggyback rule: probe on cadence when a decode slot idles; the
        starvation override keeps a saturated fleet from going blind."""
        if tick < self.cfg.warmup_ticks:
            return False
        since = tick - self._last_probe
        if since < self.cfg.probe_every:
            return False
        return idle_slots > 0 \
            or since >= self.cfg.probe_every * self.cfg.starve_factor

    def _after_probe(self, sched, tick, state, agreement: float) -> None:
        """Monitor: record only."""

    @property
    def mean_agreement(self) -> float:
        if not self.series:
            return float("nan")
        return sum(r["agreement"] for r in self.series) / len(self.series)


class AdaptiveController(DriftMonitor):
    """The acting arm: detector + state machine + program swap."""

    def __init__(self, sched, env, probes: ProbeSet | None = None,
                 cfg: ControllerConfig = ControllerConfig(),
                 det_cfg: DetectorConfig = DetectorConfig(),
                 plan_cache=None):
        super().__init__(sched, env, probes, cfg)
        self.detector = DriftDetector(det_cfg, self.ref_agreement)
        self.state = ControllerState.HEALTHY
        self.tracking = False     # thermal servo engaged (sticky)
        self.trim_updates = 0     # actuator writes, servo follow-ups too
        self.plan_cache = plan_cache
        reg = obs_metrics.registry()
        self._g_state = reg.gauge("serve.adaptive.state")
        self._g_drift = reg.gauge("serve.adaptive.drift_est_k")
        self._c_retrim = reg.counter("serve.adaptive.retrims")
        self._c_replan = reg.counter("serve.adaptive.replans")
        self._g_state.set(int(self.state))

    def on_tick_end(self, sched, tick, state, idle_slots) -> None:
        # one sensor reading every tick keeps the tracking estimate fresh
        self._g_drift.set(self.detector.observe_temp(self.env.sense(tick)))
        # probe FIRST (it scores the trim that served this tick), THEN let
        # the servo re-aim the trim at the next tick's predicted temperature
        super().on_tick_end(sched, tick, state, idle_slots)
        if self.tracking:
            target = self.detector.predict()
            if abs(target - self.trim_k) > self.cfg.trim_deadband_k:
                self._write_trim(target, tick)
        if self.cfg.force_replan_at is not None \
                and tick == self.cfg.force_replan_at and not self.replans:
            self._replan(sched, tick, state)

    def _after_probe(self, sched, tick, state, agreement: float) -> None:
        det = self.detector
        fired = det.update(agreement)
        in_band = (det.ref - agreement) <= det.cfg.cusum_k
        if self.state in (ControllerState.HEALTHY, ControllerState.REPLAN):
            if fired:
                self._transition(ControllerState.DEGRADED, tick)
                self._retrim(tick)
            elif self.state is ControllerState.REPLAN and in_band:
                self._transition(ControllerState.HEALTHY, tick)
        elif self.state is ControllerState.RETRIM:
            trim_fresh = abs(det.predict() - self.trim_k) \
                <= self.cfg.trim_slack_k
            if in_band:
                det.reset()
                self._transition(ControllerState.HEALTHY, tick)
            elif agreement < self.cfg.guard_agreement and trim_fresh \
                    and self.cfg.allow_replan:
                # trimmed at the best available estimate and STILL below
                # guard: thermal compensation is out of ammunition
                self._replan(sched, tick, state)

    # -- actions ------------------------------------------------------------
    def _transition(self, to: ControllerState, tick: int) -> None:
        self.state = to
        self._g_state.set(int(to))
        obs.instant(f"adaptive.{to.name.lower()}", cat="adaptive",
                    tick=tick)

    def _write_trim(self, target_k: float, tick: int) -> None:
        """One actuator write: program trim voltages for `target_k`.  By the
        trim identity (`voltage_of_weight(dt_trim=d)` under offset d equals
        the untrimmed chain under offset 0) this is `trim_k = target` on
        the injected residual."""
        self.trim_k = float(target_k)
        self.first_action_tick = min(self.first_action_tick, tick)
        self.trim_updates += 1

    def _retrim(self, tick: int) -> None:
        """Trim at the predicted temperature and engage the servo."""
        self._write_trim(self.detector.predict(), tick)
        self.tracking = True
        self.retrims += 1
        self._c_retrim.inc()
        self.detector.reset()
        self._transition(ControllerState.RETRIM, tick)

    def _replan(self, sched, tick, state) -> None:
        """Measure → search → compile → warm → swap, all between ticks."""
        from repro_torch import rosa
        from repro_torch.serve.metrics import abstract_decode_batch

        t0 = time.perf_counter()
        self.first_action_tick = min(self.first_action_tick, tick)
        self._transition(ControllerState.REPLAN, tick)
        resid = self.env.residual(tick, self.trim_k)
        with obs.span("adaptive.replan", "adaptive", tick=tick):
            rows = self.probes.degradation_rows(sched.params, resid,
                                                tick=tick)
            base_cfg = sched.program.engine.plan.default
            store = rosa.PlanCache() if self.plan_cache is None \
                else self.plan_cache
            spec = {"kind": "serve-adaptive",
                    "model": sched.bundle.cfg.name,
                    "n_probes": self.probes.cfg.n_probes,
                    "prompt_len": self.probes.cfg.prompt_len,
                    "seed": self.probes.cfg.seed,
                    "rng": mrr.rng_family(sched.device),
                    "resid_mk": round(resid * 1e3)}
            store.store_matrix(rosa.PlanCache.matrix_key(base_cfg, spec),
                               rows)
            bundle, scfg = sched.bundle, sched.scfg
            new_prog = rosa.compile(
                lambda eng, p, b: bundle.decode_step(p, b),
                rosa.Engine.from_config(base_cfg),
                (bundle.abstract(torch.float32),
                 abstract_decode_batch(bundle.cfg, scfg)),
                autotune=rosa.AutotuneConfig(ope=ROSA_OPTIMAL, batch=1),
                degradation=rows, cache=store, device=sched.device)
            new_prog = new_prog.with_variation(self.probes.chip) \
                .with_ledger(rosa.EnergyLedger())
            # double buffer: build and warm the new step on a dummy state
            # of the live state's shapes BEFORE any pointer moves
            new_step = make_drift_step(bundle, scfg, new_prog)
            dummy = DecodeState(**{
                f.name: _zeros_like(getattr(state, f.name))
                if f.name != "seed" else state.seed
                for f in dataclasses.fields(DecodeState)})
            with _ledger_scope(new_prog.engine, "decode"):
                warm_state, _ = new_step(sched.params, dummy, null_admit(),
                                         scfg.temperature,
                                         _residual_arg(resid))
            if sched.device.type == "cuda":
                torch.cuda.synchronize(sched.device)
            del dummy, warm_state
            new_admit = make_admit_step(bundle, scfg, program=new_prog)
            new_chunk = make_chunk_fn(bundle, program=new_prog)
            new_whole = make_whole_fn(bundle, program=new_prog)
            new_evict = make_evict(bundle, scfg, program=new_prog) \
                if scfg.evict_on_done else None
            # the swap: host-side pointer writes between ticks; in-flight
            # slots (the DecodeState) carry over untouched
            sched.program, sched.engine = new_prog, new_prog.engine
            sched.step = new_step
            sched.admit_step = new_admit
            sched.chunk_fn = new_chunk
            sched.whole_fn = new_whole
            sched.evict = new_evict
            sched._drift_program = new_prog
            self.probes.rebind(new_prog)
        self.replans += 1
        self._c_replan.inc()
        self.detector.reset()
        self.swaps.append({"tick": tick, "wall_s": time.perf_counter() - t0,
                           "downtime_ticks": 0,
                           "plan": {n: m.value for n, m in
                                    new_prog.engine.plan.mapping_plan()
                                    .items()}})


def _energy(sched) -> float:
    """Energy per generated token [J] of the CURRENT program's decode trace
    (0.0 until the first decode step ran)."""
    ledger = sched.engine.ledger if sched.engine is not None else None
    if ledger is None:
        return 0.0
    try:
        return float(ledger.per_token(ROSA_OPTIMAL,
                                      batch=sched.scfg.n_slots))
    except (ValueError, ZeroDivisionError):
        return 0.0
