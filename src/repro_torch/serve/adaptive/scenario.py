"""Drift scenarios: plant and sensor model, the A/B harness, bench metrics
(PyTorch port of `repro.serve.adaptive.scenario`).

`DriftEnv` is the physical world the controller lives in: a ground-truth
`robust.drift.DriftModel` schedule sampled per scheduler tick through
`offsets_at`, and a noisy temperature sensor (the only thermal signal the
controller reads; ground truth reaches ONLY the plant-side residual).

`run_scenario` serves one Poisson request stream twice over the SAME drift
step: uncontrolled (`DriftMonitor`) first, then closed-loop
(`AdaptiveController`), and scores the A/B: recovered accuracy, dropped
requests, bit-exactness of every request that finished inside the first
plan epoch, and swap downtime.  Generation budgets (not sampled EOS
tokens) end requests, so both arms run the same schedule tick for tick.
`scenario_parts` / `run_parts` are its two halves, for callers that build
the scheduler from another model configuration or carry parameters in;
`run_arm` serves one arm, for callers that measure each arm on its own.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.bench.schema import Metric
from repro_torch.core import mrr
from repro_torch.robust.drift import DriftModel
from repro_torch.serve.adaptive.controller import (AdaptiveController,
                                                   ControllerConfig,
                                                   DriftMonitor)
from repro_torch.serve.adaptive.probes import ProbeConfig, ProbeSet
from repro_torch.serve.config import ServeConfig


class DriftEnv:
    """Plant + sensor.  `residual(tick, trim)` is what physically reaches
    the rings (drift minus the actuated trim); `sense(tick)` the noisy
    reading the controller estimates from.  The walk and the sensor noise
    come from two host generators split from `seed` (the reference splits
    its key the same way; the draws are torch's, not threefry's)."""

    def __init__(self, model: DriftModel, *, tick_s: float = 30.0,
                 sensor_sigma_k: float = 0.02,
                 horizon_ticks: int = 4096, seed: int = 0):
        self.model = model
        self.tick_s = tick_s
        self.sensor_sigma_k = sensor_sigma_k
        self.horizon_ticks = horizon_ticks
        self._k_walk, self._k_sense = mrr.split(
            torch.Generator().manual_seed(seed))
        self._grid = np.arange(horizon_ticks, dtype=np.float64) * tick_s
        self._cache: dict[int, float] = {}

    def true_offset(self, tick: int) -> float:
        """Ground-truth d(t) [K] at a tick (plant side only)."""
        tick = min(int(tick), self.horizon_ticks - 1)
        if tick not in self._cache:
            self._cache[tick] = float(self.model.offsets_at(
                tick * self.tick_s, key=self._k_walk, t_grid=self._grid))
        return self._cache[tick]

    def residual(self, tick: int, trim_k: float) -> float:
        """What reaches the rings: drift minus the applied trim."""
        return self.true_offset(tick) - trim_k

    def sense(self, tick: int) -> float:
        """One temperature-sensor reading (deterministic per tick)."""
        n = float(mrr.normal(mrr.fold_in(self._k_sense, tick), ()))
        return self.true_offset(tick) + self.sensor_sigma_k * n


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """One drift-serving experiment (a scenario IS its config)."""

    arch: str = "qwen3-32b"         # smoke-config registry name
    kind: str = "sine"              # drift schedule: sine | linear | walk
    amp_k: float = 0.6              # peak thermal offset [K]
    period_ticks: float = 96.0      # schedule period/horizon in ticks
    tick_s: float = 30.0            # wall seconds one tick models
    sensor_sigma_k: float = 0.02    # temperature-sensor noise [K]
    n_requests: int = 16
    rate: float = 0.5               # Poisson arrivals per tick
    n_slots: int = 4
    max_len: int = 56
    prefill_chunk: int = 8
    variation_seed: int = 0         # pinned fabricated chip
    seed: int = 0
    probe_every: int = 2
    n_probes: int = 16
    prompt_len: int = 4
    warmup_ticks: int = 6
    force_replan_at: int | None = None


@dataclasses.dataclass
class ScenarioResult:
    """The A/B verdict plus both raw arms."""

    cfg: ScenarioConfig
    ref_agreement: float            # drift-free probe agreement (a0)
    rep_uncontrolled: object
    rep_controlled: object
    monitor: DriftMonitor
    controller: AdaptiveController
    first_action_tick: int
    sched: object = None            # the (post-swap) serving scheduler

    @classmethod
    def from_arms(cls, cfg: ScenarioConfig, sched, uncontrolled: tuple,
                  controlled: tuple) -> "ScenarioResult":
        """The verdict of two `run_arm` results, (monitor, report) and
        (controller, report), served by `sched`."""
        (monitor, rep_u), (controller, rep_c) = uncontrolled, controlled
        return cls(cfg=cfg, ref_agreement=monitor.ref_agreement,
                   rep_uncontrolled=rep_u, rep_controlled=rep_c,
                   monitor=monitor, controller=controller,
                   first_action_tick=controller.first_action_tick,
                   sched=sched)

    @property
    def recovery(self) -> float:
        """Fraction of the uncontrolled accuracy loss the controller won
        back: 1 - (lost with controller) / (lost without)."""
        lost_u = self.ref_agreement - self.monitor.mean_agreement
        lost_c = self.ref_agreement - self.controller.mean_agreement
        if lost_u <= 1e-9:
            return 1.0
        return 1.0 - lost_c / lost_u

    def dropped_requests(self, requests) -> int:
        """Requests that did not deliver their full generation budget."""
        comps = self.rep_controlled.completions
        return sum(1 for r in requests
                   if len(comps[r.rid].tokens) != r.max_new_tokens)

    def epoch_bitexact(self) -> tuple[int, bool]:
        """(n, ok): token streams of requests fully served BEFORE the first
        controller action must equal the uncontrolled run's: the two arms
        are numerically identical until the controller first moves an
        actuator."""
        cu = self.rep_uncontrolled.completions
        cc = self.rep_controlled.completions
        n, ok = 0, True
        for rid, comp in cc.items():
            # actions land in on_tick_end, AFTER the action tick's decode:
            # a request finishing ON that tick is still pre-swap
            if 0 <= comp.done_tick <= self.first_action_tick:
                n += 1
                ok = ok and comp.tokens == cu[rid].tokens
        return n, ok

    def summary(self) -> dict:
        """One-level JSON-able scenario summary."""
        n_epoch, exact = self.epoch_bitexact()
        walls = np.asarray(self.controller.tick_wall_s or [0.0])
        return {
            "kind": self.cfg.kind, "amp_k": self.cfg.amp_k,
            "ref_agreement": self.ref_agreement,
            "uncontrolled_agreement": self.monitor.mean_agreement,
            "controlled_agreement": self.controller.mean_agreement,
            "recovery": self.recovery,
            "retrims": self.controller.retrims,
            "replans": self.controller.replans,
            "trim_updates": self.controller.trim_updates,
            "first_action_tick": self.first_action_tick,
            "epoch_requests": n_epoch, "epoch_bitexact": exact,
            "swap_downtime_ticks": max(
                [s["downtime_ticks"] for s in self.controller.swaps],
                default=0),
            "swap_wall_ms": max(
                [s["wall_s"] * 1e3 for s in self.controller.swaps],
                default=0.0),
            "p99_tick_ms": float(np.percentile(walls, 99) * 1e3),
            "final_state": self.controller.state.name,
        }


@dataclasses.dataclass
class ScenarioParts:
    """What `run_parts` drives: the scheduler, the request stream, the
    plant, the shared probe set and the controller settings."""

    sched: object
    requests: list
    env: DriftEnv
    probes: ProbeSet
    ccfg: ControllerConfig


def scenario_parts(model_cfg, cfg: ScenarioConfig, *, params=None,
                   chip=None, device: str | torch.device = "cuda"
                   ) -> ScenarioParts:
    """Build a scenario's parts for `model_cfg` as `run_scenario` does for
    the smoke config of ``cfg.arch``: `params` and `chip` (a
    `{name: StaticVariation}`) replace the seeded ones when given."""
    from repro_torch.serve.loadgen import poisson_requests
    from repro_torch.serve.scheduler import Scheduler

    # "auto": the rosa_fused kernel on CUDA, the reference's "ref" pipeline
    # on the CPU
    scfg = ServeConfig(n_slots=cfg.n_slots, max_len=cfg.max_len,
                       prefill_chunk=cfg.prefill_chunk, seed=cfg.seed,
                       rosa=True, rosa_backend="auto",
                       variation_seed=cfg.variation_seed)
    sched = Scheduler(model_cfg, scfg, params=params, init_seed=cfg.seed,
                      chip=chip, device=device)
    reqs = poisson_requests(cfg.n_requests, cfg.rate,
                            vocab=model_cfg.vocab, prompt_len=(4, 8),
                            gen_len=(2, 24), seed=cfg.seed)
    env = DriftEnv(
        DriftModel(kind=cfg.kind, amp_k=cfg.amp_k,
                   period_s=cfg.period_ticks * cfg.tick_s),
        tick_s=cfg.tick_s, sensor_sigma_k=cfg.sensor_sigma_k,
        seed=cfg.seed)
    probes = ProbeSet(sched.bundle, sched.program,
                      ProbeConfig(n_probes=cfg.n_probes,
                                  prompt_len=cfg.prompt_len,
                                  seed=cfg.seed + 2024))
    ccfg = ControllerConfig(probe_every=cfg.probe_every,
                            warmup_ticks=cfg.warmup_ticks,
                            force_replan_at=cfg.force_replan_at)
    return ScenarioParts(sched, reqs, env, probes, ccfg)


def run_arm(parts: ScenarioParts, controlled: bool) -> tuple:
    """Serve the stream once under a fresh hook: the uncontrolled
    `DriftMonitor`, or the `AdaptiveController` with a plan cache of its
    own; returns (hook, ServeReport)."""
    from repro_torch import rosa

    args = (parts.sched, parts.env, parts.probes, parts.ccfg)
    hook = AdaptiveController(*args, plan_cache=rosa.PlanCache(
        max_entries=256)) if controlled else DriftMonitor(*args)
    return hook, parts.sched.run(parts.requests, hook=hook)


def run_parts(parts: ScenarioParts, cfg: ScenarioConfig) -> tuple:
    """Serve the stream uncontrolled, then controlled; returns
    (ScenarioResult, requests)."""
    uncontrolled = run_arm(parts, controlled=False)
    controlled = run_arm(parts, controlled=True)
    return (ScenarioResult.from_arms(cfg, parts.sched, uncontrolled,
                                     controlled), parts.requests)


def run_scenario(cfg: ScenarioConfig = ScenarioConfig(),
                 device: str | torch.device = "cuda") -> tuple:
    """Serve the stream uncontrolled then controlled on the smoke config of
    ``cfg.arch``, on `device`; returns (ScenarioResult, requests)."""
    from repro_torch.configs import get_smoke

    return run_parts(scenario_parts(get_smoke(cfg.arch), cfg,
                                    device=device), cfg)


def drift_serve_metrics(quick: bool = True,
                        device: str | torch.device = "cuda") -> tuple:
    """The reference's `drift_serve` bench: sine drift, forced mid-stream
    replan; returns (ScenarioResult, [Metric]).  ``quick=False`` is the
    full-size scenario (16 requests)."""
    cfg = ScenarioConfig(force_replan_at=30) if not quick else \
        ScenarioConfig(n_requests=12, force_replan_at=30)
    res, reqs = run_scenario(cfg, device=device)
    return res, scenario_metrics(res, reqs)


def scenario_metrics(res: ScenarioResult, reqs) -> list[Metric]:
    """The `drift_serve` bench's metrics of one scenario run."""
    s = res.summary()
    n_epoch, exact = res.epoch_bitexact()
    return [
        Metric("recovery_frac", round(res.recovery, 4), "frac",
               gate=True, rel_tol=0.1, direction="higher_is_better"),
        Metric("recovery_ge_80pct", int(res.recovery >= 0.8), "bool",
               gate=True, rel_tol=0.0, direction="higher_is_better"),
        Metric("dropped_requests", res.dropped_requests(reqs), "requests",
               gate=True, rel_tol=0.0, direction="lower_is_better"),
        Metric("epoch_bitexact", int(exact), "bool",
               gate=True, rel_tol=0.0, direction="higher_is_better"),
        Metric("epoch_requests", n_epoch, "requests"),
        Metric("swap_downtime_ticks", s["swap_downtime_ticks"], "ticks",
               gate=True, rel_tol=0.0, direction="lower_is_better"),
        Metric("retrims", res.controller.retrims, "count",
               gate=True, rel_tol=0.0),
        Metric("replans", res.controller.replans, "count",
               gate=True, rel_tol=0.0),
        Metric("trim_updates", res.controller.trim_updates, "count"),
        Metric("uncontrolled_agreement",
               round(res.monitor.mean_agreement, 4), "frac",
               gate=True, rel_tol=0.05, direction="higher_is_better"),
        Metric("controlled_agreement",
               round(res.controller.mean_agreement, 4), "frac",
               gate=True, rel_tol=0.05, direction="higher_is_better"),
        Metric("ref_agreement", round(res.ref_agreement, 4), "frac"),
        Metric("swap_wall_ms", round(s["swap_wall_ms"], 2), "ms"),
        Metric("p99_tick_ms", round(s["p99_tick_ms"], 2), "ms"),
    ]
