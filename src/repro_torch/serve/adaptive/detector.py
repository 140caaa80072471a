"""Drift detection: alpha-beta temperature tracker + CUSUM statistic (the
port's copy of `repro.serve.adaptive.detector`, plain Python).

Two independent signals feed the controller:

  * an alpha-beta (g-h) filter over the (noisy) temperature-sensor
    readings — a level + rate estimate of the thermal offset, so the
    one-tick-ahead `predict()` a re-trim programs into
    `voltage_of_weight(dt_trim=...)` leads a moving drift instead of
    lagging it (a plain EWMA trails a 2pi*amp/period ramp by ~1/alpha
    ticks, which is most of the residual budget at probe sensitivity);
  * a one-sided CUSUM over the probe-agreement DROP (reference minus
    measured, minus a slack `k`): transient single-probe noise is
    absorbed by the slack, while a sustained drop integrates past the
    threshold `h` and fires.

Hysteresis is explicit: once fired, the detector stays in the degraded
regime until `rearm` consecutive probes sit back inside the slack band —
so the controller never flaps around the threshold.  All state is plain
Python floats on the host; nothing here touches a tensor.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Detection thresholds (agreement in [0, 1] units, temps in K)."""

    ewma_alpha: float = 0.5    # level gain (1 = trust last reading)
    rate_beta: float = 0.3     # rate gain of the alpha-beta tracker
    cusum_k: float = 0.02      # slack: drops below this never accumulate
    cusum_h: float = 0.04      # decision threshold on the CUSUM sum
    rearm: int = 2             # consecutive in-band probes to re-arm


class DriftDetector:
    """Host-side detector state; `observe_temp` once per tick,
    `update` once per probe window."""

    def __init__(self, cfg: DetectorConfig, ref_agreement: float):
        self.cfg = cfg
        self.ref = float(ref_agreement)
        self.temp_estimate_k = 0.0   # filtered level [K]
        self.temp_rate_k = 0.0       # filtered rate [K per observation]
        self.cusum = 0.0
        self.fired = False
        self._seeded = False
        self._ok_streak = 0

    def observe_temp(self, sensed_k: float) -> float:
        """Predict-correct one sensor reading; returns the level."""
        a, b = self.cfg.ewma_alpha, self.cfg.rate_beta
        if not self._seeded:
            self.temp_estimate_k = float(sensed_k)
            self._seeded = True
        else:
            pred = self.temp_estimate_k + self.temp_rate_k
            r = float(sensed_k) - pred
            self.temp_estimate_k = pred + a * r
            self.temp_rate_k += b * r
        return self.temp_estimate_k

    def predict(self) -> float:
        """One-observation-ahead temperature [K] — what a trim applied
        between ticks should program for the NEXT tick's plant."""
        return self.temp_estimate_k + self.temp_rate_k

    def update(self, agreement: float) -> bool:
        """Fold one probe score; True while the degraded regime holds."""
        drop = self.ref - float(agreement)
        self.cusum = max(0.0, self.cusum + drop - self.cfg.cusum_k)
        if self.cusum > self.cfg.cusum_h:
            self.fired = True
            self._ok_streak = 0
        elif self.fired:
            if drop <= self.cfg.cusum_k:
                self._ok_streak += 1
                if self._ok_streak >= self.cfg.rearm:
                    self.reset()
            else:
                self._ok_streak = 0
        return self.fired

    def reset(self) -> None:
        """Re-arm after a successful corrective action (or hysteresis)."""
        self.cusum = 0.0
        self.fired = False
        self._ok_streak = 0
