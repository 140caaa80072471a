"""Closed-loop drift-adaptive serving: detect → re-trim → re-plan (PyTorch
port of `repro.serve.adaptive`).

The serving chip drifts thermally mid-traffic; this package keeps it
accurate without dropping a request.  Golden-token probes piggyback on
idle decode slots (`probes`), an alpha-beta tracker and a CUSUM decide
when drift is real (`detector`), and a HEALTHY→DEGRADED→RETRIM→REPLAN
state machine first re-trims the ring voltages at the estimated
temperature, then, if accuracy stays below guard, re-selects the hybrid
plan through the plan cache and swaps the serving `rosa.Program` between
ticks (`controller`).  `scenario` is the A/B harness and
`python -m repro_torch.serve.adaptive` the CLI.
"""

from repro_torch.serve.adaptive.controller import (AdaptiveController,
                                                   ControllerConfig,
                                                   ControllerState,
                                                   DriftMonitor,
                                                   make_drift_step)
from repro_torch.serve.adaptive.detector import DetectorConfig, DriftDetector
from repro_torch.serve.adaptive.probes import (ProbeConfig, ProbeSet,
                                               plan_selector)
from repro_torch.serve.adaptive.scenario import (DriftEnv, ScenarioConfig,
                                                 ScenarioParts,
                                                 ScenarioResult,
                                                 drift_serve_metrics,
                                                 run_arm, run_parts,
                                                 run_scenario,
                                                 scenario_metrics,
                                                 scenario_parts)

__all__ = [
    "AdaptiveController", "ControllerConfig", "ControllerState",
    "DetectorConfig", "DriftDetector", "DriftEnv", "DriftMonitor",
    "ProbeConfig", "ProbeSet", "ScenarioConfig", "ScenarioParts",
    "ScenarioResult", "drift_serve_metrics", "make_drift_step",
    "plan_selector", "run_arm", "run_parts", "run_scenario",
    "scenario_metrics", "scenario_parts",
]
