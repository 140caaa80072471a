"""repro_torch.serve — continuous-batching serving over the optical Engine
(PyTorch port of `repro.serve`).

  `ServeConfig`      slots / cache capacity / prefill chunking / sampling /
                     optical-engine knobs
  `Scheduler`        slot-based continuous batching (and the static
                     "oneshot" baseline) with per-tick prefill chunks and
                     in-step slot refill
  `run_sequential`   the per-request oracle the scheduler is held against
  `poisson_requests` reproducible synthetic load (Poisson arrivals)
  `TickHook`         per-tick scheduler extension (extra decode-step args,
                     an end-of-tick callback)

`serve.adaptive` is closed-loop drift-adaptive serving on top
(`python -m repro_torch.serve.adaptive`).
"""

from repro_torch.serve.config import ServeConfig, serving_model_config
from repro_torch.serve.loadgen import poisson_requests
from repro_torch.serve.metrics import (build_serving_engine,
                                       build_serving_program, report_metrics,
                                       trace_serving_shapes)
from repro_torch.serve.scheduler import (Completion, Request, Scheduler,
                                         ServeReport, TickHook,
                                         run_sequential, serving_program)

__all__ = [
    "Completion", "Request", "Scheduler", "ServeConfig", "ServeReport",
    "TickHook", "build_serving_engine", "build_serving_program",
    "poisson_requests", "report_metrics", "run_sequential",
    "serving_model_config", "serving_program", "trace_serving_shapes",
]
