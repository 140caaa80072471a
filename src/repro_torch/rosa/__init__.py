"""The rosa package: execution plans, the Engine and compiled Programs over
the optical backends (PyTorch port of `repro.rosa`).

  `ExecutionPlan`  layer name -> `RosaConfig` (default + overrides; the
                   hybrid IS/WS mapping is an override set); `to_json` /
                   `from_json` round-trip it
  `Engine`         routes every named matmul: resolves its config, folds a
                   per-layer/per-step key, records the GEMM on an optional
                   `EnergyLedger`, dispatches to the registered backend
  `Program`        `rosa.compile`: trace on meta tensors, autotune the
                   hybrid plan (EDP-only or accuracy-aware from a
                   degradation matrix or `DegradationSource`), persist it
                   in the on-disk `PlanCache` (`$ROSA_PLAN_CACHE`), freeze

`use_engine` / `current_engine` are the reference's deprecated aliases of
`engine_context` / `ambient_engine`.
"""

from repro_torch.rosa import serialize
from repro_torch.rosa.backends import (DEFAULT, RosaConfig, backend_names,
                                       register_backend, resolve_backend,
                                       rosa_matmul)
from repro_torch.rosa.engine import (Engine, ambient_engine, current_engine,
                                     engine_context, layer_key, use_engine)
from repro_torch.rosa.ledger import EnergyLedger, MatmulEvent
from repro_torch.rosa.plan import ExecutionPlan
from repro_torch.rosa.program import (EDP_ONLY, AutotuneConfig,
                                      DegradationSource, PlanCache, Program,
                                      ProgramTrace, TraceEntry, capture_trace,
                                      compile, default_cache_dir)

__all__ = [
    "DEFAULT", "EDP_ONLY", "AutotuneConfig", "DegradationSource", "Engine",
    "EnergyLedger", "ExecutionPlan", "MatmulEvent", "PlanCache", "Program",
    "ProgramTrace", "RosaConfig", "TraceEntry", "ambient_engine",
    "backend_names", "capture_trace", "compile", "current_engine",
    "default_cache_dir", "engine_context", "layer_key", "register_backend",
    "resolve_backend", "rosa_matmul", "serialize", "use_engine",
]
