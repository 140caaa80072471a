"""The rosa package: execution plans, the Engine and compiled Programs over
the optical backends (PyTorch port of `repro.rosa`).

  `ExecutionPlan`  layer name -> `RosaConfig` (default + overrides; the
                   hybrid IS/WS mapping is an override set)
  `Engine`         routes every named matmul: resolves its config, folds a
                   per-layer/per-step key, records the GEMM on an optional
                   `EnergyLedger`, dispatches to the registered backend
  `Program`        `rosa.compile`: trace on meta tensors, autotune the
                   hybrid plan by EDP, freeze
"""

from repro_torch.rosa.backends import (DEFAULT, RosaConfig, backend_names,
                                       register_backend, resolve_backend,
                                       rosa_matmul)
from repro_torch.rosa.engine import (Engine, ambient_engine, engine_context,
                                     layer_key)
from repro_torch.rosa.ledger import EnergyLedger, MatmulEvent
from repro_torch.rosa.plan import ExecutionPlan
from repro_torch.rosa.program import (AutotuneConfig, Program, ProgramTrace,
                                      TraceEntry, capture_trace, compile)

__all__ = [
    "DEFAULT", "AutotuneConfig", "Engine", "EnergyLedger", "ExecutionPlan",
    "MatmulEvent", "Program", "ProgramTrace", "RosaConfig", "TraceEntry",
    "ambient_engine", "backend_names", "capture_trace", "compile",
    "engine_context", "layer_key", "register_backend", "resolve_backend",
    "rosa_matmul",
]
