"""`rosa.Program` — compile-once programs with an autotuned hybrid plan
(PyTorch port of the part of `repro.rosa.program` that serving uses).

`compile(apply_fn, engine, example_args, autotune=...)` is three steps:

  1. **Trace** — `apply_fn(engine, *example_args)` runs once on `meta`
     tensors with a recording engine installed; every named matmul the
     engine routes lands in a `ProgramTrace` and no arithmetic runs, so a
     full-width model traces in milliseconds.
  2. **Autotune** — with an `AutotuneConfig`, the layer-wise hybrid IS/WS
     plan is searched on the traced GEMMs by EDP (`core.mapping`,
     degradation muted: the plan is the per-layer EDP argmin, the plan the
     reference's `profile_layers_fast` search gives without a degradation
     matrix).
  3. **Freeze** — the plan is installed on the engine, the trace is priced
     onto the engine's ledger when it carries a fresh one, and the returned
     `Program` runs `apply_fn` (or, via `bind`, any step function) with
     that engine installed as the ambient context.

Not ported yet: the on-disk `PlanCache` (compilation behaves as the
reference's `cache=False`), plan serialization, `verify=` and
accuracy-aware search from degradation matrices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from repro_torch.core import energy as E
from repro_torch.core import mapping as M
from repro_torch.core.constants import ROSA_OPTIMAL, ComputeMode, OPEConfig
from repro_torch.rosa.engine import Engine, engine_context
from repro_torch.rosa.ledger import EnergyLedger
from repro_torch.rosa.plan import ExecutionPlan

ApplyFn = Callable[..., Any]


@dataclasses.dataclass(frozen=True)
class TraceEntry:
    """One distinct routed GEMM: layer name, shape, recorded call count."""

    name: str
    m: int
    k: int
    n: int
    count: int = 1

    def layer_shape(self) -> E.LayerShape:
        return E.LayerShape(self.name, m=self.m, k=self.k, n=self.n,
                            kind="gemm")


@dataclasses.dataclass(frozen=True)
class ProgramTrace:
    """The named-matmul trace of one abstract program evaluation."""

    entries: tuple[TraceEntry, ...] = ()

    def layer_shapes(self) -> list[E.LayerShape]:
        return [e.layer_shape() for e in self.entries]

    def __len__(self) -> int:
        return len(self.entries)

    @classmethod
    def from_ledger(cls, ledger: EnergyLedger) -> "ProgramTrace":
        """Collapse the ledger's events into counted entries, first-seen
        order preserved."""
        counts: dict[tuple, int] = {}
        for ev in ledger.events:
            k = (ev.name, ev.m, ev.k, ev.n)
            counts[k] = counts.get(k, 0) + 1
        return cls(tuple(TraceEntry(name, m, k, n, c)
                         for (name, m, k, n), c in counts.items()))


def _abstract_run(apply_fn: ApplyFn, engine: Engine, args) -> None:
    with torch.no_grad(), engine_context(engine):
        apply_fn(engine, *args)


def capture_trace(apply_fn: ApplyFn, engine: Engine,
                  example_args: Sequence[Any]) -> ProgramTrace:
    """Run `apply_fn` once on the (meta-tensor) example arguments with a
    private recording ledger and capture its routed matmuls."""
    recorder = EnergyLedger()
    _abstract_run(apply_fn, engine.with_ledger(recorder), example_args)
    return ProgramTrace.from_ledger(recorder)


@dataclasses.dataclass(frozen=True)
class AutotuneConfig:
    """Workload-aware hybrid-mapping search settings (EDP only: the
    accuracy term waits for the degradation matrices of `robust`)."""

    ope: OPEConfig = ROSA_OPTIMAL
    batch: int = 1
    mode: ComputeMode = ComputeMode.MIXED
    osa: E.OSAEnergyConfig = E.OSA_OPTIMAL


class Program:
    """A compiled optical program: the frozen engine (tuned plan, pinned
    chip, ledger) its step functions run under.

    Call it like the traced function minus the engine argument,
    ``program(*args, key=..., variation=...)``, with an optional base key
    (per-layer keys fold inside the engine) and an optional pinned chip;
    `bind(fn)` installs the engine around any other function."""

    def __init__(self, apply_fn: ApplyFn, engine: Engine,
                 trace: ProgramTrace):
        self.apply_fn = apply_fn
        self.engine = engine
        self.trace = trace

    def __call__(self, *args, key: torch.Generator | None = None,
                 variation=None):
        eng = self.engine
        if key is not None:
            eng = eng.with_key(key)
        if variation is not None:
            eng = eng.with_variation(variation)
        with engine_context(eng):
            return self.apply_fn(eng, *args)

    @property
    def plan(self) -> ExecutionPlan:
        return self.engine.plan

    @property
    def ledger(self) -> EnergyLedger | None:
        """The frozen engine's ledger (None when unattached)."""
        return self.engine.ledger

    def with_engine(self, engine: Engine) -> "Program":
        return Program(self.apply_fn, engine, self.trace)

    def with_variation(self, variation) -> "Program":
        return self.with_engine(self.engine.with_variation(variation))

    def with_ledger(self, ledger: EnergyLedger | None) -> "Program":
        return self.with_engine(self.engine.with_ledger(ledger))

    def bind(self, fn: Callable) -> Callable:
        """`fn` run with this program's engine installed as the ambient
        context (how the serving scheduler builds its steps)."""
        engine = self.engine

        def wrapped(*args, **kwargs):
            with engine_context(engine):
                return fn(*args, **kwargs)

        return wrapped


def compile(apply_fn: ApplyFn, engine: Engine,
            example_args: Sequence[Any] = (), *,
            autotune: AutotuneConfig | None = None) -> Program:
    """Compile `apply_fn` against `engine` into a frozen `Program`.

    `example_args` are tensors (use `meta` tensors: they are only traced).
    With `autotune` the traced workload drives the hybrid IS/WS plan search
    seeded from `engine.plan.default`; without it the plan is taken as-is.
    """
    example_args = tuple(example_args)
    trace = capture_trace(apply_fn, engine, example_args)
    if autotune is not None:
        base_cfg = engine.plan.default
        if base_cfg is None:
            raise ValueError(
                "autotune needs engine.plan.default (the base RosaConfig the "
                "search specializes per layer); pass autotune=None to freeze "
                "the plan as-is")
        if len(trace) == 0:
            plan = engine.plan
        else:
            profiles = M.profile_layers(
                trace.layer_shapes(), autotune.ope, lambda name, m: 0.0,
                mode=autotune.mode, osa=autotune.osa, batch=autotune.batch)
            plan = ExecutionPlan.from_mapping_plan(base_cfg,
                                                   M.hybrid_plan(profiles))
        engine = engine.with_plan(plan)
    # final abstract pass under the frozen plan: checks every traced layer
    # resolves, and prices the trace onto a FRESH ledger (a ledger already
    # carrying runtime events is left alone)
    if autotune is not None or engine.ledger is not None:
        final = engine
        if final.ledger is not None and len(final.ledger.events):
            final = final.with_ledger(None)
        _abstract_run(apply_fn, final, example_args)
    return Program(apply_fn, engine, trace)
