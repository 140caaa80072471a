"""`rosa.Program` — compile-once programs with autotuned, disk-cached plans
(PyTorch port of `repro.rosa.program`).

`compile(apply_fn, engine, example_args, autotune=...)` is three steps:

  1. **Trace** — `apply_fn(engine, *example_args)` runs once on `meta`
     tensors with a recording engine installed; every named matmul the
     engine routes lands in a `ProgramTrace` and no arithmetic runs, so a
     full-width model traces in milliseconds.
  2. **Autotune** — with an `AutotuneConfig`, the layer-wise hybrid IS/WS
     plan is searched over the traced workload: EDP-only through
     `core.mapping.profile_layers_fast`, or accuracy-aware when a
     Monte-Carlo `degradation` matrix (`robust.sensitivity`) or a
     `DegradationSource` is supplied.  The searched plan is persisted in a
     content-addressed on-disk `PlanCache` keyed by hash(trace, RosaConfig,
     search settings, degradation), so a warm compile loads the plan and
     skips the search.  Keys, documents and the cache directory are the
     reference's: either package loads the plans the other stored.
  3. **Freeze** — the plan is installed on the engine, the trace is priced
     onto the engine's ledger when it carries a fresh one, and the returned
     `Program` runs `apply_fn` (or, via `bind`, any step function) with
     that engine installed as the ambient context.

`Program.plan` / `Program.lower()` expose the resolved plan for inspection
and JSON round-trip; `verify=` runs `repro_torch.analysis` over it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import tempfile
from typing import Any, Callable, Sequence

import torch

from repro_torch.core import energy as E
from repro_torch.core import mapping as M
from repro_torch.core.constants import ROSA_OPTIMAL, ComputeMode, OPEConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs
from repro_torch.rosa.engine import Engine, engine_context
from repro_torch.rosa.ledger import EnergyLedger
from repro_torch.rosa.plan import ExecutionPlan
from repro_torch.rosa.serialize import (canonical_json, config_to_json,
                                        content_hash, ope_from_json,
                                        osa_energy_from_json, to_jsonable)

# apply_fn(engine, *args) -> outputs.  The engine is handed in explicitly
# AND installed as the ambient context around the call, so explicit-engine
# models (cnn_apply) and ambient-engine models (the transformer stacks)
# compile through the same entry point.
ApplyFn = Callable[..., Any]


# ---------------------------------------------------------------------------
# ProgramTrace — the captured named-matmul workload
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TraceEntry:
    """One distinct routed GEMM: layer name, shape, recorded call count."""

    name: str
    m: int
    k: int
    n: int
    count: int = 1

    def layer_shape(self) -> E.LayerShape:
        """This entry as an energy-model LayerShape."""
        return E.LayerShape(self.name, m=self.m, k=self.k, n=self.n,
                            kind="gemm")


@dataclasses.dataclass(frozen=True)
class ProgramTrace:
    """The named-matmul trace of one abstract program evaluation."""

    entries: tuple[TraceEntry, ...] = ()

    @property
    def names(self) -> tuple[str, ...]:
        """Layer names in trace order."""
        return tuple(e.name for e in self.entries)

    def layer_shapes(self) -> list[E.LayerShape]:
        """LayerShapes of every traced entry."""
        return [e.layer_shape() for e in self.entries]

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def fingerprint(self) -> str:
        """Content hash of the trace (one input to the plan-cache key)."""
        return content_hash(self.to_json())

    # -- JSON round-trip -----------------------------------------------------
    def to_json(self) -> dict:
        """JSON-able dict of the trace."""
        return {"entries": [to_jsonable(e) for e in self.entries]}

    @classmethod
    def from_json(cls, doc: dict) -> "ProgramTrace":
        """Inverse of `to_json`."""
        return cls(tuple(TraceEntry(name=e["name"], m=int(e["m"]),
                                    k=int(e["k"]), n=int(e["n"]),
                                    count=int(e["count"]))
                         for e in doc["entries"]))

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
    private recording ledger and capture its routed matmuls.  Only matmuls
    the engine routes optically (resolved config not None) appear."""
    recorder = EnergyLedger()
    with obs.span("rosa.capture_trace", cat="compile"):
        _abstract_run(apply_fn, engine.with_ledger(recorder), example_args)
    return ProgramTrace.from_ledger(recorder)


# ---------------------------------------------------------------------------
# Autotune settings
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AutotuneConfig:
    """Workload-aware hybrid-mapping search settings.

    EDP profiling runs on the traced GEMMs through the vectorized energy
    model (`mapping.profile_layers_fast`).  Without a degradation matrix
    the accuracy term is muted and the plan is the per-layer EDP argmin;
    with one (`robust.sensitivity.degradation_matrix`) the balanced metric
    runs accuracy-aware, and `guard_pp` additionally vetoes any per-layer
    choice that costs more than `guard_pp` percentage points over that
    layer's most robust mapping (`sensitivity.accuracy_guarded_plan`).

    ``accuracy_aware`` (the default) lets a supplied degradation matrix or
    `DegradationSource` steer the search; ``accuracy_aware=False`` (the
    `EDP_ONLY` preset) mutes the accuracy term even when one is supplied:
    the search is then the per-layer EDP argmin and degradation inputs do
    not enter the cache key.
    """

    ope: OPEConfig = ROSA_OPTIMAL
    batch: int = 1
    mode: ComputeMode = ComputeMode.MIXED
    osa: E.OSAEnergyConfig = E.OSA_OPTIMAL
    guard_pp: float | None = None
    accuracy_aware: bool = True

    def to_json(self) -> dict:
        """Lower to a JSON-native dict (cache-key input)."""
        return to_jsonable(self)

    @classmethod
    def from_json(cls, doc: dict) -> "AutotuneConfig":
        """Invert `to_json` (documents without the flag are
        accuracy-aware)."""
        return cls(ope=ope_from_json(doc["ope"]), batch=int(doc["batch"]),
                   mode=ComputeMode(doc["mode"]),
                   osa=osa_energy_from_json(doc["osa"]),
                   guard_pp=doc["guard_pp"],
                   accuracy_aware=bool(doc.get("accuracy_aware", True)))


EDP_ONLY = AutotuneConfig(accuracy_aware=False)


@dataclasses.dataclass(frozen=True)
class DegradationSource:
    """A measure-on-miss provider of Monte-Carlo degradation matrices.

    ``measure(layer_names)`` returns ``{layer: {mapping: pp}}`` for exactly
    the requested layers (the expensive MC stage); ``spec`` is a JSON-able
    identity of everything those numbers depend on: ensemble size and seed,
    noise and variation models, eval-set size, trained-params digest.
    `compile` content-addresses cached matrices in the `PlanCache` by
    (spec, base RosaConfig) and calls ``measure`` only for layers the cache
    does not hold, so a warm compile skips the MC stage and a grown trace
    re-scores only its new layers.  See
    `robust.sensitivity.cnn_degradation_source`.
    """

    measure: Callable[[Sequence[str]], dict]
    spec: Any


# ---------------------------------------------------------------------------
# Content-addressed on-disk plan cache
# ---------------------------------------------------------------------------
_CACHE_ENV = "ROSA_PLAN_CACHE"
# Part of every cache key and checked on load; the reference's value, so
# the two packages share keys (bumped whenever the plan SEARCH changes
# meaning, so stale plans searched by older code are never reused).
_CACHE_SCHEMA = 2


def default_cache_dir() -> pathlib.Path:
    """Cache root: `$ROSA_PLAN_CACHE` or `~/.cache/rosa-repro/plans`."""
    return pathlib.Path(os.environ.get(
        _CACHE_ENV, "~/.cache/rosa-repro/plans")).expanduser()


class PlanCache:
    """Content-addressed plan store: one JSON file per cache key.

    Keys are sha256 hashes over the canonical JSON of (trace, base
    RosaConfig, autotune settings, degradation matrix), so any change to
    the workload or the search inputs misses and re-searches; identical
    inputs hit and load the identical plan.  Writes are atomic renames, so
    concurrent compiles never see torn files.

    `max_entries` bounds the store: after every write the oldest-mtime
    entries beyond the bound are unlinked (plans and degradation files
    alike).  Loads touch their entry's mtime, so eviction is LRU.
    `python -m repro_torch.rosa stats|gc` inspects and prunes a store.
    """

    def __init__(self, root: str | os.PathLike | None = None,
                 max_entries: int | None = None):
        if max_entries is not None and max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.root = pathlib.Path(root) if root is not None \
            else default_cache_dir()
        self.max_entries = max_entries

    def _path(self, key: str) -> pathlib.Path:
        return self.root / f"{key}.json"

    @staticmethod
    def key(trace: ProgramTrace, base_cfg, autotune: AutotuneConfig,
            degradation: dict | None = None) -> str:
        """Content key of a (trace, config, autotune, degradation) plan."""
        return content_hash({
            "schema": _CACHE_SCHEMA,
            "trace": trace.to_json(),
            "config": config_to_json(base_cfg),
            "autotune": autotune.to_json(),
            "degradation": degradation or {},
        })

    def load(self, key: str) -> ExecutionPlan | None:
        """The cached plan under `key`, or None on a miss.  An unreadable,
        stale or torn entry is a miss: the cold path re-searches and
        overwrites it."""
        path = self._path(key)
        with obs.span("plancache.load", cat="cache", key=key[:12]):
            try:
                doc = json.loads(path.read_text())
                if doc.get("schema") != _CACHE_SCHEMA \
                        or doc.get("key") != key:
                    plan = None
                else:
                    plan = ExecutionPlan.from_json(doc["plan"])
            except (OSError, json.JSONDecodeError, KeyError, TypeError,
                    ValueError, AttributeError):
                plan = None
        if plan is not None:
            self._touch(path)
        obs_metrics.registry().counter(
            "rosa.plancache_hits" if plan is not None
            else "rosa.plancache_misses").inc()
        return plan

    def store(self, key: str, plan: ExecutionPlan,
              trace: ProgramTrace) -> pathlib.Path:
        """Atomically persist a searched plan under its content key."""
        doc = {"schema": _CACHE_SCHEMA, "key": key, "plan": plan.to_json(),
               "trace_fingerprint": trace.fingerprint}
        with obs.span("plancache.store", cat="cache", key=key[:12]):
            path = self._write(self._path(key), doc)
        self.gc()
        return path

    @staticmethod
    def _touch(path: pathlib.Path) -> None:
        """Bump an entry's mtime on a hit: mtime is the LRU clock."""
        with contextlib.suppress(OSError):
            os.utime(path)

    def _entries(self) -> list[pathlib.Path]:
        """Every persisted entry (plans and degradation stores), least
        recently used first."""
        try:
            files = [p for p in self.root.iterdir()
                     if p.suffix == ".json" and p.is_file()]
        except OSError:
            return []

        def mtime(p: pathlib.Path) -> float:
            try:
                return p.stat().st_mtime
            except OSError:       # evicted meanwhile: sort last
                return float("inf")

        return sorted(files, key=lambda p: (mtime(p), p.name))

    def gc(self, max_entries: int | None = None) -> int:
        """Evict least-recently-used entries beyond the bound; returns the
        eviction count.  `max_entries=None` uses the instance bound (a
        no-op when the instance is unbounded)."""
        bound = self.max_entries if max_entries is None else max_entries
        if bound is None:
            return 0
        if bound < 1:
            raise ValueError("max_entries must be >= 1")
        entries = self._entries()
        evicted = 0
        for path in entries[:max(len(entries) - bound, 0)]:
            with contextlib.suppress(OSError):
                path.unlink()
                evicted += 1
        if evicted:
            obs_metrics.registry().counter(
                "rosa.plancache_evictions").inc(evicted)
        return evicted

    def stats(self) -> dict:
        """JSON-able store summary (`python -m repro_torch.rosa stats`)."""
        entries = self._entries()
        plans = [p for p in entries if not p.name.endswith(".deg.json")]
        sizes = []
        for p in entries:
            with contextlib.suppress(OSError):
                sizes.append(p.stat().st_size)
        return {"root": str(self.root),
                "entries": len(entries),
                "plans": len(plans),
                "matrices": len(entries) - len(plans),
                "bytes": sum(sizes),
                "max_entries": self.max_entries,
                "lru": [p.name for p in entries[:3]],
                "mru": [p.name for p in entries[-3:]]}

    def _write(self, path: pathlib.Path, doc: dict) -> pathlib.Path:
        self.root.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            with contextlib.suppress(FileNotFoundError):
                os.unlink(tmp)
            raise
        return path

    # -- degradation matrices -------------------------------------------------
    # One `<key>.deg.json` per (base RosaConfig, measurement spec): a
    # per-layer accumulator keyed by layer name inside, so a grown trace
    # re-measures only its new layers (`DegradationSource`).
    @staticmethod
    def matrix_key(base_cfg, spec) -> str:
        """Content key of a degradation-matrix store file."""
        return content_hash({"schema": _CACHE_SCHEMA, "kind": "degradation",
                             "config": config_to_json(base_cfg),
                             "spec": to_jsonable(spec)})

    def _matrix_path(self, key: str) -> pathlib.Path:
        return self.root / f"{key}.deg.json"

    def load_matrix(self, key: str) -> dict | None:
        """The cached `{layer: {mapping: pp}}` rows, or None on any miss."""
        path = self._matrix_path(key)
        try:
            doc = json.loads(path.read_text())
            if doc.get("schema") != _CACHE_SCHEMA or doc.get("key") != key:
                return None
            rows = {str(n): {str(m): float(v) for m, v in row.items()}
                    for n, row in doc["layers"].items()}
        except (OSError, json.JSONDecodeError, KeyError, TypeError,
                ValueError, AttributeError):
            return None
        self._touch(path)
        return rows

    def store_matrix(self, key: str, layers: dict) -> pathlib.Path:
        """Atomically persist (or extend) a degradation-matrix store."""
        doc = {"schema": _CACHE_SCHEMA, "key": key, "layers": layers}
        path = self._write(self._matrix_path(key), doc)
        self.gc()
        return path


def _resolve_cache(cache) -> PlanCache | None:
    if cache is False:
        return None
    if cache is None or cache is True:
        return PlanCache()
    if isinstance(cache, PlanCache):
        return cache
    return PlanCache(cache)


def _measured_matrix(src: DegradationSource, trace: ProgramTrace,
                     base_cfg, store: PlanCache | None) -> dict:
    """Degradation rows for the traced layers: cache first, measure the rest.

    Loads the rows the PlanCache holds under
    `PlanCache.matrix_key(base_cfg, src.spec)`, measures ONLY the missing
    layers (a warm cache measures nothing), marks layers the source cannot
    score with an empty row so they are never re-attempted, and persists
    the extended store.
    """
    mkey = PlanCache.matrix_key(base_cfg, src.spec)
    with obs.span("degstore.load", cat="cache", key=mkey[:12]):
        have = (store.load_matrix(mkey) if store is not None else None) \
            or {}
    missing = [n for n in trace.names if n not in have]
    reg = obs_metrics.registry()
    reg.counter("rosa.degstore_layer_hits").inc(
        len(trace.names) - len(missing))
    reg.counter("rosa.degstore_layer_misses").inc(len(missing))
    if missing:
        with obs.span("rosa.degradation_measure", cat="compile",
                      layers=len(missing)):
            have = {**have, **src.measure(missing)}
        for n in missing:
            have.setdefault(n, {})
        if store is not None:
            with obs.span("degstore.store", cat="cache", key=mkey[:12]):
                store.store_matrix(mkey, have)
    return {n: have[n] for n in trace.names if have.get(n)}


# ---------------------------------------------------------------------------
# Program — the frozen executable handle
# ---------------------------------------------------------------------------
class Program:
    """A compiled optical program: the frozen engine (tuned plan, pinned
    chip, ledger) its step functions run under.

    Call it like the traced function minus the engine argument,
    ``program(*args, key=..., variation=...)``, with an optional base key
    (per-layer keys fold inside the engine) and an optional pinned chip;
    `bind(fn)` installs the engine around any other function.  `searched`,
    `cache_hit` and `cache_key` say where the plan came from."""

    def __init__(self, apply_fn: ApplyFn, engine: Engine,
                 trace: ProgramTrace, *, searched: bool = False,
                 cache_hit: bool = False, cache_key: str | None = None):
        self.apply_fn = apply_fn
        self.engine = engine
        self.trace = trace
        self.searched = searched
        self.cache_hit = cache_hit
        self.cache_key = cache_key

    def __call__(self, *args, key: torch.Generator | None = None,
                 variation=None):
        eng = self.engine
        if key is not None:
            eng = eng.with_key(key)
        if variation is not None:
            eng = eng.with_variation(variation)
        with engine_context(eng):
            return self.apply_fn(eng, *args)

    # -- inspection ----------------------------------------------------------
    @property
    def plan(self) -> ExecutionPlan:
        """The resolved per-layer execution plan this program runs."""
        return self.engine.plan

    @property
    def ledger(self) -> EnergyLedger | None:
        """The frozen engine's ledger (None when unattached)."""
        return self.engine.ledger

    def lower(self) -> dict:
        """JSON-serializable artifact: the captured trace, the resolved plan
        and the cache provenance (`ExecutionPlan.from_json` /
        `ProgramTrace.from_json` invert the nested documents)."""
        return {
            "trace": self.trace.to_json(),
            "plan": self.plan.to_json(),
            "cache_key": self.cache_key,
            "searched": self.searched,
            "cache_hit": self.cache_hit,
        }

    def lower_json(self) -> str:
        """Canonical-JSON string of `lower()`."""
        return canonical_json(self.lower())

    # -- derivation ----------------------------------------------------------
    def with_engine(self, engine: Engine) -> "Program":
        """Same trace and provenance, another frozen engine."""
        return Program(self.apply_fn, engine, self.trace,
                       searched=self.searched, cache_hit=self.cache_hit,
                       cache_key=self.cache_key)

    def with_variation(self, variation) -> "Program":
        """Program with one sampled chip pinned on its engine."""
        return self.with_engine(self.engine.with_variation(variation))

    def with_ledger(self, ledger: EnergyLedger | None) -> "Program":
        """Program with `ledger` attached to its engine."""
        return self.with_engine(self.engine.with_ledger(ledger))

    def bind(self, fn: Callable) -> Callable:
        """`fn` run with this program's engine installed as the ambient
        context (how the serving scheduler builds its steps)."""
        engine = self.engine

        def wrapped(*args, **kwargs):
            with engine_context(engine):
                return fn(*args, **kwargs)

        return wrapped


# ---------------------------------------------------------------------------
# compile — trace once, autotune, freeze
# ---------------------------------------------------------------------------
@obs.traced("rosa.compile", cat="compile")
def compile(apply_fn: ApplyFn, engine: Engine,
            example_args: Sequence[Any] = (), *,
            autotune: AutotuneConfig | None = None,
            degradation: "dict | DegradationSource | None" = None,
            cache: "PlanCache | str | os.PathLike | None | bool" = None,
            verify: str = "off",
            device: str | torch.device | None = None) -> Program:
    """Compile `apply_fn` against `engine` into a frozen `Program`.

    `example_args` are tensors (use `meta` tensors: they are only traced).
    With ``autotune`` the traced workload drives the hybrid IS/WS plan
    search seeded from ``engine.plan.default`` (its overrides are replaced
    by the searched plan); without it the plan is taken as-is.
    ``degradation`` makes the search accuracy-aware (mute it with
    ``AutotuneConfig(accuracy_aware=False)`` / `EDP_ONLY`): a ready
    `{layer: {mapping: pp}}` matrix or a `DegradationSource`, whose rows
    are cached in the `PlanCache` per (layer, RosaConfig, spec).  Searched
    plans persist in the `PlanCache` (``cache``: the default directory when
    None, a directory path, a `PlanCache`, or ``False`` to disable).  The
    search's energy model runs on ``device`` (None: CUDA).

    The reference's ``donate_argnums`` is not taken: the port's steps
    update their state in place, so there is nothing to donate.

    ``verify`` runs the `repro_torch.analysis` checks (generator-state
    reuse, host round trips, float64 promotion) over one call of the
    compiled program, its `meta` example arguments as zeros on ``device``
    (None: CUDA) and a fresh generator as its key: ``"error"`` raises
    `analysis.VerificationError` on ERROR-severity findings, ``"warn"``
    emits a warning per finding, ``"off"`` (default) skips the pass.
    """
    if verify not in ("off", "warn", "error"):
        raise ValueError(
            f"verify must be 'off'|'warn'|'error', got {verify!r}")
    example_args = tuple(example_args)
    trace = capture_trace(apply_fn, engine, example_args)

    searched = False
    cache_hit = False
    cache_key = None
    if autotune is not None:
        base_cfg = engine.plan.default
        if base_cfg is None:
            raise ValueError(
                "autotune needs engine.plan.default (the base RosaConfig the "
                "search specializes per layer); pass autotune=None to freeze "
                "the plan as-is")
        store = _resolve_cache(cache)
        src = degradation if isinstance(degradation, DegradationSource) \
            else None
        deg = degradation if isinstance(degradation, dict) else None
        if not autotune.accuracy_aware:
            src = deg = None
        key_deg = deg if deg is not None else \
            ({"source": to_jsonable(src.spec)} if src is not None else None)
        cache_key = PlanCache.key(trace, base_cfg, autotune, key_deg)
        plan = store.load(cache_key) if store is not None else None
        if plan is not None:
            cache_hit = True
        elif len(trace) == 0:
            plan = engine.plan     # nothing routed optically: nothing to tune
        else:
            if src is not None:
                deg = _measured_matrix(src, trace, base_cfg, store)
            d_fn = None
            if deg is not None:
                # default 0: layers the source could not score run EDP-only
                matrix = deg
                d_fn = lambda name, m: float(     # noqa: E731
                    matrix.get(name, {}).get(m.value, 0.0))
            with obs.span("rosa.plan_search", cat="compile",
                          layers=len(trace)):
                profiles = M.profile_layers_fast(
                    trace.layer_shapes(), autotune.ope, d_fn,
                    mode=autotune.mode, osa=autotune.osa,
                    batch=autotune.batch, device=device)
                if autotune.guard_pp is not None and deg is not None:
                    from repro_torch.robust.sensitivity import \
                        accuracy_guarded_plan
                    mapping_plan = accuracy_guarded_plan(
                        profiles, max_extra_pp=autotune.guard_pp)
                else:
                    mapping_plan = M.hybrid_plan(profiles)
            # open layer set: names outside the trace resolve to the base
            plan = ExecutionPlan.from_mapping_plan(base_cfg, mapping_plan)
            searched = True
            if store is not None:
                store.store(cache_key, plan, trace)
        engine = engine.with_plan(plan)

    # final abstract pass under the frozen plan: checks every traced layer
    # resolves, and prices the trace onto a FRESH ledger (a ledger already
    # carrying runtime events is left alone)
    if autotune is not None or engine.ledger is not None:
        final = engine
        if final.ledger is not None and len(final.ledger.events):
            final = final.with_ledger(None)
        with obs.span("rosa.freeze", cat="compile"):
            _abstract_run(apply_fn, final, example_args)
    program = Program(apply_fn, engine, trace, searched=searched,
                      cache_hit=cache_hit, cache_key=cache_key)

    if verify != "off":
        # lazy import: rosa stays importable without the analysis package,
        # which imports rosa for its CLI targets
        from repro_torch import analysis as A
        report = A.verify_program(program, example_args, device=device)
        if verify == "error" and report.errors:
            raise A.VerificationError(report)
        if report.findings:
            import warnings
            for f in report.findings:
                # past `obs.traced`'s wrapper, at compile's caller
                warnings.warn(f"rosa.compile verification: {f}",
                              stacklevel=3)
    return program
