"""Hierarchical span tracer with Chrome-trace JSON export (the port's own
copy of `repro.obs.trace`, which imports no JAX).

One `Tracer` collects timestamped events — duration spans, instants,
counter samples, and async request-lifecycle markers — and serializes them
as a Chrome trace (the ``traceEvents`` JSON format) loadable in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``.

Design constraints, in order:

1. **Zero-cost when disabled.**  Instrumented code calls the module-level
   helpers (`span`, `instant`, `counter`, ...), which consult a
   `contextvars.ContextVar` — exactly the ambient-engine pattern of
   `rosa.engine_context` — and collapse to a shared no-op when no tracer
   is installed.
2. **Thread/task safety.**  Installation is context-local (`tracing`),
   event emission is lock-guarded, and span nesting needs no explicit
   stack: complete ("X") events nest by time containment per (pid, tid),
   which Perfetto renders directly.
3. **Exception safety.**  A span is emitted from a ``finally`` block with
   its real duration even when the body raises; the raising span is
   annotated with the exception type so failed stages are visible on the
   timeline.

Usage::

    tracer = Tracer()
    with tracing(tracer):
        with span("rosa.compile", cat="compile"):
            ...
    tracer.save("out.trace.json")        # load in Perfetto
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import json
import os
import threading
import time
from typing import Any, Callable

_TRACER_VAR: contextvars.ContextVar["Tracer | None"] = \
    contextvars.ContextVar("repro_torch_obs_tracer", default=None)


def current_tracer() -> "Tracer | None":
    """The innermost tracer installed by `tracing`, or None when disabled."""
    return _TRACER_VAR.get()


def enabled() -> bool:
    """Whether a tracer is currently installed (cheap per-tick guard)."""
    return _TRACER_VAR.get() is not None


@contextlib.contextmanager
def tracing(tracer: "Tracer | None"):
    """Install `tracer` as the ambient tracer for the dynamic extent.

    Context-local (thread- and task-safe), nestable; ``tracing(None)``
    explicitly DISABLES tracing inside the block.
    """
    token = _TRACER_VAR.set(tracer)
    try:
        yield tracer
    finally:
        _TRACER_VAR.reset(token)


class Tracer:
    """An append-only event collector with a perf_counter timebase.

    ``clock`` is injectable (tests pass a deterministic fake); timestamps
    are microseconds relative to the tracer's construction epoch, which is
    what the Chrome trace format expects.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._epoch = clock()
        self._lock = threading.Lock()
        # spans are stored as raw tuples and materialized to Chrome dicts
        # only at export — emission is the hot path, export is not
        self._events: "list[dict | tuple]" = []
        self._pid = os.getpid()
        self._thread_names: dict[int, str] = {}
        self._once: set = set()
        self.wall_epoch = time.time()

    # -- timebase ------------------------------------------------------------
    def now_us(self) -> float:
        """Microseconds since the tracer epoch (the event timebase)."""
        return (self._clock() - self._epoch) * 1e6

    # -- low-level emission --------------------------------------------------
    def _emit(self, ev: dict) -> None:
        tid = ev.setdefault("tid", threading.get_ident())
        ev.setdefault("pid", self._pid)
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            self._events.append(ev)

    def _append(self, tup: tuple) -> None:
        """Append one raw (un-materialized) event tuple — the hot path.

        Tuple layouts, discriminated by the leading Chrome phase char:

        * ``("X", name, cat, t0, t1, args, err, tid)`` — span; t0/t1 are
          RAW clock readings, converted to µs-since-epoch at export
        * ``("C", name, cat, traw, values, tid)`` — counter sample
        * ``("i", name, cat, traw, args, tid)`` — instant
        * ``("b"|"n"|"e", name, cat, traw, id, args, tid)`` — async
        """
        tid = tup[-1]
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            self._events.append(tup)

    def _materialize(self, ev: tuple) -> dict:
        epoch, pid = self._epoch, self._pid
        ph = ev[0]
        if ph == "X":
            _, name, cat, t0, t1, args, err, tid = ev
            if err is not None:
                args = {**args, "error": err}
            d = {"name": name, "cat": cat, "ph": "X",
                 "ts": (t0 - epoch) * 1e6, "dur": (t1 - t0) * 1e6,
                 "tid": tid, "pid": pid}
        elif ph == "C":
            _, name, cat, traw, args, tid = ev
            return {"name": name, "cat": cat, "ph": "C",
                    "ts": (traw - epoch) * 1e6, "args": args,
                    "tid": tid, "pid": pid}
        elif ph == "i":
            _, name, cat, traw, args, tid = ev
            d = {"name": name, "cat": cat, "ph": "i",
                 "ts": (traw - epoch) * 1e6, "s": "t",
                 "tid": tid, "pid": pid}
        else:                                   # async: b / n / e
            _, name, cat, traw, sid, args, tid = ev
            d = {"name": name, "cat": cat, "ph": ph, "id": sid,
                 "ts": (traw - epoch) * 1e6, "tid": tid, "pid": pid}
        if args:
            d["args"] = args
        return d

    @property
    def events(self) -> list[dict]:
        """Snapshot of the recorded events as Chrome dicts (a copy —
        safe to mutate).  Thread-name "M" metadata events lead."""
        with self._lock:
            raw = list(self._events)
            names = dict(self._thread_names)
        out: list[dict] = [
            {"name": "thread_name", "ph": "M", "pid": self._pid, "tid": tid,
             "args": {"name": nm}} for tid, nm in names.items()]
        for ev in raw:
            out.append(self._materialize(ev) if type(ev) is tuple else ev)
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._events) + len(self._thread_names)

    # -- spans ---------------------------------------------------------------
    def span(self, name: str, cat: str = "", **args: Any) -> "_SpanCtx":
        """Record a complete ("X") event around the block.

        Emitted from ``__exit__`` so a raising body still produces a
        correctly-bounded span, annotated with the exception type.
        """
        return _SpanCtx(self, name, cat or "span", args)

    def instant(self, name: str, cat: str = "", **args: Any) -> None:
        """Record a thread-scoped instant ("i") event."""
        self._append(("i", name, cat or "instant", self._clock(), args,
                      threading.get_ident()))

    def first(self, key) -> bool:
        """True the first time `key` is seen by this tracer, then False."""
        with self._lock:
            if key in self._once:
                return False
            self._once.add(key)
            return True

    # -- counters ------------------------------------------------------------
    def counter(self, name: str, value: "float | int | dict",
                cat: str = "counter") -> None:
        """Record a counter ("C") sample — one Perfetto track per `name`.

        `value` may be a scalar (series ``value``) or a dict of series.
        """
        args = dict(value) if isinstance(value, dict) else {"value": value}
        self._append(("C", name, cat, self._clock(), args,
                      threading.get_ident()))

    # -- async (request-lifecycle) events ------------------------------------
    def async_begin(self, name: str, id: "int | str", cat: str = "async",
                    **args: Any) -> None:
        """Open an async track item (Perfetto pairs by (cat, id, name))."""
        self._async("b", name, id, cat, args)

    def async_instant(self, name: str, id: "int | str", cat: str = "async",
                      **args: Any) -> None:
        """Mark an instant on an open async track item."""
        self._async("n", name, id, cat, args)

    def async_end(self, name: str, id: "int | str", cat: str = "async",
                  **args: Any) -> None:
        """Close an async track item opened by `async_begin`."""
        self._async("e", name, id, cat, args)

    def _async(self, ph: str, name: str, id, cat: str, args: dict) -> None:
        self._append((ph, name, cat, self._clock(), str(id), args,
                      threading.get_ident()))

    # -- export --------------------------------------------------------------
    def to_chrome(self) -> dict:
        """The Chrome trace document (``{"traceEvents": [...]}``)."""
        return {"traceEvents": self.events,
                "displayTimeUnit": "ms",
                "otherData": {"wall_epoch_s": self.wall_epoch}}

    def save(self, path) -> None:
        """Serialize `to_chrome()` as JSON at `path`."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, separators=(",", ":"))
            f.write("\n")


class _SpanCtx:
    """A hand-rolled span context manager.

    This is the hot path of the tracer (one instance per span, several per
    scheduler tick), so it avoids ``contextlib.contextmanager``'s generator
    machinery — that alone is ~3x the cost of the whole emission.
    """

    __slots__ = ("_tr", "_name", "_cat", "_args", "_t0")

    def __init__(self, tr: Tracer, name: str, cat: str, args: dict):
        self._tr = tr
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> Tracer:
        self._t0 = self._tr._clock()        # raw clock; converted at export
        return self._tr

    def __exit__(self, etype, exc, tb) -> bool:
        tr = self._tr
        tr._append(("X", self._name, self._cat, self._t0, tr._clock(),
                    self._args, None if etype is None else etype.__name__,
                    threading.get_ident()))
        return False


# ---------------------------------------------------------------------------
# Module-level helpers — the zero-cost-when-disabled instrumentation API
# ---------------------------------------------------------------------------
_NULL_SPAN = contextlib.nullcontext()


def span(name: str, cat: str = "", **args: Any):
    """`Tracer.span` on the ambient tracer, or a shared no-op context."""
    tr = _TRACER_VAR.get()
    return _NULL_SPAN if tr is None else _SpanCtx(tr, name, cat or "span", args)


def instant(name: str, cat: str = "", **args: Any) -> None:
    """`Tracer.instant` on the ambient tracer; no-op when disabled."""
    tr = _TRACER_VAR.get()
    if tr is not None:
        tr.instant(name, cat, **args)


def instant_once(key: tuple, name: str, cat: str = "", **args: Any) -> None:
    """`instant`, the first time (name, *key) is seen by the installed
    tracer.  The reference's compile instants fire while JAX traces a step,
    once per compiled shape; the port runs eagerly and keys them on the
    shape instead, so a step that runs a thousand times emits one."""
    tr = _TRACER_VAR.get()
    if tr is not None and tr.first((name, *key)):
        tr.instant(name, cat, **args)


def counter(name: str, value: "float | int | dict",
            cat: str = "counter") -> None:
    """`Tracer.counter` on the ambient tracer; no-op when disabled."""
    tr = _TRACER_VAR.get()
    if tr is not None:
        tr.counter(name, value, cat)


def async_begin(name: str, id: "int | str", cat: str = "async",
                **args: Any) -> None:
    """`Tracer.async_begin` on the ambient tracer; no-op when disabled."""
    tr = _TRACER_VAR.get()
    if tr is not None:
        tr.async_begin(name, id, cat, **args)


def async_instant(name: str, id: "int | str", cat: str = "async",
                  **args: Any) -> None:
    """`Tracer.async_instant` on the ambient tracer; no-op when disabled."""
    tr = _TRACER_VAR.get()
    if tr is not None:
        tr.async_instant(name, id, cat, **args)


def async_end(name: str, id: "int | str", cat: str = "async",
              **args: Any) -> None:
    """`Tracer.async_end` on the ambient tracer; no-op when disabled."""
    tr = _TRACER_VAR.get()
    if tr is not None:
        tr.async_end(name, id, cat, **args)


def traced(name: str | None = None, cat: str = ""):
    """Decorator form of `span` (span name defaults to the qualname)."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with span(label, cat):
                return fn(*a, **kw)

        return wrapped
    return deco
