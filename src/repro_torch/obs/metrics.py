"""Metrics registry: counters, gauges, bounded-memory histograms (PyTorch
port of `repro.obs.metrics`).

A `MetricsRegistry` is a thread-safe, get-or-create table of named
instruments.  Every instrument keeps O(1) state (a histogram holds fixed
bucket counts + count/sum/min/max, never samples), so a registry can run
under a serving scheduler for months without growing.

Two export surfaces:

* `to_metrics()` — bench-schema `repro_torch.bench.schema.Metric` rows, so
  any counter can ride inside a ``BENCH_<n>.json`` entry;
* `to_prometheus()` — the Prometheus text exposition format, for scraping.

A process-global default registry (`registry()`) carries the series the
instrumented subsystems maintain:

    rosa.plancache_hits / rosa.plancache_misses     PlanCache plan IO
    rosa.plancache_evictions                        PlanCache LRU bound
    rosa.degstore_layer_hits / _misses              degradation-matrix rows
    serve.queue_depth / serve.slots_active          scheduler gauges
    serve.evictions / serve.requests_completed      scheduler counters
    serve.adaptive.retrims / .replans               drift controller actions
    serve.adaptive.state / .drift_est_k             drift controller gauges
    kernels.builds / kernels.build_s                nvcc builds (hooks)
    kernels.build_cache_hits                        libraries up to date

`install_kernel_hooks` is the counterpart of the reference's
`install_jax_hooks`: where the reference counts XLA compiles and
compile-cache hits, the port counts nvcc builds of its CUDA kernels
(`repro_torch.kernels.build_all`).  The listener resolves `registry()` at
fire time (so tests can swap the registry) and drops a back-dated
``kernels.build`` span onto the ambient trace.
"""

from __future__ import annotations

import contextlib
import math
import re
import threading

from repro_torch.obs import trace as _trace

# log-spaced seconds buckets: ~30 us .. ~5 min, x4 per step — wide enough
# for both a single serving tick and a cold compile
DEFAULT_BOUNDS = tuple(2.0 ** e for e in range(-15, 9, 2))


class Counter:
    """Monotonic counter (float increments allowed)."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        """Add `n` (must be >= 0) to the counter."""
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        """Current total."""
        with self._lock:
            return self._value


class Gauge:
    """Last-written value (set/add semantics)."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        """Overwrite the gauge."""
        with self._lock:
            self._value = float(v)

    def add(self, n: float) -> None:
        """Adjust the gauge by `n` (may be negative)."""
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        """Current value."""
        with self._lock:
            return self._value


class Histogram:
    """Bounded-memory histogram: fixed bucket bounds, no stored samples.

    ``bounds`` are the upper edges of the finite buckets (sorted); one
    overflow bucket catches everything above the last edge.  Memory is
    O(len(bounds)) forever, whatever the observation rate.
    """

    __slots__ = ("name", "help", "bounds", "_lock", "_counts", "count",
                 "total", "min", "max")

    def __init__(self, name: str, help: str = "",
                 bounds: tuple = DEFAULT_BOUNDS):
        self.name, self.help = name, help
        self.bounds = tuple(sorted(float(b) for b in bounds))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _bucket(self, v: float) -> int:
        lo, hi = 0, len(self.bounds)
        while lo < hi:                       # first bound >= v
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def observe(self, v: float) -> None:
        """Record one sample."""
        v = float(v)
        i = self._bucket(v)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.total += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        """Mean of the observed samples (0 when empty)."""
        with self._lock:
            return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (upper bucket edge; 0 when empty)."""
        with self._lock:
            counts, n = list(self._counts), self.count
        if not n:
            return 0.0
        target = max(1, math.ceil(n * q / 100.0))
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= target:
                return self.bounds[i] if i < len(self.bounds) else self.max
        return self.max                                   # pragma: no cover

    def snapshot(self) -> dict:
        """Summary dict (count/sum/min/max/mean + cumulative buckets)."""
        with self._lock:
            counts = list(self._counts)
            out = {"count": self.count, "sum": self.total,
                   "min": self.min if self.count else 0.0,
                   "max": self.max if self.count else 0.0}
        out["mean"] = out["sum"] / out["count"] if out["count"] else 0.0
        cum, acc = [], 0
        for c in counts:
            acc += c
            cum.append(acc)
        out["buckets"] = list(zip([*self.bounds, math.inf], cum))
        return out


class MetricsRegistry:
    """Thread-safe get-or-create table of named instruments."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, cls, **kw):
        with self._lock:
            item = self._items.get(name)
            if item is None:
                item = self._items[name] = cls(name, **kw)
        if not isinstance(item, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(item).__name__}, not {cls.__name__}")
        return item

    def counter(self, name: str, help: str = "") -> Counter:
        """Get-or-create a `Counter`."""
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        """Get-or-create a `Gauge`."""
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  bounds: tuple = DEFAULT_BOUNDS) -> Histogram:
        """Get-or-create a `Histogram`."""
        return self._get(name, Histogram, help=help, bounds=bounds)

    def items(self) -> dict:
        """Snapshot {name: instrument} (insertion order preserved)."""
        with self._lock:
            return dict(self._items)

    def snapshot(self) -> dict:
        """{name: value | histogram summary} for cheap diffing."""
        out = {}
        for name, item in self.items().items():
            out[name] = item.snapshot() if isinstance(item, Histogram) \
                else item.value
        return out

    # -- exports -------------------------------------------------------------
    def to_metrics(self, prefix: str = "") -> list:
        """Bench-schema `Metric` rows (never gated: runtime
        observations)."""
        from repro_torch.bench.schema import Metric
        rows = []
        for name, item in self.items().items():
            if isinstance(item, Histogram):
                rows.append(Metric(f"{prefix}{name}_count", item.count))
                rows.append(Metric(f"{prefix}{name}_mean", item.mean))
            else:
                rows.append(Metric(f"{prefix}{name}", item.value))
        return rows

    def to_prometheus(self) -> str:
        """The Prometheus text exposition format of every instrument."""
        lines = []
        for name, item in self.items().items():
            pname = _prom_name(name)
            if item.help:
                lines.append(f"# HELP {pname} {item.help}")
            if isinstance(item, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {_prom_val(item.value)}")
            elif isinstance(item, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_prom_val(item.value)}")
            else:
                snap = item.snapshot()
                lines.append(f"# TYPE {pname} histogram")
                for edge, cum in snap["buckets"]:
                    le = "+Inf" if math.isinf(edge) else _prom_val(edge)
                    lines.append(f'{pname}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{pname}_sum {_prom_val(snap['sum'])}")
                lines.append(f"{pname}_count {snap['count']}")
        return "\n".join(lines) + "\n"


def _prom_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _prom_val(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() and abs(v) < 1e15 \
        else repr(float(v))


# ---------------------------------------------------------------------------
# The process-global default registry
# ---------------------------------------------------------------------------
_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry the instrumented subsystems write to."""
    return _REGISTRY


@contextlib.contextmanager
def swap_registry(reg: MetricsRegistry):
    """Temporarily replace the global registry (hermetic tests)."""
    global _REGISTRY
    prev, _REGISTRY = _REGISTRY, reg
    try:
        yield reg
    finally:
        _REGISTRY = prev


# ---------------------------------------------------------------------------
# Kernel-build bridge: nvcc builds and up-to-date libraries
# ---------------------------------------------------------------------------
_KERNEL_HOOKS_LOCK = threading.Lock()
_KERNEL_HOOKS_INSTALLED = False


def _on_build(event: str, name: str, seconds: float) -> None:
    reg = registry()
    tr = _trace.current_tracer()
    if event == "cache_hit":
        reg.counter("kernels.build_cache_hits").inc()
        if tr is not None:
            tr.instant("kernels.build_cache_hits", cat="kernels", kernel=name)
        return
    reg.counter("kernels.builds").inc()
    reg.histogram("kernels.build_s").observe(seconds)
    if tr is not None:
        # the duration arrives after the fact: back-date the span start
        tr._emit({"name": "kernels.build", "cat": "kernels", "ph": "X",
                  "ts": tr.now_us() - seconds * 1e6, "dur": seconds * 1e6,
                  "args": {"kernel": name}})


def install_kernel_hooks() -> bool:
    """Register the kernel-build listener (idempotent; returns True).

    Until it is called `build_all` notifies nobody; after, every build and
    every up-to-date library found dispatches through `registry()` and the
    ambient tracer at fire time."""
    global _KERNEL_HOOKS_INSTALLED
    with _KERNEL_HOOKS_LOCK:
        if not _KERNEL_HOOKS_INSTALLED:
            from repro_torch import kernels
            kernels.BUILD_LISTENERS.append(_on_build)
            _KERNEL_HOOKS_INSTALLED = True
        return True
