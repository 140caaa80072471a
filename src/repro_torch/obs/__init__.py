"""repro_torch.obs — spans, metrics and trace export (PyTorch port of
`repro.obs`).

* `trace` — hierarchical span tracer with Chrome-trace JSON export
  (Perfetto-loadable); ambient installation via `tracing`, zero-cost
  module-level helpers (`span`, `instant`, `counter`, async events);
* `metrics` — thread-safe registry of counters/gauges/bounded histograms
  with bench-schema and Prometheus exports, plus `install_kernel_hooks`
  for the nvcc build counters (the port's counterpart of the reference's
  `install_jax_hooks`);
* `energy` — `EnergyTrack`, bridging `rosa.EnergyLedger` step pricing
  onto the trace timeline as cumulative counter tracks;
* `cli` — ``python -m repro_torch.obs summarize`` trace summarizer.
"""

from repro_torch.obs.energy import EnergyTrack
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    install_kernel_hooks,
    registry,
    swap_registry,
)
from repro_torch.obs.trace import (
    Tracer,
    async_begin,
    async_end,
    async_instant,
    counter,
    current_tracer,
    enabled,
    instant,
    span,
    traced,
    tracing,
)

__all__ = [
    "Counter",
    "EnergyTrack",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Tracer",
    "async_begin",
    "async_end",
    "async_instant",
    "counter",
    "current_tracer",
    "enabled",
    "install_kernel_hooks",
    "instant",
    "registry",
    "span",
    "swap_registry",
    "traced",
    "tracing",
]
