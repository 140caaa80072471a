"""Serving metrics and the serving Program (PyTorch port of the parts of
`repro.serve.metrics` that serving needs).

`build_serving_program` traces the decode step once on `meta` tensors to
discover its GEMMs, autotunes the layer-wise hybrid IS/WS plan on those
shapes (paper Sec. 3.5, EDP term) through the on-disk plan cache (a warm
start loads the plan) and optionally pins one fabricated chip; every token
is then served through that frozen (plan, chip) pair.
`trace_serving_shapes` prices the decode step and one prefill chunk onto an
engine's ledger under "decode" / "prefill" scopes, and `report_metrics`
turns one scheduler run into named metrics.  Step-unit and tick metrics
are deterministic; wall-clock ones depend on the device.
"""

from __future__ import annotations

import torch

from repro_torch.bench.schema import Metric
from repro_torch.core.constants import ROSA_OPTIMAL
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.scheduler import ServeReport


def abstract_decode_batch(cfg, scfg: ServeConfig) -> dict:
    """A decode batch of `meta` tensors (n_slots rows, max_len cache)."""
    from repro_torch.models import transformer as T
    s = scfg.n_slots
    return {"token": torch.empty((s,), dtype=torch.int32, device="meta"),
            "pos": torch.empty((s,), dtype=torch.int32, device="meta"),
            "cache": T.init_cache(cfg, s, scfg.max_len, device="meta")}


def abstract_chunk_batch(cfg, scfg: ServeConfig) -> dict:
    """One prefill chunk of `meta` tensors against a batch-1 cache."""
    from repro_torch.models import transformer as T
    return {"tokens": torch.empty((1, scfg.prefill_chunk), dtype=torch.int32,
                                  device="meta"),
            "n_valid": torch.empty((1,), dtype=torch.int32, device="meta"),
            "cache": T.init_cache(cfg, 1, scfg.max_len, device="meta")}


def trace_serving_shapes(bundle, scfg: ServeConfig, engine):
    """Trace the decode step and one prefill chunk (for the families that
    prefill in chunks) on `meta` tensors under `engine`'s ledger with
    "decode"/"prefill" attribution scopes."""
    from repro_torch import rosa
    ledger = engine.ledger
    params = bundle.abstract(torch.float32)
    with torch.no_grad(), rosa.engine_context(engine):
        with ledger.scope("decode"):
            bundle.decode_step(params, abstract_decode_batch(bundle.cfg,
                                                             scfg))
        if bundle.cfg.family != "ssm":
            with ledger.scope("prefill"):
                bundle.chunk_step(params,
                                  abstract_chunk_batch(bundle.cfg, scfg))
    return ledger


def build_serving_program(bundle, scfg: ServeConfig, chip=None,
                          device: str | torch.device = "cuda", cache=None):
    """Compile the decode step into a `rosa.Program`: one abstract trace
    discovers the decode GEMMs, the hybrid IS/WS plan is autotuned on that
    workload (on `device`) and lands in the on-disk plan cache (``cache``,
    as `rosa.compile` takes it: a warm start with the same model, slots and
    backend skips the search), and the program carries the pinned chip:
    `chip` when given, else one sampled from scfg.variation_seed (on
    `device`)."""
    from repro_torch import rosa
    from repro_torch.robust import variation as V

    # act_per_vector: a request's numerics must not depend on which other
    # requests share its decode batch
    base = rosa.RosaConfig(backend=scfg.rosa_backend, act_per_vector=True)
    probe = rosa.Engine.from_config(base)
    params = bundle.abstract(torch.float32)
    batch = abstract_decode_batch(bundle.cfg, scfg)
    # the traced GEMMs already carry the slot batch in m: batch=1 here
    program = rosa.compile(
        lambda eng, p, b: bundle.decode_step(p, b), probe, (params, batch),
        autotune=rosa.AutotuneConfig(ope=ROSA_OPTIMAL, batch=1),
        cache=cache, device=device)
    if chip is None and scfg.variation_seed is not None:
        chip = V.sample_chip(
            torch.Generator().manual_seed(scfg.variation_seed),
            dims={e.name: e.k for e in program.trace.entries}, device=device)
    if chip is not None:
        program = program.with_variation(
            {name: v.to(device) for name, v in chip.items()})
    return program


def build_serving_engine(bundle, scfg: ServeConfig, with_ledger: bool = True,
                         cache=None, chip=None,
                         device: str | torch.device = "cuda"):
    """The engine of `build_serving_program` (hybrid plan from the decode
    trace, optional pinned chip), with a fresh `EnergyLedger` when
    requested."""
    from repro_torch import rosa

    engine = build_serving_program(bundle, scfg, chip=chip, device=device,
                                   cache=cache).engine
    if with_ledger:
        engine = engine.with_ledger(rosa.EnergyLedger())
    return engine


def report_metrics(rep: ServeReport, prefix: str = "") -> list[Metric]:
    """Throughput/latency metrics of one scheduler run: step-unit and tick
    metrics are deterministic, wall-clock ones depend on the device."""
    p = prefix
    return [
        Metric(f"{p}total_tokens", rep.total_tokens),
        Metric(f"{p}tokens_per_unit", rep.tokens_per_unit, "tok/step"),
        Metric(f"{p}occupancy", rep.occupancy, "frac"),
        Metric(f"{p}latency_p50_ticks", rep.percentile(50), "ticks"),
        Metric(f"{p}latency_p99_ticks", rep.percentile(99), "ticks"),
        Metric(f"{p}ttft_p50_ticks", rep.percentile(50, "ttft"), "ticks"),
        Metric(f"{p}ticks", rep.ticks, "ticks"),
        Metric(f"{p}tokens_per_s", rep.tokens_per_s, "tok/s"),
        Metric(f"{p}wall_s", rep.wall_s, "s"),
        Metric(f"{p}ttft_p50_ms", rep.wall_percentile_ms(50, "ttft"), "ms"),
        Metric(f"{p}latency_p99_ms", rep.wall_percentile_ms(99), "ms"),
    ]
