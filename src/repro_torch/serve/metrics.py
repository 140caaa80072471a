"""Serving metrics and the serving Program (PyTorch port of the parts of
`repro.serve.metrics` that serving needs).

`build_serving_program` traces the decode step once on `meta` tensors to
discover its GEMMs, autotunes the layer-wise hybrid IS/WS plan on those
shapes (paper Sec. 3.5, EDP term) through the on-disk plan cache (a warm
start loads the plan) and optionally pins one fabricated chip; every token
is then served through that frozen (plan, chip) pair.
`trace_serving_shapes` prices the decode step and one prefill chunk onto an
engine's ledger under "decode" / "prefill" scopes, `energy_metrics` turns
that trace into per-token energy and the hybrid-vs-WS decode EDP, and
`report_metrics` turns one scheduler run into named metrics, and
`smoke_report` is the serving bench (one-shot vs continuous on a smoke
arch, plus `energy_metrics`).  Step-unit and tick metrics are
deterministic and gate; wall-clock ones depend on the device and never
do.
"""

from __future__ import annotations

import torch

from repro_torch.bench.schema import Metric
from repro_torch.core.constants import ROSA_OPTIMAL, Mapping
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
        if bundle.cfg.family not in ("ssm", "hybrid"):
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


def energy_metrics(model_cfg, scfg: ServeConfig, cache=None,
                   device: str | torch.device = "cuda") -> list[Metric]:
    """Per-token / per-chunk energy of the optical serving path, plus the
    hybrid-vs-WS decode EDP ratio the plan search bought (the reference's
    floats, gated as the reference gates them).  `cache` is the plan
    cache, as `rosa.compile` takes it."""
    from repro_torch.core import mapping as M
    from repro_torch.models.model import build_model
    from repro_torch.serve.config import serving_model_config

    bundle = build_model(serving_model_config(model_cfg, rosa=True))
    engine = build_serving_engine(bundle, scfg, cache=cache, device=device)
    ledger = trace_serving_shapes(bundle, scfg, engine)
    shapes = [ev.layer_shape() for ev in ledger.unique_events("decode")]
    plan = {s.name: engine.config(s.name).mapping for s in shapes}
    # batch=1: the decode-step trace already encodes n_slots in each m
    e_hybrid = M.plan_edp(shapes, plan, ROSA_OPTIMAL, batch=1)
    e_ws = M.plan_edp(shapes, {s.name: Mapping.WS for s in shapes},
                      ROSA_OPTIMAL, batch=1)
    out = [
        Metric("energy_per_token_j",
               ledger.per_token(ROSA_OPTIMAL, batch=scfg.n_slots,
                                tag="decode"),
               unit="J", gate=True, rel_tol=1e-3,
               direction="lower_is_better"),
        Metric("decode_edp_hybrid_vs_ws", e_hybrid / e_ws, unit="ratio",
               gate=True, rel_tol=1e-3, direction="lower_is_better"),
        Metric("decode_is_layers",
               sum(1 for m in plan.values() if m is Mapping.IS),
               gate=True, rel_tol=0.0),
    ]
    prefill = ledger.breakdown(ROSA_OPTIMAL, batch=1, tag="prefill")
    if prefill.energy > 0:
        out.append(Metric("energy_per_prefill_chunk_j", prefill.energy,
                          unit="J", gate=True, rel_tol=1e-3,
                          direction="lower_is_better"))
    return out


def report_metrics(rep: ServeReport, prefix: str = "",
                   gate: bool = True) -> list[Metric]:
    """Throughput/latency metrics of one scheduler run.  Step-unit and
    tick metrics are deterministic and gate (unless `gate` is False);
    wall-clock ones depend on the device and never do."""
    p = prefix
    return [
        Metric(f"{p}total_tokens", rep.total_tokens, gate=gate,
               rel_tol=0.0),
        Metric(f"{p}tokens_per_unit", rep.tokens_per_unit, unit="tok/step",
               gate=gate, rel_tol=1e-6, direction="higher_is_better"),
        Metric(f"{p}occupancy", rep.occupancy, unit="frac", gate=gate,
               rel_tol=1e-6, direction="higher_is_better"),
        Metric(f"{p}latency_p50_ticks", rep.percentile(50), unit="ticks",
               gate=gate, rel_tol=1e-6, direction="lower_is_better"),
        Metric(f"{p}latency_p99_ticks", rep.percentile(99), unit="ticks",
               gate=gate, rel_tol=1e-6, direction="lower_is_better"),
        Metric(f"{p}ttft_p50_ticks", rep.percentile(50, "ttft"),
               unit="ticks", gate=gate, rel_tol=1e-6,
               direction="lower_is_better"),
        Metric(f"{p}tokens_per_s", rep.tokens_per_s, unit="tok/s"),
        Metric(f"{p}wall_s", rep.wall_s, unit="s"),
        Metric(f"{p}ttft_p50_ms", rep.wall_percentile_ms(50, "ttft"),
               unit="ms"),
        Metric(f"{p}latency_p99_ms", rep.wall_percentile_ms(99), unit="ms"),
    ]


def smoke_report(arch: str = "qwen3-32b", n_requests: int = 24,
                 rate: float = 1.0, scfg: ServeConfig | None = None,
                 seed: int = 0,
                 device: str | torch.device = "cuda") -> list[Metric]:
    """The `serve_smoke` bench: one Poisson stream on the smoke arch,
    served one-shot and then continuous; gates continuous throughput, the
    continuous / one-shot ratio, latency percentiles and per-token
    energy.

    The workload is ragged (generation budgets 2..40), the regime
    continuous batching exists for: a static batch decodes max(budget)
    steps while its short requests idle, continuous refills their slots
    the next tick."""
    from repro_torch.configs import get_smoke
    from repro_torch.serve.loadgen import poisson_requests
    from repro_torch.serve.scheduler import Scheduler

    cfg = get_smoke(arch)
    scfg = scfg or ServeConfig(n_slots=4, max_len=56, prefill_chunk=8,
                               seed=seed)
    sched = Scheduler(cfg, scfg, init_seed=seed, device=device)
    reqs = poisson_requests(n_requests, rate, vocab=cfg.vocab,
                            prompt_len=(4, 8), gen_len=(2, 40), seed=seed)
    ones = sched.run(reqs, policy="oneshot")
    cont = sched.run(reqs, policy="continuous")

    out = report_metrics(cont, prefix="cont_")
    out += [m for m in report_metrics(ones, prefix="oneshot_", gate=False)
            if m.name in ("oneshot_tokens_per_unit", "oneshot_occupancy",
                          "oneshot_tokens_per_s")]
    out.append(Metric(
        "throughput_ratio_vs_oneshot",
        cont.tokens_per_unit / max(ones.tokens_per_unit, 1e-12),
        unit="x", gate=True, rel_tol=1e-6, direction="higher_is_better"))

    # energy of the same serving shapes through the optical engine
    out += energy_metrics(cfg, scfg, device=device)
    return out
