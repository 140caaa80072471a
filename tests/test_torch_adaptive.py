"""Port parity of closed-loop drift-adaptive serving
(`repro_torch.serve.adaptive`, `robust.drift.DriftModel.offsets_at`,
`serve.scheduler.TickHook`) against the JAX reference
(`repro.serve.adaptive`), on the CPU at the reference's smoke config
(qwen3-32b, 2 layers, d=64).

The reference runs its own `drift_serve` quick scenario with the sensor
noise off; its parameters, its pinned chip and its probe prompts are
carried across, so with IDEAL per-shot noise (the serving default) both
packages serve the same model on the same chip through the same "ref"
pipeline.  Tolerances:

  * `offsets_at`: 1e-6 K against the reference (its float32 evaluation);
    the walk is exact on the port's own grid;
  * the detector: decisions and estimates exactly (plain Python floats);
  * the scenario: every probe agreement within one prompt of 16
    (1/16; measured: equal), the same probe ticks, the same action
    counts and swap tick, zero drops, epoch_bitexact, zero downtime;
    the post-replan plan equals the reference `compile`'s given the same
    degradation rows.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import rosa
from repro_torch.configs import get_smoke
from repro_torch.core.constants import ROSA_OPTIMAL, Mapping
from repro_torch.models.model import params_from_reference
from repro_torch.robust import drift as TD
from repro_torch.robust.variation import from_reference
from repro_torch.serve import (Request, Scheduler, ServeConfig, TickHook,
                               build_serving_engine, serving_model_config)
from repro_torch.serve import adaptive as TA
from repro_torch.serve.adaptive import __main__ as adaptive_main
from repro_torch.serve.adaptive.probes import _ROW_FLOOR
from repro_torch.serve.decode import init_state, make_serve_step, null_admit
from repro_torch.serve.metrics import abstract_decode_batch
from test_torch_ref import reference

SCEN = dict(n_requests=12, force_replan_at=30, sensor_sigma_k=0.0)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small CPU ops: one intra-op thread keeps the file fast when test
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def R():
    return reference()


@pytest.fixture(scope="module")
def plan_dir(tmp_path_factory):
    """The scenarios' plan cache: module fixtures run before conftest
    points ROSA_PLAN_CACHE at its per-run directory."""
    with pytest.MonkeyPatch.context() as mp:
        root = tmp_path_factory.mktemp("plans")
        mp.setenv("ROSA_PLAN_CACHE", str(root))
        yield root


@pytest.fixture(scope="module")
def ref_scen(R, plan_dir):
    """The reference's quick drift_serve scenario, sensor noise off."""
    import importlib
    ad = importlib.import_module("repro.serve.adaptive")
    res, reqs = ad.run_scenario(ad.ScenarioConfig(**SCEN))
    return res, reqs


@pytest.fixture(scope="module")
def port_scen(ref_scen, plan_dir):
    """The port's scenario on the reference's params, chip and prompts."""
    jres, _ = ref_scen
    cfg = TA.ScenarioConfig(**SCEN)
    parts = TA.scenario_parts(
        get_smoke(cfg.arch), cfg, params=params_from_reference(
            jres.sched.params),
        chip=from_reference(jres.controller.probes.chip), device="cpu")
    parts.probes.tokens = torch.from_numpy(
        np.array(jres.controller.probes.tokens))
    res, reqs = TA.run_parts(parts, cfg)
    return res, reqs


# ---------------------------------------------------------------------------
# offsets_at
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["sine", "linear"])
def test_offsets_at_matches_reference(R, kind):
    t = np.array([0.0, 30.0, 455.5, 1440.0, 2879.0, 7200.0])
    dm = TD.DriftModel(kind=kind, amp_k=0.6, period_s=2880.0)
    jdm = R.drift.DriftModel(kind=kind, amp_k=0.6, period_s=2880.0)
    for ti in t:
        np.testing.assert_allclose(dm.offsets_at(ti),
                                   float(jdm.offsets_at(ti)), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(dm.offsets_at(t), dm.offsets(t), rtol=0,
                               atol=0)


def test_offsets_at_walk_on_and_between_grid_points():
    grid = np.arange(64, dtype=np.float64) * 30.0
    dm = TD.DriftModel(kind="walk", amp_k=0.6, period_s=2880.0)
    key = torch.Generator().manual_seed(5)
    table = dm.offsets(grid, torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(dm.offsets_at(grid, key, grid), table)
    # the key is left as it is: every call sees the same walk
    assert dm.offsets_at(grid[7], key, grid) == table[7]
    mid = 0.25 * grid[10] + 0.75 * grid[11]
    np.testing.assert_allclose(dm.offsets_at(mid, key, grid),
                               0.25 * table[10] + 0.75 * table[11],
                               rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="key"):
        dm.offsets_at(1.0, None, grid)
    with pytest.raises(ValueError, match="t_grid"):
        dm.offsets_at(1.0, key)


# ---------------------------------------------------------------------------
# Detector
# ---------------------------------------------------------------------------
def test_detector_decisions_equal_reference(R):
    import importlib
    jdet = importlib.import_module("repro.serve.adaptive.detector")
    rng = np.random.default_rng(11)
    temps = np.cumsum(rng.normal(0.02, 0.03, 80))
    agrees = np.clip(1.0 - np.abs(rng.normal(0.0, 0.06, 80)), 0.0, 1.0)
    cfg = TA.DetectorConfig(cusum_k=0.02, cusum_h=0.04, rearm=2)
    a = TA.DriftDetector(cfg, 1.0)
    b = jdet.DriftDetector(jdet.DetectorConfig(cusum_k=0.02, cusum_h=0.04,
                                               rearm=2), 1.0)
    for i, (tk, ag) in enumerate(zip(temps, agrees)):
        assert a.observe_temp(tk) == b.observe_temp(tk)
        assert a.predict() == b.predict()
        if i % 3 == 0:
            assert a.update(ag) == b.update(ag)
            assert (a.cusum, a.fired) == (b.cusum, b.fired)
        if i == 50:
            a.reset()
            b.reset()


# ---------------------------------------------------------------------------
# TickHook and the drift step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smoke_sched():
    scfg = ServeConfig(n_slots=2, max_len=24, prefill_chunk=4, rosa=True,
                       variation_seed=3)
    return Scheduler(get_smoke("qwen3-32b"), scfg, device="cpu",
                     plan_cache=False)


def _two_requests():
    return [Request(0, np.arange(1, 5), 4, arrival=0),
            Request(1, np.arange(2, 8), 3, arrival=1)]


def test_noop_tick_hook_called_every_tick(smoke_sched):
    class Counting(TickHook):
        def __init__(self):
            self.calls = []

        def on_tick_end(self, sched, tick, state, idle_slots):
            self.calls.append((tick, idle_slots))

    hook = Counting()
    rep = smoke_sched.run(_two_requests(), hook=hook)
    ticks = [t for t, _ in hook.calls]
    assert ticks == list(range(rep.ticks))       # once per executed tick
    assert all(0 <= idle <= 2 for _, idle in hook.calls)
    assert hook.step_args(0) == ()
    rep2 = smoke_sched.run(_two_requests())
    for rid in (0, 1):
        assert rep.completions[rid].tokens == rep2.completions[rid].tokens


def test_scheduler_spans_every_prefill_chunk_and_decode_step(smoke_sched):
    """Under a tracer, `Scheduler.run` emits one `serve.prefill_chunk` span
    a chunk and one `serve.decode_step` span a step (the reference's
    names), and serves the same tokens as untraced."""
    from repro_torch.obs.trace import Tracer, tracing
    tracer = Tracer()
    with tracing(tracer):
        rep = smoke_sched.run(_two_requests())
    names = [e["name"] for e in tracer.events if e.get("ph") == "X"]
    assert names.count("serve.prefill_chunk") == rep.prefill_chunks > 0
    assert names.count("serve.decode_step") == rep.decode_steps > 0
    want = smoke_sched.run(_two_requests())
    for rid in (0, 1):
        assert rep.completions[rid].tokens == want.completions[rid].tokens


def test_drift_step_at_zero_residual_is_the_serve_step(smoke_sched):
    """The drift step shifts the pinned chip; at residual 0 it serves the
    same logits as the plain step, and a residual moves them."""
    sched = smoke_sched
    plain = make_serve_step(sched.bundle, dataclasses.replace(
        sched.scfg, collect_logits=True), program=sched.program)
    drift = TA.make_drift_step(sched.bundle, dataclasses.replace(
        sched.scfg, collect_logits=True), sched.program)
    outs = []
    for fn, extra in ((plain, ()), (drift, (0.0,)), (drift, (0.5,))):
        state = init_state(sched.cfg, sched.scfg)
        state.active[:] = True
        state.budget[:] = 8
        state.tok[:] = torch.tensor([3, 9], dtype=torch.int32)
        with torch.inference_mode():
            outs.append(fn(sched.params, state, null_admit(), 0.0,
                           *extra)[1]["logits"])
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    assert not torch.equal(outs[2], outs[0])


def test_scheduler_serves_under_a_callers_engine(smoke_sched):
    """`Scheduler(engine=...)`: the caller's plan as-is, no search."""
    eng = smoke_sched.engine.with_plan(rosa.ExecutionPlan.from_mapping_plan(
        smoke_sched.engine.plan.default, {"mlp/wi": Mapping.WS}))
    sched = Scheduler(get_smoke("qwen3-32b"), smoke_sched.scfg,
                      params=smoke_sched.params, engine=eng, device="cpu")
    assert sched.engine is eng and not sched.program.searched
    assert sched.program.plan.mapping_plan() == {"mlp/wi": Mapping.WS}
    rep = sched.run(_two_requests())
    assert [len(rep.completions[r].tokens) for r in (0, 1)] == [4, 3]


def test_build_serving_engine_serves_as_the_compiled_program(smoke_sched,
                                                              tmp_path):
    """`build_serving_engine`: the serving program's plan and pinned chip
    with a fresh ledger; a `Scheduler` given it serves the tokens of one
    that compiles its own program, and charges the engine's ledger."""
    eng = build_serving_engine(smoke_sched.bundle, smoke_sched.scfg,
                               cache=rosa.PlanCache(tmp_path), device="cpu")
    assert eng.plan.mapping_plan() == \
        smoke_sched.program.plan.mapping_plan()
    assert eng.variation.keys() == smoke_sched.engine.variation.keys()
    for name, v in eng.variation.items():
        torch.testing.assert_close(v.ddt, smoke_sched.engine.variation[
            name].ddt, rtol=0, atol=0)
    assert isinstance(eng.ledger, rosa.EnergyLedger) \
        and eng.ledger is not smoke_sched.engine.ledger
    assert build_serving_engine(smoke_sched.bundle, smoke_sched.scfg,
                                with_ledger=False, cache=False,
                                device="cpu").ledger is None
    sched = Scheduler(get_smoke("qwen3-32b"), smoke_sched.scfg,
                      params=smoke_sched.params, engine=eng, device="cpu")
    rep, want = sched.run(_two_requests()), smoke_sched.run(_two_requests())
    for rid in (0, 1):
        assert rep.completions[rid].tokens == want.completions[rid].tokens
    assert eng.ledger.per_token(ROSA_OPTIMAL, batch=2) > 0.0


# ---------------------------------------------------------------------------
# The scenario against the reference
# ---------------------------------------------------------------------------
def test_scenario_serves_every_request_and_swaps_without_downtime(
        port_scen, plan_dir):
    res, reqs = port_scen
    s = res.summary()
    assert res.dropped_requests(reqs) == 0
    n_epoch, exact = res.epoch_bitexact()
    assert n_epoch >= 1 and exact
    assert s["swap_downtime_ticks"] == 0
    assert res.controller.replans >= 1
    assert res.controller.swaps[0]["tick"] == 30
    assert res.ref_agreement == 1.0
    assert res.controller.mean_agreement > res.monitor.mean_agreement
    # the swap rebound the scheduler onto the new program
    assert res.sched._drift_program is res.sched.program
    assert res.sched.engine is res.sched.program.engine
    # each package's replan stored its rows and its searched plan
    stats = rosa.PlanCache(plan_dir).stats()
    assert stats["matrices"] == 2 and stats["plans"] >= 2


def test_scenario_agreements_equal_reference(port_scen, ref_scen):
    res, _ = port_scen
    jres, _ = ref_scen
    for arm in ("monitor", "controller"):
        got, want = getattr(res, arm).series, getattr(jres, arm).series
        assert [r["tick"] for r in got] == [r["tick"] for r in want]
        np.testing.assert_allclose([r["agreement"] for r in got],
                                   [r["agreement"] for r in want], rtol=0,
                                   atol=1.0 / 16 + 1e-12)
    s, js = res.summary(), jres.summary()
    for k in ("retrims", "replans", "first_action_tick", "epoch_requests",
              "epoch_bitexact", "swap_downtime_ticks"):
        assert s[k] == js[k], k
    assert s["recovery"] == pytest.approx(js["recovery"], abs=0.1)
    assert res.ref_agreement == jres.ref_agreement


def test_probes_leave_the_serving_ledger_alone(port_scen):
    res, _ = port_scen
    sched = res.sched
    events = list(sched.engine.ledger.events)
    e0 = res.controller.series[-1]["energy_per_token_j"]
    assert e0 > 0
    res.controller.probes.agreement(sched.params, 0.3)
    res.controller.probes.degradation_rows(sched.params, 0.1)
    assert sched.engine.ledger.events == events
    assert TA.controller._energy(sched) == e0


def test_degradation_rows_and_replan_plan_equal_reference(R, port_scen,
                                                          ref_scen):
    """The same rows' keys as the reference's ProbeSet, and the plan the
    reference's accuracy-aware compile gives for the port's rows."""
    res, _ = port_scen
    jres, _ = ref_scen
    rows = res.controller.probes.degradation_rows(res.sched.params, 0.2)
    jrows = jres.controller.probes.degradation_rows(jres.sched.params, 0.2)
    assert {n: set(r) for n, r in rows.items()} == \
        {n: set(r) for n, r in jrows.items()}
    assert set(rows) == {"mlp/wi", "mlp/wo"}
    assert all(v >= _ROW_FLOOR for r in rows.values() for v in r.values())
    json.dumps(rows)
    # the post-replan plan of the scenario, against the reference compile
    sched = res.sched
    swap_rows = res.controller.probes.degradation_rows(
        sched.params, res.controller.env.residual(30, 0.0))
    jb = jres.sched.bundle
    jscfg = jres.sched.scfg
    jprog = R.rosa.compile(
        lambda eng, p, b: jb.decode_step(p, b),
        R.rosa.Engine.from_config(jres.sched.program.engine.plan.default),
        (jb.abstract(R.jnp.float32),
         R.metrics._abstract_decode_batch(jb.cfg, jscfg)),
        autotune=R.rosa.AutotuneConfig(ope=R.constants.ROSA_OPTIMAL,
                                       batch=1),
        degradation=swap_rows, cache=False)
    want = {n: m.value for n, m in jprog.plan.mapping_plan().items()}
    port_prog = rosa.compile(
        lambda eng, p, b: sched.bundle.decode_step(p, b),
        rosa.Engine.from_config(sched.program.engine.plan.default),
        (sched.bundle.abstract(torch.float32),
         abstract_decode_batch(sched.bundle.cfg, sched.scfg)),
        autotune=rosa.AutotuneConfig(batch=1), degradation=swap_rows,
        cache=False, device="cpu")
    assert {n: m.value for n, m in
            port_prog.plan.mapping_plan().items()} == want
    assert res.controller.swaps[0]["plan"] == \
        jres.controller.swaps[0]["plan"]


def test_cli_runs_on_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("ROSA_PLAN_CACHE", str(tmp_path / "plans"))
    out = tmp_path / "drift.json"
    assert adaptive_main.main(["--device", "cpu", "--requests", "4",
                               "--force-replan-at", "8", "--json",
                               str(out)]) == 0
    text = capsys.readouterr().out
    assert "recovery" in text and "swap_downtime_ticks" in text
    from repro_torch.bench import schema
    doc = schema.load(out)
    names = {m.name for m in doc.results[0].metrics}
    assert {"recovery_frac", "dropped_requests", "epoch_bitexact",
            "swap_downtime_ticks", "replans"} <= names


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (kernels build on first "
                    "use)")


@pytest.mark.cuda
def test_drift_step_on_cuda_matches_cpu(tmp_path):
    """The drift step through the rosa_fused kernel on the card against
    its plain version on the CPU, on the same params and chip, at
    residuals 0 and 0.3 K: logits within the flip-aware bound."""
    _need_card()
    from repro_torch.kernels.rosa_fused import ops as fused_ops
    from test_torch_ref import assert_quantized_parity
    scfg = ServeConfig(n_slots=2, max_len=24, prefill_chunk=4, rosa=True,
                       rosa_backend="fused", variation_seed=3,
                       collect_logits=True)
    cpu = Scheduler(get_smoke("qwen3-32b"), scfg, device="cpu",
                    plan_cache=tmp_path)
    card = Scheduler(get_smoke("qwen3-32b"), scfg, params=cpu.params,
                     device="cuda", plan_cache=tmp_path)
    assert card.program.cache_hit
    outs = []
    fused_ops.LAUNCHES.reset()
    for sched in (cpu, card):
        step = TA.make_drift_step(sched.bundle, sched.scfg, sched.program)
        row = []
        for resid in (0.0, 0.3):
            state = init_state(sched.cfg, sched.scfg, sched.device)
            state.active[:] = True
            state.budget[:] = 8
            state.tok[:] = torch.tensor([3, 9], dtype=torch.int32)
            with torch.inference_mode():
                row.append(step(sched.params, state, null_admit(), 0.0,
                                resid)[1]["logits"].cpu())
        outs.append(row)
    assert fused_ops.LAUNCHES.count == 2 * 2 * card.cfg.n_layers
    for a, b in zip(outs[0], outs[1]):
        assert_quantized_parity(b, a)


@pytest.mark.cuda
def test_cached_compile_on_cuda(tmp_path):
    """The serving compile on the card: cold searches on the card's energy
    model, warm loads; the plan equals the CPU search's."""
    _need_card()
    from repro_torch.models.model import build_model
    from repro_torch.serve import build_serving_program
    b = build_model(serving_model_config(get_smoke("qwen3-32b"), rosa=True))
    scfg = ServeConfig(rosa=True, rosa_backend="fused")
    cold = build_serving_program(b, scfg, device="cuda", cache=tmp_path)
    warm = build_serving_program(b, scfg, device="cuda", cache=tmp_path)
    cpu = build_serving_program(b, scfg, device="cpu", cache=False)
    assert cold.searched and warm.cache_hit and not warm.searched
    assert warm.plan == cold.plan == cpu.plan
