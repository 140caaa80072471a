"""Port parity of the robustness subsystem (`repro_torch.robust`) against the
JAX reference (`repro.robust`), on the CPU at small sizes.

Chips are sampled by the reference and carried across
(`variation.from_reference`), and per-shot noise is IDEAL, so both packages
evaluate the same deterministic chips: threefry bits cannot be reproduced
with torch generators, so keyed draws (`sample_ensemble` itself, noisy
evaluations) are compared by structure and statistics, never by bits.
The evaluators run the golden file's JAX-trained mobilenet_v3 parameters
(`tests/data/torch_cnn_mobilenet_v3.npz`), other tests numpy-made ones of
the reference's shapes; images are synth-CIFAR, which both packages
generate bit for bit.  Tolerances:

  * ensemble helpers on carried chips, `control_variate_accs`, drift
    offsets and residuals, `params_digest`, plan order and EDP: exact (or
    1e-12 where float64 sums are taken);
  * accuracies: within one image per chip (100 / n_eval pp), and each
    degradation cell within 100 / n_eval pp: per-tensor quantization
    couples rows (ROADMAP Queue 3), so a requant code flipped by a 1e-6
    realization difference can move a whole image's prediction (measured:
    equal on these inputs);
  * the surrogate feature (summed realization RMS errors): 1e-5 relative,
    the folded chain's few-ulp distance from XLA's (test_torch_core).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch import rosa
from repro_torch.bench import schema as TSchema
from repro_torch.configs.paper_cnns import CNN_WORKLOADS
from repro_torch.core import mapping as TMap
from repro_torch.core import mrr as TM
from repro_torch.core.constants import ROSA_OPTIMAL, Mapping
from repro_torch.models.cnn import LITE_MODELS
from repro_torch.models.model import params_from_reference
from repro_torch.robust import __main__ as robust_main
from repro_torch.robust import cli as TCLI
from repro_torch.robust import drift as TD
from repro_torch.robust import ensemble as TE
from repro_torch.robust import report as TR
from repro_torch.robust import sensitivity as TS
from repro_torch.robust import variation as TV
from repro_torch.training import cnn_train as TT
from test_torch_cnn import GOLDEN, _np_params, load_golden
from test_torch_ref import reference, to_np

MODEL, N_EVAL, EVAL_BATCH = "mobilenet_v3", 32, 16
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The evaluators run many small CPU ops: with one intra-op thread they
    stay fast when test workers share the cores (each worker's OpenMP pool
    otherwise spins against the others', ten times slower measured), and
    no result the tests hold depends on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def R():
    return reference()


@pytest.fixture(scope="module")
def setup(R):
    """The golden file's JAX-trained mobilenet_v3 parameters (numpy, and
    the port's), the eval set of both packages and a 4-chip antithetic
    reference ensemble with its port carry-over.  Trained parameters give
    the predictions real margins; on random ones a single flipped requant
    code moves several near-tied predictions at once."""
    with np.load(GOLDEN) as z:
        jp, _ = load_golden(z)
    xj, yj = R.ensemble.cnn_eval_set(N_EVAL)
    xt, yt = TE.cnn_eval_set(N_EVAL)
    ens_j = R.variation.sample_ensemble(R.jax.random.PRNGKey(3), 4,
                                        R.variation.cnn_lane_dims(MODEL),
                                        antithetic=True)
    return dict(jp=jp, pt=params_from_reference(jp), xj=xj, yj=yj, xt=xt,
                yt=yt, ens_j=ens_j, ens_t=TV.from_reference(ens_j))


def _engines(R):
    """QAT_CFG engines (IDEAL per-shot noise) of both packages."""
    names = [s.name for s in LITE_MODELS[MODEL]]
    return (R.rosa.Engine.from_config(R.cnn_train.QAT_CFG, layers=names),
            rosa.Engine.from_config(TT.QAT_CFG, layers=names))


def _key():
    return torch.Generator().manual_seed(0)


def _within_one_image(got, want, n_eval=N_EVAL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=100.0 / n_eval + 1e-9)


# ---------------------------------------------------------------------------
# Variation helpers
# ---------------------------------------------------------------------------
def _eq(t_chip, j_chip):
    assert set(t_chip) == set(j_chip)
    for name in j_chip:
        for f in ("dv", "ddt", "dlam"):
            np.testing.assert_array_equal(
                to_np(getattr(t_chip[name], f)),
                np.asarray(getattr(j_chip[name], f)), err_msg=name)


def test_ensemble_helpers_exact_on_carried_ensemble(R, setup):
    Vj, ens_j, ens_t = R.variation, setup["ens_j"], setup["ens_t"]
    assert TV.ensemble_size(ens_t) == Vj.ensemble_size(ens_j) == 4
    _eq(TV.chip_at(ens_t, 2), Vj.chip_at(ens_j, 2))
    _eq(TV.chip_slice(ens_t, 3), Vj.chip_slice(ens_j, 3))
    _eq(TV.scale_ensemble(ens_t, 0.5), Vj.scale_ensemble(ens_j, 0.5))
    _eq(TV.shift_thermal(ens_t, 0.125), Vj.shift_thermal(ens_j, 0.125))


def test_antithetic_mirror_is_exact():
    ens = TV.sample_ensemble(_key(), 6, {"a": 40, "b": (3, 5)},
                             antithetic=True)
    for v in ens.values():
        for f in (v.dv, v.ddt, v.dlam):
            assert torch.equal(f[1::2], -f[0::2])
            assert not torch.equal(f[0], f[2])
    with pytest.raises(ValueError, match="even"):
        TV.sample_ensemble(_key(), 3, {"a": 4}, antithetic=True)


def test_sample_ensemble_field_statistics():
    """Per-field spread of 512 chips x 64 lanes (32768 draws): std within
    3 % of the model's sigma (the std's own spread is 0.4 %), mean within
    4 standard errors of 0."""
    model = TV.PAPER_VARIATION.scaled(2.0)
    ens = TV.sample_ensemble(_key(), 512, {"l": 64}, model)["l"]
    for f, sigma in ((ens.dv, model.sigma_v_static),
                     (ens.ddt, model.sigma_dt_static),
                     (ens.dlam, model.sigma_lambda_fab)):
        assert tuple(f.shape) == (512, 64)
        assert abs(float(f.std()) / sigma - 1) < 0.03
        assert abs(float(f.mean())) < 4 * sigma / np.sqrt(f.numel())


def test_layer_draws_stable_under_added_layer():
    a = TV.sample_ensemble(_key(), 4, {"x": 8, "y": 5})
    b = TV.sample_ensemble(_key(), 4, {"w": 3, "x": 8, "y": 5})
    for name in ("x", "y"):
        for f in ("dv", "ddt", "dlam"):
            assert torch.equal(getattr(a[name], f), getattr(b[name], f))


# ---------------------------------------------------------------------------
# Evaluators: IDEAL per-shot noise, carried chips
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_evals(R, setup):
    """The reference's ensemble evaluator and gated plan evaluator, each
    compiled once for the module (the 4-chip ensemble, N_EVAL images)."""
    eng_j, _ = _engines(R)
    names = [s.name for s in LITE_MODELS[MODEL]]
    apply_j = R.ensemble.cnn_apply_fn(MODEL)
    return dict(
        names=names, eng=eng_j,
        run=R.ensemble.make_ensemble_eval(apply_j, eng_j,
                                          eval_batch=EVAL_BATCH),
        gated=R.ensemble.make_plan_eval(apply_j, eng_j, names,
                                        eval_batch=EVAL_BATCH, gated=True),
        keys=R.jax.random.split(R.jax.random.PRNGKey(0), 4))


def test_evaluate_and_estimate_ensemble_match_reference(R, setup,
                                                        ref_evals):
    """`evaluate_ensemble` (the reference's evaluator with its per-chip
    keys) per chip within one image; the variance-reduced estimate: the
    surrogate within 1e-5 and the probes within one image of the
    reference's, the predictions the control-variate fit of the port's own
    probes and surrogate; FULL_MC is `evaluate_ensemble` itself."""
    _, eng_t = _engines(R)
    accs_j, agree_j, clean_j = ref_evals["run"](
        setup["jp"], setup["xj"], setup["yj"], setup["ens_j"],
        ref_evals["keys"])
    args = (TE.cnn_apply_fn(MODEL), setup["pt"], setup["xt"], setup["yt"],
            eng_t, setup["ens_t"], _key())
    got = TE.evaluate_ensemble(*args, eval_batch=EVAL_BATCH)
    assert got.n_chips == 4 and got.method == "mc"
    _within_one_image(got.accs, np.asarray(accs_j))
    _within_one_image([got.clean_acc], [float(clean_j)])
    np.testing.assert_allclose(got.agreement, np.asarray(agree_j), rtol=0,
                               atol=1.0 / N_EVAL + 1e-9)
    full = TE.estimate_ensemble(*args, estimator=TE.FULL_MC,
                                eval_batch=EVAL_BATCH)
    np.testing.assert_array_equal(full.accs, got.accs)

    est = TE.estimate_ensemble(*args, estimator=TE.EstimatorConfig(
        n_probe=2), eval_batch=EVAL_BATCH)
    assert (est.method, est.n_probe, est.n_chips) \
        == ("control-variate", 2, 4)
    names = ref_evals["names"]
    f_j = R.ensemble.surrogate_features(
        R.ensemble.layer_weights(setup["jp"], names), setup["ens_j"],
        ref_evals["eng"])
    f_t = TE.surrogate_features(TE.layer_weights(setup["pt"], names),
                                setup["ens_t"], eng_t)
    np.testing.assert_allclose(f_t, np.asarray(f_j), rtol=1e-5)
    np.testing.assert_array_equal(est.accs[:2], got.accs[:2])
    np.testing.assert_array_equal(
        est.accs, TE.control_variate_accs(got.accs[:2], f_t, 2))

    # label-free: accuracy against the clean predictions
    free = TE.evaluate_ensemble(*args[:3], None, *args[4:],
                                eval_batch=EVAL_BATCH)
    np.testing.assert_allclose(free.accs, 100.0 * got.agreement, rtol=1e-6)
    assert free.clean_acc == 100.0


def test_gated_plan_eval_matches_reference(R, setup, ref_evals):
    """Mixed mapping gates, one-hot analog gates (a depthwise conv, a
    1x1 conv) and all-ones gates, per chip within one image."""
    _, eng_t = _engines(R)
    names = ref_evals["names"]
    run_t = TE.make_plan_eval(TE.cnn_apply_fn(MODEL), eng_t, names,
                              eval_batch=EVAL_BATCH, gated=True)
    keys_t = TM.split_keys(_key(), 4)
    sel = (np.arange(len(names)) % 3 == 1).astype(np.float32)
    eye = np.eye(len(names), dtype=np.float32)
    for g in (eye[names.index("mb4_dw")], eye[names.index("mb2_exp")],
              np.ones(len(names), np.float32)):
        want = ref_evals["gated"](setup["jp"], setup["xj"], setup["yj"],
                                  setup["ens_j"], ref_evals["keys"],
                                  R.jnp.asarray(sel), R.jnp.asarray(g))
        got = run_t(setup["pt"], setup["xt"], setup["yt"], setup["ens_t"],
                    keys_t, sel, g)
        _within_one_image(got[0], np.asarray(want[0]))
        _within_one_image([got[2]], [float(want[2])])


def test_degradation_matrix_matches_reference(R, setup, ref_evals):
    """Cells of four columns (a conv, a depthwise conv, a projection, the
    classifier) within 100 / n_eval pp; re-scoring one column reproduces
    it."""
    names = ref_evals["names"]
    cols = ["conv_stem", "mb2_dw", "mb6_prj", "fc"]
    want = R.sensitivity.degradation_matrix(
        R.ensemble.cnn_apply_fn(MODEL), setup["jp"], setup["xj"],
        setup["yj"], names, R.cnn_train.QAT_CFG, setup["ens_j"],
        R.jax.random.PRNGKey(0), layers=cols,
        evaluator=ref_evals["gated"])
    args = (TE.cnn_apply_fn(MODEL), setup["pt"], setup["xt"], setup["yt"],
            names, TT.QAT_CFG, setup["ens_t"], _key())
    got = TS.degradation_matrix(*args, noise=TM.IDEAL,
                                eval_batch=EVAL_BATCH, layers=cols)
    assert list(got) == list(want) == cols
    for n in cols:
        assert set(got[n]) == {"input_stationary", "weight_stationary"}
        _within_one_image([got[n][m] for m in sorted(got[n])],
                          [want[n][m] for m in sorted(want[n])])
    fresh = TS.refresh_degradation_matrix(
        got, ["mb2_dw"], *args, noise=TM.IDEAL, eval_batch=EVAL_BATCH)
    assert fresh == got


def test_drift_simulation_matches_reference(R, setup, ref_evals):
    """Sine drift with re-trim on a three-point grid: the residual offsets
    exactly, the ensemble-mean accuracy within one image at each time."""
    _, eng_t = _engines(R)
    t = np.array([0.0, 1200.0, 2400.0])
    want = R.drift.simulate(
        R.ensemble.cnn_apply_fn(MODEL), setup["jp"], setup["xj"],
        setup["yj"], ref_evals["eng"], setup["ens_j"],
        R.jax.random.PRNGKey(0),
        R.drift.DriftModel(kind="sine", amp_k=0.5, period_s=3600.0), t,
        1800.0, evaluator=ref_evals["run"])
    got = TD.simulate(TE.cnn_apply_fn(MODEL), setup["pt"], setup["xt"],
                      setup["yt"], eng_t, setup["ens_t"], _key(),
                      TD.DriftModel(kind="sine", amp_k=0.5, period_s=3600.0),
                      t, 1800.0, eval_batch=EVAL_BATCH)
    np.testing.assert_array_equal(got.residual_k, want.residual_k)
    _within_one_image(got.mean_acc, want.mean_acc)
    assert set(got.summary()) == set(want.summary())


# ---------------------------------------------------------------------------
# Pure functions: exact against the reference
# ---------------------------------------------------------------------------
def test_control_variate_accs_matches_reference(R):
    r = np.random.default_rng(4)
    for n_probe in (2, 4):
        feats = r.uniform(0.0, 0.2, 16)
        probe = 80.0 - 60.0 * feats[:n_probe] + r.normal(0, 0.5, n_probe)
        np.testing.assert_allclose(
            TE.control_variate_accs(probe, feats, n_probe),
            R.ensemble.control_variate_accs(probe, feats, n_probe),
            rtol=0, atol=1e-12)
    flat = np.full(8, 0.1)          # no spread: slope 0
    np.testing.assert_array_equal(
        TE.control_variate_accs(np.array([50.0, 52.0]), flat, 2),
        R.ensemble.control_variate_accs(np.array([50.0, 52.0]), flat, 2))


@pytest.mark.parametrize("kind", ["sine", "linear"])
@pytest.mark.parametrize("retrim", [None, 900.0, 1000.0])
def test_drift_offsets_and_residuals_match_reference(R, kind, retrim):
    t = np.linspace(0.0, 3600.0, 9)
    dm_t = TD.DriftModel(kind=kind, amp_k=0.3, period_s=2400.0)
    dm_j = R.drift.DriftModel(kind=kind, amp_k=0.3, period_s=2400.0)
    off_t, off_j = dm_t.offsets(t), dm_j.offsets(t)
    np.testing.assert_allclose(off_t, off_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(TD.residual_offsets(off_t, t, retrim),
                               R.drift.residual_offsets(off_j, t, retrim),
                               rtol=0, atol=1e-12)


def test_walk_drift_is_a_keyed_random_walk():
    """`walk` draws from its key (statistics, not the reference's bits):
    deterministic per key, starting at 0."""
    t = np.linspace(0.0, 3600.0, 65)
    dm = TD.DriftModel(kind="walk", amp_k=0.25)
    a, b = dm.offsets(t, _key()), dm.offsets(t, _key())
    np.testing.assert_array_equal(a, b)
    assert a[0] == 0.0 and np.abs(a).max() > 0
    with pytest.raises(ValueError, match="key"):
        dm.offsets(t)


def test_trim_voltages_match_reference(R):
    w = np.random.default_rng(5).uniform(-1, 1, (24, 9)).astype(np.float32)
    for dt in (0.0, 0.2, -0.1):
        got = to_np(TD.trim_voltages(torch.from_numpy(w), dt))
        want = np.asarray(R.jax.jit(R.drift.trim_voltages)(
            R.jnp.asarray(w), dt))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_params_digest_matches_reference(R):
    jp = _np_params("mobilenet_v3", seed=3)
    d = TS.params_digest(params_from_reference(jp))
    assert d == R.sensitivity.params_digest(jp)
    assert d == TS.params_digest(jp)                 # numpy leaves alike
    assert TS.params_digest({"a": np.zeros(3, np.float32)}) \
        == R.sensitivity.params_digest({"a": np.zeros(3, np.float32)})
    jp["fc"]["b"] = jp["fc"]["b"] + 1
    assert TS.params_digest(params_from_reference(jp)) != d


def test_cnn_degradation_source_spec_equals_reference(R):
    """The provider's spec is the reference's for the same parameters and
    settings plus the random-number family that draws the chips, both
    packages derive the same matrix key from one spec, the reference's own
    spec keys another entry, and `measure` scores exactly the layers asked
    for."""
    jp = _np_params("alexnet", seed=2)
    src = TS.cnn_degradation_source(params_from_reference(jp), "alexnet",
                                    n_chips=2, n_eval=16, eval_batch=16)
    jsrc = R.sensitivity.cnn_degradation_source(jp, "alexnet", n_chips=2,
                                                n_eval=16, eval_batch=16)
    assert rosa.serialize.canonical_json(src.spec) == \
        R.rosa.serialize.canonical_json(dict(jsrc.spec, rng="torch-cpu"))
    key = rosa.PlanCache.matrix_key(TT.QAT_CFG, src.spec)
    assert key == R.rosa.PlanCache.matrix_key(R.cnn_train.QAT_CFG, src.spec)
    assert key != R.rosa.PlanCache.matrix_key(R.cnn_train.QAT_CFG, jsrc.spec)
    rows = src.measure(["conv2", "fc1"])
    assert set(rows) == {"conv2", "fc1"}
    assert all(set(r) == {"input_stationary", "weight_stationary"}
               and min(r.values()) >= 0.0 for r in rows.values())


SMOKE_KW = dict(n_chips=4, n_probe=2, n_eval=16)


def test_run_smoke_measures_its_own_matrix_and_matches_reference_schema(
        R, tmp_path, monkeypatch):
    """The reference's smoke run stores its degradation matrix; the port's
    run on the same parameters and cache does not read it (its chips are
    torch's draws, not threefry's): it runs its own Monte-Carlo stage and
    stores a second matrix, and reports the reference's summary keys and
    metric names."""
    import importlib
    jcli = importlib.import_module("repro.robust.cli")
    jp = _np_params("alexnet", seed=4)
    jsum, jmet = jcli.run_smoke(
        "alexnet", params={k: {kk: R.jnp.asarray(vv) for kk, vv in v.items()}
                           for k, v in jp.items()},
        cache=R.rosa.PlanCache(tmp_path), **SMOKE_KW)
    calls = []
    real = TS.degradation_matrix
    monkeypatch.setattr(TS, "degradation_matrix",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tsum, tmet = TCLI.run_smoke("alexnet", params=params_from_reference(jp),
                                cache=rosa.PlanCache(tmp_path),
                                device="cpu", **SMOKE_KW)
    assert not jsum["matrix_cached"] and not tsum["matrix_cached"]
    assert calls == [1]
    assert set(tsum["degradation"]) == set(jsum["degradation"])
    assert rosa.PlanCache(tmp_path).stats()["matrices"] == 2
    assert set(tsum) == set(jsum)
    assert [m.name for m in tmet] == [m.name for m in jmet]
    assert [m.gate for m in tmet] == [m.gate for m in jmet]


def _fixed_deg(seed=0):
    r = np.random.default_rng(seed)
    return {s.name: {"input_stationary": float(r.uniform(0, 3)),
                     "weight_stationary": float(r.uniform(0, 3))}
            for s in LITE_MODELS[MODEL]}


@pytest.mark.parametrize("seed", [0, 1])
def test_profiles_order_plans_and_edp_match_reference(R, seed):
    """From one degradation matrix: the joined profiles, the search order,
    the accuracy-guarded plan and the EDP ratio of a plan are the
    reference's (EDP in float64, to 1e-12)."""
    deg = _fixed_deg(seed)
    rows_t = [l for l in CNN_WORKLOADS[MODEL] if l.name in deg]
    rows_j = [l for l in R.paper_cnns.CNN_WORKLOADS[MODEL] if l.name in deg]
    p_t = TS.profile_layers_mc(rows_t, ROSA_OPTIMAL, deg, batch=128,
                               device="cpu")
    p_j = R.sensitivity.profile_layers_mc(rows_j, R.constants.ROSA_OPTIMAL,
                                          deg, batch=128)
    for a, b in zip(p_t, p_j):
        assert (a.name, a.d_is, a.d_ws) == (b.name, b.d_is, b.d_ws)
        np.testing.assert_allclose([a.e_is, a.e_ws], [b.e_is, b.e_ws],
                                   rtol=1e-12)
    guard_t = TS.accuracy_guarded_plan(p_t)
    guard_j = R.sensitivity.accuracy_guarded_plan(p_j)
    assert {k: v.value for k, v in guard_t.items()} \
        == {k: v.value for k, v in guard_j.items()}
    plan = {n: Mapping.IS for n in ("head", "mb4_exp")}
    ratio_t = (TMap.plan_edp(rows_t, plan, ROSA_OPTIMAL, batch=128)
               / TMap.plan_edp(rows_t, {}, ROSA_OPTIMAL, batch=128))
    plan_j = {n: R.constants.Mapping.IS for n in plan}
    ratio_j = (R.mapping.plan_edp(rows_j, plan_j, R.constants.ROSA_OPTIMAL,
                                  batch=128)
               / R.mapping.plan_edp(rows_j, {}, R.constants.ROSA_OPTIMAL,
                                    batch=128))
    assert ratio_t == ratio_j


def test_searched_plan_takes_the_best_most_is_prefix(monkeypatch):
    """The search order and the choice among its measured prefixes, with
    `plan_search` replaced by fixed accuracies."""
    deg = _fixed_deg(2)
    rows = [l for l in CNN_WORKLOADS[MODEL] if l.name in deg]
    prof = TS.profile_layers_mc(rows, ROSA_OPTIMAL, deg, batch=128,
                                device="cpu")
    accs = np.array([50.0, 51.0, 52.0, 52.0, 49.0, 52.0, 40.0])
    monkeypatch.setattr(TS, "plan_search",
                        lambda *a, **k: accs[:len(a[8])])
    plan, info = TS.searched_hybrid_plan(prof, None, None, None, None,
                                         TT.QAT_CFG, {}, _key())
    n_is = int(max(np.flatnonzero(accs[:len(info["order"]) + 1]
                                  >= accs[:len(info["order"]) + 1].max())))
    assert info["n_is"] == n_is
    assert set(plan) == set(info["order"][:n_is])


# ---------------------------------------------------------------------------
# Report and CLI
# ---------------------------------------------------------------------------
def test_report_validates_with_reference_schema(R, tmp_path):
    res = TE.EnsembleResult(accs=np.array([80.0, 79.0, 81.5, 70.0]),
                            agreement=np.array([0.9, 0.8, 0.95, 0.7]),
                            clean_acc=81.0)
    metrics = TR.ensemble_metrics(res, gate=True) \
        + TR.yield_curve_metrics(res, drops_pp=(1.0, 5.0)) \
        + TR.sweep_metrics(TR.sigma_sweep(lambda s: res, (0.0, 1.5)))
    path = TR.save_report([TR.BenchResult(name="robust_ensemble",
                                          metrics=metrics)],
                          tmp_path / "BENCH_9.json")
    doc = R.schema.load(path)                 # the reference validates it
    assert doc.env["torch"] == torch.__version__
    got = {m.name: m.value for m in doc.results[0].metrics}
    assert got["yield_2pp"] == 0.75 and got["n_chips"] == 4
    assert got["acc_s1p5"] == res.mean_acc
    assert set(got) >= {"mean_acc", "yield_1pp", "yield_5pp", "yield_s0"}


@pytest.mark.parametrize("cmd,extra", [
    ("ensemble", ["--n-chips", "4", "--n-probe", "2"]),
    ("sensitivity", ["--n-chips", "2"]),
    ("drift", ["--n-chips", "2", "--drift-kind", "linear"]),
    ("sweep", ["--n-chips", "2", "--scales", "0", "1"])])
def test_cli_runs_end_to_end_on_cpu(cmd, extra, tmp_path, monkeypatch,
                                    capsys):
    """`python -m repro_torch.robust <cmd> --device cpu` at a tiny size
    (one QAT step, 16 images), with a schema-valid report."""
    real = TT.train_cnn
    monkeypatch.setattr(TT, "train_cnn", lambda *a, **k: real(
        *a, **dict(k, n_train=64)))
    out = tmp_path / "r.json"
    assert robust_main.main([cmd, "--device", "cpu", "--steps", "1",
                             "--n-eval", "16", "--json", str(out),
                             *extra]) == 0
    text = capsys.readouterr().out
    assert f"== robust.{cmd} [alexnet] ==" in text
    doc = TSchema.load(out)
    assert doc.env["torch"] == torch.__version__
    assert doc.results[0].name == f"robust_{cmd}" and doc.results[0].metrics


def test_cli_smoke_twice_reports_matrix_cached(tmp_path, monkeypatch,
                                              capsys):
    """`python -m repro_torch.robust smoke --device cpu` at a tiny size,
    twice on one cache: the second run reports matrix_cached true and its
    Monte-Carlo stage (`degradation_matrix`) never runs."""
    real = TT.train_cnn
    monkeypatch.setattr(TT, "train_cnn", lambda *a, **k: real(
        *a, **dict(k, n_train=64)))
    calls = []
    real_deg = TS.degradation_matrix
    monkeypatch.setattr(TS, "degradation_matrix",
                        lambda *a, **k: calls.append(1) or real_deg(*a, **k))
    monkeypatch.setenv("ROSA_PLAN_CACHE", str(tmp_path / "plans"))
    flags = []
    for _ in range(2):
        assert robust_main.main(["smoke", "--device", "cpu", "--steps", "1",
                                 "--n-eval", "16", "--n-chips", "2",
                                 "--n-probe", "1"]) == 0
        text = capsys.readouterr().out
        assert "== robust.smoke [alexnet] ==" in text
        flags.append(re.search(r'"matrix_cached": (\w+)', text).group(1))
    assert flags == ["false", "true"] and calls == [1]
    assert rosa.PlanCache(tmp_path / "plans").stats()["matrices"] == 1


def test_smoke_and_missing_card_raise():
    """Without a card the CLI's default device exits naming --device cpu,
    for smoke as for the other studies (no fallback to the CPU)."""
    if not torch.cuda.is_available():
        for cmd in ("ensemble", "smoke"):
            with pytest.raises(SystemExit, match="--device cpu"):
                robust_main.main([cmd])
    assert "smoke" in TCLI.RUNNERS


def test_port_imports_neither_jax_nor_the_reference():
    """No module of src/repro_torch, and not chip_smoke.py, imports jax or
    the reference package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 50
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad, bad


@pytest.mark.cuda
def test_gated_evaluator_on_cuda_matches_cpu():
    """The gated plan evaluator on the card (rosa_fused with one-hot gates
    and 0 / 1 mapping gates, mrr_transfer for the depthwise weights)
    against the plain CPU path, per chip within one image."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (kernels build on first "
                    "use)")
    with np.load(GOLDEN) as z:
        jp, _ = load_golden(z)
    names = [s.name for s in LITE_MODELS[MODEL]]
    ens = TV.sample_ensemble(_key(), 2, TV.cnn_lane_dims(MODEL))
    sel = (np.arange(len(names)) % 3 == 1).astype(np.float32)
    g = np.eye(len(names), dtype=np.float32)[names.index("mb4_dw")]
    out = []
    for device in ("cpu", "cuda"):
        x, y = TE.cnn_eval_set(N_EVAL, device=device)
        run = TE.make_plan_eval(TE.cnn_apply_fn(MODEL), rosa.Engine.from_config(
            TT.QAT_CFG, layers=names), names, eval_batch=EVAL_BATCH,
            gated=True)
        out.append(run(params_from_reference(jp, device), x, y,
                       {k: v.to(device) for k, v in ens.items()},
                       TM.split_keys(torch.Generator(device).manual_seed(0),
                                     2), sel, g))
    _within_one_image(out[1][0], out[0][0])
