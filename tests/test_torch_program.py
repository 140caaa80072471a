"""Port parity of compile-once Programs and the on-disk PlanCache
(`repro_torch.rosa.program`, `serialize`, `__main__`) against the JAX
reference (`repro.rosa`), on the CPU.

The two packages share the cache: the same trace, base RosaConfig,
autotune settings and degradation lower to byte-equal canonical JSON and
so to equal keys, a plan stored by either package loads in the other,
and `compile` searches through `profile_layers_fast` as the reference
does, so both give the same plan on every traced workload (a toy
two-layer net, the qwen3-32b smoke decode step, alexnet).  Plans and keys
are compared exactly; the energy models agree to float64 rounding (held
at 1e-9 in test_torch_energy_vec.py), far inside the EDP margins the
plans turn on.  The rest mirrors the PlanCache tests of
tests/test_program.py and tests/test_adaptive.py: DegradationSource
measure-on-miss, EDP_ONLY, LRU gc, stats and the CLI, corrupt entries as
misses, `lower()` and the deprecated wrappers.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import rosa
from repro_torch.configs import get_smoke
from repro_torch.core import mapping as TMap
from repro_torch.core import mrr as TM
from repro_torch.core import osa as TO
from repro_torch.core.constants import Mapping
from repro_torch.models.model import build_model
from repro_torch.rosa import __main__ as rosa_main
from repro_torch.rosa import serialize as TSer
from repro_torch.serve import (ServeConfig, build_serving_program,
                               serving_model_config)
from repro_torch.training import cnn_train as TT
from test_torch_ref import reference

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
WORKLOADS = ("toy", "qwen3-32b", "alexnet")
MODES = ("edp", "deg", "guard")


@pytest.fixture(scope="module")
def R():
    return reference()


def _noisy(pkg):
    return pkg.rosa.RosaConfig(noise=pkg.mrr.PAPER_NOISE)


class _Port:
    """The port's modules under the names the reference namespace uses."""
    rosa, mrr = rosa, TM


# ---------------------------------------------------------------------------
# The traced workloads, built alike in both packages
# ---------------------------------------------------------------------------
def _toy_net(eng, x, w1, w2):
    return eng.matmul(eng.matmul(x, w1, name="a"), w2, name="b")


def _toy(port: bool, R, width: int = 16):
    shapes = ((4, width), (width, 8), (8, 4))
    if port:
        args = tuple(torch.empty(s, device="meta") for s in shapes)
    else:
        args = tuple(R.jax.ShapeDtypeStruct(s, R.jnp.float32)
                     for s in shapes)
    return _toy_net, args


def _qwen(port: bool, R):
    """The qwen3-32b smoke decode step at 4 slots (mlp/wi, mlp/wo)."""
    if port:
        bundle = build_model(serving_model_config(get_smoke("qwen3-32b"),
                                                  rosa=True))
        from repro_torch.serve.metrics import abstract_decode_batch
        scfg = ServeConfig(n_slots=4, max_len=56)
        return (lambda eng, p, b: bundle.decode_step(p, b),
                (bundle.abstract(torch.float32),
                 abstract_decode_batch(bundle.cfg, scfg)))
    bundle = R.model.build_model(R.serve.serving_model_config(
        R.configs.get_smoke("qwen3-32b"), rosa=True))
    scfg = R.serve.ServeConfig(n_slots=4, max_len=56)
    return (lambda eng, p, b: bundle.decode_step(p, b),
            (bundle.abstract(R.jnp.float32),
             R.metrics._abstract_decode_batch(bundle.cfg, scfg)))


def _alexnet(port: bool, R):
    """alexnet's eight conv/fc layers at batch 8 on 32x32 images."""
    m = TT if port else R.cnn_train
    specs = m.LITE_MODELS["alexnet"]

    def apply_fn(eng, params, x):
        return m.cnn_apply(params, specs, x, eng,
                           residual_from=m.LITE_SKIPS.get("alexnet"))

    if port:
        skel = m.abstract_params(m.cnn_def(specs), torch.float32)
        x = torch.empty((8, 32, 32, 3), device="meta")
    else:
        skel = m.abstract_params(m.cnn_def(specs), R.jnp.float32)
        x = R.jax.ShapeDtypeStruct((8, 32, 32, 3), R.jnp.float32)
    return apply_fn, (skel, x)


def _workload(name, port, R):
    return {"toy": _toy, "qwen3-32b": _qwen, "alexnet": _alexnet}[name](
        port, R)


def _deg(names, seed: int) -> dict:
    """A Monte-Carlo-like degradation matrix from a seed (numpy), the IS
    column the worse by 3-80x: enough to turn the toy net's layers, whose
    IS and WS EDPs are within 1 %, to WS."""
    rng = np.random.default_rng(seed)
    return {n: {Mapping.IS.value: float(rng.uniform(10.0, 40.0)),
                Mapping.WS.value: float(rng.uniform(0.5, 3.0))}
            for n in names}


def _autotune(pkg, mode):
    tune = pkg.rosa.AutotuneConfig(batch=4)
    return dataclasses.replace(tune, guard_pp=0.5) if mode == "guard" \
        else tune


def _compile(port, R, work, cfg, mode, cache, deg=None, device="cpu"):
    pkg = _Port if port else R
    apply_fn, args = _workload(work, port, R)
    eng = pkg.rosa.Engine.from_config(cfg)
    kw = {"device": device} if port else {}
    return pkg.rosa.compile(apply_fn, eng, args,
                            autotune=_autotune(pkg, mode),
                            degradation=deg if mode != "edp" else None,
                            cache=cache, **kw)


def _plan_doc(prog) -> dict:
    return json.loads(TSer.canonical_json(prog.plan.to_json()))


# ---------------------------------------------------------------------------
# Serialization and keys: byte-equal across the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("noise", ["ideal", "paper"])
def test_config_canonical_json_byte_equal(R, noise):
    cfg_t = rosa.RosaConfig(noise=TM.IDEAL if noise == "ideal"
                            else TM.PAPER_NOISE, mapping=Mapping.IS,
                            osa_cfg=TO.OSAConfig(splitter_imbalance=0.01),
                            backend="fused", act_per_vector=True)
    cfg_j = R.rosa.RosaConfig(
        noise=R.mrr.IDEAL if noise == "ideal" else R.mrr.PAPER_NOISE,
        mapping=R.constants.Mapping.IS,
        osa_cfg=R.osa.OSAConfig(splitter_imbalance=0.01), backend="fused",
        act_per_vector=True)
    got = TSer.canonical_json(TSer.config_to_json(cfg_t))
    assert got == R.rosa.serialize.canonical_json(
        R.rosa.serialize.config_to_json(cfg_j))
    # the folded MRR chain keeps its constants out of MRRParams' fields
    assert json.loads(got)["mrr_params"] == dataclasses.asdict(TM.MRRParams())
    assert TSer.config_from_json(json.loads(got)) == cfg_t
    for tune in (rosa.AutotuneConfig(), rosa.EDP_ONLY,
                 rosa.AutotuneConfig(batch=64, guard_pp=0.5)):
        j = R.rosa.AutotuneConfig(batch=tune.batch, guard_pp=tune.guard_pp,
                                  accuracy_aware=tune.accuracy_aware)
        assert TSer.canonical_json(tune.to_json()) == \
            R.rosa.serialize.canonical_json(j.to_json())
        assert rosa.AutotuneConfig.from_json(tune.to_json()) == tune


@pytest.mark.parametrize("noise", ["ideal", "paper"])
@pytest.mark.parametrize("guard", [None, 0.5])
@pytest.mark.parametrize("work", WORKLOADS)
def test_plan_cache_key_equal_across_packages(R, work, noise, guard):
    """The same trace, config, autotune and degradation give the same
    canonical documents and the same PlanCache key in both packages."""
    t_cfg = rosa.RosaConfig(noise=TM.IDEAL if noise == "ideal"
                            else TM.PAPER_NOISE)
    j_cfg = R.rosa.RosaConfig(noise=R.mrr.IDEAL if noise == "ideal"
                              else R.mrr.PAPER_NOISE)
    fn, args = _workload(work, True, R)
    t_trace = rosa.capture_trace(fn, rosa.Engine.from_config(t_cfg), args)
    fn, args = _workload(work, False, R)
    j_trace = R.rosa.capture_trace(fn, R.rosa.Engine.from_config(j_cfg),
                                   args)
    assert TSer.canonical_json(t_trace.to_json()) == \
        R.rosa.serialize.canonical_json(j_trace.to_json())
    assert t_trace.fingerprint == j_trace.fingerprint
    deg = _deg(t_trace.names, 3)
    t_tune = rosa.AutotuneConfig(batch=4, guard_pp=guard)
    j_tune = R.rosa.AutotuneConfig(batch=4, guard_pp=guard)
    for d in (None, deg):
        assert rosa.PlanCache.key(t_trace, t_cfg, t_tune, d) == \
            R.rosa.PlanCache.key(j_trace, j_cfg, j_tune, d)
    assert rosa.PlanCache.matrix_key(t_cfg, {"kind": "x"}) == \
        R.rosa.PlanCache.matrix_key(j_cfg, {"kind": "x"})


# ---------------------------------------------------------------------------
# The search: the reference's plan on every traced workload
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("work", WORKLOADS)
def test_compile_plan_equals_reference(R, work, mode):
    """EDP-only, with a degradation dict, and with guard_pp: the port's
    compile (profile_layers_fast) and the reference's give one plan."""
    fn, args = _workload(work, True, R)
    names = rosa.capture_trace(fn, rosa.Engine.from_config(_noisy(_Port)),
                               args).names
    deg = _deg(names, 7)
    port = _compile(True, R, work, _noisy(_Port), mode, False, deg)
    ref = _compile(False, R, work, _noisy(R), mode, False, deg)
    assert port.searched and not port.cache_hit
    assert port.cache_key == ref.cache_key
    assert _plan_doc(port) == json.loads(
        R.rosa.serialize.canonical_json(ref.plan.to_json()))
    profs = TMap.profile_layers_fast(port.trace.layer_shapes(),
                                     rosa.AutotuneConfig().ope, batch=4,
                                     device="cpu")
    edp_plan = TMap.hybrid_plan(profs)
    if mode == "edp":
        assert port.plan.mapping_plan() == edp_plan
    elif work == "toy":
        # the matrix steers the search away from the EDP argmin
        assert port.plan.mapping_plan() != edp_plan


def test_guard_vetoes_costly_mappings(R):
    """A matrix with IS far worse and guard_pp: every layer stays WS, in
    both packages."""
    deg = {n: {Mapping.IS.value: 50.0, Mapping.WS.value: 0.0}
           for n in ("a", "b")}
    prog = _compile(True, R, "toy", _noisy(_Port), "guard", False, deg)
    assert set(prog.plan.mapping_plan().values()) == {Mapping.WS}
    ref = _compile(False, R, "toy", _noisy(R), "guard", False, deg)
    assert {m.value for m in ref.plan.mapping_plan().values()} == \
        {Mapping.WS.value}


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("work", ["toy", "alexnet"])
def test_plan_stored_by_one_package_loads_in_the_other(R, tmp_path, work,
                                                       writer):
    deg = _deg(["a", "b", "conv1", "conv2", "conv3", "conv4", "conv5",
                "fc1", "fc2", "fc3"], 1)
    first = _compile(writer == "port", R, work,
                     _noisy(_Port if writer == "port" else R), "guard",
                     tmp_path, deg)
    second = _compile(writer != "port", R, work,
                      _noisy(_Port if writer != "port" else R), "guard",
                      tmp_path, deg)
    assert first.searched and second.cache_hit and not second.searched
    assert first.cache_key == second.cache_key
    docs = [json.loads(TSer.canonical_json(p.plan.to_json()))
            for p in (first, second)]
    assert docs[0] == docs[1]


def test_serving_warm_start_loads_the_reference_plan(R, tmp_path):
    """The serving compile (qwen3-32b smoke, backend ref) of the reference
    stores its plan; the port's warm start loads it and skips the search."""
    j_cfg = R.configs.get_smoke("qwen3-32b")
    j_bundle = R.model.build_model(R.serve.serving_model_config(j_cfg,
                                                                rosa=True))
    jprog = R.metrics.build_serving_program(
        j_bundle, R.serve.ServeConfig(rosa=True), cache=tmp_path)
    bundle = build_model(serving_model_config(get_smoke("qwen3-32b"),
                                              rosa=True))
    prog = build_serving_program(bundle, ServeConfig(rosa=True),
                                 device="cpu", cache=tmp_path)
    assert jprog.searched and prog.cache_hit and not prog.searched
    assert prog.cache_key == jprog.cache_key
    assert {k: v.value for k, v in prog.plan.mapping_plan().items()} == \
        {k: v.value for k, v in jprog.plan.mapping_plan().items()}
    assert rosa.PlanCache(tmp_path).stats()["plans"] == 1


# ---------------------------------------------------------------------------
# Cold / warm, DegradationSource, EDP_ONLY
# ---------------------------------------------------------------------------
def _counting_source(calls, spec=None):
    def measure(names):
        calls.append(tuple(names))
        return {n: {Mapping.IS.value: 2.0, Mapping.WS.value: 0.0}
                for n in names}
    return rosa.DegradationSource(measure=measure,
                                  spec=spec or {"kind": "test", "v": 1})


def test_plan_cache_cold_then_warm(R, tmp_path):
    cold = _compile(True, R, "toy", _noisy(_Port), "edp", tmp_path)
    assert cold.searched and not cold.cache_hit
    assert (tmp_path / f"{cold.cache_key}.json").exists()
    warm = _compile(True, R, "toy", _noisy(_Port), "edp", tmp_path)
    assert warm.cache_hit and not warm.searched
    assert warm.cache_key == cold.cache_key and warm.plan == cold.plan
    # another config, other settings and another trace miss
    six = _compile(True, R, "toy", dataclasses.replace(_noisy(_Port),
                                                       quant_bits=6),
                   "edp", tmp_path)
    assert six.searched and six.cache_key != cold.cache_key
    fn, args = _toy(True, R, width=32)
    wide = rosa.compile(fn, rosa.Engine.from_config(_noisy(_Port)), args,
                        autotune=rosa.AutotuneConfig(batch=4),
                        cache=tmp_path, device="cpu")
    assert wide.searched and wide.cache_key != cold.cache_key


def test_degradation_source_measures_once_then_warm_skips(R, tmp_path):
    """measure runs once per layer over a cold and a warm compile, not at
    all when warm, and only for the layers the store lacks."""
    calls = []
    src = _counting_source(calls)
    cold = _compile(True, R, "toy", _noisy(_Port), "deg", tmp_path, src)
    assert cold.searched and calls == [("a", "b")]
    warm = _compile(True, R, "toy", _noisy(_Port), "deg", tmp_path, src)
    assert warm.cache_hit and calls == [("a", "b")]
    assert warm.plan == cold.plan
    (tmp_path / f"{cold.cache_key}.json").unlink()   # plan gone, rows kept
    again = _compile(True, R, "toy", _noisy(_Port), "deg", tmp_path, src)
    assert again.searched and calls == [("a", "b")]
    # a store holding one row: only the other is measured
    calls2 = []
    src2 = _counting_source(calls2, {"kind": "test", "v": 2})
    store = rosa.PlanCache(tmp_path)
    store.store_matrix(store.matrix_key(_noisy(_Port), src2.spec),
                       {"a": {Mapping.IS.value: 2.0, Mapping.WS.value: 0.0}})
    _compile(True, R, "toy", _noisy(_Port), "deg", tmp_path, src2)
    assert calls2 == [("b",)]


def test_degradation_rows_stored_by_the_reference_skip_measure(R, tmp_path):
    """Rows a reference DegradationSource stored are found by the port's
    source of the same spec: the port measures nothing."""
    def j_measure(names):
        return {n: {"input_stationary": 2.0, "weight_stationary": 0.0}
                for n in names}
    spec = {"kind": "shared", "v": 1}
    jsrc = R.rosa.DegradationSource(measure=j_measure, spec=spec)
    ref = _compile(False, R, "toy", _noisy(R), "deg", tmp_path, jsrc)
    (tmp_path / f"{ref.cache_key}.json").unlink()
    calls = []
    port = _compile(True, R, "toy", _noisy(_Port), "deg", tmp_path,
                    _counting_source(calls, spec))
    assert calls == [] and port.searched
    assert _plan_doc(port) == json.loads(
        R.rosa.serialize.canonical_json(ref.plan.to_json()))


def test_edp_only_leaves_degradation_out_of_the_key(R, tmp_path):
    calls = []
    src = _counting_source(calls)
    tune = dataclasses.replace(rosa.EDP_ONLY, batch=4)
    fn, args = _toy(True, R)
    eng = rosa.Engine.from_config(_noisy(_Port))
    a = rosa.compile(fn, eng, args, autotune=tune, degradation=src,
                     cache=tmp_path, device="cpu")
    b = rosa.compile(fn, eng, args, autotune=tune,
                     degradation=_deg(["a", "b"], 0), cache=tmp_path,
                     device="cpu")
    assert calls == [] and a.searched and b.cache_hit
    assert a.cache_key == b.cache_key == rosa.PlanCache.key(
        a.trace, _noisy(_Port), tune, None)
    assert rosa.AutotuneConfig().accuracy_aware and not tune.accuracy_aware
    doc = rosa.AutotuneConfig().to_json()
    doc.pop("accuracy_aware")
    assert rosa.AutotuneConfig.from_json(doc).accuracy_aware


# ---------------------------------------------------------------------------
# The store: LRU gc, stats, the CLI, corrupt entries
# ---------------------------------------------------------------------------
def _fill(cache, names):
    for n in names:
        cache.store_matrix(n, {"layer": {"weight_stationary": 1.0}})


def test_plancache_gc_bound_and_lru(tmp_path):
    cache = rosa.PlanCache(tmp_path, max_entries=3)
    _fill(cache, [f"k{i}" for i in range(6)])    # gc runs after each store
    assert cache.stats()["entries"] == 3
    assert {p.name for p in tmp_path.iterdir()} == \
        {"k3.deg.json", "k4.deg.json", "k5.deg.json"}
    os.utime(tmp_path / "k4.deg.json", (1.0, 1.0))
    os.utime(tmp_path / "k5.deg.json", (2.0, 2.0))
    assert cache.load_matrix("k3") is not None   # a load makes k3 MRU
    assert cache.gc(1) == 2
    assert {p.name for p in tmp_path.iterdir()} == {"k3.deg.json"}


def test_plancache_stats_and_validation(tmp_path):
    with pytest.raises(ValueError):
        rosa.PlanCache(tmp_path, max_entries=0)
    cache = rosa.PlanCache(tmp_path)
    assert cache.gc() == 0                       # unbounded: a no-op
    with pytest.raises(ValueError):
        cache.gc(0)
    _fill(cache, ["a", "b"])
    st = cache.stats()
    assert st["entries"] == 2 and st["matrices"] == 2 and st["plans"] == 0
    assert st["bytes"] > 0 and st["max_entries"] is None
    assert st["root"] == str(tmp_path)
    json.dumps(st)


def test_plancache_cli_stats_and_gc(tmp_path, capsys):
    _fill(rosa.PlanCache(tmp_path), [f"k{i}" for i in range(4)])
    assert rosa_main.main(["stats", "--root", str(tmp_path)]) == 0
    assert json.loads(capsys.readouterr().out)["entries"] == 4
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.rosa", "gc", "--max-entries",
         "2", "--root", str(tmp_path)], capture_output=True, text=True,
        env=env, check=True)
    doc = json.loads(out.stdout)
    assert doc["evicted"] == 2 and doc["entries"] == 2


def test_default_cache_dir_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("ROSA_PLAN_CACHE", str(tmp_path / "x"))
    assert rosa.default_cache_dir() == tmp_path / "x"
    assert rosa.PlanCache().root == tmp_path / "x"
    monkeypatch.delenv("ROSA_PLAN_CACHE")
    assert str(rosa.default_cache_dir()).endswith(".cache/rosa-repro/plans")


@pytest.mark.parametrize("content", ["{corrupt", '{"schema": 1}',
                                     '{"schema": 2, "key": "other"}',
                                     '{"schema": 2, "key": "K", "plan": 3}'])
def test_corrupt_or_stale_entries_are_misses(R, tmp_path, content):
    cold = _compile(True, R, "toy", _noisy(_Port), "edp", tmp_path)
    path = tmp_path / f"{cold.cache_key}.json"
    path.write_text(content.replace('"K"', f'"{cold.cache_key}"'))
    cache = rosa.PlanCache(tmp_path)
    assert cache.load(cold.cache_key) is None
    assert cache.load_matrix(cold.cache_key) is None
    again = _compile(True, R, "toy", _noisy(_Port), "edp", tmp_path)
    assert again.searched and again.plan == cold.plan
    assert cache.load(cold.cache_key) == cold.plan     # overwritten whole


def test_counters_count_hits_misses_and_evictions(R, tmp_path):
    from repro_torch.obs import metrics as obs_metrics
    with obs_metrics.swap_registry(obs_metrics.MetricsRegistry()) as reg:
        _compile(True, R, "toy", _noisy(_Port), "edp", tmp_path)
        _compile(True, R, "toy", _noisy(_Port), "edp", tmp_path)
        _fill(rosa.PlanCache(tmp_path, max_entries=1), ["m"])
        snap = reg.snapshot()
    assert snap["rosa.plancache_misses"] == 1
    assert snap["rosa.plancache_hits"] == 1
    assert snap["rosa.plancache_evictions"] == 1
    assert "rosa_plancache_hits 1" in reg.to_prometheus()


# ---------------------------------------------------------------------------
# lower(), verify=, the deprecated wrappers
# ---------------------------------------------------------------------------
def test_lower_round_trips(R, tmp_path):
    prog = _compile(True, R, "alexnet", _noisy(_Port), "edp", tmp_path)
    doc = json.loads(prog.lower_json())
    assert doc == json.loads(json.dumps(prog.lower()))
    assert rosa.ExecutionPlan.from_json(doc["plan"]) == prog.plan
    assert rosa.ProgramTrace.from_json(doc["trace"]) == prog.trace
    assert doc["cache_key"] == prog.cache_key and doc["searched"]
    plan = rosa.ExecutionPlan.build(
        _noisy(_Port), {"a": dataclasses.replace(
            _noisy(_Port), mapping=Mapping.IS, quant_bits=6), "b": None},
        layers=("a", "b", "c"))
    assert rosa.ExecutionPlan.from_json(
        json.loads(json.dumps(plan.to_json()))) == plan


def test_verify_and_base_config_are_checked(R):
    fn, args = _toy(True, R)
    with pytest.raises(NotImplementedError, match="item 6"):
        rosa.compile(fn, rosa.Engine.from_config(_noisy(_Port)), args,
                     verify="warn")
    with pytest.raises(ValueError, match="autotune"):
        rosa.compile(fn, rosa.Engine.dense(), args,
                     autotune=rosa.AutotuneConfig(), cache=False)


def test_deprecated_wrappers_warn_and_delegate():
    eng = rosa.Engine.from_config(_noisy(_Port))
    with pytest.warns(DeprecationWarning, match="use_engine"):
        ctx = rosa.use_engine(eng)
    with ctx:
        with pytest.warns(DeprecationWarning, match="current_engine"):
            assert rosa.current_engine() is eng
        assert rosa.ambient_engine() is eng
    assert rosa.ambient_engine() is None
