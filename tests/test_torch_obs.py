"""Port parity of `repro_torch.obs`: the trace summarizer byte for byte, the
energy bridge, the Scheduler's spans / request events / counter tracks /
registry values on the same requests as the reference's, the compile spans
and plan-cache counters, the compile instants, the kernel-build hooks and
`launch.serve --trace`.

The reference runs as the JAX package's own tests run it on the CPU
(`test_torch_ref.reference()`); the port runs on the CPU.
"""

import io
import itertools
import json
import sys

import numpy as np
import pytest
import torch

from repro_torch import kernels, obs, rosa
from repro_torch.configs import get_smoke
from repro_torch.models.model import build_model, params_from_reference
from repro_torch.obs import cli as obs_cli
from repro_torch.robust.variation import from_reference
from repro_torch.serve import (Scheduler, ServeConfig, poisson_requests,
                               report_metrics, serving_model_config)
from repro_torch.serve.metrics import trace_serving_shapes
from repro_torch.training import cnn_train as TT
from test_torch_ref import reference

GOLDEN = (
    "trace: 7 events (2 spans)\n"
    "\n"
    "top 2 spans by self-time (ms):\n"
    "        self      total  count  name\n"
    "       2.000      3.000      1  compile\n"
    "       1.000      1.000      1  search\n"
    "\n"
    "requests:\n"
    "        id    ttft_ms     e2e_ms  args\n"
    "         7      1.000      2.000  tokens=5\n"
    "\n"
    "counters (final values):\n"
    "  energy.decode: J=0.25\n"
)
ENERGY_REL = 1e-12


@pytest.fixture(scope="module")
def R():
    return reference()


def _fake_clock():
    t = itertools.count()
    return lambda: next(t) * 1e-3       # 1 ms per call


def _summaries(R, path, top=15) -> tuple[str, str]:
    got, want = io.StringIO(), io.StringIO()
    obs_cli.summarize(str(path), top=top, out=got)
    R.obs_cli.summarize(str(path), top=top, out=want)
    return got.getvalue(), want.getvalue()


# ---------------------------------------------------------------------------
# The summarizer
# ---------------------------------------------------------------------------
def test_summary_golden_and_byte_equal_to_reference(R, tmp_path):
    tr = obs.Tracer(clock=_fake_clock())
    tr._pid = 1          # pin pid for byte-stable output paths
    with tr.span("compile", cat="stage"):
        with tr.span("search"):
            pass
    tr.async_begin("request", 7, cat="request", prompt_len=3)
    tr.async_instant("first_token", 7, cat="request")
    tr.async_end("request", 7, cat="request", tokens=5)
    tr.counter("energy.decode", {"J": 0.25}, cat="energy")
    path = tmp_path / "golden.json"
    tr.save(path)
    got, want = _summaries(R, path, top=5)
    assert got == want == GOLDEN


def test_summary_of_a_serving_trace_byte_equal_to_reference(R, tmp_path,
                                                            capsys):
    """A traced smoke serving run, a fake clock: nested spans, every
    request's lifecycle, counter tracks; --top cuts the span table."""
    sched = Scheduler(get_smoke("qwen3-32b"),
                      ServeConfig(n_slots=2, max_len=32, prefill_chunk=4),
                      device="cpu")
    tr = obs.Tracer(clock=_fake_clock())
    with obs.tracing(tr):
        sched.run(poisson_requests(4, 1.0, vocab=sched.cfg.vocab,
                                   prompt_len=(4, 8), gen_len=(2, 6),
                                   seed=0))
    path = tmp_path / "serve.json"
    tr.save(path)
    for top in (2, 15):
        got, want = _summaries(R, path, top=top)
        assert got == want
    assert obs_cli.main(["summarize", str(path), "--top", "3"]) == 0
    out = capsys.readouterr().out
    assert "top 3 spans" in out and "serve.tick" in out


# ---------------------------------------------------------------------------
# The energy bridge
# ---------------------------------------------------------------------------
def _toy_ledgers(R):
    """The reference test's ledger: one layer traced under "decode"."""
    jax, jnp = R.jax, R.jnp
    jl = R.rosa.EnergyLedger()
    jeng = R.rosa.Engine.from_config(R.rosa.RosaConfig(), layers=["l0"],
                                     key=jax.random.PRNGKey(0), ledger=jl)
    with jl.scope("decode"):
        jax.eval_shape(lambda x: jeng.matmul(x, jnp.zeros((8, 4)),
                                             name="l0"), jnp.zeros((2, 8)))
    tl = rosa.EnergyLedger()
    teng = rosa.Engine.from_config(rosa.RosaConfig(), layers=["l0"],
                                   ledger=tl)
    with tl.scope("decode"):
        teng.matmul(torch.empty((2, 8), device="meta"),
                    torch.empty((8, 4), device="meta"), name="l0")
    return tl, jl


def _serving_ledgers(R):
    """The qwen3-32b smoke serving trace (decode step + prefill chunk)."""
    scfg = ServeConfig(n_slots=4, max_len=56, prefill_chunk=8, rosa=True)
    bundle = build_model(serving_model_config(get_smoke("qwen3-32b"),
                                              rosa=True))
    tl = trace_serving_shapes(bundle, scfg, rosa.Engine.from_config(
        rosa.RosaConfig(act_per_vector=True), ledger=rosa.EnergyLedger()))
    jscfg = R.serve.ServeConfig(n_slots=4, max_len=56, prefill_chunk=8,
                                rosa=True)
    jbundle = R.model.build_model(R.serve.serving_model_config(
        R.configs.get_smoke("qwen3-32b"), rosa=True))
    jl = R.metrics.trace_serving_shapes(jbundle, jscfg,
                                        R.rosa.Engine.from_config(
        R.rosa.RosaConfig(act_per_vector=True),
        ledger=R.rosa.EnergyLedger()))
    return tl, jl


def _ticks(track, tracer_mod, ticks):
    tr = tracer_mod.Tracer()
    with tracer_mod.tracing(tr):
        for tag, n in ticks:
            track.tick(tag, n=n)
    return [(e["name"], e["args"]["J"]) for e in tr.events
            if e.get("ph") == "C"]


@pytest.mark.parametrize("ledgers", [_toy_ledgers, _serving_ledgers])
def test_energy_track_cumulative_j_equals_reference(R, ledgers):
    tl, jl = ledgers(R)
    assert [(e.name, e.m, e.k, e.n, e.tag) for e in tl.events] == \
        [(e.name, e.m, e.k, e.n, e.tag) for e in jl.events]
    ticks = [("decode", 1), ("prefill", 1), ("decode", 2), ("decode", 1),
             ("prefill", 3)]
    t_track, j_track = obs.EnergyTrack(tl), R.obs.EnergyTrack(jl)
    got = _ticks(t_track, obs, ticks)
    want = _ticks(j_track, R.obs, ticks)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert len(got) >= 3 and all(j > 0 for _, j in got)
    for (_, a), (_, b) in zip(got, want, strict=True):
        assert abs(a - b) <= ENERGY_REL * b
    assert abs(t_track.total_j() - j_track.total_j()) \
        <= ENERGY_REL * j_track.total_j()
    # no tracer: no accumulation, no emission
    idle = obs.EnergyTrack(tl)
    idle.tick("decode")
    assert idle.total_j() == 0.0


# ---------------------------------------------------------------------------
# The Scheduler's instrumentation against the reference's
# ---------------------------------------------------------------------------
def _trace_view(events) -> dict:
    """What the two packages must agree on: serve.* span counts, each
    request's async events (phase, name, args) in order, counter-track
    value sequences, and the compile instants' distinct shapes."""
    spans: dict = {}
    reqs: dict = {}
    tracks: dict = {}
    instants: set = set()
    for e in events:
        ph = e.get("ph")
        if ph == "X" and e["name"].startswith("serve."):
            spans[e["name"]] = spans.get(e["name"], 0) + 1
        elif ph in ("b", "n", "e"):
            reqs.setdefault(e["id"], []).append(
                (ph, e["name"], e.get("cat"), e.get("args", {})))
        elif ph == "C":
            tracks.setdefault(e["name"], []).append(e["args"])
        elif ph == "i" and e["name"] == "rosa.matmul":
            a = e["args"]
            instants.add((a["layer"], a["m"], a["k"], a["n"], a["dense"]))
    return {"spans": spans, "requests": reqs, "tracks": tracks,
            "instants": instants}


def _serve_both(R, rosa_on: bool):
    jcfg = R.configs.get_smoke("qwen3-32b")
    kw = dict(n_slots=2, max_len=32, prefill_chunk=8, seed=0, rosa=rosa_on,
              variation_seed=7 if rosa_on else None)
    jsched = R.serve.Scheduler(jcfg, R.serve.ServeConfig(**kw),
                               init_seed=0, plan_cache=False)
    jreqs = R.serve.poisson_requests(4, 1.0, vocab=jcfg.vocab,
                                     prompt_len=(4, 8), gen_len=(2, 6),
                                     seed=0)
    jreg, jtr = R.obs.MetricsRegistry(), R.obs.Tracer()
    with R.obs.swap_registry(jreg), R.obs.tracing(jtr):
        jrep = jsched.run(jreqs)
    chip = from_reference(jsched.engine.variation) if rosa_on else None
    sched = Scheduler(get_smoke("qwen3-32b"), ServeConfig(**kw),
                      params=params_from_reference(jsched.params),
                      chip=chip, device="cpu", plan_cache=False)
    reqs = poisson_requests(4, 1.0, vocab=jcfg.vocab, prompt_len=(4, 8),
                            gen_len=(2, 6), seed=0)
    reg, tr = obs.MetricsRegistry(), obs.Tracer()
    with obs.swap_registry(reg), obs.tracing(tr):
        rep = sched.run(reqs)
    return (rep, reg, tr), (jrep, jreg, jtr)


@pytest.mark.parametrize("rosa_on", [False, True], ids=["plain", "rosa"])
def test_scheduler_trace_equals_reference(R, rosa_on):
    (rep, reg, tr), (jrep, jreg, jtr) = _serve_both(R, rosa_on)
    assert {r: c.tokens for r, c in rep.completions.items()} == \
        {r: c.tokens for r, c in jrep.completions.items()}
    got, want = _trace_view(tr.events), _trace_view(jtr.events)
    assert got["spans"] == want["spans"]
    assert got["spans"]["serve.tick"] == rep.ticks
    assert got["requests"] == want["requests"]
    assert len(got["requests"]) == 4
    assert got["instants"] == want["instants"]
    track_names = set(got["tracks"])
    assert track_names == set(want["tracks"])
    assert {"serve.queue_depth", "serve.slots_active"} <= track_names
    assert (("energy.decode" in track_names)
            and ("energy.prefill" in track_names)) == rosa_on
    for name, vals in want["tracks"].items():
        if name.startswith("energy."):
            a = [v["J"] for v in got["tracks"][name]]
            b = [v["J"] for v in vals]
            assert len(a) == len(b)
            np.testing.assert_allclose(a, b, rtol=ENERGY_REL, atol=0)
        else:
            assert got["tracks"][name] == vals
    snap = {k: v for k, v in reg.snapshot().items()
            if k.startswith("serve.")}
    jsnap = {k: v for k, v in jreg.snapshot().items()
             if k.startswith("serve.")}
    assert snap == jsnap
    assert snap["serve.requests_completed"] == 4
    for c in rep.completions.values():
        assert (c.enqueue_wall <= c.first_token_wall <= c.admit_wall
                <= c.done_wall)


def test_traced_and_untraced_runs_agree():
    """Tracing changes neither the tokens nor any gated metric."""
    sched = Scheduler(get_smoke("qwen3-32b"),
                      ServeConfig(n_slots=2, max_len=32, prefill_chunk=8,
                                  seed=0, rosa=True, rosa_backend="fused",
                                  variation_seed=7),
                      device="cpu", plan_cache=False)
    reqs = poisson_requests(4, 1.0, vocab=sched.cfg.vocab,
                            prompt_len=(4, 8), gen_len=(2, 6), seed=0)
    with obs.tracing(None):
        off = sched.run(reqs)
    tr = obs.Tracer()
    with obs.tracing(tr):
        on = sched.run(reqs)
    assert {r: c.tokens for r, c in off.completions.items()} == \
        {r: c.tokens for r, c in on.completions.items()}
    gated = [{m.name: m.value for m in report_metrics(rep) if m.gate}
             for rep in (off, on)]
    assert gated[0] == gated[1] and gated[0]
    # the compile instants: once per distinct shape, not once per launch
    inst = [e for e in tr.events if e.get("ph") == "i"]
    fused = [e for e in inst if e["name"] == "kernels.rosa_fused"]
    specs = {tuple(sorted(e["args"].items())) for e in fused}
    routed = 2 * sched.cfg.n_layers * (on.decode_steps + on.prefill_chunks)
    assert len(fused) == len(specs) == 4 < routed   # wi / wo x (2, 8) rows
    matmuls = [e for e in inst if e["name"] == "rosa.matmul"]
    assert len(matmuls) == len({tuple(sorted(e["args"].items()))
                                for e in matmuls})


# ---------------------------------------------------------------------------
# Compile spans, plan-cache counters
# ---------------------------------------------------------------------------
def _alexnet_compile(pkg, cnn, skel, x, cache, **kw):
    specs = cnn.LITE_MODELS["alexnet"]

    def apply_fn(eng, params, xx):
        return cnn.cnn_apply(params, specs, xx, eng,
                             residual_from=cnn.LITE_SKIPS.get("alexnet"))

    engine = pkg.Engine.from_config(cnn.QAT_CFG)
    tune = pkg.AutotuneConfig(batch=4)
    return [pkg.compile(apply_fn, engine, (skel, x), autotune=tune,
                        cache=cache, **kw) for _ in range(2)]


def test_compile_spans_and_plancache_counters_equal_reference(R, tmp_path):
    specs = TT.LITE_MODELS["alexnet"]
    counts = []
    for port in (True, False):
        o = obs if port else R.obs
        reg, tr = o.MetricsRegistry(), o.Tracer()
        with o.swap_registry(reg), o.tracing(tr):
            if port:
                cold, warm = _alexnet_compile(
                    rosa, TT, TT.abstract_params(TT.cnn_def(specs),
                                                 torch.float32),
                    torch.empty((4, 32, 32, 3), device="meta"),
                    tmp_path / "port", device="cpu")
            else:
                m = R.cnn_train
                cold, warm = _alexnet_compile(
                    R.rosa, m, m.abstract_params(m.cnn_def(specs),
                                                 R.jnp.float32),
                    R.jax.ShapeDtypeStruct((4, 32, 32, 3), R.jnp.float32),
                    tmp_path / "ref")
        assert cold.searched and warm.cache_hit
        names = [e["name"] for e in tr.events if e.get("ph") == "X"]
        counts.append({
            "spans": {n: names.count(n) for n in (
                "rosa.compile", "rosa.capture_trace", "rosa.plan_search",
                "plancache.store", "plancache.load", "rosa.freeze")},
            "misses": reg.counter("rosa.plancache_misses").value,
            "hits": reg.counter("rosa.plancache_hits").value})
    assert counts[0] == counts[1]
    assert counts[0]["spans"] == {
        "rosa.compile": 2, "rosa.capture_trace": 2, "rosa.plan_search": 1,
        "plancache.store": 1, "plancache.load": 2, "rosa.freeze": 2}
    assert counts[0]["misses"] == counts[0]["hits"] == 1


# ---------------------------------------------------------------------------
# Kernel-build hooks
# ---------------------------------------------------------------------------
def test_kernel_hooks_idempotent_and_count_builds(tmp_path, monkeypatch):
    """`build_all` against a stand-in nvcc: one build the first time, a
    cache hit the second; each build a back-dated kernels.build span."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// a kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", build)
    monkeypatch.setattr(kernels, "nvcc_path", lambda: str(nvcc))
    # a process whose hooks are not installed yet
    monkeypatch.setattr(kernels, "BUILD_LISTENERS", [])
    monkeypatch.setattr(obs.metrics, "_KERNEL_HOOKS_INSTALLED", False)
    reg, tr = obs.MetricsRegistry(), obs.Tracer()
    with obs.swap_registry(reg), obs.tracing(tr):
        kernels.build_all()                      # before the hooks: silent
        assert reg.snapshot() == {}
        for lib in build.glob("*.so"):
            lib.unlink()
        assert obs.install_kernel_hooks() and obs.install_kernel_hooks()
        assert kernels.BUILD_LISTENERS.count(obs.metrics._on_build) == 1
        libs = kernels.build_all()
        assert libs["fake"].exists()
        kernels.build_all()
    assert reg.counter("kernels.builds").value == 1
    assert reg.counter("kernels.build_cache_hits").value == 1
    assert reg.histogram("kernels.build_s").count == 1
    builds = [e for e in tr.events if e.get("name") == "kernels.build"]
    assert len(builds) == 1 and builds[0]["ph"] == "X"
    assert builds[0]["args"] == {"kernel": "fake"}
    assert 0 <= builds[0]["ts"] and builds[0]["dur"] > 0
    assert [e["name"] for e in tr.events if e.get("ph") == "i"] == \
        ["kernels.build_cache_hits"]


# ---------------------------------------------------------------------------
# launch.serve --trace
# ---------------------------------------------------------------------------
def test_serve_cli_trace_reads_in_the_summarizer(tmp_path, capsys):
    from repro_torch.launch import serve

    path = tmp_path / "serve.json"
    serve.main(["--smoke", "--device", "cpu", "--rosa", "--variation-seed",
                "7", "--requests", "3", "--trace", str(path)])
    out = capsys.readouterr().out
    assert f"python -m repro_torch.obs summarize {path}" in out
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"serve.tick", "serve.prefill_chunk", "serve.decode_step",
            "rosa.compile", "energy.decode", "request"} <= names
    assert obs_cli.main(["summarize", str(path)]) == 0
    summary = capsys.readouterr().out
    assert "requests:" in summary and "energy.decode: J=" in summary
