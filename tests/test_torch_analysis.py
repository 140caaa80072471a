"""`repro_torch.analysis`: findings and baselines against the reference's
(fingerprints, JSON, baselines written by either package), each check on
a target built to trip it and on a clean one, the CLI's baseline cycle,
`rosa.compile(verify=...)`, and the smoke serving stack's targets.

Tests marked `cuda` run the targets on the card (the sync-debug paths of
the purity check) and skip without one.
"""

import json
import os
import pathlib
import subprocess
import sys
import warnings

import pytest
import torch

from repro_torch import analysis as A
from repro_torch import rosa
from repro_torch.analysis import (AnalysisTarget, Severity,
                                  VerificationError, load_baseline,
                                  run_checks, write_baseline)
from repro_torch.analysis import cli as analysis_cli
from repro_torch.analysis.checks import kernels as kernel_check
from repro_torch.analysis.findings import AnalysisReport, Finding
from repro_torch.core import mrr
from test_torch_ref import reference


@pytest.fixture(scope="module")
def R():
    return reference()


def codes(findings):
    return sorted({f.code for f in findings})


def check(name, fn=None, args=(), **kw):
    return list(run_checks([AnalysisTarget("t", fn, tuple(args), **kw)],
                           checks=[name]))


def _finding(code="X001", sev=Severity.WARNING, loc="here", pkg=None):
    cls = pkg.analysis.Finding if pkg else Finding
    sev = pkg.analysis.Severity[sev.name] if pkg else sev
    return cls(check="x", code=code, severity=sev, subject="s",
               location=loc, message="m")


# ---------------------------------------------------------------------------
# Findings and baselines
# ---------------------------------------------------------------------------
def test_fingerprint_ignores_message_and_equals_reference(R):
    a = _finding()
    b = Finding(check="x", code="X001", severity=Severity.WARNING,
                subject="s", location="here", message="other words")
    assert a.fingerprint == b.fingerprint == _finding(pkg=R).fingerprint
    assert a.to_json() == _finding(pkg=R).to_json()
    rep = AnalysisReport((_finding(), _finding("X002", Severity.ERROR)))
    back = AnalysisReport.from_json(json.loads(json.dumps(rep.to_json())))
    assert back == rep
    assert back.summary() == "2 findings (1 error, 1 warning, 0 info)"


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_baseline_loads_in_the_other_package(R, tmp_path, writer):
    path = tmp_path / "base.json"
    if writer == "port":
        write_baseline(path, AnalysisReport((_finding("X001"),)))
        acked = R.analysis.load_baseline(path)
    else:
        R.analysis.write_baseline(
            path, R.analysis.AnalysisReport((_finding("X001", pkg=R),)))
        acked = load_baseline(path)
    assert acked == {_finding("X001").fingerprint}
    rep = AnalysisReport((_finding("X001"), _finding("X002"),
                          _finding("X003", Severity.INFO)))
    jrep = R.analysis.AnalysisReport(
        (_finding("X001", pkg=R), _finding("X002", pkg=R),
         _finding("X003", Severity.INFO, pkg=R)))
    assert [f.code for f in rep.new_against(acked)] == ["X002"] == \
        [f.code for f in jrep.new_against(acked)]


def test_missing_and_wrong_schema_baselines(tmp_path):
    assert load_baseline(tmp_path / "nope.json") == set()
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"schema": 99, "findings": {}}))
    with pytest.raises(ValueError, match="repro_torch.analysis"):
        load_baseline(p)
    with pytest.raises(ValueError):
        run_checks([], checks=["nonexistent"])


# ---------------------------------------------------------------------------
# kernels: KER001-003
# ---------------------------------------------------------------------------
def test_kernel_preflight_findings(monkeypatch):
    def shapes(*gemms, ssd=()):
        return check("kernels", gemm_shapes=gemms, ssd_shapes=ssd)

    # deepseek-v2's router: 160 columns in 128-column tiles, 60 % waste
    waste = shapes(("router", 512, 5120, 160))
    assert codes(waste) == ["KER002"]
    assert {f.location.split(":")[0] for f in waste} == \
        {"osa_matmul", "rosa_fused"}
    # a zero dimension and a batch past grid y's 65535 are refused
    bad = shapes(("empty", 0, 64, 64),
                 ssd=(("wide", 70000, 128, 8, 64, 64),))
    assert codes(bad) == ["KER003"]
    assert all(f.severity is Severity.ERROR for f in bad)
    assert any("65535" in f.message for f in bad)
    # an aligned decode shape is clean
    assert shapes(("mlp/wi", 4, 5120, 51200)) == []
    # a card with 48 KB of shared memory a block cannot stage the scan
    monkeypatch.setattr(kernel_check, "device_limits", lambda: dict(
        kernel_check.H100, smem_bytes=48 * 1024))
    small = shapes(ssd=(("mamba2", 1, 512, 64, 64, 128),))
    assert codes(small) == ["KER001"]
    assert small[0].severity is Severity.ERROR


# ---------------------------------------------------------------------------
# donation: DON001 / DON002
# ---------------------------------------------------------------------------
def _cache():
    return {"k": torch.zeros(4, 8), "pos": torch.zeros(4, dtype=torch.int32)}


def test_state_rebuilt_is_don001_in_place_is_clean():
    def fresh(params, cache):
        return params["w"].sum(), dict(cache, pos=cache["pos"] + 1)

    def in_place(params, cache):
        cache["pos"].add_(1)
        cache["k"][:, 0] = params["w"].sum()
        return params["w"].sum(), cache

    params = {"w": torch.ones(3), "b": torch.ones(3)}
    got = check("donation", fresh, (params, _cache()), state_argnums=(1,))
    assert codes(got) == ["DON001"]
    assert [f.location for f in got] == ["state arg 1/pos"]
    assert check("donation", in_place, (params, _cache()),
                 state_argnums=(1,), hot_path=True) == []
    dropped = check("donation", lambda p, c: p["w"].sum(),
                    (params, _cache()), state_argnums=(1,))
    assert [f.location for f in dropped] == ["state arg 1"]
    undeclared = check("donation", in_place, (params, _cache()),
                       hot_path=True)
    assert codes(undeclared) == ["DON002"]
    assert undeclared[0].severity is Severity.WARNING


# ---------------------------------------------------------------------------
# purity: PUR001 / PUR002
# ---------------------------------------------------------------------------
def test_host_round_trips():
    def step(x):
        return x * x.sum().item()

    def loop(x):
        for _ in range(3):
            x = x / x.abs().max().item()
        return x

    x = torch.ones(4)
    once = check("purity", step, (x,), hot_path=True)
    assert codes(once) == ["PUR002"]
    assert once[0].location == \
        "test_torch_analysis.py:step aten._local_scalar_dense"
    assert codes(check("purity", loop, (x,))) == ["PUR001"]
    assert check("purity", step, (x,)) == []          # not a hot path
    assert check("purity", lambda t: t * 2, (x,), hot_path=True) == []


# ---------------------------------------------------------------------------
# recompile: REC002
# ---------------------------------------------------------------------------
def test_float64_promotion():
    x = torch.ones(4)
    promoted = check("recompile", lambda t: (t.double() * 2).float(), (x,))
    assert codes(promoted) == ["REC002"]
    assert check("recompile", lambda t: t * 2.0, (x,)) == []
    # float64 inputs: the promotion is the caller's
    assert check("recompile", lambda t: t * 2.0, (x.double(),)) == []


# ---------------------------------------------------------------------------
# prng: PRNG001 / PRNG002
# ---------------------------------------------------------------------------
def test_generator_state_reuse_and_default_draws():
    def reset(x):
        g = torch.Generator().manual_seed(3)
        a = torch.randn(x.shape, generator=g)
        g.manual_seed(3)                       # the same state again
        return x + a + torch.rand(x.shape, generator=g)

    def two(x):
        g1 = torch.Generator().manual_seed(3)
        g2 = torch.Generator().manual_seed(4)
        return x + torch.randn(x.shape, generator=g1) \
            + torch.randn(x.shape, generator=g2)

    def folded_twice(x):
        k = torch.Generator().manual_seed(5)
        return x + mrr.normal(mrr.fold_in(k, 1), x.shape) \
            + mrr.normal(mrr.fold_in(k, 1), x.shape)

    def default(x):
        return x + torch.randn(x.shape)

    x = torch.ones(4)
    assert codes(check("prng", reset, (x,))) == ["PRNG001"]
    assert codes(check("prng", folded_twice, (x,))) == ["PRNG001"]
    assert check("prng", two, (x,)) == []
    assert codes(check("prng", default, (x,), hot_path=True)) == ["PRNG002"]
    assert check("prng", default, (x,)) == []


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------
def test_zoo_scan_baseline_cycle(tmp_path, capsys):
    base = str(tmp_path / "baseline.json")
    rep_json = tmp_path / "report.json"
    argv = ["--no-models", "--no-serve", "--baseline", base]
    assert analysis_cli.main(argv) == 1         # nothing acknowledged yet
    assert analysis_cli.main(argv + ["--write-baseline"]) == 0
    assert analysis_cli.main(argv + ["--json", str(rep_json)]) == 0
    res = json.loads(rep_json.read_text())["results"][0]
    assert res["name"] == "static_analysis"
    metrics = {m["name"]: m for m in res["metrics"]}
    assert metrics["findings_new"]["value"] == 0
    assert metrics["findings_new"]["gate"] is True
    assert metrics["findings_total"]["value"] > 0
    assert metrics["findings_kernels"]["value"] \
        == metrics["findings_total"]["value"]
    assert "0 new vs baseline" in capsys.readouterr().out


def test_committed_baseline_acknowledges_every_finding():
    """`python -m repro_torch.analysis --device cpu` against the package's
    baseline: the zoo, the smoke decode step and the serving stack."""
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cpu"],
        capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(src)))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert ", 0 new vs baseline" in proc.stdout


def test_serving_targets_have_no_error_finding():
    targets = analysis_cli.build_targets(zoo=False, device="cpu")
    assert [t.name for t in targets] == [
        "model:qwen3-32b:decode_step", "serve:qwen3-32b:decode_step",
        "serve:qwen3-32b:admit_step", "serve:qwen3-32b:evict",
        "serve:qwen3-32b:program", "serve:qwen3-32b:drift_step",
        "serve:qwen3-32b:chunk_fn"]
    report = run_checks(targets)
    assert report.errors == ()
    assert len(report) == 0
    for t in targets:
        assert all(not fresh for fresh in t.run().fresh_state.values())


# ---------------------------------------------------------------------------
# rosa.compile(verify=...)
# ---------------------------------------------------------------------------
@pytest.fixture()
def noisy():
    return rosa.Engine.from_config(rosa.RosaConfig(noise=mrr.PAPER_NOISE))


def _args():
    return (torch.empty((4, 16), device="meta"),
            torch.empty((16, 8), device="meta"))


def _reused(eng, x, w):
    """One layer name twice: both products fold the same key."""
    return eng.matmul(x, w, name="l0") + eng.matmul(x, w, name="l0")


def _clean(eng, x, w):
    return eng.matmul(x, w, name="l0") + eng.matmul(x, w, name="l1")


def test_error_mode_rejects_a_reused_generator_state(noisy):
    with pytest.raises(VerificationError) as ei:
        rosa.compile(_reused, noisy, _args(), cache=False, verify="error",
                     device="cpu")
    assert "PRNG001" in codes(ei.value.report.findings)
    assert all(f.subject == "program" for f in ei.value.report)


def test_warn_mode_warns_but_builds(noisy):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        prog = rosa.compile(_reused, noisy, _args(), cache=False,
                            verify="warn", device="cpu")
    assert isinstance(prog, rosa.Program)
    assert any("PRNG001" in str(x.message) for x in w)
    assert all(x.filename == __file__ for x in w
               if "verification" in str(x.message))


def test_clean_program_passes_error_mode(noisy):
    prog = rosa.compile(_clean, noisy, _args(), cache=False, verify="error",
                        device="cpu")
    assert isinstance(prog, rosa.Program)
    assert A.verify_program(prog, _args(), device="cpu").errors == ()


def test_invalid_mode_rejected(noisy):
    with pytest.raises(ValueError, match="verify"):
        rosa.compile(_clean, noisy, _args(), cache=False, verify="loud")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_purity_sees_implicit_syncs_on_cuda():
    """Under the sync debug mode a device tensor built from a host scalar
    in a loop is PUR001, and one `.item()` counts once, not twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def loop(x):
        for _ in range(3):
            x = x + torch.as_tensor(1.0, device=x.device)
        return x

    def item(x):
        return x * x.sum().item()

    x = torch.ones(4, device="cuda")
    assert codes(check("purity", loop, (x,), hot_path=True)) == ["PUR001"]
    assert codes(check("purity", item, (x,), hot_path=True)) == ["PUR002"]
    report = run_checks(analysis_cli.build_targets(zoo=False,
                                                   device="cuda"))
    assert report.errors == ()
