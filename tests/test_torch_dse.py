"""Port parity of `repro_torch.core.dse` and the paper's figure launchers
(`launch.fig7_array_dse`, `fig8_osa`, `fig9_power_breakdown`,
`table1_modes`) against the JAX reference, on the CPU.

Tolerances: the vectorized engine against the scalar one at 1e-6 relative
(the reference's own engine-parity bound), against the reference's
`evaluate_grid` at 1e-9; the paper pins and windows of
tests/test_paper_golden.py at their own tolerances; Fig. 9 and Table 1,
scalar on both sides, exactly.  `chip_smoke.py` phase 11 holds the card to
the values in its ENERGY_REF, which must be the reference's.
"""

import importlib.util
import json
import pathlib

import pytest

from repro_torch.configs.paper_cnns import WORKLOADS
from repro_torch.core import dse
from repro_torch.core import energy as TE
from repro_torch.core.constants import ComputeMode, Mapping
from repro_torch.launch import (fig7_array_dse, fig8_osa,
                                fig9_power_breakdown, table1_modes)
from test_torch_ref import reference

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def R():
    return reference()


@pytest.fixture(scope="module")
def G(R):
    """tests/test_paper_golden.py (imports the reference at import time,
    so only after `reference()` has applied its alias)."""
    import test_paper_golden
    return test_paper_golden


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wls():
    return [dse.Workload(n, ls) for n, ls in WORKLOADS.items()]


def _jwls(R):
    return [R.dse.Workload(n, ls) for n, ls in R.paper_cnns.WORKLOADS.items()]


def test_dse_vmap_matches_scalar():
    """The vectorized engine against the scalar one on the full default
    grid (the reference's test_dse_vmap_matches_scalar_reference)."""
    pts_v = dse.sweep(_wls(), engine="vmap", batch=8, device="cpu")
    pts_s = dse.sweep(_wls(), engine="scalar", batch=8)
    assert [p.label for p in pts_v] == [p.label for p in pts_s]
    by_label = {p.label: p for p in pts_s}
    for pv in pts_v:
        ps = by_label[pv.label]
        for attr in ("metric", "geomean", "worst"):
            a, b = getattr(pv, attr), getattr(ps, attr)
            assert abs(a - b) <= 1e-6 * abs(b), (pv.label, attr)
        for name in pv.rel_edp:
            a, b = pv.rel_edp[name], ps.rel_edp[name]
            assert abs(a - b) <= 1e-6 * abs(b), (pv.label, name)


@pytest.mark.parametrize("mapping,mode,osa", [
    (Mapping.WS, ComputeMode.MIXED, "NO_OSA"),
    (Mapping.IS, ComputeMode.MIXED, "OSA_OPTIMAL"),
    (Mapping.WS, ComputeMode.ANALOG, "OSA_DEFAULT"),
    (Mapping.IS, ComputeMode.DIGITAL, "NO_OSA")])
def test_evaluate_grid_matches_reference(R, mapping, mode, osa):
    cands = dse.default_candidates()
    got = dse.evaluate_grid(_wls(), cands, mapping=mapping, mode=mode,
                            osa=getattr(TE, osa), batch=128, lam=0.4,
                            device="cpu")
    C = R.constants
    want = R.dse.evaluate_grid(
        _jwls(R), R.dse.default_candidates(), mapping=C.Mapping(mapping.value),
        mode=C.ComputeMode(mode.value), osa=getattr(R.energy, osa),
        batch=128, lam=0.4)
    assert len(got) == len(want) == len(cands)
    for p, q in zip(got, want, strict=True):
        assert p.label == q.label
        assert p.metric == pytest.approx(q.metric, rel=1e-9)
        assert p.geomean == pytest.approx(q.geomean, rel=1e-9)
        assert p.worst == pytest.approx(q.worst, rel=1e-9)
        for name in q.rel_edp:
            assert p.rel_edp[name] == pytest.approx(q.rel_edp[name], rel=1e-9)
            assert p.edp_per_workload[name] == pytest.approx(
                q.edp_per_workload[name], rel=1e-9)


def test_dse_unknown_engine_rejected():
    wls = [dse.Workload("alexnet", WORKLOADS["alexnet"])]
    with pytest.raises(ValueError, match="quantum"):
        dse.sweep(wls, engine="quantum", device="cpu")
    with pytest.raises(ValueError, match="no workload layers"):
        dse.evaluate_grid([], dse.default_candidates(), device="cpu")


def test_dse_and_launchers_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dse.sweep(_wls())
    for mod in (fig7_array_dse, fig8_osa, fig9_power_breakdown,
                table1_modes):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.run(verbose=False)
        with pytest.raises(SystemExit, match="--device cpu"):
            mod.main([])


@pytest.fixture(scope="module")
def fig7():
    return fig7_array_dse.run(verbose=False, device="cpu")


@pytest.fixture(scope="module")
def fig8():
    return fig8_osa.run(verbose=False, device="cpu")


def test_fig7_array_dse_golden(G, fig7):
    assert fig7["best"].label == G.GOLDEN["fig7_best_label"]
    assert fig7["reduction_vs_deap"] == pytest.approx(
        G.GOLDEN["fig7_reduction_vs_deap"], rel=G.REL)
    assert fig7["reduction_vs_compact"] == pytest.approx(
        G.GOLDEN["fig7_reduction_vs_compact"], rel=G.REL)
    assert abs(fig7["reduction_vs_compact"] - G.PAPER_COMPACT) \
        < G.PAPER_COMPACT_WINDOW
    assert fig7["reduction_vs_deap"] > G.PAPER_DEAP_FIG7_FLOOR


def test_fig8_osa_golden(G, fig8):
    assert fig8["geomean_reduction_osa"] == pytest.approx(
        G.GOLDEN["fig8_geomean_reduction_osa"], rel=G.REL)
    assert fig8["geomean_reduction_osa_ode"] == pytest.approx(
        G.GOLDEN["fig8_geomean_reduction_osa_ode"], rel=G.REL)
    assert abs(fig8["geomean_reduction_osa"] - G.PAPER_OSA) \
        < G.PAPER_OSA_WINDOW
    assert fig8["geomean_reduction_osa_ode"] > fig8["geomean_reduction_osa"]


def test_fig8_fig9_table1_equal_reference(R, fig8):
    """Scalar on both sides: the same floats, key for key."""
    from benchmarks import fig8_osa as jfig8
    from benchmarks import fig9_power_breakdown as jfig9
    from benchmarks import table1_modes as jtable1

    assert fig8 == jfig8.run(verbose=False)
    assert fig9_power_breakdown.run(verbose=False, device="cpu") \
        == jfig9.run(verbose=False)
    assert table1_modes.run(verbose=False, device="cpu") \
        == jtable1.run(verbose=False)


def test_table4_edp_only_golden(G, chip_smoke):
    """Table 4's EDP side (vectorized profile, scalar pricing), as
    `chip_smoke.py` phase 11 computes it."""
    got = chip_smoke.table4_edp_only("cpu")
    assert got["table4_avg_hybrid_vs_ws_edp_red"] == pytest.approx(
        G.GOLDEN["table4_avg_hybrid_vs_ws_edp_red"], rel=G.REL)
    assert got["table4_avg_hybrid_vs_deap_edp_red"] > G.PAPER_TABLE4_DEAP_AVG
    assert got["table4_avg_hybrid_vs_ws_edp_red"] >= 0.0


def test_chip_smoke_energy_constants_are_the_reference(R, chip_smoke):
    """ENERGY_REF, which phase 11 holds the card to, equals what the
    reference computes, and the port on the CPU is within ENERGY_REL."""
    from benchmarks import (fig7_array_dse as j7, fig8_osa as j8,
                            fig9_power_breakdown as j9, table1_modes as jt1)

    M, C = R.mapping, R.constants
    f7, f8 = j7.run(verbose=False), j8.run(verbose=False)
    f9, t1 = j9.run(verbose=False), jt1.run(verbose=False)
    wls = R.configs.get_workload_zoo()
    pts = R.dse.sweep(wls, engine="vmap", batch=chip_smoke.ZOO_BATCH)
    want = {
        "fig7_best_label": f7["best"].label,
        "fig7_reduction_vs_deap": f7["reduction_vs_deap"],
        "fig7_reduction_vs_compact": f7["reduction_vs_compact"],
        "fig8_geomean_reduction_osa": f8["geomean_reduction_osa"],
        "fig8_geomean_reduction_osa_ode": f8["geomean_reduction_osa_ode"],
        "fig9_n_workloads": len(f9),
        "fig9_alexnet_adc_power_reduction":
            1 - f9["alexnet"]["osa"]["adc"] / f9["alexnet"]["no_osa"]["adc"],
        "table1_ops_mixed_vs_analog":
            t1["mixed"]["ops"] / t1["analog"]["ops"],
        "table1_mixed_edp": t1["mixed"]["edp"],
        "table1_mixed_oadc_energy": t1["mixed"]["oadc_energy"],
        "zoo_n_workloads": len(wls),
        "zoo_n_layer_rows": sum(len(w.layers) for w in wls),
        "zoo_n_candidates": len(pts),
        "zoo_best_label": pts[0].label,
        "zoo_best_metric": pts[0].metric,
    }
    for wl in R.configs.get_workload_zoo(include_paper=False,
                                         archs=list(chip_smoke.HYBRID_ZOO)):
        profs = M.profile_layers_fast(wl.layers, C.ROSA_OPTIMAL,
                                      batch=chip_smoke.ZOO_BATCH)
        e_h = M.plan_edp(wl.layers, M.hybrid_plan(profs), C.ROSA_OPTIMAL,
                         batch=chip_smoke.ZOO_BATCH)
        e_ws = M.plan_edp(wl.layers, {p.name: C.Mapping.WS for p in profs},
                          C.ROSA_OPTIMAL, batch=chip_smoke.ZOO_BATCH)
        want[f"hybrid_zoo_{wl.name}"] = e_h / e_ws
    import test_paper_golden
    ws_red, deap_red = test_paper_golden._table4_edp_reductions()
    want["table4_avg_hybrid_vs_ws_edp_red"] = float(ws_red)
    want["table4_avg_hybrid_vs_deap_edp_red"] = float(deap_red)
    assert chip_smoke.ENERGY_REF == want
    bad, worst = chip_smoke.energy_mismatches(
        chip_smoke.energy_values("cpu"), want)
    assert not bad and worst <= chip_smoke.ENERGY_REL


def test_launcher_json(tmp_path):
    out = tmp_path / "t1.json"
    res = table1_modes.main(["--device", "cpu", "--json", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    out7 = tmp_path / "f7.json"
    fig7_array_dse.main(["--device", "cpu", "--json", str(out7)])
    assert set(json.loads(out7.read_text())) == {
        "best", "deap", "compact", "reduction_vs_deap",
        "reduction_vs_compact"}
