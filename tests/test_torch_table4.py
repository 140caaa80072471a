"""The Table 4 entry point (`python -m repro_torch.launch.table4`) end to end
on the CPU at a few steps: QAT, the per-layer noise profile, the hybrid
plan, the five accuracies and the EDPs per model, in the shape of the
reference's `benchmarks/table4_hybrid.py::run` result, and the paper's
three averages over the models.  (Its parts are held against the
reference in test_torch_cnn.py; this file is separate so the runs go to
their own test worker.)  The CPU runs evaluate on a 16-image test split
instead of 512, to keep the file near 20 s; the card runs
the full split (`chip_smoke.py` phase 9).
"""

import functools

import pytest

from repro_torch.configs.paper_cnns import CNN_WORKLOADS
from repro_torch.core.constants import Mapping
from repro_torch.launch import table4
from repro_torch.models import cnn as TCNN
from repro_torch.training import cnn_train
from test_torch_ref import reference

MODELS = ["alexnet", "resnet18"]


@pytest.fixture
def small_test_split(monkeypatch):
    """A 16-image test split for the CPU runs (the evaluation cache is
    emptied before and after, so no other test sees it)."""
    monkeypatch.setattr(cnn_train, "train_test_split", functools.partial(
        cnn_train.train_test_split, n_test=16))
    cnn_train._test_set.cache_clear()
    yield
    cnn_train._test_set.cache_clear()


def test_table4_cli_smoke_on_cpu(tmp_path, small_test_split):
    """The entry point end to end on the CPU over two models: the
    reference's `run` shape ({model: run_model result}), a plan over every
    lite layer, the EDPs, and the three averages by the reference's
    formulas."""
    out = tmp_path / "t4.json"
    res = table4.main(["--models", *MODELS, "--device", "cpu", "--steps",
                       "2", "--n-mc", "1", "--json", str(out)])
    assert out.exists()
    assert list(res) == MODELS
    for model, r in res.items():
        assert r["model"] == model
        assert set(r["accs"]) == {"clean", "ws", "is", "hybrid", "analog"}
        assert all(0.0 <= a <= 100.0 for a in r["accs"].values())
        assert set(r["plan"]) == {s.name for s in TCNN.LITE_MODELS[model]}
        assert r["plan_is_layers"] == sum(v == Mapping.IS.value
                                          for v in r["plan"].values())
        assert r["edp"] == table4.plan_edps(
            model, {k: Mapping(v) for k, v in r["plan"].items()})
        assert set(r["profile"]["layers"]) == set(r["plan"])
    # the reference's `run` prints these three averages
    n = len(res)
    want = {
        "hybrid_vs_ws_pp": sum(r["accs"]["hybrid"] - r["accs"]["ws"]
                               for r in res.values()) / n,
        "hybrid_vs_deap_edp_red": sum(1 - r["edp"]["hybrid"]
                                      / r["edp"]["deap"]
                                      for r in res.values()) / n,
        "loss_vs_clean_pp": sum(r["accs"]["clean"] - r["accs"]["hybrid"]
                                for r in res.values()) / n,
    }
    assert table4.averages(res) == want


def test_table4_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        table4.main(["--models", "mobilenet_v3", "--steps", "1"])


def test_chip_smoke_table4_edps_are_the_reference():
    """The WS and DEAP EDPs `chip_smoke.py` phase 9 holds the card to,
    for all four CNNs, are the reference's `plan_edp` / `network_energy`
    floats, and the port's."""
    import importlib.util
    import pathlib

    R = reference()
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert set(cs.TABLE4_EDP) == set(CNN_WORKLOADS) == set(cs.CNNS)
    C, E, M = R.constants, R.energy, R.mapping
    for model, pinned in cs.TABLE4_EDP.items():
        lite = {s.name for s in R.cnn.LITE_MODELS[model]}
        layers = [l for l in R.paper_cnns.CNN_WORKLOADS[model]
                  if l.name in lite]
        want = (M.plan_edp(layers, {}, C.ROSA_OPTIMAL, batch=128),
                E.network_energy(layers, C.DEAP_HIGH_CHANNEL, C.Mapping.WS,
                                 C.ComputeMode.ANALOG, E.NO_OSA,
                                 batch=128).edp)
        assert pinned == want, model
        got = table4.plan_edps(model, {})
        assert (got["ws"], got["deap"]) == pinned, model
