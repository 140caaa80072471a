"""The Table 4 entry point (`python -m repro_torch.launch.table4`) end to end
on the CPU at a few steps: QAT, the per-layer noise profile, the hybrid
plan, the five accuracies and the EDPs, in the shape of the reference's
`benchmarks/table4_hybrid.py::run_model` result.  (Its parts are held
against the reference in test_torch_cnn.py; this file is separate so the
run, about 20 s on the CPU, goes to its own test worker.)
"""

import pytest

from repro_torch.core.constants import Mapping
from repro_torch.launch import table4
from repro_torch.models import cnn as TCNN

MODEL = "mobilenet_v3"


def test_table4_cli_smoke_on_cpu(tmp_path):
    """The entry point end to end on the CPU at a few steps: the
    reference's result shape, a plan over every lite layer, and EDPs."""
    out = tmp_path / "t4.json"
    res = table4.main(["--model", MODEL, "--device", "cpu", "--steps", "3",
                       "--n-mc", "1", "--json", str(out)])
    assert out.exists()
    assert set(res["accs"]) == {"clean", "ws", "is", "hybrid", "analog"}
    assert all(0.0 <= a <= 100.0 for a in res["accs"].values())
    assert set(res["plan"]) == {s.name for s in TCNN.LITE_MODELS[MODEL]}
    assert res["plan_is_layers"] == sum(v == Mapping.IS.value
                                        for v in res["plan"].values())
    assert res["edp"] == table4.plan_edps(
        MODEL, {k: Mapping(v) for k, v in res["plan"].items()})
    assert set(res["profile"]["layers"]) == set(res["plan"])


def test_table4_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        table4.main(["--model", MODEL, "--steps", "1"])
