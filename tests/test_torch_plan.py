"""The serving trace, plan and energy at FULL qwen3-32b width, abstractly:
the reference traces with `jax.eval_shape`, the port on `meta` tensors, so
no arithmetic runs on either side.  Depth is cut to 4 of 64 layers; the
stacked layers share each projection's name, so the trace, the plan and
the per-token energy do not depend on depth.  All three must be equal.
"""

import dataclasses

import pytest

from repro_torch import rosa
from repro_torch.configs import get_config
from repro_torch.core.constants import ROSA_OPTIMAL, Mapping
from repro_torch.models.model import build_model
from repro_torch.serve import (ServeConfig, build_serving_program,
                               serving_model_config, trace_serving_shapes)
from test_torch_ref import reference

# (name, m, k, n) of the decode GEMMs at n_slots=4
DECODE_GEMMS = [("mlp/wi", 4, 5120, 51200), ("mlp/wo", 4, 25600, 5120)]
ENERGY_PER_TOKEN = 0.018735444554955898


def _scfg(side):
    return side.ServeConfig(n_slots=4, max_len=56, prefill_chunk=8,
                            rosa=True, rosa_backend="fused")


@pytest.fixture(scope="module")
def port():
    cfg = dataclasses.replace(get_config("qwen3-32b"), n_layers=4)
    bundle = build_model(serving_model_config(cfg, rosa=True))
    scfg = ServeConfig(n_slots=4, max_len=56, prefill_chunk=8, rosa=True,
                       rosa_backend="fused")
    prog = build_serving_program(bundle, scfg, device="cpu", cache=False)
    ledger = trace_serving_shapes(
        bundle, scfg, prog.engine.with_ledger(rosa.EnergyLedger()))
    return bundle, prog, ledger


@pytest.fixture(scope="module")
def ref():
    R = reference()
    cfg = dataclasses.replace(R.configs.get_config("qwen3-32b"), n_layers=4)
    bundle = R.model.build_model(R.serve.serving_model_config(cfg, rosa=True))
    scfg = _scfg(R.serve)
    prog = R.metrics.build_serving_program(bundle, scfg, cache=False)
    ledger = R.metrics.trace_serving_shapes(
        bundle, scfg, prog.engine.with_ledger(R.rosa.EnergyLedger()))
    return R, prog, ledger, bundle


def test_full_width_param_count(port, ref):
    bundle = port[0]
    assert bundle.n_params == ref[3].n_params == 3_506_223_104   # ~14 GB
    assert bundle.cfg.d_model == 5120 and bundle.cfg.d_ff == 25600


def test_decode_trace_equals_reference(port, ref):
    _, prog, _ = port
    jprog = ref[1]
    got = [(e.name, e.m, e.k, e.n) for e in prog.trace.entries]
    assert got == DECODE_GEMMS
    assert got == [(e.name, e.m, e.k, e.n) for e in jprog.trace.entries]
    assert [e.count for e in prog.trace.entries] == \
        [e.count for e in jprog.trace.entries]


def test_autotuned_plan_equals_reference(port, ref):
    _, prog, _ = port
    jprog = ref[1]
    plan = prog.plan.mapping_plan()
    assert plan == {"mlp/wi": Mapping.IS, "mlp/wo": Mapping.IS}
    assert {k: v.name for k, v in plan.items()} == \
        {k: v.name for k, v in jprog.plan.mapping_plan().items()}
    assert prog.plan.default.act_per_vector
    assert prog.plan.resolve("mlp/wi").backend == "fused"


def test_energy_per_token_equals_reference(port, ref):
    _, _, ledger = port
    R, _, jledger, _ = ref
    e = ledger.per_token(ROSA_OPTIMAL, batch=4)
    assert e == ENERGY_PER_TOKEN
    assert e == jledger.per_token(R.constants.ROSA_OPTIMAL, batch=4)
    got = [(ev.name, ev.m, ev.k, ev.n, ev.tag)
           for ev in ledger.unique_events()]
    assert got == [(ev.name, ev.m, ev.k, ev.n, ev.tag)
                   for ev in jledger.unique_events()]
    assert ("mlp/wi", 8, 5120, 51200, "prefill") in got
