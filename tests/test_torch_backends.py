"""Port parity of `repro_torch.rosa` (backends, straight-through gradients,
"auto" resolution, Engine, ledger) against the JAX reference.

`rosa_matmul` runs each registered backend on the same numbers as the
reference's backend of the same name.  Tolerances: "dense" at float32
rtol 1e-5; the optical backends at the flip-aware one-LSB bound (see
test_torch_kernels).  Gradients are exact
straight-through matmuls: float32 rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from repro_torch import rosa
from repro_torch.core import energy as TE
from repro_torch.core import mrr as TM
from repro_torch.core.constants import ROSA_OPTIMAL, Mapping
from repro_torch.rosa import backends as TB
from test_torch_ref import assert_quantized_parity, reference, to_np


@pytest.fixture(scope="module")
def R():
    return reference()


def _data(seed=0, m=6, k=48, n=20, lead=()):
    r = np.random.default_rng(seed)
    x = r.normal(size=(*lead, m, k)).astype(np.float32)
    w = r.normal(size=(k, n)).astype(np.float32)
    dv = (0.01 * r.normal(size=(k,))).astype(np.float32)
    return x, w, dv


@pytest.mark.parametrize("backend", ["dense", "ref", "fused", "pallas"])
@pytest.mark.parametrize("mapping,chip", [("WS", False), ("IS", True),
                                          ("WS", True)])
def test_rosa_matmul_backends_match_reference(R, backend, mapping, chip):
    x, w, dv = _data(lead=(2,))
    var_j = var_t = None
    if chip:
        var_j = R.mrr.StaticVariation(R.jnp.asarray(dv), R.jnp.float32(0.05),
                                      R.jnp.float32(1e-4))
        var_t = TM.StaticVariation(torch.from_numpy(dv), torch.tensor(0.05),
                                   torch.tensor(1e-4))
    cfg_j = R.backends.RosaConfig(mapping=R.constants.Mapping[mapping],
                                  backend=backend, act_per_vector=True)
    cfg_t = TB.RosaConfig(mapping=Mapping[mapping], backend=backend,
                          act_per_vector=True)
    y = TB.rosa_matmul(torch.from_numpy(x), torch.from_numpy(w), cfg_t, None,
                       var_t)
    want = R.backends.rosa_matmul(R.jnp.asarray(x), R.jnp.asarray(w), cfg_j,
                                  None, var_j)
    assert y.shape == tuple(want.shape)
    if backend == "dense" and not chip:
        np.testing.assert_allclose(to_np(y), to_np(want), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert_quantized_parity(y, want)


def test_optical_backends_agree_within_the_port(R):
    """ref, fused and pallas on one pinned chip (IS, as served)."""
    x, w, dv = _data(1, m=5, k=70, n=33)
    var = TM.StaticVariation(torch.from_numpy(dv), torch.tensor(0.05),
                             torch.tensor(1e-4))
    ys = {b: TB.rosa_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            TB.RosaConfig(mapping=Mapping.IS, backend=b,
                                          act_per_vector=True), None, var)
          for b in ("ref", "fused", "pallas")}
    assert_quantized_parity(ys["fused"], ys["ref"])
    assert_quantized_parity(ys["pallas"], ys["ref"])


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_straight_through_gradients(R, backend):
    x, w, _ = _data(2, lead=(3,))
    c = np.random.default_rng(9).normal(size=(3, 6, 20)).astype(np.float32)
    cfg_j = R.backends.RosaConfig(backend=backend)
    gx_j, gw_j = R.jax.grad(
        lambda a, b: (R.backends.rosa_matmul(a, b, cfg_j)
                      * R.jnp.asarray(c)).sum(), argnums=(0, 1))(
        R.jnp.asarray(x), R.jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (TB.rosa_matmul(xt, wt, TB.RosaConfig(backend=backend))
     * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(to_np(xt.grad), to_np(gx_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(to_np(wt.grad), to_np(gw_j), rtol=1e-5,
                               atol=1e-5)


def test_auto_resolution_and_registry():
    assert TB.resolve_backend("auto", "cpu")[0] == "ref"
    assert TB.resolve_backend("auto", torch.device("cuda"))[0] == "fused"
    assert TB.resolve_backend("auto", "meta")[0] == "ref"
    assert set(TB.backend_names()) >= {"dense", "ref", "pallas", "fused"}
    assert TB.is_raw_backend("fused") and not TB.is_raw_backend("ref")
    with pytest.raises(ValueError, match="unknown backend"):
        TB.resolve_backend("nope")


def test_ideal_auto_shortcut_is_fake_quant_matmul():
    x, w, _ = _data(3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    y = TB.rosa_matmul(xt, wt, TB.RosaConfig())
    from repro_torch.core import quant as TQ
    torch.testing.assert_close(y, TQ.fake_quant(xt) @ TQ.fake_quant(wt),
                               rtol=0, atol=0)


def test_engine_routes_names_keys_and_ledger(R):
    """Per-layer keys fold (name, step); the ledger records each distinct
    (name, shape, mapping, mode, tag) once and prices like the reference."""
    base = torch.Generator().manual_seed(0)
    k1 = rosa.layer_key(base, "mlp/wi", 0).initial_seed()
    assert k1 == rosa.layer_key(base, "mlp/wi", 0).initial_seed()
    assert k1 != rosa.layer_key(base, "mlp/wi", 1).initial_seed()
    assert k1 != rosa.layer_key(base, "mlp/wo", 0).initial_seed()
    ledger = rosa.EnergyLedger()
    eng = rosa.Engine.from_hybrid_plan(
        TB.RosaConfig(), {"a": Mapping.IS}, ledger=ledger)
    x = torch.randn(4, 16)
    for _ in range(3):                       # repeats record once
        eng.matmul(x, torch.randn(16, 8), name="a")
        with ledger.scope("decode"):
            eng.matmul(x, torch.randn(16, 8), name="b")
    eng.matmul(x[:2], torch.randn(16, 8), name="b")
    assert [(e.name, e.m, e.mapping, e.tag) for e in ledger.events] == [
        ("a", 4, Mapping.IS, ""), ("b", 4, Mapping.WS, "decode"),
        ("b", 2, Mapping.WS, "")]
    led_j = R.rosa.EnergyLedger()
    for ev in ledger.events:
        with led_j.scope(ev.tag):
            led_j.record(ev.name, ev.m, ev.k, ev.n, R.backends.RosaConfig(
                mapping=R.constants.Mapping[ev.mapping.name]))
    assert ledger.edp(ROSA_OPTIMAL) == led_j.edp(R.constants.ROSA_OPTIMAL)
    assert ledger.per_token(ROSA_OPTIMAL, batch=4) == \
        led_j.per_token(R.constants.ROSA_OPTIMAL, batch=4)


def test_meta_tensors_record_without_running_a_backend():
    ledger = rosa.EnergyLedger()
    eng = rosa.Engine.from_config(TB.RosaConfig(backend="fused"),
                                  ledger=ledger)
    y = eng.matmul(torch.empty(4, 5120, device="meta"),
                   torch.empty(5120, 51200, device="meta"), name="mlp/wi")
    assert y.device.type == "meta" and tuple(y.shape) == (4, 51200)
    assert [(e.m, e.k, e.n) for e in ledger.events] == [(4, 5120, 51200)]


def test_hybrid_plan_is_the_edp_argmin(R):
    shapes = [TE.LayerShape("a", 4, 5120, 51200, kind="gemm"),
              TE.LayerShape("b", 512, 64, 64, kind="gemm")]
    from repro_torch.core import mapping as TMap
    prof = TMap.profile_layers(shapes, ROSA_OPTIMAL, lambda n, m: 0.0)
    plan = TMap.hybrid_plan(prof)
    jshapes = [R.energy.LayerShape(s.name, s.m, s.k, s.n, kind="gemm")
               for s in shapes]
    jplan = R.mapping.hybrid_plan(R.mapping.profile_layers_fast(
        jshapes, R.constants.ROSA_OPTIMAL))
    assert {k: v.name for k, v in plan.items()} == \
        {k: v.name for k, v in jplan.items()}
    for p, q in zip(prof, R.mapping.profile_layers_fast(
            jshapes, R.constants.ROSA_OPTIMAL)):
        assert p.e_is == pytest.approx(q.e_is, rel=1e-12)
        assert p.e_ws == pytest.approx(q.e_ws, rel=1e-12)
