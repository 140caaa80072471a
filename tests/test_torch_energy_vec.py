"""Port parity of `repro_torch.core.energy_vec` (the vectorized energy
model) and of the model-level additions it serves (`OSA_DEFAULT`, the
Table 1 OPS formulas, `mapping.profile_layers_fast`) against the JAX
reference, on the CPU.

Tolerances: the grid against the reference's `grid_energy` (float64 under
x64) and against the scalar `layer_energy` at 1e-9 relative, the paper
pin's tolerance; the float64 guard at 1e-12.  `grid_energy` on a card
equals the CPU result within 1e-12 (marked `cuda`).
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch import rosa
from repro_torch.configs.paper_cnns import WORKLOADS
from repro_torch.core import energy as TE
from repro_torch.core import energy_vec as TEV
from repro_torch.core import mapping as TM
from repro_torch.core.constants import (COMPACT_4X4, DEAP_HIGH_CHANNEL,
                                        ROSA_OPTIMAL, ComputeMode, Mapping,
                                        OPEConfig)
from test_torch_ref import reference, to_np

REL = 1e-9
OPES = [ROSA_OPTIMAL, COMPACT_4X4, DEAP_HIGH_CHANNEL,
        OPEConfig(rows=3, cols=5, tiles=7)]
OSAS = {"none": TE.NO_OSA, "default": TE.OSA_DEFAULT,
        "optimal": TE.OSA_OPTIMAL}


@pytest.fixture(scope="module")
def R():
    return reference()


def _ref_grid(R, mapping, mode, osa, batch, shapes):
    """The reference's (P, L) energy and latency over OPES x every paper
    workload row, under x64."""
    EV, C = R.energy_vec, R.constants
    jopes = [C.OPEConfig(rows=o.rows, cols=o.cols, tiles=o.tiles)
             for o in OPES]
    jshapes = [R.energy.LayerShape(s.name, s.m, s.k, s.n, s.groups, s.kind)
               for s in shapes]
    josa = R.energy.OSAEnergyConfig(enabled=osa.enabled, ode_len=osa.ode_len)
    with R.jax.enable_x64():
        spec = EV.EnergySpec.make(mapping=C.Mapping(mapping.value),
                                  mode=C.ComputeMode(mode.value), osa=josa,
                                  batch=batch)
        en, lat = EV.grid_energy(EV.stack_candidates(jopes),
                                 EV.stack_layers(jshapes), spec)
        return to_np(en), to_np(lat)


ALL_ROWS = [s for layers in WORKLOADS.values() for s in layers]


@pytest.mark.parametrize("osa", sorted(OSAS))
@pytest.mark.parametrize("mode", list(ComputeMode))
@pytest.mark.parametrize("mapping", [Mapping.IS, Mapping.WS])
def test_grid_energy_matches_reference_and_scalar(R, mapping, mode, osa):
    """Every paper workload row x four arrays, one mapping, mode and OSA
    sizing: the reference's vectorized model and the port's scalar one."""
    o = OSAS[osa]
    spec = TEV.EnergySpec.make(mapping=mapping, mode=mode, osa=o, batch=128)
    en, lat = TEV.grid_energy(TEV.stack_candidates(OPES),
                              TEV.stack_layers(ALL_ROWS), spec, device="cpu")
    assert en.dtype == lat.dtype == torch.float64
    assert tuple(en.shape) == (len(OPES), len(ALL_ROWS))
    jen, jlat = _ref_grid(R, mapping, mode, o, 128, ALL_ROWS)
    np.testing.assert_allclose(to_np(en), jen, rtol=REL, atol=0)
    np.testing.assert_allclose(to_np(lat), jlat, rtol=REL, atol=0)
    for (p, ope), (i, s) in itertools.product(enumerate(OPES),
                                              enumerate(ALL_ROWS)):
        bd = TE.layer_energy(s, ope, mapping, mode, o, batch=128)
        assert float(en[p, i]) == pytest.approx(bd.energy, rel=REL), \
            (ope, s.name)
        assert float(lat[p, i]) == pytest.approx(bd.latency, rel=REL), \
            (ope, s.name)


def test_grid_energy_stays_float64():
    """A float32 intermediate anywhere would round these event counts
    (m * n_total > 2**24, not powers of two) by ~1e-8 relative."""
    big = TE.LayerShape("big", m=50_001, k=999, n=333)
    assert big.m * 128 * big.n > 2 ** 24
    for mapping, mode in itertools.product((Mapping.IS, Mapping.WS),
                                           ComputeMode):
        spec = TEV.EnergySpec.make(mapping=mapping, mode=mode,
                                   osa=TE.OSA_DEFAULT, batch=128)
        en, lat = TEV.grid_energy(TEV.stack_candidates(OPES),
                                  TEV.stack_layers([big]), spec,
                                  device="cpu")
        assert en.dtype == lat.dtype == torch.float64
        for p, ope in enumerate(OPES):
            bd = TE.layer_energy(big, ope, mapping, mode, TE.OSA_DEFAULT,
                                 batch=128)
            edp = float(en[p, 0]) * float(lat[p, 0])
            assert edp == pytest.approx(bd.edp, rel=1e-12), (mapping, mode)


def test_energy_spec_and_scalar_additions_match_reference(R):
    for pam, osa in itertools.product((1, 2, 3), OSAS.values()):
        s = TEV.EnergySpec.make(mapping=Mapping.IS, osa=osa, batch=4,
                                pam_bits=pam)
        js = R.energy_vec.EnergySpec.make(
            mapping=R.constants.Mapping.IS,
            osa=R.energy.OSAEnergyConfig(osa.enabled, osa.ode_len), batch=4,
            pam_bits=pam)
        assert (s.n_slots, s.osa.enabled, s.osa.ode_len, s.batch) == \
            (js.n_slots, js.osa.enabled, js.osa.ode_len, js.batch)
    assert TE.OSA_DEFAULT == TE.OSAEnergyConfig(
        R.energy.OSA_DEFAULT.enabled, R.energy.OSA_DEFAULT.ode_len)
    for ope in OPES:
        jope = R.constants.OPEConfig(ope.rows, ope.cols, ope.tiles)
        assert TE.ops_analog(ope) == R.energy.ops_analog(jope)
        assert TE.ops_digital(ope) == R.energy.ops_digital(jope)
        assert TE.ops_mixed(ope) == R.energy.ops_mixed(jope)


@pytest.mark.parametrize("model", sorted(WORKLOADS))
def test_profile_layers_fast_matches_reference(R, model):
    """Per-layer IS/WS EDPs of one paper workload (the reference's
    test_energy_vec_matches_scalar_on_paper_layers, both sides), a
    degradation matrix through `degradation_fn_from_matrix`, and the
    executable plan lifted from the profile."""
    layers = WORKLOADS[model]
    deg = {s.name: {"input_stationary": (i % 3) * 0.7,
                    "weight_stationary": (i % 2) * 1.3}
           for i, s in enumerate(layers)}
    prof = TM.profile_layers_fast(layers, ROSA_OPTIMAL,
                                  TM.degradation_fn_from_matrix(deg),
                                  batch=128, device="cpu")
    jlayers = R.paper_cnns.WORKLOADS[model]
    jprof = R.mapping.profile_layers_fast(
        jlayers, R.constants.ROSA_OPTIMAL,
        R.mapping.degradation_fn_from_matrix(deg), batch=128)
    for p, q, s in zip(prof, jprof, layers, strict=True):
        assert (p.name, p.d_is, p.d_ws) == (q.name, q.d_is, q.d_ws)
        assert p.e_is == pytest.approx(q.e_is, rel=REL)
        assert p.e_ws == pytest.approx(q.e_ws, rel=REL)
        for mp, e in ((Mapping.IS, p.e_is), (Mapping.WS, p.e_ws)):
            assert e == pytest.approx(TE.layer_energy(
                s, ROSA_OPTIMAL, mp, batch=128).edp, rel=REL)
    plan = TM.hybrid_plan(prof)
    assert {k: v.value for k, v in plan.items()} == \
        {k: v.value for k, v in R.mapping.hybrid_plan(jprof).items()}
    xp = TM.execution_plan(prof, rosa.RosaConfig())
    assert xp.mapping_plan() == plan
    assert xp.layers == tuple(s.name for s in layers)


def test_grid_energy_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    spec = TEV.EnergySpec.make()
    args = (TEV.stack_candidates(OPES), TEV.stack_layers(ALL_ROWS[:3]), spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEV.grid_energy(*args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.profile_layers_fast(ALL_ROWS[:3], ROSA_OPTIMAL)


@pytest.mark.cuda
def test_grid_energy_on_cuda_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cand, layers = TEV.stack_candidates(OPES), TEV.stack_layers(ALL_ROWS)
    for mapping, mode, osa in itertools.product(
            (Mapping.IS, Mapping.WS), ComputeMode, OSAS.values()):
        spec = TEV.EnergySpec.make(mapping=mapping, mode=mode, osa=osa,
                                   batch=128)
        for a, b in zip(TEV.grid_energy(cand, layers, spec, device="cuda"),
                        TEV.grid_energy(cand, layers, spec, device="cpu"),
                        strict=True):
            assert a.device.type == "cuda" and a.dtype == torch.float64
            np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-12,
                                       atol=0)
