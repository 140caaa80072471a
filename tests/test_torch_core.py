"""Port parity of `repro_torch.core` (quant, MRR chain, OSA, energy) against
the JAX reference, inputs from numpy seeds.

Tolerances: quantization, digit planes, the transmission endpoints and the
energy model are exact.  The MRR chain is held against the reference's
jitted chain at 2e-6 absolute (~16 float32 ulps of a weight in [-1, 1],
of a voltage in [1, 3]): the port evaluates the folded form XLA compiles
the reference into, and XLA contracts some of its multiply-adds into FMAs.
Written out op by op, the chain subtracts two ~1538 nm wavelengths and
loses ~3e-4 of normalized weight to that cancellation, which is why the
reference's un-jitted evaluation is not the yardstick.  Contractions are
held at float32 rtol 1e-5 (another summation order).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import energy as TE
from repro_torch.core import mrr as TM
from repro_torch.core import osa as TO
from repro_torch.core import quant as TQ
from repro_torch.core.constants import ROSA_OPTIMAL, ComputeMode, Mapping
from test_torch_ref import reference, to_np, to_torch


@pytest.fixture(scope="module")
def R():
    return reference()


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# quant
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("per_vector", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_and_fake_quant_exact(R, per_vector, bits):
    x = _rng(bits).normal(size=(9, 70)).astype(np.float32)
    jc, tc = R.quant.QuantConfig(bits=bits), TQ.QuantConfig(bits=bits)
    qj, sj = R.quant.quantize(R.jnp.asarray(x), jc, per_vector=per_vector)
    qt, st = TQ.quantize(torch.from_numpy(x), tc, per_vector=per_vector)
    np.testing.assert_array_equal(to_np(qt), to_np(qj))
    np.testing.assert_array_equal(to_np(st), to_np(sj))
    np.testing.assert_array_equal(
        to_np(TQ.fake_quant(torch.from_numpy(x), tc, per_vector)),
        to_np(R.quant.fake_quant(R.jnp.asarray(x), jc, per_vector)))


def test_round_half_to_even_and_absmax_floor(R):
    """Ties round to even on both sides, and an all-zero row takes the
    1e-8 floor (codes 0, scale 1e-8) under per-vector quantization."""
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], np.float32)
    np.testing.assert_array_equal(to_np(torch.round(torch.from_numpy(ties))),
                                  [0, 2, 2, -0, -2, -2, 4])
    # absmax 127 -> x / 127 * 127 lands on the ties exactly
    x = np.array([[127.0, 0.5, 1.5, 2.5, -2.5, 6.5],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    qt, st = TQ.quantize(torch.from_numpy(x), per_vector=True)
    qj, sj = R.quant.quantize(R.jnp.asarray(x), per_vector=True)
    np.testing.assert_array_equal(to_np(qt), to_np(qj))
    np.testing.assert_array_equal(to_np(qt)[0], [127, 0, 2, 2, -2, 6])
    np.testing.assert_array_equal(to_np(st).ravel(),
                                  np.float32([127.0, 1e-8]))
    np.testing.assert_array_equal(to_np(st), to_np(sj))


@pytest.mark.parametrize("pam_bits", [1, 2, 3])
def test_digit_planes_exact(R, pam_bits):
    q = _rng(pam_bits).integers(-127, 128, size=(6, 33)).astype(np.float32)
    np.testing.assert_array_equal(
        to_np(TQ.decompose_pam(torch.from_numpy(q), pam_bits)),
        to_np(R.quant.decompose_pam(R.jnp.asarray(q), pam_bits)))
    np.testing.assert_array_equal(
        to_np(TQ.pam_plane_weights(pam_bits)),
        to_np(R.quant.pam_plane_weights(pam_bits)))
    planes = TQ.decompose_pam(torch.from_numpy(q), pam_bits)
    w = TQ.pam_plane_weights(pam_bits).reshape(-1, 1, 1)
    np.testing.assert_array_equal(to_np((planes * w).sum(0)), q)
    if pam_bits == 1:
        np.testing.assert_array_equal(
            to_np(TQ.decompose_planes(torch.from_numpy(q))),
            to_np(R.quant.decompose_planes(R.jnp.asarray(q))))


# ---------------------------------------------------------------------------
# MRR chain
# ---------------------------------------------------------------------------
def _var_pair(R, k, seed):
    r = _rng(seed)
    dv, ddt, dlam = (r.normal(size=(k,)).astype(np.float32) * s
                     for s in (0.01, 0.04, 0.01))
    return (R.mrr.StaticVariation(R.jnp.asarray(dv), R.jnp.asarray(ddt),
                                  R.jnp.asarray(dlam)),
            TM.StaticVariation(*(torch.from_numpy(a) for a in (dv, ddt, dlam))))


def test_endpoints_and_chain_stages_exact(R):
    assert TM.transmission_endpoints_py() == \
        R.mrr.transmission_endpoints_py()
    np.testing.assert_array_equal(
        to_np(torch.stack(TM.transmission_endpoints())),
        to_np(R.jnp.stack(R.mrr.transmission_endpoints())))
    w = _rng(1).uniform(-1.1, 1.1, size=(40, 50)).astype(np.float32)
    v = to_np(R.jax.jit(R.mrr.voltage_of_weight)(R.jnp.asarray(w)))
    v = np.clip(v, 1.0, 3.0)
    np.testing.assert_allclose(
        to_np(TM.voltage_of_weight(torch.from_numpy(w))), v, rtol=0,
        atol=2e-6)
    np.testing.assert_allclose(
        to_np(TM.weight_of_voltage(torch.from_numpy(v))),
        to_np(R.jax.jit(R.mrr.weight_of_voltage)(R.jnp.asarray(v))),
        rtol=0, atol=2e-6)


def test_folded_constants_are_the_compiled_ones():
    """The folded chain's constants, as XLA prints them for the
    reference's compiled chain (MRRParams defaults)."""
    c = TM.chain_constants()
    assert np.float32(c.c_dl) == np.float32(-0.479980469)
    assert np.float32(c.e_v2) == np.float32(1.28843951)
    assert np.float32(c.f_dt) == np.float32(0.776132643)
    assert np.float32(c.g_lam) == np.float32(0.286205649)
    assert np.float32(c.j_w) == np.float32(2.59001517)
    assert c.h_det == -c.c_dl and c.i_td == -c.b_td


@pytest.mark.parametrize("case", ["ideal", "variation", "noisy"])
def test_realize_weights_injected_draws(R, case):
    """Same N(0, 1) draws in, the same realized weights out, to a few ulps
    of the reference's compiled chain."""
    k = 96
    w = _rng(2).uniform(-1.0, 1.0, size=(k, 24)).astype(np.float32)
    var_j = var_t = None
    if case != "ideal":
        var_j, var_t = _var_pair(R, 24, 3)
    noise_j = R.mrr.PAPER_NOISE if case == "noisy" else R.mrr.IDEAL
    noise_t = TM.PAPER_NOISE if case == "noisy" else TM.IDEAL
    key = R.jax.random.PRNGKey(5)
    eps = None
    if case == "noisy":
        k_dac, k_th = R.jax.random.split(key)
        eps = tuple(to_torch(R.jax.random.normal(kk, w.shape))
                    for kk in (k_dac, k_th))
    got = to_np(TM.realize_weights(torch.from_numpy(w), None,
                                   TM.DEFAULT_PARAMS, noise_t, var_t, eps))
    want = to_np(R.mrr.realize_weights(R.jnp.asarray(w), key,
                                       R.mrr.DEFAULT_PARAMS, noise_j, var_j))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_realize_ideal_round_trip():
    w = torch.linspace(-1, 1, 255)
    np.testing.assert_allclose(to_np(TM.realize_weights(w)), to_np(w),
                               atol=2e-3)


def test_keys_split_and_fold_deterministically():
    base = torch.Generator().manual_seed(11)
    a1, b1 = TM.split(base)
    a2, _ = TM.split(base)
    assert a1.initial_seed() == a2.initial_seed() != b1.initial_seed()
    assert TM.fold_in(base, 3).initial_seed() \
        != TM.fold_in(base, 4).initial_seed()
    e1 = TM.draw_eps(base, (5,))
    e2 = TM.draw_eps(base, (5,))
    torch.testing.assert_close(e1[0], e2[0], rtol=0, atol=0)
    assert not torch.equal(e1[0], e1[1])


@pytest.mark.parametrize("orient", ["weight", "activation", "scalar"])
def test_expand_lanes(R, orient):
    var_j, var_t = _var_pair(R, 12, 7)
    if orient == "scalar":
        var_j = R.mrr.StaticVariation(*(R.jnp.float32(0.1),) * 3)
        var_t = TM.StaticVariation(*(torch.tensor(0.1),) * 3)
    shape = (12, 5) if orient == "weight" else (3, 12)
    got = TM.expand_lanes(var_t, torch.zeros(shape))
    want = R.mrr.expand_lanes(var_j, R.jnp.zeros(shape))
    for f in ("dv", "ddt", "dlam"):
        g, wnt = getattr(got, f), getattr(want, f)
        assert tuple(g.shape) == tuple(wnt.shape)
        np.testing.assert_array_equal(to_np(g), to_np(wnt))
        if orient == "weight":   # a view of the lane vector, not a copy
            assert g.data_ptr() == getattr(var_t, f).data_ptr()
    assert TM.expand_lanes(None, torch.zeros(shape)) is None


# ---------------------------------------------------------------------------
# OSA
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cfg_kw", [
    {}, {"pam_bits": 2, "n_slots": 4},
    {"splitter_imbalance": 0.01, "odl_loss_db_per_stage": 0.05}])
def test_slot_gains(R, cfg_kw):
    got = to_np(TO.slot_gains(TO.OSAConfig(**cfg_kw)))
    want = to_np(R.osa.slot_gains(R.osa.OSAConfig(**cfg_kw)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if not cfg_kw:
        np.testing.assert_array_equal(got, want)


def test_slot_jitter_needs_a_key():
    with pytest.raises(ValueError):
        TO.slot_gains(TO.OSAConfig(slot_jitter_sigma=0.1))
    g = TO.slot_gains(TO.OSAConfig(slot_jitter_sigma=0.1),
                      eps=torch.ones(7))
    np.testing.assert_allclose(to_np(g), 1.1 * 2.0 ** np.arange(7),
                               rtol=1e-6)


@pytest.mark.parametrize("pam_bits,per_vector,nonideal", [
    (1, False, False), (1, True, False), (2, False, False),
    (1, True, True)])
def test_osa_matmul_ref(R, pam_bits, per_vector, nonideal):
    r = _rng(pam_bits + 2 * per_vector)
    x = r.normal(size=(7, 45)).astype(np.float32)
    w = r.normal(size=(45, 13)).astype(np.float32)
    kw = ({"splitter_imbalance": 0.01, "odl_loss_db_per_stage": 0.05}
          if nonideal else {})
    got = TO.osa_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                            TO.OSAConfig(pam_bits=pam_bits, **kw),
                            per_vector=per_vector)
    want = R.osa.osa_matmul_ref(R.jnp.asarray(x), R.jnp.asarray(w),
                                R.osa.OSAConfig(pam_bits=pam_bits, **kw),
                                per_vector=per_vector)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5,
                               atol=1e-5)
    if not nonideal:   # ideal OSA == fake-quant matmul
        fq = TQ.fake_quant(torch.from_numpy(x), per_vector=per_vector)
        np.testing.assert_allclose(to_np(got), to_np(fq @ torch.from_numpy(w)),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# energy model (pure Python copy: exact)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mapping", ["WS", "IS"])
@pytest.mark.parametrize("mode", ["MIXED", "ANALOG", "DIGITAL"])
def test_layer_energy_exact(R, mapping, mode):
    for m, k, n in [(4, 5120, 51200), (8, 25600, 5120), (196, 27, 64)]:
        got = TE.layer_energy(TE.LayerShape("l", m, k, n), ROSA_OPTIMAL,
                              Mapping[mapping], ComputeMode[mode])
        want = R.energy.layer_energy(
            R.energy.LayerShape("l", m, k, n), R.constants.ROSA_OPTIMAL,
            R.constants.Mapping[mapping], R.constants.ComputeMode[mode])
        assert got.as_dict() == want.as_dict()
