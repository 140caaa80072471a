"""Port parity of the MRR transfer kernel module against the JAX reference.

On the CPU `kernels.mrr_transfer.ops.mrr_transfer` runs its plain version
(`ref.mrr_transfer_ref`, the port's folded chain); the reference runs its
Pallas kernel in interpret mode.  Both are fed the same N(0, 1) draws,
made with numpy.  Tolerances:

  * against the reference's jitted chain (`mrr_transfer_ref` under
    `jax.jit`, `realize_weights`): 2e-6, the few ulps by which the port's
    folded chain and XLA's compiled one round apart (test_torch_core);
  * against the Pallas kernel in interpret mode: 5e-5, on targets inside
    [-1, 1].  The kernel takes its transmission endpoints in double
    precision, the chain in float32 (T_hi differs by 6.5e-5, ROADMAP
    Queue 3): on these draws its interpret-mode evaluation differs from
    the jitted chain by 1.05e-5, and by 9.4e-5 for targets clipped at
    q_max, where the jitted-chain tests cover the port.

Tests marked `cuda` launch the CUDA kernel and skip without a card.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import mrr as TM
from repro_torch.kernels.mrr_transfer import ops, ref
from repro_torch.rosa import backends as TB
from test_torch_ref import reference, to_np

SIGMAS = (0.02, 0.04)


@pytest.fixture(scope="module")
def R():
    return reference()


def _draws(shape, seed, lo=-1.1, hi=1.1):
    """Targets (the clip range beyond [-1, 1] included) and two draws."""
    r = np.random.default_rng(seed)
    w = r.uniform(lo, hi, size=shape).astype(np.float32)
    e_dac = r.normal(size=shape).astype(np.float32)
    e_th = r.normal(size=shape).astype(np.float32)
    return w, e_dac, e_th


def _port(w, e_dac, e_th, sigmas=SIGMAS, var=None):
    return to_np(ops.mrr_transfer(
        torch.from_numpy(w), None, *sigmas, var=var,
        eps=(torch.from_numpy(e_dac), torch.from_numpy(e_th))))


def test_plain_matches_reference_pallas_kernel_interpret(R):
    w, e_dac, e_th = _draws((16, 256), 0, -1.0, 1.0)
    want = R.mt_kernel.mrr_transfer_pallas(
        R.jnp.asarray(w), R.jnp.asarray(e_dac), R.jnp.asarray(e_th),
        sigma_dac=SIGMAS[0], sigma_th=SIGMAS[1], interpret=True)
    np.testing.assert_allclose(_port(w, e_dac, e_th), to_np(want), rtol=0,
                               atol=5e-5)


@pytest.mark.parametrize("shape", [(8, 128), (1,), (7,), (129,), (13, 77),
                                   (3, 5, 9)])
@pytest.mark.parametrize("sigmas", [SIGMAS, (0.05, 0.0), (0.0, 0.0)])
def test_plain_matches_jitted_reference_chain(R, shape, sigmas):
    """Any shape and length (no sheet padding), the same draws in."""
    w, e_dac, e_th = _draws(shape, sum(shape))
    chain = R.jax.jit(R.mt_ref.mrr_transfer_ref,
                      static_argnames=("sigma_dac", "sigma_th", "p"))
    want = chain(R.jnp.asarray(w), R.jnp.asarray(e_dac),
                 R.jnp.asarray(e_th), sigma_dac=sigmas[0],
                 sigma_th=sigmas[1])
    got = _port(w, e_dac, e_th, sigmas)
    assert got.shape == shape
    np.testing.assert_allclose(got, to_np(want), rtol=0, atol=2e-6)


@pytest.mark.parametrize("lanes", ["per_lane", "scalar", "full"])
def test_variation_matches_reference_realize_weights(R, lanes):
    """A chip's static variation (per-lane (K,) fields against a (K, N)
    weight broadcast per `expand_lanes`), no per-shot noise."""
    k, n = 40, 24
    w, _, _ = _draws((k, n), 3)
    r = np.random.default_rng(4)
    shape = {"per_lane": (k,), "scalar": (), "full": (k, n)}[lanes]
    fields = [np.asarray(s * r.normal(size=shape), np.float32)
              for s in (0.01, 0.04, 0.01)]
    var_j = R.mrr.expand_lanes(R.mrr.StaticVariation(
        *(R.jnp.asarray(f) for f in fields)), R.jnp.asarray(w))
    var_t = TM.expand_lanes(TM.StaticVariation(
        *(torch.from_numpy(f) for f in fields)), torch.from_numpy(w))
    want = R.mrr.realize_weights(R.jnp.asarray(w), None,
                                 R.mrr.DEFAULT_PARAMS, R.mrr.IDEAL, var_j)
    got = to_np(ops.mrr_transfer(torch.from_numpy(w), None, 0.0, 0.0,
                                 var=var_t))
    np.testing.assert_allclose(got, to_np(want), rtol=0, atol=2e-6)


def test_noise_and_variation_equal_realize_weights_op_for_op():
    """The oracle is `core.mrr.realize_weights` with injected draws, and
    the wrapper hands it the draws unchanged: bitwise equal."""
    w, e_dac, e_th = _draws((33, 17), 5)
    var = TM.StaticVariation(torch.full((33, 1), 0.01), torch.tensor(0.03),
                             torch.full((17,), -0.002))
    eps = (torch.from_numpy(e_dac), torch.from_numpy(e_th))
    want = TM.realize_weights(torch.from_numpy(w), None, TM.DEFAULT_PARAMS,
                              TM.PAPER_NOISE, var, eps)
    got = ops.mrr_transfer(torch.from_numpy(w), None, *SIGMAS, var=var,
                           eps=eps)
    assert torch.equal(got, want)
    assert torch.equal(ref.mrr_transfer_ref(torch.from_numpy(w), *eps,
                                            *SIGMAS, var=var), want)


def test_key_path_draws_what_draw_eps_draws():
    """From a key, the wrapper draws `draw_eps(key, w.shape)`: the (DAC,
    thermal) split of `realize_weights`, so both consume the same draws."""
    w, _, _ = _draws((9, 31), 6)
    wt = torch.from_numpy(w)
    key = torch.Generator().manual_seed(123)
    eps = TM.draw_eps(key, wt.shape)
    got = ops.mrr_transfer(wt, key, *SIGMAS)
    assert torch.equal(got, ops.mrr_transfer(wt, None, *SIGMAS, eps=eps))
    assert torch.equal(got, TM.realize_weights(wt, key, TM.DEFAULT_PARAMS,
                                               TM.PAPER_NOISE))
    with pytest.raises(ValueError, match="key"):
        ops.mrr_transfer(wt, None, *SIGMAS)


def test_noisy_realize_routes_through_the_wrapper(monkeypatch):
    """The composed backends' analog operand and `condition_weight` go
    through `mrr_transfer` (on CUDA tensors that is the kernel)."""
    calls = []
    real = ops.mrr_transfer

    def spy(w, *a, **k):
        calls.append(tuple(w.shape))
        return real(w, *a, **k)

    monkeypatch.setattr(ops, "mrr_transfer", spy)
    cfg = TB.RosaConfig(noise=TM.PAPER_NOISE, backend="ref")
    key = torch.Generator().manual_seed(1)
    w = torch.randn(12, 9)
    TB.condition_weight(w, cfg, key)
    TB.rosa_matmul(torch.randn(5, 12), w, cfg, key)
    assert calls == [(12, 9), (12, 9)]
    assert TB.condition_weight(w, TB.RosaConfig(), key) is w    # ideal
    assert TB.condition_weight(w, None, key) is w               # dense
    assert len(calls) == 2


def test_cpu_calls_never_reach_the_kernel_loader(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel loader reached from a CPU call")

    monkeypatch.setattr(kernels, "library", boom)
    monkeypatch.setattr(kernels, "build_all", boom)
    ops._lib.cache_clear()
    n = ops.LAUNCHES.count
    ops.mrr_transfer(torch.rand(4, 5), torch.Generator().manual_seed(0))
    assert ops.LAUNCHES.count == n


def test_launch_refuses_what_the_kernel_does_not_take():
    w = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="draws"):
        ops.launch(w, None, None, 0.02, 0.04)
    with pytest.raises(ValueError, match="CUDA"):
        ops.launch(w, torch.zeros(4, 8), torch.zeros(4, 8), 0.02, 0.04)


def test_preflight():
    wi = ops.preflight(5120 * 51200)
    assert wi["issues"] == [] and wi["pad_waste"] == 0.0
    # one stream of float4 segments, 8 a thread: 8192 elements a block
    assert wi["grid"] == (5120 * 51200 // 8192, 1, 1)
    assert wi["bytes"] == 16 * 5120 * 51200
    assert ops.preflight(60 * 25)["grid"] == (2, 1, 1)
    assert ops.preflight(0)["issues"]


# ---------------------------------------------------------------------------
# On the card: the kernel against its plain version, bit for bit
# ---------------------------------------------------------------------------
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (kernels build on first "
                    "use)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,noisy,with_var", [
    ((60, 25), True, True), ((1000, 27), True, False),
    ((513, 130), False, True), ((1_000_003,), True, False)])
def test_kernel_equals_plain_on_cuda(shape, noisy, with_var):
    _need_cuda()
    g = torch.Generator("cuda").manual_seed(0)
    w = 2.2 * torch.rand(shape, device="cuda", generator=g) - 1.1
    var = None
    if with_var:
        lanes = shape[0]
        var = TM.expand_lanes(TM.StaticVariation(
            *(s * torch.randn(lanes, device="cuda", generator=g)
              for s in (0.01, 0.04, 0.01))), w)
    sig = SIGMAS if noisy else (0.0, 0.0)
    eps = TM.draw_eps(torch.Generator("cuda").manual_seed(1), shape,
                      "cuda") if noisy else (None, None)
    got = ops.launch(w, *eps, *sig, var=var)
    want = ops.plain(w, *eps, *sig, var=var)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_backward_raises_without_plain_fallback():
    _need_cuda()
    w = torch.rand(8, 8, device="cuda", requires_grad=True)
    y = ops.mrr_transfer(w, torch.Generator("cuda").manual_seed(0))
    with pytest.raises(NotImplementedError, match="variation-aware QAT"):
        y.sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("orient", ["row", "col", "any"])
@pytest.mark.parametrize("noisy", [True, False])
def test_kernel_equals_plain_in_each_lane_layout_on_cuda(orient, noisy):
    """Per-row fields against a (K, N) weight, per-column fields against
    (M, K) activations (both the lane vectors themselves), and a full-shape
    field (a strided view): bit for bit, at aligned and ragged widths."""
    _need_cuda()
    g = torch.Generator("cuda").manual_seed(2)
    for shape in [(96, 256), (37, 27)]:
        w = 2.2 * torch.rand(shape, device="cuda", generator=g) - 1.1
        if orient == "any":
            var = TM.StaticVariation(
                *(s * torch.randn(shape, device="cuda", generator=g)
                  for s in (0.01, 0.04, 0.01)))
        else:
            lanes = shape[0] if orient == "row" else shape[1]
            var = TM.StaticVariation(
                *(s * torch.randn(lanes, device="cuda", generator=g)
                  for s in (0.01, 0.04, 0.01)))
            if orient == "row":
                var = TM.expand_lanes(var, w)
        sig = SIGMAS if noisy else (0.0, 0.0)
        eps = TM.draw_eps(torch.Generator("cuda").manual_seed(3), shape,
                          "cuda") if noisy else (None, None)
        got = ops.launch(w, *eps, *sig, var=var)
        want = ops.plain(w, *eps, *sig, var=var)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (orient, shape)
