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

The backward (`ops.plain_grad`, `ref.mrr_transfer_grad_ref`; the CUDA
backward kernel), in its reciprocal form (one division per distinct
denominator), is held against `jax.grad` of the reference's
`core.mrr.realize_weights`, fed the reference's own draws: 2e-6 of the
gradient's full scale on interior targets (4.5e-7 measured; 5.2e-7 with
a division per quotient).  At the end points the clip conventions differ
(stated in `test_end_points_follow_torch_clamp`); through
`condition_weight`, where the absmax element sits at an end point, the
gradient holds to 3e-6 of its full scale (1.1e-6 measured, 1.5e-6 with a
division per quotient: the element's two routes, through q and through
the per-tensor scale, carry the chain's derivative with opposite signs,
so the convention cancels).  The reformulation itself is bounded against
the same derivative in float64 (1e-6 of its full scale over the whole
clip range, draws and a full-shape chip field), and both clips' ties
pass the whole gradient.

Tests marked `cuda` launch the CUDA kernel and skip without a card.
"""

import dataclasses

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


def _ref_draws(R, key, shape):
    """The reference's (DAC, thermal) draws of `realize_weights(key)`."""
    k_dac, k_th = R.jax.random.split(key)
    return tuple(torch.from_numpy(np.array(R.jax.random.normal(k, shape)))
                 for k in (k_dac, k_th))


@pytest.mark.parametrize("chip", [False, True])
@pytest.mark.parametrize("noisy", [False, True])
def test_plain_grad_matches_jax_grad_of_realize_weights(R, chip, noisy):
    """g * d realize / d w on interior targets, with and without a chip
    (per lane, against a (K, N) weight) and per-shot draws."""
    jax, jnp = R.jax, R.jnp
    shape = (40, 24)
    r = np.random.default_rng(7 + 2 * chip + noisy)
    w = r.uniform(-0.98, 0.98, shape).astype(np.float32)
    g = r.normal(size=shape).astype(np.float32)
    key = jax.random.PRNGKey(5)
    var_j = var_t = None
    if chip:
        f = [np.asarray(s * r.normal(size=40), np.float32)
             for s in (0.01, 0.04, 0.01)]
        var_j = R.mrr.expand_lanes(R.mrr.StaticVariation(
            *map(jnp.asarray, f)), jnp.asarray(w))
        var_t = TM.expand_lanes(TM.StaticVariation(
            *map(torch.from_numpy, f)), torch.from_numpy(w))
    noise = R.mrr.PAPER_NOISE if noisy else R.mrr.IDEAL
    want = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(
        R.mrr.realize_weights(a, key, R.mrr.DEFAULT_PARAMS, noise, var_j)
        * g)))(jnp.asarray(w)))
    eps = _ref_draws(R, key, shape) if noisy else (None, None)
    got = to_np(ops.plain_grad(torch.from_numpy(g), torch.from_numpy(w),
                               *eps, *(SIGMAS if noisy else (0.0, 0.0)),
                               var=var_t))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


def test_end_points_follow_torch_clamp(R):
    """At q = -1 (v = v_max) a clip passes the whole gradient here, as
    `torch.clamp` does, where JAX's `clip` passes half; at q = +1 (v just
    below v_min) both give 0.  The plain derivative equals autograd of the
    plain chain, end points included."""
    w = torch.tensor([-1.0, -0.5, 0.0, 0.5, 1.0, 1.05])
    wr = w.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(ref.mrr_transfer_ref(wr, None, None, 0.0,
                                                       0.0).sum(), wr)
    got = ops.plain_grad(torch.ones_like(w), w, None, None, 0.0, 0.0)
    np.testing.assert_allclose(to_np(got), to_np(auto), rtol=2e-6,
                               atol=1e-7)
    jax = R.jax
    want = np.asarray(jax.vmap(jax.grad(lambda a: R.mrr.realize_weights(
        a)))(R.jnp.asarray(to_np(w))))
    got = to_np(got)
    np.testing.assert_allclose(got[1:4], want[1:4], rtol=2e-6)
    assert abs(want[0] / got[0] - 0.5) < 1e-3
    assert got[4] == want[4] == 0.0 and got[5] == want[5] == 0.0


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_condition_weight_gradient_matches_reference(R, sign):
    """The depthwise weight's realization under a PAPER_VARIATION chip,
    differentiated end to end (per-tensor scale, fake-quant, the chain),
    with the absmax element negative or positive."""
    jax, jnp = R.jax, R.jnp
    r = np.random.default_rng(int(sign) + 3)
    w = r.normal(size=(16, 9)).astype(np.float32)
    i = np.unravel_index(np.abs(w).argmax(), w.shape)
    w[i] = sign * 1.5 * abs(w[i])
    g = r.normal(size=w.shape).astype(np.float32)
    chip = R.variation.sample_chip(jax.random.PRNGKey(11), {"l": 16})["l"]
    want = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(
        R.backends.condition_weight(a, R.cnn_train.QAT_CFG, None, chip)
        * g)))(jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_(True)
    y = TB.condition_weight(wt, TB.RosaConfig(), None, TM.StaticVariation(
        *(torch.from_numpy(np.array(getattr(chip, f)))
          for f in ("dv", "ddt", "dlam"))))
    (got,) = torch.autograd.grad((y * torch.from_numpy(g)).sum(), wt)
    np.testing.assert_allclose(to_np(got), want, rtol=0,
                               atol=3e-6 * np.abs(want).max())


def _grad64(g, w, eps, sigmas, var):
    """g * d realize / d w of the plain chain evaluated in float64 (the
    same float32 constants, operands widened exactly), by autograd."""
    w64 = w.double().requires_grad_(True)
    var64 = None if var is None else TM.StaticVariation(
        *(f.double() for f in (var.dv, var.ddt, var.dlam)))
    eps64 = tuple(None if e is None else e.double() for e in eps)
    y = ref.mrr_transfer_ref(w64, *eps64, *sigmas, var=var64)
    (d,) = torch.autograd.grad((y * g.double()).sum(), w64)
    return d


def test_plain_grad_within_its_bound_of_the_float64_derivative():
    """The reciprocal form (one division per denominator) against the
    same derivative in float64, over a 512 x 512 sheet spanning the whole
    clip range [-1.1, 1.1] with PAPER_NOISE draws and a full-shape chip
    field: within 1e-6 of the gradient's full scale (6.4e-7 measured; the
    form with a division per quotient was 4.7e-7 here, the float32
    chain's own conditioning sets both)."""
    shape = (512, 512)
    r = np.random.default_rng(0)
    w = torch.from_numpy(r.uniform(-1.1, 1.1, shape).astype(np.float32))
    g = torch.from_numpy(r.normal(size=shape).astype(np.float32))
    eps = tuple(torch.from_numpy(r.normal(size=shape).astype(np.float32))
                for _ in range(2))
    var = TM.StaticVariation(*(torch.from_numpy(
        (s * r.normal(size=shape)).astype(np.float32))
        for s in (0.01, 0.04, 0.01)))
    got = ops.plain_grad(g, w, *eps, *SIGMAS, var=var)
    want = _grad64(g, w, eps, SIGMAS, var)
    scale = float(want.abs().max())
    assert scale > 0 and bool(torch.isfinite(got).all())
    assert float((got.double() - want).abs().max()) <= 1e-6 * scale
    outside = (w < -1) | (w > 1)
    assert bool(outside.any()) and bool((got[outside] == 0).all())


def test_plain_grad_clip_ties_pass_the_whole_gradient(monkeypatch):
    """Both clips pass the whole gradient at a tie, as `torch.clamp`
    does.  The target clip: at w = -1 and, with v_min moved below s(+1)
    (0.99989 in float32, under the default v_min 1), at w = +1, the
    derivative equals the float64 one.  The voltage clip: with v_min set
    to s(0.999) and v_max to s(-0.999), exactly, those targets' gradient
    is the one the unbinding clip gives, bit for bit, and 0 once the
    bound moves one ulp past s."""
    c0 = TM.chain_constants()
    w = torch.tensor([-1.0, 1.0, -0.999, 0.999])
    g = torch.tensor([1.0, -1.0, 0.5, 2.0])
    none = (None, None)

    def grad_with(**bounds):
        c = dataclasses.replace(c0, **bounds)
        monkeypatch.setattr(TM, "chain_constants", lambda p=None: c)
        return ops.plain_grad(g, w, *none, 0.0, 0.0)

    free = ops.plain_grad(g, w, *none, 0.0, 0.0)
    assert free[1] == 0.0                  # s(+1) < v_min: clipped
    grad_with(v_min=0.999)                 # the target clip's ties
    moved = ops.plain_grad(g, w, *none, 0.0, 0.0)
    want = _grad64(g, w, none, (0.0, 0.0), None)
    monkeypatch.undo()
    assert float(moved[0]) != 0.0 and float(moved[1]) != 0.0
    np.testing.assert_allclose(to_np(moved[:2]), to_np(want[:2]),
                               rtol=1e-6)
    assert torch.equal(free[0], moved[0])
    s = TM.voltage_of_chain(w, c0)         # v_min < s < v_max: inside
    lo, hi = float(s[3]), float(s[2])
    assert c0.v_min < lo and hi < c0.v_max
    tied = grad_with(v_min=lo, v_max=hi)
    assert torch.equal(tied[2:], free[2:]) and bool((tied[2:] != 0).all())
    past = grad_with(v_min=float(np.nextafter(np.float32(lo), 2)),
                     v_max=float(np.nextafter(np.float32(hi), 0)))
    assert bool((past[2:] == 0).all())


def test_launch_backward_refuses_what_the_kernel_does_not_take():
    w = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.launch_backward(torch.zeros(4, 8), w, None, None, 0.0, 0.0)
    with pytest.raises(ValueError, match="draws"):
        ops.launch_backward(torch.zeros(4, 8), w, None, None, 0.02, 0.04)


def test_cpu_gradient_takes_the_plain_chain():
    """On the CPU the realization is differentiated through the plain
    chain by autograd: no kernel, no backward launch."""
    n = ops.LAUNCHES_BWD.count
    w = (2 * torch.rand(6, 5) - 1).requires_grad_(True)
    ops.mrr_transfer(w, None, 0.0, 0.0).sum().backward()
    assert ops.LAUNCHES_BWD.count == n
    np.testing.assert_allclose(
        to_np(w.grad), to_np(ops.plain_grad(torch.ones(6, 5), w.detach(),
                                            None, None, 0.0, 0.0)),
        rtol=2e-6, atol=1e-7)


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
def test_cuda_backward_launches_the_kernel_without_plain_fallback(
        monkeypatch):
    """On CUDA the gradient through `mrr_transfer` is the backward kernel's
    (one launch, equal to the plain derivative bit for bit), and with the
    kernel unavailable backward raises instead of falling back."""
    _need_cuda()
    gen = torch.Generator("cuda").manual_seed(0)
    w0 = 2 * torch.rand(48, 25, device="cuda", generator=gen) - 1
    var = TM.expand_lanes(TM.StaticVariation(
        *(s * torch.randn(48, device="cuda", generator=gen)
          for s in (0.01, 0.04, 0.01))), w0)
    key = torch.Generator("cuda").manual_seed(1)
    eps = TM.draw_eps(key, w0.shape, "cuda")
    monkeypatch.setattr(ops, "plain_grad", None)      # never reached
    w = w0.clone().requires_grad_(True)
    n = ops.LAUNCHES_BWD.count
    ops.mrr_transfer(w, key, *SIGMAS, var=var).sum().backward()
    torch.cuda.synchronize()
    assert ops.LAUNCHES_BWD.count == n + 1
    monkeypatch.undo()
    assert torch.equal(w.grad, ops.plain_grad(torch.ones_like(w0), w0, *eps,
                                              *SIGMAS, var=var))

    def unavailable():
        raise kernels.KernelBuildError("nvcc refused the source")

    y = ops.mrr_transfer(w0.clone().requires_grad_(True), key, *SIGMAS,
                         var=var)
    monkeypatch.setattr(ops, "_lib", unavailable)
    with pytest.raises(kernels.KernelBuildError):
        y.sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 9), (36, 9), (48, 25), (60, 25),
                                   (513, 130)])
@pytest.mark.parametrize("noisy", [True, False])
def test_backward_kernel_equals_plain_grad_on_cuda(shape, noisy):
    """mobilenet_v3's depthwise weights (and a ragged sheet) with a chip
    per row, with and without draws: bit for bit."""
    _need_cuda()
    g = torch.Generator("cuda").manual_seed(4)
    w = 2.2 * torch.rand(shape, device="cuda", generator=g) - 1.1
    gr = torch.randn(shape, device="cuda", generator=g)
    var = TM.expand_lanes(TM.StaticVariation(
        *(s * torch.randn(shape[0], device="cuda", generator=g)
          for s in (0.01, 0.04, 0.01))), w)
    sig = SIGMAS if noisy else (0.0, 0.0)
    eps = TM.draw_eps(torch.Generator("cuda").manual_seed(5), shape,
                      "cuda") if noisy else (None, None)
    got = ops.launch_backward(gr, w, *eps, *sig, var=var)
    want = ops.plain_grad(gr, w, *eps, *sig, var=var)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("orient", ["row", "col", "any"])
@pytest.mark.parametrize("noisy", [True, False])
def test_kernel_equals_plain_in_each_lane_layout_on_cuda(orient, noisy):
    """Per-row fields against a (K, N) weight, per-column fields against
    (M, K) activations (both the lane vectors themselves), and a full-shape
    field (a strided view): forward and backward bit for bit, at aligned
    and ragged widths."""
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
        gr = torch.randn(shape, device="cuda", generator=g)
        got_b = ops.launch_backward(gr, w, *eps, *sig, var=var)
        want_b = ops.plain_grad(gr, w, *eps, *sig, var=var)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (orient, shape)
        assert torch.equal(got_b, want_b), (orient, shape, "backward")
