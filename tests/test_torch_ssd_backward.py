"""The SSD scan's backward on the CPU: the plain backward
`ref.ssd_chunked_backward` (what the backward kernel computes) against
autograd of the plain forward and against `jax.vjp` of the reference's
`repro.models.ssm.ssd_chunked`, the autograd Function the wrapper routes a
CUDA call that needs gradients through, and `preflight_backward`.

Inputs are made with numpy from a seed.  Bounds:

  * against autograd of `ref.ssd_chunked`, in float64: 1e-10 of each
    gradient's max, or of 1 where that max is below 1 (at L 1, d loga is
    0 and autograd's is float64 rounding);
  * against `jax.vjp` of the reference (b and c repeated to heads; the
    port's group gradient is the sum of the reference's head gradients),
    in float32 at chunk 8 with decays where the reference is finite: 1e-5
    of each gradient's max (float32 reordering);
  * at chunk 128 with log a = -0.8 a step the reference's d loga is not
    finite (it takes exp(l_i - l_j) on the whole square and masks after),
    the port's is, and equals float64 autograd of the sequential oracle
    `ref.ssd_scan_ref` within 1e-10 of its max (float64) and 1e-4
    (float32);
  * `torch.autograd.gradcheck` of the Function in float64, with the
    kernels' launches replaced by the plain versions;
  * the CPU model of the kernel's tensor-core split (`ref.split_tf32`):
    hi with the low 13 mantissa bits zero, hi + lo within 2^-22 of a
    relative; its 3xTF32 products (`ref.matmul_3xtf32`) at the
    backward's product shapes, over 16 seeds each: every element within
    the split's a priori error bound (2^-20 + 3 ceil(K / 8) 2^-24) times
    sum_k |a_ik| |b_kj| (the representation and the dropped lo.lo term,
    then one float32 rounding per instruction), and the whole product
    within phase 19(a)'s gate: 4x the float32 product's distance from
    float64 plus 1e-6 of its max.  The bare 4x does not hold on every
    seed of the causal triangle (`python tests/test_torch_ssd_backward.py
    --survey-3xtf32` prints the ratios over 200 seeds).

The kernels themselves run on the card only (phase 19 of chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import skinny
from repro_torch.kernels.ssd_scan import ops, ref
from test_torch_ref import reference


@pytest.fixture(scope="module")
def R():
    return reference()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs under several xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(bsz, l, h, p, g, s, seed, dtype=np.float64, decay=None):
    """x, loga, b, c, dy, dstate as numpy (log a = -softplus(N(0, 1)),
    or `decay` a step)."""
    r = np.random.default_rng(seed)
    loga = (np.full((bsz, l, h), decay) if decay is not None
            else -np.log1p(np.exp(r.normal(size=(bsz, l, h)))))
    out = (r.normal(size=(bsz, l, h, p)), loga,
           r.normal(size=(bsz, l, g, s)), r.normal(size=(bsz, l, g, s)),
           r.normal(size=(bsz, l, h, p)), r.normal(size=(bsz, h, s, p)))
    return tuple(a.astype(dtype) for a in out)


def _rel(got, want, least: float = 1e-300) -> float:
    """max |got - want| over max |want| (at least `least`)."""
    got, want = (torch.as_tensor(np.asarray(t)).double() for t in (got, want))
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        least))


# (B, L, H, P, G, S, chunk): L a multiple of the chunk, ragged, shorter
# than a chunk, one step; G 1 < H, G 2, G = H
CASES = [(2, 24, 4, 3, 1, 5, 8), (2, 21, 4, 3, 2, 5, 8),
         (1, 5, 4, 3, 4, 5, 8), (1, 1, 4, 3, 2, 5, 8),
         (2, 40, 6, 4, 3, 6, 16)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dstate", ["zero", "given"])
def test_plain_backward_matches_autograd(case, dstate):
    bsz, l, h, p, g, s, q = case
    x, loga, b, c, dy, ds = map(torch.from_numpy,
                                _inputs(bsz, l, h, p, g, s, seed=l))
    ins = [t.clone().requires_grad_() for t in (x, loga, b, c)]
    y, st = ref.ssd_chunked(*ins, q)
    assert y.dtype == torch.float64
    cot = ds if dstate == "given" else None
    loss = (y * dy).sum() + ((st * cot).sum() if cot is not None else 0)
    want = torch.autograd.grad(loss, ins)
    got = ref.ssd_chunked_backward(x, loga, b, c, dy, cot, q)
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == torch.float64
        assert _rel(a, w, least=1.0) <= 1e-10


def test_plain_backward_with_initial_state_matches_autograd():
    x, loga, b, c, dy, ds = map(torch.from_numpy,
                                _inputs(2, 19, 4, 3, 2, 5, seed=9))
    s0 = torch.from_numpy(np.random.default_rng(10).normal(size=ds.shape))
    ins = [t.clone().requires_grad_() for t in (x, loga, b, c)]
    y, st = ref.ssd_chunked(*ins, 8, s0)
    want = torch.autograd.grad((y * dy).sum() + (st * ds).sum(), ins)
    got = ref.ssd_chunked_backward(x, loga, b, c, dy, ds, 8, s0)
    for a, w in zip(got, want):
        assert _rel(a, w, least=1.0) <= 1e-10


@pytest.mark.parametrize("case", [(2, 24, 4, 3, 1, 5), (2, 21, 4, 3, 2, 5),
                                  (1, 13, 4, 3, 4, 5)])
def test_plain_backward_matches_reference_vjp(R, case):
    """The reference differentiates its jnp chunking with `jax.vjp`; its
    b and c are per head, so each group's gradient is the sum over the
    group's heads."""
    jax, jnp = R.jax, R.jnp
    bsz, l, h, p, g, s = case
    x, loga, b, c, dy, ds = _inputs(bsz, l, h, p, g, s, seed=l + g,
                                    dtype=np.float32)
    rep = h // g
    _, vjp = jax.vjp(lambda *a: R.ssm.ssd_chunked(*a, 8), jnp.asarray(x),
                     jnp.asarray(loga), jnp.asarray(np.repeat(b, rep, 2)),
                     jnp.asarray(np.repeat(c, rep, 2)))
    jdx, jdl, jdb, jdc = (np.asarray(t) for t in vjp((jnp.asarray(dy),
                                                      jnp.asarray(ds))))
    got = ops.plain_backward(*map(torch.from_numpy, (x, loga, b, c, dy, ds)),
                             8)
    want = (jdx, jdl, jdb.reshape(bsz, l, g, rep, s).sum(3),
            jdc.reshape(bsz, l, g, rep, s).sum(3))
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and np.isfinite(w).all()
        assert _rel(a, w) <= 1e-5


def test_reference_dloga_overflows_where_the_port_stays_finite(R):
    """Chunk 128 at log a = -0.8 a step: l_i - l_j passes 88.7 above the
    diagonal, where the reference forms exp(l_i - l_j) before its mask,
    so `jax.grad` gives 0 * inf in d loga.  The port masks before the exp:
    its d loga is finite and is the sequential oracle's."""
    jax, jnp = R.jax, R.jnp
    bsz, l, h, p, s = 1, 128, 2, 4, 4
    x, loga, b, c, dy, _ = _inputs(bsz, l, h, p, h, s, seed=3,
                                   dtype=np.float32, decay=-0.8)
    _, vjp = jax.vjp(lambda *a: R.ssm.ssd_chunked(*a, 128)[0],
                     *map(jnp.asarray, (x, loga, b, c)))
    jdx, jdl, jdb, jdc = (np.asarray(t) for t in vjp(jnp.asarray(dy)))
    assert not np.isfinite(jdl).all()
    assert all(np.isfinite(t).all() for t in (jdx, jdb, jdc))

    # float64 autograd of the sequential oracle, per (batch, head)
    want = np.zeros((bsz, l, h))
    for hi in range(h):
        la = torch.from_numpy(loga[0, :, hi]).double().requires_grad_()
        y, _ = ref.ssd_scan_ref(torch.from_numpy(x[0, :, hi]).double(),
                                torch.exp(la),
                                torch.from_numpy(b[0, :, hi]).double(),
                                torch.from_numpy(c[0, :, hi]).double())
        (g,) = torch.autograd.grad(
            (y * torch.from_numpy(dy[0, :, hi]).double()).sum(), la)
        want[0, :, hi] = g.numpy()
    t = [torch.from_numpy(a) for a in (x, loga, b, c, dy)]
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        got = ref.ssd_chunked_backward(*(a.to(dtype) for a in t), None,
                                       128)[1]
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) <= tol


def _triangle(q, n, seed):
    """A Q-step chunk's decayed causal triangle (C B^T . decay, zero above
    the diagonal; S 128) and an (Q, n) operand, float32."""
    r = np.random.default_rng(seed)
    c, b = r.normal(size=(2, q, 128))
    lcum = np.cumsum(-np.log1p(np.exp(r.normal(size=q))))
    dec = np.where(np.tri(q, dtype=bool),
                   np.exp(np.minimum(lcum[:, None] - lcum[None, :], 0)), 0)
    return ((c @ b.T) * dec).astype(np.float32), \
        r.normal(size=(q, n)).astype(np.float32)


# the backward's products, small, made from a seed: (64 x 128)(128 x 64)
# as B G / dY S_in^T (depth S or P), a Q 64 chunk's triangle transposed
# against dY (M^T dY) and against B (D B, depth 64 into S 128)
PRODUCTS = {"square": lambda seed: tuple(
                np.random.default_rng(seed).normal(size=sh).astype(np.float32)
                for sh in ((64, 128), (128, 64))),
            "triangle^T": lambda seed: (lambda m, y: (m.T.copy(), y))(
                *_triangle(64, 64, seed=seed)),
            "triangle": lambda seed: _triangle(64, 128, seed=seed)}


def _3xtf32_errors(product, seed):
    """(a, b, the 3xTF32 product's error from float64 element by element,
    the float32 product's max error, the exact product's max, the a
    priori bound element by element)."""
    a, b = map(torch.from_numpy, PRODUCTS[product](seed))
    want = a.double() @ b.double()
    err3 = (ref.matmul_3xtf32(a, b).double() - want).abs()
    err32 = float(((a @ b).double() - want).abs().max())
    steps = -(-a.shape[1] // 8)
    bound = ((2.0**-20 + 3 * steps * 2.0**-24)
             * (a.double().abs() @ b.double().abs()))
    return a, b, err3, err32, float(want.abs().max()), bound


@pytest.mark.parametrize("product", list(PRODUCTS))
def test_split_tf32_and_3xtf32_products(product):
    """The kernel's tensor-core arithmetic modelled on the CPU: each
    operand split once into TF32 hi and lo (cvt.rna: to nearest, ties
    away from zero), the product as lo.hi + hi.lo + hi.hi with lo.lo
    dropped, over 16 seeds."""
    # ties go away from zero, as cvt.rna rounds them
    tie = torch.tensor([1 + 2**-11, -(1 + 2**-11)], dtype=torch.float32)
    assert ref.split_tf32(tie)[0].tolist() == [1 + 2**-10, -(1 + 2**-10)]
    for seed in range(16):
        a, b, err3, err32, scale, bound = _3xtf32_errors(product, seed)
        assert a.shape[1] >= 64
        for t in (a, b):
            hi, lo = ref.split_tf32(t)
            for part in (hi, lo):
                assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
            nz = t != 0
            rel = ((hi.double() + lo.double() - t.double()).abs()[nz]
                   / t.double().abs()[nz])
            assert float(rel.max()) <= 2.0**-22
        assert bool((err3 <= bound).all()), (product, seed)
        assert 0 < err32 and float(err3.max()) <= 4 * err32 + 1e-6 * scale, (
            product, seed, float(err3.max()), err32)


# ---------------------------------------------------------------------------
# The autograd Function and the wrapper's routing
# ---------------------------------------------------------------------------
def _plain_launches(monkeypatch):
    """`_launch` / `launch_backward` replaced by the plain versions (the
    "workspace" handed from one to the other is loga itself), each call
    recorded."""
    calls = []

    def fwd(x, loga, b, c, chunk):
        calls.append("fwd")
        y, st = ops.plain(x, loga, b, c, chunk)
        return y, st, loga

    def bwd(x, b, c, dy, dstate, ws, chunk):
        calls.append("bwd")
        return ops.plain_backward(x, ws, b, c, dy, dstate, chunk)

    monkeypatch.setattr(ops, "_launch", fwd)
    monkeypatch.setattr(ops, "launch_backward", bwd)
    return calls


@pytest.mark.parametrize("case", [(1, 11, 2, 3, 1, 2, 4), (2, 9, 4, 2, 2, 3,
                                                           4)])
def test_function_gradcheck(monkeypatch, case):
    calls = _plain_launches(monkeypatch)
    bsz, l, h, p, g, s, q = case
    ins = [torch.from_numpy(a).requires_grad_()
           for a in _inputs(bsz, l, h, p, g, s, seed=1)[:4]]
    assert torch.autograd.gradcheck(
        lambda *a: ops._Scan.apply(*a, q), ins)
    # y alone: the final state's cotangent arrives as None
    assert torch.autograd.gradcheck(
        lambda *a: ops._Scan.apply(*a, q)[0], ins)
    assert "fwd" in calls and "bwd" in calls


def test_launch_backward_refuses_cpu_tensors():
    x, loga, b, c, dy, ds = map(torch.from_numpy,
                                _inputs(1, 8, 2, 4, 1, 4, seed=0,
                                        dtype=np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        ops.launch_backward(x, b, c, dy, ds, torch.zeros(8), 8)


# ---------------------------------------------------------------------------
# preflight_backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s_dim", [128, 64])     # mamba2-1.3b, zamba2-1.2b
def test_preflight_backward_at_the_train_shapes(s_dim):
    rep = ops.preflight_backward(8, 256, 64, 64, s_dim, chunk=128, groups=1)
    assert rep["issues"] == [] and rep["kernel"] == "ssd_scan_bwd"
    assert [ln["name"] for ln in rep["launches"]] == list(ops.BWD_NAMES)
    assert rep["smem_bytes"] <= skinny.SMEM_LIMIT
    # the contraction launches' ring (three slots of an A and a B strip)
    # and a staged 64 x 72 tile
    assert rep["smem_bytes"] == ops.TC_SMEM == 74240
    for ln in rep["launches"]:
        assert ln["smem_bytes"] <= skinny.SMEM_LIMIT
        assert ln["blocks_per_sm"] == 2 and ln["grid"][1] == 8
    ws = rep["workspace_floats"]
    assert ws["g"] == 8 * 64 * 2 * s_dim * 64
    assert ws["pdb"] == ws["pdc"] == 8 * 256 * 64 * s_dim
    # G = H writes dB and dC directly: no per-head partials
    assert ops.preflight_backward(8, 256, 64, 64, s_dim, groups=64)[
        "workspace_floats"]["pdb"] == 0


@pytest.mark.parametrize("kw,match", [
    (dict(bsz=1, l=10, h=3, p=4, s_dim=5, chunk=300), "exceeds the kernels"),
    (dict(bsz=1, l=10, h=3, p=4, s_dim=5, groups=2), "do not divide"),
    (dict(bsz=0, l=10, h=3, p=4, s_dim=5), "non-positive"),
    (dict(bsz=70000, l=10, h=4, p=4, s_dim=5), "grid y"),
])
def test_preflight_backward_reports_bad_shapes(kw, match):
    kw = dict(kw)
    args = [kw.pop(k) for k in ("bsz", "l", "h", "p", "s_dim")]
    issues = ops.preflight_backward(*args, **kw)["issues"]
    assert any(match in i for i in issues), issues


if __name__ == "__main__":
    import sys
    if sys.argv[1:] != ["--survey-3xtf32"]:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_ssd_backward.py"
                 " --survey-3xtf32")
    # the 3xTF32 products over 200 seeds: their max error over the float32
    # product's, its share of phase 19(a)'s gate and of the a priori bound
    for product in PRODUCTS:
        ratio, gate, prior, over = [], [], [], []
        for seed in range(200):
            _, _, err3, err32, scale, bound = _3xtf32_errors(product, seed)
            e = float(err3.max())
            ratio.append(e / err32)
            gate.append(e / (4 * err32 + 1e-6 * scale))
            prior.append(float((err3 / bound).max()))
            if e > 4 * err32:
                over.append(seed)
        print(f"{product}: err / float32 err median {np.median(ratio):.2f}, "
              f"max {max(ratio):.2f}; over 4x on {len(over)} of 200 seeds "
              f"{over}; share of 19(a)'s gate max {max(gate):.3f}; of the "
              f"a priori bound max {max(prior):.3f}")
