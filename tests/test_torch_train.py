"""Port parity of the LM training path against the JAX reference, on the
CPU: `layers.rmsnorm`'s hand-written backward, `softmax_xent`,
`transformer.forward` / `train_loss` of all six families, gradients with
plain and optical MLPs, the remat policies, AdamW and its schedules,
bfloat16 error feedback, `TokenPipeline`, checkpoints across the two
packages, `launch.steps.make_train_step` and `launch.train`.

Inputs are made with numpy from a seed and fed to both packages with the
reference's parameters (`params_from_reference`).  Bounds:

  * rmsnorm in float32: values and both cotangents within 1e-6 of their
    max; in bfloat16 within one bfloat16 step (2^-8) of their max, the
    cotangents in the activation dtype as the reference keeps them;
  * `softmax_xent`, with and without a mask: 1e-6 relative;
  * `forward` of one smoke config per family (vision with patches, encdec
    with source embeddings, both as `make_inputs` draws them):
    `train_loss` within 1e-5 relative; the final hidden states within
    1e-5 of their max, or 4x the reference's own distance from the
    port's float64 forward where that floor is higher (a random-weight
    stack amplifies float32 reordering: encdec-smoke sits ~3e-5 from
    float64 in either package);
  * plain-MLP gradients of qwen3-32b-smoke: each leaf within 1e-5 of its
    max |g|; with `rosa_mlp` through the "ref" backend, the flip-aware
    bound of `test_torch_cnn.py::test_qat_step_with_pinned_chip_matches_reference`
    (loss 1e-5 relative, the gradient tree within 1e-3 of its norm);
  * the remat policies "none" / "full" / "dots": gradients equal bit for
    bit, also through a keyed noisy engine (recomputation draws again);
  * mamba2-smoke and zamba2-smoke with every scan through the
    `ssd_scan` autograd Function (its launches replaced by the plain
    forward and backward): loss and |g| at 1e-5 relative, each gradient
    leaf within 1e-5 of its max or 4x the reference's distance from the
    port's float64 gradients, against the reference's `jax.grad`;
  * AdamW (5 steps; clipped and not, each schedule, with error feedback)
    and the schedules: 1e-6 relative on every leaf;
  * TokenPipeline, checkpoints across the packages and the resumed CLI:
    bit for bit; the CLI's 6 + 2 steps equal the reference's
    `make_train_step` loop from the same params at 1e-5.

The `cuda`-marked test trains on the card against the CPU and counts the
`rosa_fused` launches of an optical train step; it skips here.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch import kernels, rosa
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    read_meta, restore, save)
from repro_torch.configs import get_smoke
from repro_torch.core import mrr
from repro_torch.data import TokenPipeline
from repro_torch.distributed import compress as C
from repro_torch.kernels.rosa_fused import ops as fused_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import steps as ST
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models.model import (SMOKE_SHAPES, build_model,
                                      opt_state_from_reference,
                                      params_from_reference)
from repro_torch.models.module import leaves, map_tree, unflatten
from repro_torch.models.transformer import hybrid_depth
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, global_norm, linear_warmup)
from repro_torch.rosa.backends import RosaConfig
from test_torch_ref import BF16_STEP, reference, rel_err, to_np

torch.backends.cuda.matmul.allow_tf32 = False

QWEN = "qwen3-32b"
FAMILIES = ("qwen3-32b", "qwen3-moe-235b-a22b", "deepseek-v2-236b",
            "mamba2-1.3b", "zamba2-1.2b", "seamless-m4t-medium",
            "phi-3-vision-4.2b")
B, S = 2, 16


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


def _tree_np(tree) -> dict:
    """{"a/b": ndarray} of a tree of either package, keys sorted."""
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else k: v for k in sorted(tree)
                for p, v in _tree_np(tree[k]).items()}
    return {"": to_np(tree)}


def _batch(R, cfg, seed: int):
    """A train batch (tokens, labels; patches / source embeddings drawn
    as `make_inputs` draws them: N(0, 1) rounded to bfloat16, times 0.02)
    as the port's and the reference's."""
    rng = np.random.default_rng(seed)
    np_b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    for key, n, on in (("patch_embeds", 4, cfg.frontend == "vision"),
                       ("src_embeds", 12, cfg.is_encdec)):
        if on:
            e = torch.from_numpy(rng.normal(size=(B, n, cfg.d_model))
                                 .astype(np.float32))
            np_b[key] = to_np(e.to(torch.bfloat16).float() * 0.02)
    return ({k: torch.from_numpy(v) for k, v in np_b.items()},
            {k: R.jnp.asarray(v) for k, v in np_b.items()})


# ---------------------------------------------------------------------------
# layers: rmsnorm's backward, softmax_xent
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_its_backward_match_reference(R, dtype):
    jax, jnp = R.jax, R.jnp
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 64)).astype(np.float32) * 3
    s = (1 + 0.1 * rng.normal(size=(64,))).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    st = torch.from_numpy(s).to(tdt).requires_grad_()
    y = L.rmsnorm(st, xt, 1e-6)
    dx, ds = torch.autograd.grad(y, (xt, st), torch.from_numpy(g).to(tdt))
    yj, vjp = jax.vjp(lambda a, b: R.layers.rmsnorm(b, a, 1e-6),
                      jnp.asarray(x).astype(jdt), jnp.asarray(s).astype(jdt))
    dxj, dsj = vjp(jnp.asarray(g).astype(jdt))
    tol = 1e-6 if dtype == "float32" else BF16_STEP
    for got, want in ((y, yj), (dx, dxj), (ds, dsj)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype) == dtype
        assert rel_err(got.float(), np.asarray(want, np.float32)) <= tol
    # serving (no graph) runs the same forward as plain ops, bit for bit
    with torch.no_grad():
        assert torch.equal(L.rmsnorm(st, xt, 1e-6), y.detach())


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_reference(R, masked):
    rng = np.random.default_rng(2)
    logits = (4 * rng.normal(size=(3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    got = L.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                         None if mask is None else torch.from_numpy(mask))
    want = R.layers.softmax_xent(
        R.jnp.asarray(logits), R.jnp.asarray(labels),
        None if mask is None else R.jnp.asarray(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # an all-zero mask divides by 1, not 0
    zero = L.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                          torch.zeros(3, 7))
    assert float(zero) == 0.0


# ---------------------------------------------------------------------------
# forward / train_loss of every family
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_train_loss_match_reference(R, arch):
    jax = R.jax
    jcfg, cfg = R.configs.get_smoke(arch), get_smoke(arch)
    jb_model = R.model.build_model(jcfg)
    jp = jb_model.init(jax.random.PRNGKey(0))
    p = params_from_reference(jp)
    batch, jbatch = _batch(R, cfg, seed=3)
    hj, lj = jax.jit(lambda q, b: (jb_model.forward(q, b),
                                   jb_model.train_loss(q, b)))(jp, jbatch)
    bundle = build_model(cfg)
    assert bundle.step_fn(SMOKE_SHAPES["train_4k"]) == bundle.train_loss
    with torch.no_grad():
        h = bundle.forward(p, batch)
        loss = bundle.train_loss(p, batch)
        h64 = bundle.forward(map_tree(torch.Tensor.double, p),
                             {k: v.double() if v.is_floating_point() else v
                              for k, v in batch.items()})
    assert h.shape == hj.shape and h.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(lj), rtol=1e-5)
    floor = rel_err(h64, hj)
    assert rel_err(h, hj) <= max(1e-5, 4 * floor)


def test_make_inputs_train_cell_feeds_train_loss(R):
    """`input_specs` of a train shape is a batch `train_loss` takes; the
    vision cell's loss reads the text positions only."""
    cfg = get_smoke("phi-3-vision-4.2b")
    bundle = build_model(cfg)
    batch, _ = bundle.input_specs(SMOKE_SHAPES["train_4k"], concrete=True)
    p = bundle.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        loss = bundle.train_loss(p, batch)
        x = bundle.forward(p, batch)
    assert x.shape[1] == (batch["patch_embeds"].shape[1]
                          + batch["tokens"].shape[1])
    assert loss.shape == () and bool(torch.isfinite(loss))


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------
def _grads(R, cfg, jcfg, engine=None, jengine=None):
    """(loss, grads) of both packages on qwen3-32b-smoke's reference
    params and a seeded batch, each under its engine (None: ambient
    none)."""
    jax = R.jax
    jp = R.model.build_model(jcfg).init(jax.random.PRNGKey(0))
    batch, jbatch = _batch(R, cfg, seed=4)
    with R.rosa.engine_context(jengine):
        lj, gj = jax.jit(jax.value_and_grad(
            lambda q: R.model.build_model(jcfg).train_loss(q, jbatch)))(jp)
    with rosa.engine_context(engine):
        loss, g = ST.loss_and_grads(build_model(cfg),
                                    params_from_reference(jp), batch)
    return float(loss), _tree_np(g), float(lj), _tree_np(gj)


def test_plain_mlp_gradients_match_reference(R):
    loss, g, lj, gj = _grads(R, get_smoke(QWEN), R.configs.get_smoke(QWEN))
    np.testing.assert_allclose(loss, lj, rtol=1e-5)
    assert list(g) == list(gj)
    for k in gj:
        assert rel_err(g[k], gj[k]) <= 1e-5, k


def test_optical_mlp_gradients_through_ref_backend_match_reference(R):
    """`rosa_mlp` with the "ref" backend named (the composed OSA pipeline,
    straight-through backward): the flip-aware bound."""
    cfg = dataclasses.replace(get_smoke(QWEN), rosa_mlp=True)
    jcfg = dataclasses.replace(R.configs.get_smoke(QWEN), rosa_mlp=True)
    loss, g, lj, gj = _grads(
        R, cfg, jcfg, rosa.Engine.from_config(RosaConfig(backend="ref")),
        R.rosa.Engine.from_config(R.backends.RosaConfig(backend="ref")))
    np.testing.assert_allclose(loss, lj, rtol=1e-5)
    err = np.sqrt(sum(np.sum((g[k] - gj[k]) ** 2) for k in gj))
    assert err <= 1e-3 * np.sqrt(sum(np.sum(v ** 2) for v in gj.values()))


def test_default_engine_takes_the_ideal_shortcut(R, monkeypatch):
    """`rosa_mlp` with no engine installed: `Engine.from_config()` (IDEAL
    noise, ideal OSA, backend "auto", no chip) takes `_forward`'s
    fake-quant shortcut in both packages, so no OSA pipeline and no
    kernel runs; the loss is the reference's."""
    calls = []
    real = fused_ops.rosa_fused
    monkeypatch.setattr(fused_ops, "rosa_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    from repro_torch.core import osa
    monkeypatch.setattr(osa, "osa_matmul_ref",
                        lambda *a, **k: calls.append(1))
    cfg = dataclasses.replace(get_smoke(QWEN), rosa_mlp=True)
    jcfg = dataclasses.replace(R.configs.get_smoke(QWEN), rosa_mlp=True)
    loss, g, lj, gj = _grads(R, cfg, jcfg)
    assert calls == []
    np.testing.assert_allclose(loss, lj, rtol=1e-5)
    err = np.sqrt(sum(np.sum((g[k] - gj[k]) ** 2) for k in gj))
    assert err <= 1e-3 * np.sqrt(sum(np.sum(v ** 2) for v in gj.values()))


@pytest.mark.parametrize("noisy", [False, True])
def test_remat_policies_give_equal_gradients(noisy):
    """"none", "full" and "dots" keep other tensors for the backward and
    compute the same numbers; through a keyed noisy optical engine the
    recomputed blocks draw their noise again from the folded keys."""
    cfg = dataclasses.replace(get_smoke(QWEN), rosa_mlp=noisy)
    bundle = build_model(cfg)
    p = bundle.init(torch.Generator().manual_seed(0))
    batch = TokenPipeline(cfg.vocab, S, B, seed=1).batch(0)
    engine = None
    if noisy:
        engine = rosa.Engine.from_config(
            RosaConfig(noise=mrr.PAPER_NOISE, backend="ref"),
            key=torch.Generator().manual_seed(3))
    out = {}
    for remat in ("none", "full", "dots"):
        b = build_model(dataclasses.replace(cfg, remat=remat))
        with rosa.engine_context(engine):
            out[remat] = ST.loss_and_grads(b, p, batch)
    loss, g = out["none"]
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], loss)
        for (k, a), (_, b) in zip(leaves(out[remat][1]), leaves(g)):
            assert torch.equal(a, b), (remat, k)
    if noisy:       # the noise is on: another key moves the loss
        with rosa.engine_context(engine.with_key(
                torch.Generator().manual_seed(4))):
            assert not torch.equal(ST.loss_and_grads(bundle, p, batch)[0],
                                   loss)


def test_fused_launches_of_an_optical_train_step(monkeypatch):
    """The count phase 17(b) of chip_smoke.py gates: with the "fused"
    backend each layer's two MLP projections run the kernel once in the
    forward and, under remat "full", once more when the backward
    recomputes the block; "none" keeps the forward's outputs.  (On the
    CPU the wrapper runs the plain version; it is counted here.)"""
    calls = []
    real = fused_ops.plain
    monkeypatch.setattr(fused_ops, "plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    engine = rosa.Engine.from_config(RosaConfig(backend="fused"))
    for remat, per_layer in (("full", 4), ("none", 2)):
        cfg = dataclasses.replace(get_smoke(QWEN), rosa_mlp=True,
                                  remat=remat)
        bundle = build_model(cfg)
        p = bundle.init(torch.Generator().manual_seed(0))
        step = ST.make_train_step(bundle, AdamWConfig())
        opt = ST.init_opt_state(p)
        pipe = TokenPipeline(cfg.vocab, S, B)
        calls.clear()
        with rosa.engine_context(engine):
            for i in range(2):
                p, opt, _ = step(p, opt, pipe.batch(i))
        assert len(calls) == per_layer * cfg.n_layers * 2, remat


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_recomputation_sees_the_forward_engine_in_another_thread(
        monkeypatch, remat):
    """For CUDA tensors autograd runs the backward, and with it the
    recomputation, in a device thread of its own, which does not see the
    caller's `engine_context`.  Emulated here: the forward in the
    context, the backward in a fresh thread.  The recomputed blocks must
    run the forward's engine (the "fused" backend: 4 kernel calls a layer)
    and give the gradients of remat "none", also under a keyed noisy
    engine."""
    calls = []
    real = fused_ops.plain
    monkeypatch.setattr(fused_ops, "plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    base = dataclasses.replace(get_smoke(QWEN), rosa_mlp=True)
    p = build_model(base).init(torch.Generator().manual_seed(0))
    batch = TokenPipeline(base.vocab, S, B, seed=1).batch(0)
    xs = [t.detach().requires_grad_() for _, t in leaves(p)]
    tree = dict(zip([k for k, _ in leaves(p)], xs))

    def grads(cfg, engine, thread: bool):
        with rosa.engine_context(engine):
            loss = build_model(cfg).train_loss(unflatten(tree.items()),
                                               batch)
        if not thread:
            return torch.autograd.grad(loss, xs)
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "g", torch.autograd.grad(loss, xs)))
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
        return out["g"]

    for engine, per_layer in (
            (rosa.Engine.from_config(RosaConfig(backend="fused")), 4),
            (rosa.Engine.from_config(
                RosaConfig(noise=mrr.PAPER_NOISE, backend="ref"),
                key=torch.Generator().manual_seed(3)), 0)):
        calls.clear()
        got = grads(dataclasses.replace(base, remat=remat), engine, True)
        if remat == "full":
            assert len(calls) == per_layer * base.n_layers
        want = grads(dataclasses.replace(base, remat="none"), engine, False)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ssd_scan_routes_grads_through_the_function_off_the_cpu(
        monkeypatch):
    """A card-side call that needs gradients goes through the autograd
    Function, whose backward reaches the backward kernel's launch; under
    no_grad, or on detached operands, the forward launches alone.  Meta
    tensors stand in for CUDA ones, with the wrappers' plain route for
    meta (the dry run's) switched off."""
    def meta(*shape, grad=False):
        return torch.empty(shape, device="meta", requires_grad=grad)
    args = (meta(1, 8, 2, 4, grad=True), meta(1, 8, 2), meta(1, 8, 1, 4),
            meta(1, 8, 1, 4))
    seen = []
    monkeypatch.setattr(kernels, "runs_plain",
                        lambda t: t.device.type == "cpu")

    def fwd(x, loga, b, c, chunk):
        seen.append("fwd")
        return (torch.empty_like(x), x.new_empty((1, 2, 4, 4)),
                x.new_empty(16))

    def bwd(x, b, c, dy, dstate, ws, chunk):
        seen.append(("bwd", dstate))
        return (torch.empty_like(x), x.new_empty(x.shape[:3]),
                torch.empty_like(b), torch.empty_like(c))

    monkeypatch.setattr(ssd_ops, "_launch", fwd)
    monkeypatch.setattr(ssd_ops, "launch_backward", bwd)
    y, state = ssd_ops.ssd_scan(*args, chunk=4)
    assert y.grad_fn is not None and seen == ["fwd"]
    (g,) = torch.autograd.grad(y, args[0], torch.empty_like(y))
    assert g.shape == args[0].shape and seen == ["fwd", ("bwd", None)]
    launched = []
    monkeypatch.setattr(ssd_ops, "launch", lambda *a: launched.append(a))
    with torch.no_grad():
        ssd_ops.ssd_scan(*args, chunk=4)
    ssd_ops.ssd_scan(*(a.detach() for a in args), chunk=4)
    assert len(launched) == 2 and len(seen) == 2


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_ssm_train_step_through_the_function_matches_reference(
        R, monkeypatch, arch):
    """A train step of the smoke model with every scan routed through the
    autograd Function (the kernels' launches replaced by the plain
    forward and backward): the loss and |g| within the bound of
    `test_train_step_loop_matches_reference` (1e-5 relative), each
    gradient leaf within 1e-5 of its max or 4x the reference's own
    distance from the port's float64 gradients where that floor is
    higher (`test_forward_and_train_loss_match_reference`'s rule; the
    float64 step runs the scan's CPU path, autograd of
    `ref.ssd_chunked`, not the Function under test), and the launches
    phase 19 of
    chip_smoke.py counts: under remat "full" each recomputed layer's scan
    runs twice (zamba2's tail, outside the recomputed groups, once), and
    the backward once a layer."""
    from repro_torch.models import ssm as SSM
    calls = {"fwd": 0, "bwd": 0}

    def fwd(x, loga, b, c, chunk):
        calls["fwd"] += 1
        return (*ssd_ops.plain(x, loga, b, c, chunk), loga)

    def bwd(x, b, c, dy, dstate, ws, chunk):
        calls["bwd"] += 1
        return ssd_ops.plain_backward(x, ws, b, c, dy, dstate, chunk)

    cfg, jcfg = get_smoke(arch), R.configs.get_smoke(arch)
    jax = R.jax
    jp = R.model.build_model(jcfg).init(jax.random.PRNGKey(0))
    batch, jbatch = _batch(R, cfg, seed=4)
    lj, gj = jax.jit(jax.value_and_grad(
        lambda q: R.model.build_model(jcfg).train_loss(q, jbatch)))(jp)
    gj = _tree_np(gj)
    bundle, p = build_model(cfg), params_from_reference(jp)
    g64 = _tree_np(ST.loss_and_grads(bundle, map_tree(torch.Tensor.double,
                                                      p), batch)[1])
    monkeypatch.setattr(ssd_ops, "_launch", fwd)
    monkeypatch.setattr(ssd_ops, "launch_backward", bwd)
    monkeypatch.setattr(SSM, "ssd_scan", lambda x, loga, b, c, chunk:
                        ssd_ops._Scan.apply(x, loga, b, c, chunk))
    loss, g = ST.loss_and_grads(bundle, p, batch)
    g = _tree_np(g)
    np.testing.assert_allclose(float(loss), float(lj), rtol=1e-5)
    assert list(g) == list(gj)
    for k in gj:
        assert rel_err(g[k], gj[k]) <= max(1e-5, 4 * rel_err(g64[k], gj[k])), k
    np.testing.assert_allclose(
        np.sqrt(sum(np.sum(v.astype(np.float64) ** 2) for v in g.values())),
        np.sqrt(sum(np.sum(v.astype(np.float64) ** 2) for v in gj.values())),
        rtol=1e-5)
    if cfg.family == "hybrid":
        n_groups, tail = hybrid_depth(cfg)
        recomputed = n_groups * cfg.shared_every
    else:
        recomputed, tail = cfg.n_layers, 0
    assert calls == {"fwd": 2 * recomputed + tail,
                     "bwd": recomputed + tail}


# ---------------------------------------------------------------------------
# optimizer, schedules, compression
# ---------------------------------------------------------------------------
def test_schedules_match_reference(R):
    steps = np.arange(0, 14, dtype=np.int32)
    for ours, ref in ((linear_warmup(3e-4, 4), R.optim_schedules
                       .linear_warmup(3e-4, 4)),
                      (cosine_schedule(1e-3, 3, 12),
                       R.optim_schedules.cosine_schedule(1e-3, 3, 12)),
                      (cosine_schedule(2e-4, 0, 1, 0.2),
                       R.optim_schedules.cosine_schedule(2e-4, 0, 1, 0.2))):
        got = ours(torch.from_numpy(steps))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(to_np(got),
                                   np.asarray(ref(R.jnp.asarray(steps))),
                                   rtol=1e-6)


def _tree(rng, scale=1.0) -> dict:
    """A small nested params-shaped tree of float32 numpy arrays (keys
    inserted unsorted: the order of the leaves is the sorted one)."""
    return {"w": {"z": scale * rng.normal(size=(3, 5)),
                  "a": scale * rng.normal(size=(4,))},
            "emb": scale * rng.normal(size=(6, 2)),
            "b": {"k": scale * rng.normal(size=(2, 3, 2))}}


@pytest.mark.parametrize("case", ["clip-cosine", "noclip-warmup",
                                  "clip-const-compress"])
def test_adamw_steps_match_reference(R, case):
    jnp = R.jnp
    rng = np.random.default_rng(7)
    f32 = lambda t: map_tree(lambda a: np.asarray(a, np.float32), t)  # noqa
    params = f32(_tree(rng))
    grads = [f32(_tree(rng, scale)) for scale in (3.0, 0.2, 5.0, 1e-3, 2.0)]
    clip = 0.0 if case.startswith("noclip") else 1.0
    lr, jlr = {"cosine": (cosine_schedule(1e-2, 2, 5),
                          R.optim_schedules.cosine_schedule(1e-2, 2, 5)),
               "warmup": (linear_warmup(1e-2, 3),
                          R.optim_schedules.linear_warmup(1e-2, 3)),
               "const": (3e-3, 3e-3)}[case.split("-")[1]]
    compress = case.endswith("compress")
    cfg = AdamWConfig(lr=lr, grad_clip=clip)
    jcfg = R.optim.AdamWConfig(lr=jlr, grad_clip=clip)
    p = map_tree(torch.tensor, params)       # a copy: updated in place
    st = ST.init_opt_state(p, compress)
    jp = map_tree(jnp.asarray, params)
    jst = R.steps.init_opt_state(jp, compress)
    for g in grads:
        gt, gj = map_tree(torch.from_numpy, g), map_tree(jnp.asarray, g)
        if compress:
            g16, err = C.compress(gt, st["err"])
            gt, st = C.decompress(g16), dict(st, err=err)
            j16, jerr = R.compress.compress(gj, jst["err"])
            gj, jst = R.compress.decompress(j16), dict(jst, err=jerr)
        p, adam, m = adamw_update(p, gt, st["adam"], cfg)
        st = dict(st, adam=adam)
        jp, jadam, jm = R.optim.adamw_update(jp, gj, jst["adam"], jcfg)
        jst = dict(jst, adam=jadam)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
    assert st["adam"]["step"].dtype == torch.int32
    assert int(st["adam"]["step"]) == int(jst["adam"]["step"]) == 5
    for name, got, want in (("params", p, jp), ("opt", st, jst)):
        got, want = _tree_np(got), _tree_np(want)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert rel_err(got[k], want[k]) <= 1e-6, (name, k)


def test_global_norm_sums_leaves_in_sorted_key_order(monkeypatch):
    """The leaves enter the sum in `jax.tree.leaves` order (dict keys
    sorted, recursively), whatever order the dict was built in."""
    order = []
    real = torch.square
    monkeypatch.setattr(torch, "square",
                        lambda t: order.append(t.shape) or real(t))
    tree = map_tree(torch.from_numpy, _tree(np.random.default_rng(0)))
    global_norm(tree)
    assert order == [(2, 3, 2), (6, 2), (4,), (3, 5)]


def test_opt_state_carried_from_reference(R):
    jp = R.model.build_model(R.configs.get_smoke(QWEN)).init(
        R.jax.random.PRNGKey(0))
    jst = R.steps.init_opt_state(jp, True)
    st = opt_state_from_reference(jst)
    assert set(st) == {"adam", "err"}
    assert st["adam"]["step"].dtype == torch.int32
    assert st["adam"]["step"].shape == ()
    mine = ST.init_opt_state(params_from_reference(jp), True)
    for (k, a), (_, b) in zip(leaves(st), leaves(mine), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert adamw_init(mine["adam"]["mu"])["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# data, checkpoints
# ---------------------------------------------------------------------------
def test_token_pipeline_equals_reference_bit_for_bit(R):
    ours = TokenPipeline(vocab=97, seq_len=33, global_batch=4, seed=5)
    ref = R.tokens.TokenPipeline(vocab=97, seq_len=33, global_batch=4,
                                 seed=5)
    for step in (0, 1, 17):
        got, want = ours.batch(step), ref.batch(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]))
        for shard in (0, 1):
            s, w = ours.shard_batch(step, shard, 2), ref.shard_batch(
                step, shard, 2)
            for k in s:
                np.testing.assert_array_equal(to_np(s[k]), np.asarray(w[k]))


def _state(R, compress=False):
    """Both packages' {"params", "opt"} of qwen3-32b-smoke after one
    AdamW step from the reference's params (non-zero moments)."""
    jp = R.model.build_model(R.configs.get_smoke(QWEN)).init(
        R.jax.random.PRNGKey(0))
    p = params_from_reference(jp)
    st = ST.init_opt_state(p, compress)
    g = map_tree(lambda t: torch.full_like(t, 0.1), p)
    p, adam, _ = adamw_update(p, g, st["adam"], AdamWConfig())
    return {"params": p, "opt": dict(st, adam=adam)}


def test_checkpoint_written_by_either_package_restores_in_the_other(
        R, tmp_path):
    state = _state(R, compress=True)
    jlike = R.jax.tree.map(R.jnp.asarray,
                           map_tree(lambda t: to_np(t), state))
    # port -> reference
    save(str(tmp_path / "a"), 3, state, meta={"arch": "x"})
    back = R.checkpoint.restore(str(tmp_path / "a"), 3, jlike)
    got, want = _tree_np(back), _tree_np(state)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert R.checkpoint.read_meta(str(tmp_path / "a"), 3)["meta"] == \
        {"arch": "x"}
    # reference -> port, into meta tensors of the model's structure
    R.checkpoint.save(str(tmp_path / "b"), 4, jlike, meta={"arch": "y"})
    like = map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), state)
    mine = restore(str(tmp_path / "b"), 4, like)
    for (k, a), (_, b) in zip(leaves(mine), leaves(state), strict=True):
        assert a.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a, b), k
    assert read_meta(str(tmp_path / "b"), 4) == json.loads(
        (tmp_path / "a" / "step_00000003" / "manifest.json").read_text()) \
        | {"step": 4, "meta": {"arch": "y"}}


def test_checkpoint_manager_keeps_k_and_skips_partial_writes(tmp_path):
    root = str(tmp_path)
    tree = {"w": torch.arange(6.0).reshape(2, 3),
            "n": {"s": torch.zeros((), dtype=torch.int32)}}
    mgr = CheckpointManager(root, every=2, keep=2)
    for step in range(1, 9):
        mgr.maybe_save(step, tree)
    assert sorted(os.listdir(root)) == ["step_00000006", "step_00000008"]
    os.makedirs(os.path.join(root, "step_00000010.tmp-abc"))
    os.makedirs(os.path.join(root, "step_00000012"))   # no manifest yet
    assert latest_step(root) == mgr.latest() == 8
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(ValueError, match="shape mismatch for w"):
        restore(root, 8, {"w": torch.zeros(3, 2), "n": tree["n"]})


# ---------------------------------------------------------------------------
# the train step and the CLI
# ---------------------------------------------------------------------------
def _reference_loop(R, np_params, cfg_args, start: int, stop: int,
                    np_state=None):
    """The reference's `make_train_step` loop from numpy params (and
    optimizer state), as `repro.launch.train` drives it on one device.
    Returns (losses, grad norms, params, state)."""
    jax, jnp = R.jax, R.jnp
    jcfg = R.configs.get_smoke(QWEN)
    bundle = R.model.build_model(jcfg)
    opt_cfg = R.optim.AdamWConfig(lr=R.optim_schedules.cosine_schedule(
        cfg_args["lr"], cfg_args["warmup"], cfg_args["steps"]))
    step = jax.jit(R.steps.make_train_step(bundle, opt_cfg))
    params = jax.tree.map(jnp.asarray, np_params)
    opt = (R.steps.init_opt_state(params) if np_state is None
           else jax.tree.map(jnp.asarray, np_state))
    pipe = R.tokens.TokenPipeline(vocab=jcfg.vocab, seq_len=cfg_args["seq"],
                                  global_batch=cfg_args["batch"], seed=0)
    losses, norms = [], []
    for i in range(start, stop):
        params, opt, m = step(params, opt, pipe.batch(i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, params, opt


def test_train_cli_checkpoints_resumes_and_equals_reference_loop(
        R, tmp_path, capsys):
    """`--smoke --device cpu --batch 2 --seq 32 --steps 6 --ckpt-every 5`,
    then `--steps 8 --resume`: the second run resumes from step 5, and
    both runs' losses equal the reference's loop from the CLI's initial
    params on the same batches (the schedule's total follows --steps)."""
    base = ["--arch", QWEN, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "32", "--lr", "1e-3", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "5", "--log-every", "1"]
    r1 = train_cli.run(train_cli.build_parser().parse_args(
        base + ["--steps", "6"]))
    out1 = capsys.readouterr().out
    assert out1.splitlines()[0] == "arch=qwen3-32b-smoke params=106,880"
    assert "done: 6 steps" in out1
    assert os.listdir(tmp_path) == ["step_00000005"]
    assert read_meta(str(tmp_path), 5)["meta"] == {"arch": "qwen3-32b-smoke"}
    train_cli.main(base + ["--steps", "8", "--resume"])
    out2 = capsys.readouterr().out
    assert "resumed from step 5" in out2 and "done: 3 steps" in out2

    p0 = map_tree(to_np, build_model(get_smoke(QWEN)).init(
        torch.Generator("cpu").manual_seed(0)))
    args = {"lr": 1e-3, "warmup": 20, "steps": 6, "seq": 32, "batch": 2}
    losses, norms, _, _ = _reference_loop(R, p0, args, 0, 6)
    got = [h["loss"] for h in r1["history"]]
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    np.testing.assert_allclose([h["grad_norm"] for h in r1["history"]],
                               norms, rtol=1e-5)
    for line, loss in zip([ln for ln in out1.splitlines()
                           if ln.startswith("step")], got):
        assert f"loss {loss:7.4f}" in line
    # the resumed run: the reference from the checkpoint of step 5
    ck = R.checkpoint
    like = R.jax.tree.map(R.jnp.asarray, map_tree(to_np, {
        "params": r1["params"], "opt": r1["opt"]}))
    state = ck.restore(str(tmp_path), 5, like)
    losses2, _, _, _ = _reference_loop(
        R, state["params"], dict(args, steps=8), 5, 8, state["opt"])
    resumed = [float(ln.split("loss")[1].split()[0])
               for ln in out2.splitlines() if ln.startswith("step")]
    np.testing.assert_allclose(resumed, losses2, atol=6e-5)


def test_data_parallel_flag_exits():
    # --data-axis 2 on the one device of --devices 1: 2 does not divide 1
    with pytest.raises(SystemExit, match="does not divide --devices 1"):
        train_cli.main(["--smoke", "--device", "cpu", "--data-axis", "2"])


def test_train_step_loop_matches_reference(R):
    """Six steps of the port's `make_train_step` against the reference's
    from the same params and batches: losses and grad norms at 1e-5.  The
    params after them: on every leaf all but 0.1 % of the entries within
    1e-5 of the leaf's max, and every entry within the largest update the
    reference made to that leaf.  Adam divides a gradient by its own root
    mean square, so an entry whose gradient is float noise (a cancelling
    sum: one embedding entry of 16384 here) takes a full-size step in
    another direction in each package."""
    jp = R.model.build_model(R.configs.get_smoke(QWEN)).init(
        R.jax.random.PRNGKey(1))
    np_p = R.jax.tree.map(np.asarray, jp)
    args = {"lr": 1e-3, "warmup": 2, "steps": 6, "seq": 32, "batch": 2}
    losses, norms, jpf, _ = _reference_loop(R, np_p, args, 0, 6)
    cfg = get_smoke(QWEN)
    step = ST.make_train_step(build_model(cfg), AdamWConfig(
        lr=cosine_schedule(1e-3, 2, 6)))
    p = params_from_reference(np_p)
    opt = ST.init_opt_state(p)
    pipe = TokenPipeline(cfg.vocab, 32, 2, seed=0)
    got, gn = [], []
    for i in range(6):
        p, opt, m = step(p, opt, pipe.batch(i))
        got.append(float(m["loss"]))
        gn.append(float(m["grad_norm"]))
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    np.testing.assert_allclose(gn, norms, rtol=1e-5)
    want, p0 = _tree_np(jpf), _tree_np(np_p)
    for k, v in _tree_np(p).items():
        d = np.abs(v - want[k])
        assert (d > 1e-5 * np.abs(want[k]).max()).mean() <= 1e-3, k
        assert d.max() <= np.abs(want[k] - p0[k]).max(), k


@pytest.mark.cuda
def test_optical_train_step_on_cuda_matches_cpu():
    """One optical train step of qwen3-32b-smoke on the card ("fused": the
    kernel, 4 launches a layer under remat "full") against the CPU's plain
    version of the kernel, from the same params and batch: the loss at
    1e-5 and the flip-aware bound on the gradient tree (1e-3 of its
    norm)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (kernels build on first "
                    "use)")
    cfg = dataclasses.replace(get_smoke(QWEN), rosa_mlp=True)
    bundle = build_model(cfg)
    p = bundle.init(torch.Generator().manual_seed(0))
    batch = TokenPipeline(cfg.vocab, S, B).batch(0)
    engine = rosa.Engine.from_config(RosaConfig(backend="fused"))
    with rosa.engine_context(engine):
        loss, g = ST.loss_and_grads(bundle, p, batch)
        fused_ops.LAUNCHES.reset()
        lc, gc = ST.loss_and_grads(
            bundle, map_tree(lambda t: t.cuda(), p),
            {k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
    assert fused_ops.LAUNCHES.count == 4 * cfg.n_layers
    np.testing.assert_allclose(float(lc), float(loss), rtol=1e-5)
    a, b = _tree_np(gc), _tree_np(g)
    err = np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in b))
    assert err <= 1e-3 * np.sqrt(sum(np.sum(v ** 2) for v in b.values()))
