"""Port parity of the paper CNNs and their QAT / Table 4 pipeline against the
JAX reference (`repro.models.cnn`, `repro.training.cnn_train`,
`benchmarks/table4_hybrid.py`), on the CPU at the reference's widths.

Parameters and chips are carried across as numbers
(`params_from_reference`, `chip_from_reference`); images come from
synth-CIFAR, which both packages generate bit for bit.  Per-shot noise
draws differ between the packages, so noisy parity is held with a chip
pinned and per-shot noise ideal (deterministic).  Tolerances:

  * im2col, synth-CIFAR, EDP and plans: exact;
  * whole networks (ideal QAT of all four families; mobilenet_v3 with a
    chip pinned under WS / IS / ANALOG): one requant LSB (2/127) of the
    logits' full scale and the same predictions (`assert_network_parity`).
    The contractions sum in another order, so a fake-quant code may flip
    at a rounding boundary: resnet18's l4_b1_c1 input does on these
    images (its absmax differs by one ulp), which moves the logits by 1%
    of their full scale;
  * the QAT step: loss rtol 1e-5; the straight-through gradient tree
    within 1e-4 of its norm (a flipped forward code moves the few
    gradients that pass through it: 5e-6 of the norm measured with one
    flip, 1.4e-7 without); Adam on the same gradients rtol 1e-6.

The golden file `tests/data/torch_cnn_mobilenet_v3.npz` holds JAX-trained
mobilenet_v3 parameters (400 QAT steps, seed 0), a JAX-sampled chip (key
7) and JAX's logits on the 512-image test split (clean, and chip-pinned
WS and IS).  `python tests/test_torch_cnn.py --write-golden` writes it
with the reference on the CPU; `chip_smoke.py` holds the card to it.
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch import rosa
from repro_torch.core import mrr as TM
from repro_torch.core.constants import ComputeMode, Mapping
from repro_torch.data import synth_cifar as TD
from repro_torch.launch import table4
from repro_torch.models import cnn as TCNN
from repro_torch.models.model import params_from_reference
from repro_torch.robust import variation as TV
from repro_torch.training import cnn_train as TT
from test_torch_ref import reference, to_np

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GOLDEN = pathlib.Path(__file__).resolve().parent / "data" \
    / "torch_cnn_mobilenet_v3.npz"
GOLDEN_STEPS, GOLDEN_CHIP_KEY = 400, 7
MODEL = "mobilenet_v3"
FAMILIES = ["alexnet", "vgg16", "resnet18", "mobilenet_v3"]


@pytest.fixture(scope="module")
def R():
    return reference()


def _images(n, seed=3):
    x, y = TD.synth_cifar(n, seed=seed, noise=0.35)
    return x, y


def _np_params(model, seed=0):
    """Parameters of the reference's shapes and init scale, from numpy
    (biases small and non-zero so they are exercised too)."""
    r = np.random.default_rng(seed)
    out = {}
    for name, leaves in TCNN.cnn_def(TCNN.LITE_MODELS[model]).items():
        w = leaves["w"].shape
        out[name] = {
            "w": (r.normal(size=w) / np.sqrt(w[0])).astype(np.float32),
            "b": (0.01 * r.normal(size=leaves["b"].shape)).astype(
                np.float32)}
    return out


def _cfg(side, mode, mapping):
    """QAT_CFG with (mode, mapping) on one side (R, or None for the port);
    the enums are the port's, converted for the reference by value."""
    if side is None:
        return dataclasses.replace(TT.QAT_CFG, mode=mode, mapping=mapping)
    return dataclasses.replace(
        side.cnn_train.QAT_CFG, mode=side.constants.ComputeMode(mode.value),
        mapping=side.constants.Mapping(mapping.value))


def assert_network_parity(got, want, *, qmax=127, argmax_flips=0):
    """A whole quantized network in two summation orders: a fake-quant code
    may flip at a rounding boundary, and a flip that moves a tensor's
    absmax rescales the next layer's per-tensor grid, so the deviation
    spreads over every row.  It stays within one requant LSB (2/qmax) of
    the full scale, and the predicted classes agree."""
    g, w = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    scale = np.abs(w).max()
    dev = np.abs(g - w).max() / scale
    assert dev <= 2.0 / qmax, f"deviation {dev:.2e} of full scale"
    flips = int((g.argmax(-1) != w.argmax(-1)).sum())
    assert flips <= argmax_flips, f"{flips} predictions differ"


def _programs(side, model, cfgs):
    """{name: program} for {name: RosaConfig} on one side (R or None for
    the port)."""
    ct = side.cnn_train if side is not None else TT
    mk = side.rosa.Engine if side is not None else rosa.Engine
    names = [s.name for s in ct.LITE_MODELS[model]]
    return {k: ct.cnn_program(model, mk.from_config(c, layers=names))
            for k, c in cfgs.items()}


def load_golden(z):
    """(params, chip) trees of numpy arrays from the golden file."""
    params: dict = {}
    chip: dict = {}
    for k in z.files:
        kind, *rest = k.split(".")
        if kind == "params":
            params.setdefault(rest[0], {})[rest[1]] = z[k]
        elif kind == "chip":
            chip.setdefault(rest[0], {})[rest[1]] = z[k]
    return params, chip


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        data = {k: z[k] for k in z.files}
        params, chip = load_golden(z)
    return data, params, chip


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [8, 7])
def test_im2col_matches_conv_general_dilated_patches(R, k, stride, hw):
    """SAME padding (stride 2 on an even input pads 0 before, 1 after) and
    patch lanes in (C, kh, kw) order, exactly."""
    x = np.random.default_rng(k * 10 + stride).normal(
        size=(2, hw, hw, 3)).astype(np.float32)
    want = R.cnn._im2col(R.jnp.asarray(x), k, stride)
    got = TCNN._im2col(torch.from_numpy(x), k, stride)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(to_np(got), to_np(want))


def test_synth_cifar_bitwise_equal(R):
    (xa, ya), (xb, yb) = TD.train_test_split(n_train=64, n_test=32, seed=5)
    (ra, rya), (rb, ryb) = R.synth_cifar.train_test_split(
        n_train=64, n_test=32, seed=5)
    for got, want in ((xa, ra), (ya, rya), (xb, rb), (yb, ryb)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("model", FAMILIES)
def test_program_trace_equals_reference(R, model):
    """The compiled program's routed GEMMs (conv/fc; depthwise convs are
    conditioned, not routed), traced on meta tensors."""
    def entries(trace):
        return [(e.name, e.m, e.k, e.n) for e in trace.entries]

    port = TT.cnn_program(model, TT.qat_engine(model))
    ref = R.cnn_train.cnn_program(model, R.cnn_train.qat_engine(model))
    assert entries(port.trace) == entries(ref.trace)
    assert len(port.trace) == sum(s.kind != "dwconv"
                                  for s in TCNN.LITE_MODELS[model])


@pytest.mark.parametrize("model", FAMILIES)
def test_cnn_apply_matches_reference_ideal_qat(R, model):
    jp = _np_params(model)
    x, _ = _images(8)
    want = R.cnn_train.cnn_program(model, R.cnn_train.qat_engine(model))(
        jp, R.jnp.asarray(x))
    got = TCNN.cnn_apply(params_from_reference(jp), TCNN.LITE_MODELS[model],
                         torch.from_numpy(x), TT.qat_engine(model),
                         residual_from=TCNN.LITE_SKIPS.get(model))
    assert_network_parity(got, want)


@pytest.mark.parametrize("mode,mapping", [
    (ComputeMode.MIXED, Mapping.WS), (ComputeMode.MIXED, Mapping.IS),
    (ComputeMode.ANALOG, Mapping.WS)])
def test_chip_pinned_mobilenet_matches_reference(R, golden, mode, mapping):
    """The golden file's JAX-trained params and JAX-sampled chip, per-shot
    noise ideal: every conv/fc realizes its analog operand and every
    depthwise weight is realized (`condition_weight` ignores the
    mapping)."""
    _, params, chip = golden
    jp, jchip = _ref_trees(R, params, chip)
    x, _ = _images(64)
    want = _programs(R, MODEL, {"p": _cfg(R, mode, mapping)})["p"](
        jp, R.jnp.asarray(x), variation=jchip)
    got = _programs(None, MODEL, {"p": _cfg(None, mode, mapping)})["p"](
        params_from_reference(params), torch.from_numpy(x),
        variation=TV.from_reference(jchip))
    assert_network_parity(got, want)


def test_effective_weight_matches_reference(R):
    w = np.random.default_rng(8).normal(size=(60, 25)).astype(np.float32)
    chip = R.variation.sample_chip(R.jax.random.PRNGKey(GOLDEN_CHIP_KEY),
                                   {"mb6_dw": 60})
    names = ["mb6_dw"]
    cfg_j = R.cnn_train.QAT_CFG
    eng_j = R.rosa.Engine.from_config(cfg_j, layers=names)
    eng_t = rosa.Engine.from_config(TT.QAT_CFG, layers=names)
    # ideal: identity, no fake-quant
    np.testing.assert_array_equal(
        to_np(eng_t.effective_weight(torch.from_numpy(w), name="mb6_dw")), w)
    want = eng_j.with_variation(chip).effective_weight(R.jnp.asarray(w),
                                                       name="mb6_dw")
    got = eng_t.with_variation(TV.from_reference(chip)).effective_weight(
        torch.from_numpy(w), name="mb6_dw")
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=0,
                               atol=2e-6 * np.abs(w).max())
    assert not np.allclose(to_np(got), w, atol=1e-3)     # realized


def test_meta_trace_leaves_dwconv_weights_alone():
    eng = rosa.Engine.from_config(
        dataclasses.replace(TT.QAT_CFG, noise=TM.PAPER_NOISE),
        layers=["mb1_dw"])
    w = torch.empty((16, 9), device="meta")
    assert eng.effective_weight(w, name="mb1_dw") is w


# ---------------------------------------------------------------------------
# QAT
# ---------------------------------------------------------------------------
def test_qat_step_matches_reference(R):
    """Loss and straight-through gradients against
    `jax.value_and_grad(cnn_train._loss)`, then Adam on the same
    gradients against the reference step's update, for two steps."""
    jax, jnp = R.jax, R.jnp
    jp = _np_params(MODEL, seed=1)
    x, y = _images(8, seed=4)
    specs = R.cnn.LITE_MODELS[MODEL]
    engine = R.cnn_train.qat_engine(MODEL)
    loss_j, g_j = jax.jit(jax.value_and_grad(
        lambda p, a, b: R.cnn_train._loss(p, specs, None, a, b, engine)))(
        jp, jnp.asarray(x), jnp.asarray(y))
    pt = params_from_reference(jp)
    loss_t, g_t = TT.value_and_grad(pt, TCNN.LITE_MODELS[MODEL], None,
                                    torch.from_numpy(x), torch.from_numpy(y),
                                    TT.qat_engine(MODEL))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    pairs = [(to_np(g_t[layer][leaf]), to_np(g_j[layer][leaf]))
             for layer in g_j for leaf in ("w", "b")]
    err = np.sqrt(sum(np.sum((a - b) ** 2) for a, b in pairs))
    assert err <= 1e-4 * np.sqrt(sum(np.sum(b ** 2) for _, b in pairs))

    lr = 3e-3
    m_j = jax.tree.map(jnp.zeros_like, jp)
    v_j = jax.tree.map(jnp.zeros_like, jp)
    m_t = TT.map_tree(torch.zeros_like, pt)
    v_t = TT.map_tree(torch.zeros_like, pt)
    p_j = jp
    for i in range(2):
        g = jax.tree.map(lambda a, s=i: a * (1.0 + 0.5 * s), g_j)
        m_j = jax.tree.map(lambda a, b: 0.9 * a + 0.1 * b, m_j, g)
        v_j = jax.tree.map(lambda a, b: 0.99 * a + 0.01 * b * b, v_j, g)
        t = jnp.asarray(i) + 1
        p_j = jax.tree.map(
            lambda p, mm, vv, t=t: p - lr * (mm / (1 - 0.9 ** t))
            / (jnp.sqrt(vv / (1 - 0.99 ** t)) + 1e-8), p_j, m_j, v_j)
        pt, m_t, v_t = TT.adam_step(pt, m_t, v_t, params_from_reference(g),
                                    i, lr)
    for layer in p_j:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(to_np(pt[layer][leaf]),
                                       to_np(p_j[layer][leaf]), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("model", ["alexnet", MODEL])
def test_qat_step_with_pinned_chip_matches_reference(R, model):
    """Variation-aware QAT's step: the loss and straight-through gradients
    with a chip pinned (every conv/fc realizes its weight, every depthwise
    weight is realized and differentiated through the chain) against
    `jax.value_and_grad(cnn_train._loss)` with
    `engine.with_variation(chip)`.  Loss rtol 1e-5, as in
    `test_qat_step_matches_reference`; the gradient tree within 1e-3 of
    its norm: a pre-activation within float noise of 0 may take the other
    side of a ReLU, which moves every gradient upstream of it (alexnet with
    this chip: one conv5 pre-activation of 8.4e-9 does, 5.9e-4 of the
    norm; mobilenet_v3 1.7e-7)."""
    jax, jnp = R.jax, R.jnp
    jp = _np_params(model, seed=1)
    x, y = _images(8, seed=4)
    chip = R.variation.sample_chip(jax.random.PRNGKey(GOLDEN_CHIP_KEY),
                                   R.variation.cnn_lane_dims(model))
    specs = R.cnn.LITE_MODELS[model]
    engine = R.cnn_train.qat_engine(model).with_variation(chip)
    loss_j, g_j = jax.jit(jax.value_and_grad(
        lambda p, a, b: R.cnn_train._loss(p, specs, None, a, b, engine)))(
        jp, jnp.asarray(x), jnp.asarray(y))
    loss_t, g_t = TT.value_and_grad(
        params_from_reference(jp), TCNN.LITE_MODELS[model], None,
        torch.from_numpy(x), torch.from_numpy(y),
        TT.qat_engine(model).with_variation(TV.from_reference(chip)))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    pairs = [(to_np(g_t[layer][leaf]), to_np(g_j[layer][leaf]))
             for layer in g_j for leaf in ("w", "b")]
    err = np.sqrt(sum(np.sum((a - b) ** 2) for a, b in pairs))
    assert err <= 1e-3 * np.sqrt(sum(np.sum(b ** 2) for _, b in pairs))


def test_variation_aware_qat_runs_on_cpu(monkeypatch):
    """`train_cnn(ensemble=...)`: step i trains through chip i % n_chips,
    the parameters stay finite and the accuracy is the clean one."""
    ens = TV.sample_ensemble(torch.Generator().manual_seed(3), 2,
                             TV.cnn_lane_dims(MODEL), antithetic=True)
    pinned = []
    real = TT.value_and_grad

    def spy(params, specs, skips, x, y, engine):
        pinned.append(engine.variation)
        return real(params, specs, skips, x, y, engine)

    monkeypatch.setattr(TT, "value_and_grad", spy)
    params, acc = TT.train_cnn(MODEL, steps=3, batch=8, n_train=64,
                               ensemble=ens, device="cpu")
    assert len(pinned) == 3
    for i, chip in enumerate(pinned):
        want = TV.chip_at(ens, i % 2)
        assert all(torch.equal(chip[n].ddt, want[n].ddt) for n in want)
    assert not torch.equal(pinned[0]["mb2_dw"].dv, pinned[1]["mb2_dw"].dv)
    assert all(bool(torch.isfinite(t).all()) for layer in params.values()
               for t in layer.values())
    assert acc == TT.evaluate_cnn(params, MODEL, TT.qat_engine(MODEL))


# ---------------------------------------------------------------------------
# Table 4: plan and EDP
# ---------------------------------------------------------------------------
def _fixed_profile(model, seed=0):
    r = np.random.default_rng(seed)
    return {"layers": {s.name: {Mapping.IS.value: float(r.uniform(0, 4)),
                                Mapping.WS.value: float(r.uniform(0, 4))}
                       for s in TCNN.LITE_MODELS[model]}}


def _ref_plan(R, model, prof):
    """benchmarks/table4_hybrid.py::run_model's join, on the reference."""
    C, E, M = R.constants, R.energy, R.mapping
    lite = {s.name for s in R.cnn.LITE_MODELS[model]}
    profiles = []
    for layer in R.paper_cnns.CNN_WORKLOADS[model]:
        if layer.name not in lite:
            continue
        d = prof["layers"][layer.name]
        profiles.append(M.LayerProfile(
            layer.name, d_is=d[C.Mapping.IS.value],
            d_ws=d[C.Mapping.WS.value],
            e_is=E.layer_energy(layer, C.ROSA_OPTIMAL, C.Mapping.IS,
                                batch=128).edp,
            e_ws=E.layer_energy(layer, C.ROSA_OPTIMAL, C.Mapping.WS,
                                batch=128).edp))
    return M.hybrid_plan(profiles)


@pytest.mark.parametrize("model,seed", [(m, s) for m in FAMILIES
                                        for s in (0, 1)])
def test_hybrid_plan_from_fixed_profile_equals_reference(R, model, seed):
    prof = _fixed_profile(model, seed)
    got = table4.plan_from_profile(model, prof)
    want = _ref_plan(R, model, prof)
    assert {k: v.value for k, v in got.items()} \
        == {k: v.value for k, v in want.items()}


@pytest.mark.parametrize("model", FAMILIES)
def test_plan_edp_and_deap_equal_reference(R, model):
    """EDP of WS, a hybrid plan and DEAP-CNNs on the full-size rows:
    exactly the reference's floats."""
    C, E, M = R.constants, R.energy, R.mapping
    plan_t = table4.plan_from_profile(model, _fixed_profile(model))
    got = table4.plan_edps(model, plan_t)
    lite = {s.name for s in R.cnn.LITE_MODELS[model]}
    layers = [l for l in R.paper_cnns.CNN_WORKLOADS[model]
              if l.name in lite]
    plan_j = {k: C.Mapping(v.value) for k, v in plan_t.items()}
    want = {"ws": M.plan_edp(layers, {}, C.ROSA_OPTIMAL, batch=128),
            "hybrid": M.plan_edp(layers, plan_j, C.ROSA_OPTIMAL, batch=128),
            "deap": E.network_energy(layers, C.DEAP_HIGH_CHANNEL,
                                     C.Mapping.WS, C.ComputeMode.ANALOG,
                                     E.NO_OSA, batch=128).edp}
    assert got == want


# mobilenet_v3, batch 128: the values chip_smoke.py holds the card to
EDP_WS, EDP_DEAP = 1.794560881706427e-05, 52.23022904750444


def test_mobilenet_ws_and_deap_edp_pinned(R):
    got = table4.plan_edps(MODEL, {})
    assert (got["ws"], got["deap"]) == (EDP_WS, EDP_DEAP)
    C, E, M = R.constants, R.energy, R.mapping
    lite = {s.name for s in R.cnn.LITE_MODELS[MODEL]}
    layers = [l for l in R.paper_cnns.CNN_WORKLOADS[MODEL] if l.name in lite]
    assert M.plan_edp(layers, {}, C.ROSA_OPTIMAL, batch=128) == EDP_WS
    assert E.network_energy(layers, C.DEAP_HIGH_CHANNEL, C.Mapping.WS,
                            C.ComputeMode.ANALOG, E.NO_OSA,
                            batch=128).edp == EDP_DEAP


# ---------------------------------------------------------------------------
# The golden file (JAX-trained params, a JAX chip, JAX logits)
# ---------------------------------------------------------------------------
def golden_programs(side):
    """{clean, ws, is} programs: ideal QAT, and WS / IS with per-shot
    noise ideal (a chip pinned at call time)."""
    return _programs(side, MODEL, {
        "clean": _cfg(side, ComputeMode.MIXED, Mapping.WS),
        "ws": _cfg(side, ComputeMode.MIXED, Mapping.WS),
        "is": _cfg(side, ComputeMode.MIXED, Mapping.IS)})


def write_golden(path: pathlib.Path = GOLDEN) -> None:
    """Train mobilenet_v3 with the reference, sample a chip, store both
    with the reference's test-split logits."""
    R = reference()
    params, acc = R.cnn_train.train_cnn(MODEL, steps=GOLDEN_STEPS, seed=0)
    chip = R.variation.sample_chip(R.jax.random.PRNGKey(GOLDEN_CHIP_KEY),
                                   R.variation.cnn_lane_dims(MODEL))
    xte, yte = R.cnn_train._test_set(0)
    out = {"labels": np.asarray(yte), "steps": np.asarray(GOLDEN_STEPS)}
    for layer, leaves in params.items():
        for leaf, a in leaves.items():
            out[f"params.{layer}.{leaf}"] = np.asarray(a)
    for layer, v in chip.items():
        for field in ("dv", "ddt", "dlam"):
            out[f"chip.{layer}.{field}"] = np.asarray(getattr(v, field))
    for name, prog in golden_programs(R).items():
        logits = np.asarray(prog(params, xte, variation=None
                                 if name == "clean" else chip))
        out[f"logits.{name}"] = logits
        out[f"acc.{name}"] = np.asarray(
            100.0 * np.mean(logits.argmax(-1) == np.asarray(yte)))
    print(f"reference clean accuracy {acc}; golden accuracies "
          + ", ".join(f"{k}={float(out[f'acc.{k}'])}"
                      for k in ("clean", "ws", "is")))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)


def _ref_trees(R, params, chip):
    """The golden file's numpy trees as the reference's params and chip."""
    jp = R.jax.tree.map(R.jnp.asarray, params)
    jchip = {k: R.mrr.StaticVariation(**{f: R.jnp.asarray(a)
                                         for f, a in v.items()})
             for k, v in chip.items()}
    return jp, jchip


def test_golden_reproduces_reference_forward(R, golden):
    """The stored logits are the reference's on the stored params and chip:
    the file cannot go stale."""
    data, params, chip = golden
    jp, jchip = _ref_trees(R, params, chip)
    xte, yte = R.cnn_train._test_set(0)
    np.testing.assert_array_equal(np.asarray(yte), data["labels"])
    for name, prog in golden_programs(R).items():
        logits = np.asarray(prog(jp, xte, variation=None if name == "clean"
                                 else jchip))
        np.testing.assert_allclose(logits, data[f"logits.{name}"], rtol=0,
                                   atol=1e-5 * np.abs(logits).max(),
                                   err_msg=name)


def test_port_matches_golden_on_cpu(golden):
    """The port on the stored params and chip: clean accuracy within 2
    images and chip-pinned WS / IS within 5 images of 512 of the
    reference's (measured: equal), logits within one LSB of full scale
    (measured: 0.9% at most)."""
    data, params, chip = golden
    pt = params_from_reference(params)
    ct = {k: TM.StaticVariation(*(torch.from_numpy(v[f])
                                  for f in ("dv", "ddt", "dlam")))
          for k, v in chip.items()}
    yte = data["labels"]
    for name, prog in golden_programs(None).items():
        logits = to_np(TT.eval_logits(pt, MODEL, prog, variation=None
                                      if name == "clean" else ct))
        want = data[f"logits.{name}"]
        tol = 2 if name == "clean" else 5
        assert_network_parity(logits, want, argmax_flips=tol)
        diff = abs(int((logits.argmax(-1) == yte).sum())
                   - int((want.argmax(-1) == yte).sum()))
        assert diff <= tol, name


def test_cnn_lane_dims_match_reference(R):
    for model in FAMILIES:
        assert TV.cnn_lane_dims(model) == R.variation.cnn_lane_dims(model)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (kernels build on first "
                    "use)")


@pytest.mark.cuda
@pytest.mark.parametrize("mapping", [Mapping.WS, Mapping.IS])
def test_chip_pinned_mobilenet_on_cuda_matches_cpu(cuda, golden, mapping):
    """The card's kernels (rosa_fused for conv/fc, mrr_transfer for the
    depthwise weights) against the plain CPU path on the golden params."""
    _, params, chip = golden
    pt = params_from_reference(params)
    ct = {k: TM.StaticVariation(*(torch.from_numpy(v[f])
                                  for f in ("dv", "ddt", "dlam")))
          for k, v in chip.items()}
    prog = _programs(None, MODEL, {
        "p": _cfg(None, ComputeMode.MIXED, mapping)})["p"]
    x, _ = _images(64)
    y_cpu = prog(pt, torch.from_numpy(x), variation=ct)
    y_gpu = prog(params_from_reference(params, "cuda"),
                 torch.from_numpy(x).cuda(),
                 variation={k: v.to("cuda") for k, v in ct.items()})
    torch.cuda.synchronize()
    assert_network_parity(y_gpu, y_cpu)


@pytest.mark.cuda
def test_variation_aware_qat_on_cuda_launches_the_kernels(cuda):
    """On the card every step runs each conv/fc through rosa_fused and
    each depthwise weight through mrr_transfer, forward and backward."""
    from repro_torch.kernels.mrr_transfer import ops as mrr_ops
    from repro_torch.kernels.rosa_fused import ops as fused_ops
    ens = TV.sample_ensemble(torch.Generator("cuda").manual_seed(3), 2,
                             TV.cnn_lane_dims(MODEL), antithetic=True,
                             device="cuda")
    counters = (fused_ops.LAUNCHES, mrr_ops.LAUNCHES, mrr_ops.LAUNCHES_BWD)
    before = [c.count for c in counters]
    params, _ = TT.train_cnn(MODEL, steps=2, batch=8, n_train=64,
                             ensemble=ens, device="cuda")
    torch.cuda.synchronize()
    assert [c.count - b for c, b in zip(counters, before)] == [22, 8, 8]
    assert all(bool(torch.isfinite(t).all()) for layer in params.values()
               for t in layer.values())


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-golden"]:
        write_golden()
    else:
        sys.exit("usage: python tests/test_torch_cnn.py --write-golden")
