"""Port parity of the moe and mla_moe families (qwen3-moe-235b-a22b,
deepseek-v2-236b) against the JAX reference, on the CPU.

  * the router and `moe_ref` on both smoke MoE configs and a widened one
    (d 256, 16 experts, top-6, 2 shared): the routed ids equal first (the
    smallest gap between the k-th and (k+1)-th probability is reported),
    then gates and outputs at rtol 1e-5 (outputs with an atol of 1e-5 of
    their full scale: a float32 sum of large terms near zero);
  * MLA: `mla_prefill`, and the absorbed `mla_decode` at ragged positions
    against a bfloat16 cache, rtol 1e-4;
  * both smoke models: prefill, two chunk steps and three decode steps at
    1e-4, as `test_torch_serve.py` holds qwen3-32b;
  * the Scheduler's greedy tokens equal the reference's (deepseek-v2 with
    rosa off, "ref" and "fused" with chip 7; qwen3-moe with rosa off), and
    so do the port's sequential oracle's, with equal plans and
    energy_per_token; `energy_metrics` equal to the
    reference's floats; the serving plans at full width (abstract traces)
    equal the reference's;
  * the slot API touches one row of every leaf, `layer0` included.

Tests marked `cuda` hold `rosa_fused` to its plain version on a card at
deepseek-v2's layer-0 MLP shapes, as `chip_smoke.py` phase 2 does.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import rosa
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import mrr as TM
from repro_torch.core.constants import ROSA_OPTIMAL, Mapping
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.model import (build_model, cache_axes, evict_slot,
                                      pad_cache, params_from_reference,
                                      read_slot, write_slot)
from repro_torch.models.module import leaves, map_tree
from repro_torch.robust.variation import from_reference, sample_chip
from repro_torch.serve import (Scheduler, ServeConfig, build_serving_program,
                               energy_metrics, poisson_requests,
                               run_sequential, serving_model_config,
                               trace_serving_shapes)
from test_torch_ref import assert_quantized_parity, reference, to_np

torch.backends.cuda.matmul.allow_tf32 = False

QWEN_MOE, DEEPSEEK = "qwen3-moe-235b-a22b", "deepseek-v2-236b"
# deepseek-v2's layer-0 MLP projections (K, N): mlp/wi, mlp/wo
LAYER0_PROJ = {"mlp/wi": (5120, 24576), "mlp/wo": (12288, 5120)}


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


def _np_params(skel, rng) -> dict:
    """Float32 numpy params for a ParamDef skeleton, N(0, std^2)."""
    out: dict = {}
    for path, d in leaves(skel):
        if d.init == "ones":
            a = np.ones(d.shape, np.float32)
        elif d.init == "zeros":
            a = np.zeros(d.shape, np.float32)
        else:
            a = (rng.normal(size=d.shape) * d.std).astype(np.float32)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return out


# ---------------------------------------------------------------------------
# MoE block
# ---------------------------------------------------------------------------
WIDE_MOE = dict(n_experts=16, top_k=6, d_model=256, d_ff=64, n_shared=2)


@pytest.mark.parametrize("which", [QWEN_MOE, DEEPSEEK, "wide"])
def test_route_and_moe_ref_match_reference(R, which):
    cfg = (MOE.MoEConfig(**WIDE_MOE) if which == "wide"
           else get_smoke(which).moe)
    jcfg = R.moe.MoEConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(11)
    p = _np_params(MOE.moe_def(cfg), rng)
    x = rng.normal(size=(3, 5, cfg.d_model)).astype(np.float32)
    tp = map_tree(torch.from_numpy, p)
    jp = map_tree(R.jnp.asarray, p)

    w, ids = MOE._route(tp, cfg, torch.from_numpy(x).reshape(-1, cfg.d_model))
    jw, jids = R.moe._route(jp, jcfg, R.jnp.asarray(x.reshape(-1,
                                                               cfg.d_model)))
    probs = np.sort(to_np(torch.softmax(
        torch.from_numpy(x).reshape(-1, cfg.d_model) @ tp["router"], -1)),
        axis=-1)[:, ::-1]
    gap = float(np.min(probs[:, cfg.top_k - 1] - probs[:, cfg.top_k]))
    print(f"{which}: smallest k-th vs (k+1)-th probability gap {gap:.3e}")
    np.testing.assert_array_equal(to_np(ids), np.asarray(jids),
                                  err_msg=f"routing differs (gap {gap:.3e})")
    np.testing.assert_allclose(to_np(w), np.asarray(jw), rtol=1e-5,
                               atol=1e-7)

    y = MOE.moe_ref(tp, cfg, torch.from_numpy(x))
    jy = np.asarray(R.moe.moe_ref(jp, jcfg, R.jnp.asarray(x)))
    np.testing.assert_allclose(to_np(y), jy, rtol=1e-5,
                               atol=1e-5 * np.abs(jy).max())
    assert MOE.capacity_of(15, cfg) == R.moe.capacity_of(15, jcfg)


def test_expert_ffn_matches_reference_and_copies_no_weight(R):
    cfg = MOE.MoEConfig(**WIDE_MOE)
    rng = np.random.default_rng(3)
    p = _np_params(MOE.moe_def(cfg), rng)
    buf = rng.normal(size=(cfg.n_experts, 4, cfg.d_model)).astype(np.float32)
    wi, wo = torch.from_numpy(p["wi"]), torch.from_numpy(p["wo"])
    y = MOE._expert_ffn(wi, wo, torch.from_numpy(buf))
    jy = np.asarray(R.moe._expert_ffn(R.jnp.asarray(p["wi"]),
                                      R.jnp.asarray(p["wo"]),
                                      R.jnp.asarray(buf)))
    np.testing.assert_allclose(to_np(y), jy, rtol=1e-5,
                               atol=1e-5 * np.abs(jy).max())
    # the batched product reads the stored weight through a view
    e, d, _, f = wi.shape
    assert wi.view(e, d, 2 * f).data_ptr() == wi.data_ptr()


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mla_setup(R):
    cfg = dataclasses.replace(get_smoke(DEEPSEEK).mla, uniform_decode=False)
    jcfg = R.mla.MLAConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(5)
    p = _np_params(MLA.mla_def(cfg), rng)
    for k in ("q_norm", "kv_norm"):
        p[k] = (1 + 0.1 * rng.normal(size=p[k].shape)).astype(np.float32)
    return cfg, jcfg, p, rng


def test_mla_prefill_matches_reference(R, mla_setup):
    cfg, jcfg, p, rng = mla_setup
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7)[None], (2, 7)).astype(np.int32)
    y, (c_kv, k_rope) = MLA.mla_prefill(map_tree(torch.from_numpy, p), cfg,
                                        torch.from_numpy(x),
                                        torch.from_numpy(pos.copy()))
    jy, (jc, jr) = R.mla.mla_prefill(map_tree(R.jnp.asarray, p), jcfg,
                                     R.jnp.asarray(x), R.jnp.asarray(pos))
    np.testing.assert_allclose(to_np(y), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)
    assert c_kv.dtype == torch.float32 and str(jc.dtype) == "float32"
    np.testing.assert_allclose(to_np(c_kv), np.asarray(jc), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(to_np(k_rope), np.asarray(jr), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        to_np(MLA.mla_apply(map_tree(torch.from_numpy, p), cfg,
                            torch.from_numpy(x),
                            torch.from_numpy(pos.copy()))),
        np.asarray(jy), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("chunk", [1, 3])
def test_mla_decode_at_ragged_positions_matches_reference(R, mla_setup,
                                                          chunk):
    """A bfloat16 compressed cache holding a prefix, rows at positions 3
    and 6, one token (decode) or a 3-token chunk."""
    cfg, jcfg, p, rng = mla_setup
    jnp = R.jnp
    s = 12
    c0 = rng.normal(size=(2, s, cfg.kv_lora)).astype(np.float32)
    r0 = rng.normal(size=(2, s, cfg.qk_rope)).astype(np.float32)
    x = rng.normal(size=(2, chunk, cfg.d_model)).astype(np.float32)
    pos = np.array([3, 6], np.int32)
    cache = (torch.from_numpy(c0).to(torch.bfloat16),
             torch.from_numpy(r0).to(torch.bfloat16))
    jcache = (jnp.asarray(c0).astype(jnp.bfloat16),
              jnp.asarray(r0).astype(jnp.bfloat16))
    y, (c1, r1) = MLA.mla_decode(map_tree(torch.from_numpy, p), cfg,
                                 torch.from_numpy(x), cache,
                                 torch.from_numpy(pos))
    jy, (jc1, jr1) = R.mla.mla_decode(map_tree(jnp.asarray, p), jcfg,
                                      jnp.asarray(x), jcache,
                                      jnp.asarray(pos))
    np.testing.assert_allclose(to_np(y), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)
    assert c1.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(c1.float()),
                                  np.asarray(jc1.astype(jnp.float32)))
    np.testing.assert_array_equal(to_np(r1.float()),
                                  np.asarray(jr1.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_params(R):
    return {a: R.model.build_model(R.configs.get_smoke(a)).init(
        R.jax.random.PRNGKey(0)) for a in (QWEN_MOE, DEEPSEEK)}


def _close(a, b):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", [QWEN_MOE, DEEPSEEK])
def test_prefill_chunk_decode_logits_match(R, ref_params, arch):
    cfg = serving_model_config(get_smoke(arch))
    jcfg = R.serve.serving_model_config(R.configs.get_smoke(arch))
    jp = ref_params[arch]
    p = params_from_reference(jp)
    jnp = R.jnp
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (2, 7))
    tok = tok.astype(np.int32)

    lg, cache = T.prefill(p, cfg, {"tokens": torch.from_numpy(tok)})
    jlg, jcache = R.transformer.prefill(jp, jcfg,
                                        {"tokens": jnp.asarray(tok)})
    _close(lg, jlg)
    assert sorted(cache) == sorted(jcache)
    np.testing.assert_array_equal(to_np(cache["pos"]), to_np(jcache["pos"]))
    for key in [k for k in cache if k != "pos"]:
        for got, want in zip(cache[key], jcache[key], strict=True):
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            np.testing.assert_allclose(
                to_np(got.float()), np.asarray(want.astype(jnp.float32)),
                rtol=1e-2, atol=1e-2)

    # two chunks of 4 against a max_len 12 cache, the second ragged
    c, jc = T.init_cache(cfg, 2, 12), R.transformer.init_cache(jcfg, 2, 12)
    for lo, nv in ((0, [4, 4]), (4, [3, 1])):
        chunk = tok[:, lo:lo + 4]
        lg, c = T.chunk_step(p, cfg, {
            "tokens": torch.from_numpy(chunk),
            "n_valid": torch.tensor(nv, dtype=torch.int32), "cache": c})
        jlg, jc = R.transformer.chunk_step(jp, jcfg, {
            "tokens": jnp.asarray(chunk),
            "n_valid": jnp.asarray(nv, jnp.int32), "cache": jc})
        _close(lg, jlg)
    np.testing.assert_array_equal(to_np(c["pos"]), [7, 5])

    # decode at ragged positions (7 and 5)
    for step in range(3):
        t = np.array([step + 1, 200 - step], np.int32)
        lg, c = T.decode_step(p, cfg, {"token": torch.from_numpy(t),
                                       "pos": c["pos"], "cache": c})
        jlg, jc = R.transformer.decode_step(jp, jcfg, {
            "token": jnp.asarray(t), "pos": jc["pos"], "cache": jc})
        _close(lg, jlg)
    np.testing.assert_array_equal(to_np(c["pos"]), to_np(jc["pos"]))
    assert sorted(c) == sorted(jc)


@pytest.mark.parametrize("arch,layers,n_params", [
    (QWEN_MOE, 3, 8_707_928_832), (DEEPSEEK, 3, 9_330_795_520)])
def test_full_width_param_count_equals_reference(R, arch, layers, n_params):
    """The phase-14 models of chip_smoke.py: full width, 3 layers."""
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    jcfg = dataclasses.replace(R.configs.get_config(arch), n_layers=layers)
    assert build_model(cfg).n_params == \
        R.model.build_model(jcfg).n_params == n_params


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,backend", [
    (DEEPSEEK, None), (DEEPSEEK, "ref"), (DEEPSEEK, "fused"),
    (QWEN_MOE, None)])
def test_scheduler_greedy_tokens_equal_reference(R, arch, backend):
    """Same requests, same weights, same chip: same greedy tokens, and
    with the optical path on the same plan and energy_per_token."""
    rosa_on = backend is not None
    kw = dict(n_slots=2, max_len=24, rosa=rosa_on,
              variation_seed=7 if rosa_on else None,
              rosa_backend=backend or "ref")
    jsched = R.serve.Scheduler(R.configs.get_smoke(arch),
                               R.serve.ServeConfig(**kw), plan_cache=False)
    vocab = jsched.cfg.vocab
    jrep = jsched.run(R.serve.poisson_requests(3, 1.0, vocab=vocab, seed=0))
    chip = from_reference(jsched.engine.variation) if rosa_on else None
    sched = Scheduler(get_smoke(arch), ServeConfig(**kw),
                      params=params_from_reference(jsched.params),
                      chip=chip, device="cpu", plan_cache=False)
    reqs = poisson_requests(3, 1.0, vocab=vocab, seed=0)
    rep = sched.run(reqs)
    want = {r: c.tokens for r, c in jrep.completions.items()}
    assert {r: c.tokens for r, c in rep.completions.items()} == want
    # the port's oracle decodes each request alone at the slot width
    seq = run_sequential(get_smoke(arch), ServeConfig(**kw), sched.params,
                         reqs, chip=chip, device="cpu")
    assert {r: v["tokens"] for r, v in seq.items()} == want
    assert (rep.ticks, rep.decode_steps, rep.prefill_chunks) == \
        (jrep.ticks, jrep.decode_steps, jrep.prefill_chunks)
    if rosa_on:
        plan = {k: v.name for k, v in
                sched.program.plan.mapping_plan().items()}
        assert set(plan) == {"mlp/wi", "mlp/wo"}
        assert plan == {k: v.name for k, v in
                        jsched.program.plan.mapping_plan().items()}
        e = sched.engine.ledger.per_token(ROSA_OPTIMAL, batch=2)
        assert e > 0
        assert e == jsched.engine.ledger.per_token(
            R.constants.ROSA_OPTIMAL, batch=2)


@pytest.mark.parametrize("arch", [QWEN_MOE, DEEPSEEK])
def test_full_width_serving_plan_equals_reference(R, arch):
    """The serving compile of phase 14's models, traced abstractly: the
    decode GEMMs, plan and energy_per_token equal the reference's.
    deepseek-v2 routes layer 0's two MLP projections; qwen3-moe nothing."""
    cfg = serving_model_config(dataclasses.replace(get_config(arch),
                                                   n_layers=3), rosa=True)
    scfg = ServeConfig(n_slots=4, max_len=56, prefill_chunk=8, rosa=True,
                       rosa_backend="fused")
    bundle = build_model(cfg)
    prog = build_serving_program(bundle, scfg, device="cpu", cache=False)
    ledger = trace_serving_shapes(
        bundle, scfg, prog.engine.with_ledger(rosa.EnergyLedger()))

    jcfg = R.serve.serving_model_config(dataclasses.replace(
        R.configs.get_config(arch), n_layers=3), rosa=True)
    jscfg = R.serve.ServeConfig(n_slots=4, max_len=56, prefill_chunk=8,
                                rosa=True, rosa_backend="fused")
    jbundle = R.model.build_model(jcfg)
    jprog = R.metrics.build_serving_program(jbundle, jscfg, cache=False)
    jledger = R.metrics.trace_serving_shapes(
        jbundle, jscfg, jprog.engine.with_ledger(R.rosa.EnergyLedger()))

    got = [(e.name, e.m, e.k, e.n, e.count) for e in prog.trace.entries]
    assert got == [(e.name, e.m, e.k, e.n, e.count)
                   for e in jprog.trace.entries]
    plan = {k: v.name for k, v in prog.plan.mapping_plan().items()}
    assert plan == {k: v.name for k, v in
                    jprog.plan.mapping_plan().items()}
    e = ledger.per_token(ROSA_OPTIMAL, batch=4)
    assert e == jledger.per_token(R.constants.ROSA_OPTIMAL, batch=4)
    if arch == DEEPSEEK:
        assert got == [("mlp/wi", 4, 5120, 24576, 1),
                       ("mlp/wo", 4, 12288, 5120, 1)]
        assert e > 0
    else:
        assert got == [] and plan == {} and e == 0.0


@pytest.mark.parametrize("arch", [DEEPSEEK, "qwen3-32b"])
def test_energy_metrics_equal_reference(R, arch):
    scfg = ServeConfig(n_slots=4, max_len=56, prefill_chunk=8)
    got = energy_metrics(get_smoke(arch), scfg, cache=False, device="cpu")
    want = R.metrics.energy_metrics(
        R.configs.get_smoke(arch),
        R.serve.ServeConfig(n_slots=4, max_len=56, prefill_chunk=8))
    assert [m.name for m in got] == [m.name for m in want]
    assert "energy_per_prefill_chunk_j" in [m.name for m in got]
    for m, w in zip(got, want, strict=True):
        assert (m.value, m.unit, m.gate, m.rel_tol, m.direction) == \
            (float(w.value) if isinstance(m.value, float) else w.value,
             w.unit, w.gate, w.rel_tol, w.direction), m.name


def test_serving_config_takes_mla_and_refuses_encdec(R):
    cfg = serving_model_config(get_config(DEEPSEEK), rosa=True)
    assert cfg.mla.uniform_decode is False and cfg.uniform_decode is False
    assert cfg.rosa_mlp and T.dense0(cfg).rosa_mlp
    assert T.dense0(cfg).moe is None and T.dense0(cfg).d_ff == 12288
    from repro_torch.configs import zoo_config
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        serving_model_config(zoo_config("seamless-m4t-medium"))


# ---------------------------------------------------------------------------
# Slot API
# ---------------------------------------------------------------------------
def _all(cache):
    out = []
    for k in sorted(cache):
        v = cache[k]
        out += list(v) if isinstance(v, tuple) else [v]
    return out


@pytest.mark.parametrize("arch", [QWEN_MOE, DEEPSEEK])
def test_cache_axes_equal_reference(R, arch):
    cfg = get_smoke(arch)
    assert cache_axes(cfg) == R.model.cache_axes(R.configs.get_smoke(arch))
    c = T.init_cache(cfg, 3, 8)
    jc = R.transformer.init_cache(R.configs.get_smoke(arch), 3, 8)
    assert [tuple(t.shape) for t in _all(c)] == \
        [tuple(t.shape) for t in _all(jc)]
    assert [str(t.dtype).split(".")[-1] for t in _all(c)] == \
        [str(t.dtype) for t in _all(jc)]


@pytest.mark.parametrize("arch", [QWEN_MOE, DEEPSEEK])
def test_slot_api_touches_one_row(R, arch):
    cfg = serving_model_config(get_smoke(arch))
    axes = cache_axes(cfg)
    c = T.init_cache(cfg, 3, 8)
    req = T.init_cache(cfg, 1, 8)
    for t in _all(req):
        t.fill_(1)
    before = [t.clone() for t in _all(c)]
    write_slot(cfg, c, req, 1)
    bdims = [a.index("cache_batch") for a in _all(axes)]
    for t, b, ax in zip(_all(c), before, bdims, strict=True):
        assert torch.all(t.select(ax, 1) == 1)
        for other in (0, 2):
            assert torch.equal(t.select(ax, other), b.select(ax, other))
    if cfg.first_dense_ff:
        assert c["layer0"][0].shape == (3, 8, cfg.mla.kv_lora)
        assert torch.all(c["layer0"][0][1] == 1)
    got = read_slot(cfg, c, 1)
    for a, b in zip(_all(got), _all(req), strict=True):
        assert torch.equal(a, b)
    evict_slot(cfg, c, 1)
    assert all(torch.count_nonzero(t) == 0 for t in _all(c))
    write_slot(cfg, c, req, 2, valid=False)
    assert all(torch.count_nonzero(t) == 0 for t in _all(c))

    grown = pad_cache(cfg, req, 5)
    jcfg = R.configs.get_smoke(arch)
    jgrown = R.model.pad_cache(jcfg, R.transformer.init_cache(jcfg, 1, 8), 5)
    assert [tuple(t.shape) for t in _all(grown)] == \
        [tuple(t.shape) for t in _all(jgrown)]
    for g, a in zip(_all(grown), _all(axes), strict=True):
        if "cache_seq" in a:
            assert g.shape[a.index("cache_seq")] == 13


# ---------------------------------------------------------------------------
# On the card: rosa_fused at deepseek-v2's layer-0 shapes
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("name", sorted(LAYER0_PROJ))
def test_fused_kernel_at_layer0_shapes_matches_plain_on_cuda(name, m):
    """Phase 2's layer-0 rows: IS with per-row activation scales,
    PAPER_NOISE, chip 7; two launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (kernels build on first "
                    "use)")
    from repro_torch.kernels.rosa_fused import ops
    k, n = LAYER0_PROJ[name]
    g = torch.Generator("cuda").manual_seed(1)
    x = torch.randn(m, k, device="cuda", generator=g)
    w = torch.randn(k, n, device="cuda", generator=g)
    chip = sample_chip(torch.Generator().manual_seed(7),
                       dims={nm: kk for nm, (kk, _) in LAYER0_PROJ.items()},
                       device="cuda")
    key = torch.Generator("cuda").manual_seed(2)
    args, static = ops.operands(x, w, key, chip[name], mapping=Mapping.IS,
                                act_per_vector=True, noise=TM.PAPER_NOISE)
    y = ops.launch(*args, **static)
    y_plain = ops.plain(*args, **static)
    torch.cuda.synchronize()
    assert_quantized_parity(y, y_plain)
    assert torch.equal(y, ops.launch(*args, **static))
