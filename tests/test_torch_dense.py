"""Port parity of the four remaining dense architectures (gemma3-12b,
phi-3-vision-4.2b with its patch-embedding frontend, deepseek-67b,
mistral-large-123b) and of the helpers that come with them
(`models.model.make_inputs` / `applicable`, `serve.smoke_report`,
`bench.compare`) against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and fed to both packages with the
reference's parameters (`params_from_reference`); patch embeddings are
rounded to bfloat16 on both sides, as the serving CLI feeds them.

  * each smoke model: prefill logits and two ragged chunk steps within
    1e-4 of max|ref| with the argmax equal; 12 decode steps from the
    reference's cache within 1e-4;
  * 12 decode steps from the port's own bfloat16 cache: gemma3-smoke and
    phi3v-smoke within 1e-4.  deepseek-67b-smoke and mistral-large-smoke
    are held to the argmax and to a bound from a float-order floor the
    test measures: the two packages' float32 K/V (cache_dtype float32)
    differ by `eps` of their max, and a value within `eps` of a bfloat16
    rounding boundary may round the other way in either package.  Every
    entry where the two bfloat16 caches differ must be such a value, one
    bfloat16 step apart; the bound is 4x the logits' deviation when every
    such value of the reference's cache is rounded the other way (phase
    5's 4x rule), plus the 1e-4 of float noise the other steps allow;
  * phi3v-smoke with 16 patch embeddings: prefill logits within 1e-4,
    the cache 16 + S_tok long, and the patches move the logits;
  * gemma3-12b's cache holds max_len in every layer, local ones
    included, as the reference's `init_cache` (not its docstring) does;
  * the Scheduler's greedy tokens equal the reference Scheduler's for
    each smoke model with the optical path off, and for gemma3-smoke
    with rosa "ref" and chip 7 (and the port's sequential oracle's);
  * at full width (abstract traces): the parameter count at the depth
    `chip_smoke.py` serves, the serving plan and energy_per_token equal
    the reference's; the skinny-M launch plan of `rosa_fused` at the
    eight new projection shapes;
  * `make_inputs` shapes, dtypes and logical axes of all ten
    architectures on the four smoke shapes (concrete and abstract) and
    on the assigned shapes (abstract), `applicable` on the assigned ones;
  * `smoke_report`: names, units, gates, tolerances, directions and the
    tick-unit and energy values equal to the reference's;
  * `bench.compare`: the reference's verdicts and text on pairs built to
    pass, to regress each way, to drop a gated metric, to fail a bench
    and to mix modes, and the CLI's exit codes.

Tests marked `cuda` hold `rosa_fused` to its plain version on a card at
the eight new MLP projection shapes, as `chip_smoke.py` phase 2 does.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import rosa
from repro_torch.bench import compare as C
from repro_torch.bench import schema as S
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core import mrr as TM
from repro_torch.core.constants import ROSA_OPTIMAL, Mapping
from repro_torch.kernels import skinny
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.models.model import (ASSIGNED_SHAPES, SMOKE_SHAPES,
                                      applicable, build_model, make_inputs,
                                      pad_cache, params_from_reference)
from repro_torch.models.module import leaves
from repro_torch.robust.variation import from_reference, sample_chip
from repro_torch.serve import (Scheduler, ServeConfig, build_serving_program,
                               poisson_requests, run_sequential,
                               serving_model_config, smoke_report,
                               trace_serving_shapes)
from test_torch_ref import (assert_logits_match, assert_quantized_parity,
                            cache_leaves, reference, rel_err, to_np)

torch.backends.cuda.matmul.allow_tf32 = False

GEMMA, PHI3V = "gemma3-12b", "phi-3-vision-4.2b"
DS67, MISTRAL = "deepseek-67b", "mistral-large-123b"
DENSE = (GEMMA, PHI3V, DS67, MISTRAL)
# the two whose bfloat16 caches flip against the reference's (module doc)
FLIPPING = (DS67, MISTRAL)
# chip_smoke.py phase 16: the depth served on the card and its params
SERVED = {GEMMA: (48, 11_765_419_776), PHI3V: (32, 3_821_079_552),
          DS67: (4, 4_446_035_968), MISTRAL: (4, 6_341_898_240)}
PROMPT, STEPS, PATCHES = 13, 12, 16


def new_proj(arch: str) -> dict:
    """The MLP projections (K, N) of `arch` at full width: mlp/wi, mlp/wo."""
    cfg = get_config(arch)
    return {"mlp/wi": (cfg.d_model, 2 * cfg.d_ff),
            "mlp/wo": (cfg.d_ff, cfg.d_model)}


NEW_SHAPES = sorted({kn for a in DENSE for kn in new_proj(a).values()})


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


@pytest.fixture(scope="module")
def ref_params(R):
    return {a: R.model.build_model(R.configs.get_smoke(a)).init(
        R.jax.random.PRNGKey(0)) for a in DENSE}


def _inputs(R, cfg, seed: int, n_img: int = 4):
    """Prompt ids (2, PROMPT), STEPS decode tokens (STEPS, 2) and, for the
    vision frontend, `n_img` patch embeddings rounded to bfloat16: the
    port's batch and the reference's."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, (STEPS, 2)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tok)}
    jbatch = {"tokens": R.jnp.asarray(tok)}
    if cfg.frontend == "vision":
        img = rng.normal(size=(2, n_img, cfg.d_model)).astype(np.float32)
        batch["patch_embeds"] = torch.from_numpy(img).to(torch.bfloat16)
        jbatch["patch_embeds"] = R.jnp.asarray(img).astype(R.jnp.bfloat16)
    return batch, jbatch, steps


def _decode(step_fn, params, cache, steps) -> list:
    """Logits of STEPS decode steps from `cache` (its `pos` the cursor)."""
    out = []
    for t in steps:
        lg, cache = step_fn(params, {"token": t, "pos": cache["pos"],
                                     "cache": cache})
        out.append(to_np(lg))
    return out


def _port_decode(cfg, p, cache, steps) -> list:
    return _decode(lambda p_, b: T.decode_step(p_, cfg, b), p,
                   pad_cache(cfg, cache, STEPS),
                   [torch.from_numpy(t) for t in steps])


def _ref_decode(R, jcfg, jp, jcache, steps) -> list:
    return _decode(lambda p_, b: R.transformer.decode_step(p_, jcfg, b), jp,
                   R.model.pad_cache(jcfg, jcache, STEPS),
                   [R.jnp.asarray(t) for t in steps])


def _to_port(tree):
    """A reference cache as port tensors (bfloat16 leaves kept)."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to_port(v) for v in tree)
    if str(tree.dtype) == "bfloat16":
        return torch.from_numpy(np.array(tree.astype("float32"))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(tree))


def _adjacent(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Where two bfloat16 tensors differ by exactly one representable
    step."""
    inf = torch.tensor(float("inf"), dtype=torch.bfloat16)
    return (torch.nextafter(a, inf) == b) | (torch.nextafter(b, inf) == a)


def _assert_kv_match(cache, jcache, tol: float = 1e-4) -> int:
    """The same leaves, paths and dtypes; int32 leaves equal; the bfloat16
    K/V equal but for rounding flips: a float32 value within float
    noise of a rounding boundary rounds the other way, one bfloat16 step
    (near the max that is 2^-7 of it), and a value far below the max may
    move by more steps but stays within `tol` of the max, as float32
    leaves do.  Returns the number of entries that differ."""
    got, want = cache_leaves(cache), cache_leaves(jcache)
    assert [p for p, _ in got] == [p for p, _ in want]
    flips = 0
    for (path, a), (_, b) in zip(got, want):
        assert str(a.dtype).split(".")[-1] == str(b.dtype), path
        if a.dtype == torch.int32:
            np.testing.assert_array_equal(to_np(a), to_np(b))
            continue
        assert a.dtype == torch.bfloat16, path
        b = _to_port(b)
        diff = a != b
        near = (a.float() - b.float()).abs() <= tol * float(b.abs().max())
        assert bool((_adjacent(a, b) | near)[diff].all()), path
        flips += int(diff.sum())
    return flips


# ---------------------------------------------------------------------------
# The smoke models against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_smoke_skeleton_equals_reference(R, arch):
    """The same parameter tree: paths, shapes and logical axes."""
    got = build_model(get_smoke(arch)).skeleton
    want = R.model.build_model(R.configs.get_smoke(arch)).skeleton
    assert [(p, tuple(d.shape), tuple(d.axes)) for p, d in leaves(got)] == \
        [(p, tuple(d.shape), tuple(d.axes)) for p, d in leaves(want)]


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_chunk_logits_match_reference(R, ref_params, arch):
    cfg, jcfg = get_smoke(arch), R.configs.get_smoke(arch)
    jp = ref_params[arch]
    p = params_from_reference(jp)
    batch, jbatch, _ = _inputs(R, cfg, 0)
    lg, cache = T.prefill(p, cfg, batch)
    jlg, jcache = R.transformer.prefill(jp, jcfg, jbatch)
    assert_logits_match(lg, jlg)
    _assert_kv_match(cache, jcache)

    # two chunks of 8 against a max_len 20 cache, the second ragged, at
    # per-row positions (the serving config); tokens only, as served
    scfg = serving_model_config(cfg)
    jscfg = R.serve.serving_model_config(jcfg)
    tok = to_np(batch["tokens"])
    c, jc = T.init_cache(scfg, 2, 20), R.transformer.init_cache(jscfg, 2, 20)
    for lo, nv in ((0, [8, 8]), (8, [5, 2])):
        chunk = np.ascontiguousarray(tok[:, lo:lo + 8])
        if chunk.shape[1] < 8:
            chunk = np.pad(chunk, ((0, 0), (0, 8 - chunk.shape[1])))
        lg, c = T.chunk_step(p, scfg, {
            "tokens": torch.from_numpy(chunk),
            "n_valid": torch.tensor(nv, dtype=torch.int32), "cache": c})
        jlg, jc = R.transformer.chunk_step(jp, jscfg, {
            "tokens": R.jnp.asarray(chunk),
            "n_valid": R.jnp.asarray(nv, R.jnp.int32), "cache": jc})
        assert_logits_match(lg, jlg)
    np.testing.assert_array_equal(to_np(c["pos"]), [13, 10])
    _assert_kv_match(c, jc)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_from_reference_cache_matches(R, ref_params, arch):
    """The port decodes from the reference's own bfloat16 cache: every
    step within 1e-4 of max|ref|, the argmax equal."""
    cfg, jcfg = get_smoke(arch), R.configs.get_smoke(arch)
    jp = ref_params[arch]
    _, jbatch, steps = _inputs(R, cfg, 1)
    _, jcache = R.transformer.prefill(jp, jcfg, jbatch)
    want = _ref_decode(R, jcfg, jp, jcache, steps)
    got = _port_decode(cfg, params_from_reference(jp), _to_port(jcache),
                       steps)
    for g, w in zip(got, want, strict=True):
        assert_logits_match(g, w)


def _flip_candidates(x32: np.ndarray, eps: float) -> np.ndarray:
    """Entries of a float32 array whose bfloat16 rounding a change of up to
    eps * max|x| can move."""
    t = torch.from_numpy(x32)
    d = eps * float(t.abs().max())
    return to_np(((t - d).to(torch.bfloat16) != (t + d).to(torch.bfloat16)))


def _rounded_other_way(x32: np.ndarray, flip: np.ndarray) -> torch.Tensor:
    """bfloat16(x32), with the `flip` entries on the other neighbour."""
    t = torch.from_numpy(x32)
    b = t.to(torch.bfloat16)
    up = torch.nextafter(b, torch.tensor(float("inf"), dtype=torch.bfloat16))
    down = torch.nextafter(b, torch.tensor(float("-inf"),
                                           dtype=torch.bfloat16))
    other = torch.where(b.float() < t, up, down)
    return torch.where(torch.from_numpy(flip), other, b)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_from_own_cache(R, ref_params, arch):
    cfg, jcfg = get_smoke(arch), R.configs.get_smoke(arch)
    jp = ref_params[arch]
    p = params_from_reference(jp)
    batch, jbatch, steps = _inputs(R, cfg, 1)
    _, cache = T.prefill(p, cfg, batch)
    _, jcache = R.transformer.prefill(jp, jcfg, jbatch)
    want = _ref_decode(R, jcfg, jp, jcache, steps)
    got = _port_decode(cfg, p, cache, steps)
    devs = [rel_err(g, w) for g, w in zip(got, want, strict=True)]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))

    # the float-order floor: the two packages' float32 K/V
    f32 = dataclasses.replace(cfg, cache_dtype=torch.float32)
    jf32 = dataclasses.replace(jcfg, cache_dtype=R.jnp.float32)
    kv = [to_np(t) for t in T.prefill(p, f32, batch)[1]["layers"]]
    jkv = [np.array(t) for t in
           R.transformer.prefill(jp, jf32, jbatch)[1]["layers"]]
    eps = max(rel_err(a, b) for a, b in zip(kv, jkv, strict=True))
    flips = [_flip_candidates(b, eps) for b in jkv]
    # every bfloat16 difference is one of them, one step apart
    n_diff = _assert_kv_match(cache, jcache)
    for a, b, f in zip(cache["layers"], jcache["layers"], flips,
                       strict=True):
        assert not (to_np(a != _to_port(b)) & ~f).any()
    # the logits' deviation when all of them round the other way
    other = {"layers": tuple(_rounded_other_way(b, f)
                             for b, f in zip(jkv, flips, strict=True)),
             "pos": _to_port(jcache["pos"])}
    flipped = _port_decode(cfg, p, other, steps)
    base = _port_decode(cfg, p, _to_port(jcache), steps)
    floor = max(rel_err(a, b) for a, b in zip(flipped, base, strict=True))
    print(f"{arch}: own-cache decode max rel dev {max(devs):.3e} "
          f"(steps over 1e-4: {sum(d > 1e-4 for d in devs)} of {STEPS}); "
          f"float32 K/V eps {eps:.2e}, {int(sum(f.sum() for f in flips))} "
          f"candidates, {n_diff} differ; all flipped: {floor:.3e}")
    if arch in FLIPPING:
        assert max(devs) <= 4 * floor + 1e-4
    else:
        assert max(devs) <= 1e-4


def test_gemma3_cache_holds_max_len_in_every_layer(R):
    """The reference's gemma3 docstring says its 40 local layers cap their
    decode cache at the 1024-token window; its `init_cache` allocates
    max_len for every layer, and the port follows the code: at full
    width one (48, B, max_len, 8, 256) pair, local layers included."""
    cfg, jcfg = get_config(GEMMA), R.configs.get_config(GEMMA)
    assert "cap their decode cache" in R.configs.gemma3_12b.__doc__
    c = T.init_cache(cfg, 2, 2048, device="meta")
    jc = R.jax.eval_shape(lambda: R.transformer.init_cache(jcfg, 2, 2048))
    want = (48, 2, 2048, 8, 256)
    assert [tuple(t.shape) for t in c["layers"]] == \
        [tuple(t.shape) for t in jc["layers"]] == [want, want]
    assert sum(T.layer_meta(cfg, i)["window"] == cfg.window
               for i in range(cfg.n_layers)) == 40


def test_vision_prefill_with_16_patches_matches_reference(R, ref_params):
    cfg, jcfg = get_smoke(PHI3V), R.configs.get_smoke(PHI3V)
    jp = ref_params[PHI3V]
    p = params_from_reference(jp)
    batch, jbatch, _ = _inputs(R, cfg, 2, n_img=PATCHES)
    lg, cache = T.prefill(p, cfg, batch)
    jlg, jcache = R.transformer.prefill(jp, jcfg, jbatch)
    assert_logits_match(lg, jlg)
    _assert_kv_match(cache, jcache)
    assert cache["layers"][0].shape[2] == PATCHES + PROMPT == \
        jcache["layers"][0].shape[2]
    np.testing.assert_array_equal(to_np(cache["pos"]), [PATCHES + PROMPT] * 2)
    zero = dict(batch, patch_embeds=torch.zeros_like(batch["patch_embeds"]))
    assert rel_err(T.prefill(p, cfg, zero)[0], lg) > 1e-2


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,backend", [(a, None) for a in DENSE]
                         + [(GEMMA, "ref")])
def test_scheduler_greedy_tokens_equal_reference(R, arch, backend):
    """Same requests, same weights, same chip: same greedy tokens (phi3v
    served text-only in both), and the port's oracle's; with the optical
    path on, the same plan and energy_per_token."""
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


@pytest.mark.parametrize("arch", DENSE)
def test_full_width_param_count_equals_reference(R, arch):
    """Phase 16's models: full width at the depth served on the card."""
    layers, n_params = SERVED[arch]
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    jcfg = dataclasses.replace(R.configs.get_config(arch), n_layers=layers)
    assert build_model(cfg).n_params == \
        R.model.build_model(jcfg).n_params == n_params


@pytest.mark.parametrize("arch", DENSE)
def test_full_width_serving_plan_equals_reference(R, arch):
    """The serving compile of phase 16's models, traced abstractly: the
    decode GEMMs, plan and energy_per_token equal the reference's; every
    layer routes its two MLP projections."""
    layers, _ = SERVED[arch]
    cfg = serving_model_config(dataclasses.replace(get_config(arch),
                                                   n_layers=layers),
                               rosa=True)
    scfg = ServeConfig(n_slots=4, max_len=56, prefill_chunk=8, rosa=True,
                       rosa_backend="fused")
    bundle = build_model(cfg)
    prog = build_serving_program(bundle, scfg, device="cpu", cache=False)
    ledger = trace_serving_shapes(
        bundle, scfg, prog.engine.with_ledger(rosa.EnergyLedger()))

    jcfg = R.serve.serving_model_config(dataclasses.replace(
        R.configs.get_config(arch), n_layers=layers), rosa=True)
    jscfg = R.serve.ServeConfig(n_slots=4, max_len=56, prefill_chunk=8,
                                rosa=True, rosa_backend="fused")
    jbundle = R.model.build_model(jcfg)
    jprog = R.metrics.build_serving_program(jbundle, jscfg, cache=False)
    jledger = R.metrics.trace_serving_shapes(
        jbundle, jscfg, jprog.engine.with_ledger(R.rosa.EnergyLedger()))

    got = [(e.name, e.m, e.k, e.n, e.count) for e in prog.trace.entries]
    assert got == [(e.name, e.m, e.k, e.n, e.count)
                   for e in jprog.trace.entries]
    (k_wi, n_wi), (k_wo, n_wo) = new_proj(arch).values()
    assert [g[:4] for g in got] == [("mlp/wi", 4, k_wi, n_wi),
                                    ("mlp/wo", 4, k_wo, n_wo)]
    plan = {k: v.name for k, v in prog.plan.mapping_plan().items()}
    assert plan == {k: v.name for k, v in
                    jprog.plan.mapping_plan().items()}
    e = ledger.per_token(ROSA_OPTIMAL, batch=4)
    assert e > 0
    assert e == jledger.per_token(R.constants.ROSA_OPTIMAL, batch=4)


def test_chip_smoke_phase16_models_are_these():
    """chip_smoke.py's phase-16 table and phase-2 shapes are this file's:
    full width, the depths held above but gemma3-12b's and
    phi-3-vision's, which the card serves at 6 and 16 layers since the
    script made room for its training-across-ranks phase, and each count
    the full-width model's at its depth."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.DENSE_PROJ == {a: new_proj(a) for a in DENSE}
    table = [cs.GEMMA3, *cs.DENSE_CUT, cs.PHI3V]
    depths = dict({a: layers for a, (layers, _) in SERVED.items()},
                  **{GEMMA: 6, PHI3V: 16})
    assert {a: layers for a, layers, _ in table} == depths
    for a, layers, n in table:
        assert n == build_model(dataclasses.replace(
            get_config(a), n_layers=layers)).n_params, a
    assert cs.GEMMA_SERVE["max_len"] > cs.LONG_PROMPT > \
        get_config(GEMMA).window


@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("k,n", NEW_SHAPES)
def test_decode_plan_at_new_projection_shapes(k, n, m):
    """The skinny-M path at the new sheets on 132 SMs: each K split covers
    whole ring stages (the launcher refuses k_per_split % BK != 0), the
    splits cover K with none empty, and the partial-sum workspace is
    splits x m x n floats."""
    pl = skinny.decode_plan(m, k, n, n_sm=132, planes=1)
    assert pl["k_per_split"] % skinny.BK == 0
    assert (pl["splits"] - 1) * pl["k_per_split"] < k \
        <= pl["splits"] * pl["k_per_split"]
    assert pl["grid"] == (skinny.cdiv(n, skinny.BN), pl["splits"], 1)
    assert pl["part_floats"] == (pl["splits"] * m * n
                                 if pl["splits"] > 1 else 0)
    assert pl["smem_bytes"] <= skinny.SMEM_LIMIT


def test_serve_cli_vision_batch_policy_on_cpu(capsys):
    res = serve_cli.run_batch(serve_cli.build_parser().parse_args([
        "--arch", PHI3V, "--smoke", "--device", "cpu", "--policy", "batch",
        "--batch", "2", "--prompt-len", "6", "--gen", "5"]))
    out = capsys.readouterr().out
    assert "arch=phi3v-smoke layers=2" in out and "tok/s" in out
    img = res["batch"]["patch_embeds"]
    assert img.dtype == torch.bfloat16 and img.shape == (2, 16, 64)
    assert not img.any()
    assert res["tokens"].shape == (2, 5)
    assert res["cache"]["layers"][0].shape[2] == 16 + 6 + 5 + 1
    serve_cli.main(["--arch", GEMMA, "--smoke", "--device", "cpu", "--rosa",
                    "--variation-seed", "7", "--requests", "2"])
    out = capsys.readouterr().out
    assert "arch=gemma3-smoke layers=6" in out and "ticks" in out


# ---------------------------------------------------------------------------
# make_inputs and applicable
# ---------------------------------------------------------------------------
def _specs(batch, axes) -> list:
    """(path, shape, dtype name, axes) of every leaf of an input batch."""
    return [(p, tuple(t.shape), str(t.dtype).split(".")[-1], a)
            for (p, t), (_, a) in zip(cache_leaves(batch),
                                      _axes_leaves(axes), strict=True)]


def _axes_leaves(tree, prefix: str = "") -> list:
    """(path, axes tuple) pairs of a logical-axes tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _axes_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, tuple) and tree and not all(
            a is None or isinstance(a, str) for a in tree):
        return [pair for i, t in enumerate(tree)
                for pair in _axes_leaves(t, f"{prefix}/{i}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("concrete", [False, True])
@pytest.mark.parametrize("shape", sorted(SMOKE_SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_make_inputs_specs_equal_reference(R, arch, shape, concrete):
    cfg, jcfg = get_smoke(arch), R.configs.get_smoke(arch)
    spec = SMOKE_SHAPES[shape]
    jspec = R.model.SMOKE_SHAPES[shape]
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    batch, axes = make_inputs(cfg, spec, concrete=concrete,
                              generator=torch.Generator().manual_seed(3))
    jbatch, jaxes = R.model.make_inputs(jcfg, jspec, concrete=concrete)
    assert _specs(batch, axes) == _specs(jbatch, jaxes)
    devices = {t.device.type for _, t in cache_leaves(batch)}
    assert devices == ({"cpu"} if concrete else {"meta"})
    if concrete:
        for path, t in cache_leaves(batch):
            if path in ("/tokens", "/labels", "/token"):
                assert int(t.min()) >= 0 and int(t.max()) < cfg.vocab
            if path.endswith("_embeds"):
                assert 0 < float(t.float().std()) < 0.05
        if "pos" in batch:
            np.testing.assert_array_equal(to_np(batch["pos"]),
                                          to_np(jbatch["pos"]))


@pytest.mark.parametrize("shape", sorted(ASSIGNED_SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_assigned_shapes_and_applicable_equal_reference(R, arch, shape):
    """The full configs on the assigned grid, abstract: the same inputs,
    and the same skip rule."""
    cfg, jcfg = get_config(arch), R.configs.get_config(arch)
    spec, jspec = ASSIGNED_SHAPES[shape], R.model.ASSIGNED_SHAPES[shape]
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert applicable(cfg, spec) == R.model.applicable(jcfg, jspec)
    batch, axes = make_inputs(cfg, spec)
    assert _specs(batch, axes) == _specs(*R.model.make_inputs(jcfg, jspec))


def test_make_inputs_draws_from_the_generator():
    cfg = get_smoke(PHI3V)
    spec = SMOKE_SHAPES["prefill_32k"]

    def draw(seed):
        return make_inputs(cfg, spec, concrete=True,
                           generator=torch.Generator().manual_seed(seed))[0]

    a, b, c = draw(0), draw(0), draw(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (2, 24) and a["patch_embeds"].shape == \
        (2, 8, 64)
    assert torch.equal(make_inputs(cfg, spec, concrete=True)[0]["tokens"],
                       a["tokens"])


# ---------------------------------------------------------------------------
# smoke_report and bench.compare
# ---------------------------------------------------------------------------
def test_smoke_report_equals_reference(R):
    """The serving bench on qwen3-32b-smoke (8 requests): the same metric
    list, gates and tolerances; the tick-unit and energy values equal."""
    got = smoke_report(n_requests=8, device="cpu")
    want = R.metrics.smoke_report(n_requests=8)
    assert [m.name for m in got] == [m.name for m in want]
    assert "throughput_ratio_vs_oneshot" in [m.name for m in got]
    for m, w in zip(got, want, strict=True):
        assert (m.unit, m.gate, m.rel_tol, m.direction) == \
            (w.unit, w.gate, w.rel_tol, w.direction), m.name
        if m.gate:
            assert m.value == (float(w.value) if isinstance(m.value, float)
                               else w.value), m.name


def _report(schema, mode="quick", **edits):
    """A two-bench report: every direction, a string, an ungated wall;
    `edits` {metric name: value, or None to drop it}; "status:<bench>"
    fails a bench."""
    metrics = {
        "dse": [("best_label", "R=16,C=8,T=8", "both", 0.0),
                ("reduction", 0.64, "higher_is_better", 0.05),
                ("edp", 2.0e-9, "lower_is_better", 0.01)],
        "serve_smoke": [("cont_total_tokens", 120, "both", 0.0),
                        ("throughput_ratio_vs_oneshot", 1.7,
                         "higher_is_better", 1e-6),
                        ("energy_per_token_j", 0.0187, "lower_is_better",
                         1e-3)],
    }
    results = []
    for bench, ms in metrics.items():
        out = []
        for name, value, direction, tol in ms:
            value = edits.get(name, value)
            if name in edits and value is None:
                continue
            out.append(schema.Metric(name, value, unit="", gate=True,
                                     rel_tol=tol, direction=direction))
        out.append(schema.Metric("wall_s", 1.0, unit="s"))
        failed = edits.get(f"status:{bench}")
        results.append(schema.BenchResult(
            bench, status="failed" if failed else "ok", wall_s=1.0,
            error=failed or "", metrics=out))
    return schema.BenchReport(bench_seq=2, mode=mode, results=results)


CASES = {
    "pass": {"reduction": 0.62, "edp": 2.01e-9},
    "lower_is_better": {"edp": 2.05e-9},
    "higher_is_better": {"reduction": 0.5},
    "both": {"cont_total_tokens": 119},
    "string": {"best_label": "R=8,C=8,T=8"},
    "dropped": {"energy_per_token_j": None},
    "failed_bench": {"status:dse": "Traceback: boom"},
    "mode": {},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_verdicts_equal_reference(R, case, tmp_path):
    mode = "full" if case == "mode" else "quick"
    base, cur = _report(S), _report(S, mode, **CASES[case])
    jbase, jcur = _report(R.schema), _report(R.schema, mode, **CASES[case])
    got, want = C.compare(base, cur), R.compare.compare(jbase, jcur)
    assert [dataclasses.astuple(v) for v in got.verdicts] == \
        [dataclasses.astuple(v) for v in want.verdicts]
    assert (got.failed_benches, got.mode_mismatch, got.ok) == \
        (want.failed_benches, want.mode_mismatch, want.ok)
    assert got.ok == (case == "pass")
    assert C.format_result(got) == R.compare.format_result(want)
    paths = [tmp_path / "base.json", tmp_path / "cur.json"]
    for rep, path in zip((base, cur), paths):
        S.save(rep, path)
    assert C.main([str(p) for p in paths]) == (0 if case == "pass" else 1)
    # a scaled tolerance turns the small drifts into passes or failures
    scaled = C.compare(base, cur, tol_scale=0.0)
    jscaled = R.compare.compare(jbase, jcur, tol_scale=0.0)
    assert [v.ok for v in scaled.verdicts] == [v.ok for v in jscaled.verdicts]


def test_compare_reads_reports_either_package_writes(R, tmp_path):
    base = _report(S)
    S.save(base, tmp_path / "port.json")
    R.schema.save(_report(R.schema, edp=2.05e-9), tmp_path / "ref.json")
    args = [str(tmp_path / "port.json"), str(tmp_path / "ref.json")]
    assert C.main(args) == 1 == R.compare.main(args)
    doc = json.loads((tmp_path / "ref.json").read_text())
    assert C.compare(S.from_dict(doc), S.from_dict(doc)).ok


# ---------------------------------------------------------------------------
# On the card: rosa_fused at the new projection shapes
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("arch,name", [(a, n) for a in DENSE
                                       for n in ("mlp/wi", "mlp/wo")])
def test_fused_kernel_at_new_projection_shapes_matches_plain_on_cuda(
        arch, name, m):
    """Phase 2's new rows: IS with per-row activation scales,
    PAPER_NOISE, chip 7 sampled at the model's lanes; two launches give
    the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (kernels build on first "
                    "use)")
    from repro_torch.kernels.rosa_fused import ops
    proj = new_proj(arch)
    k, n = proj[name]
    g = torch.Generator("cuda").manual_seed(1)
    x = torch.randn(m, k, device="cuda", generator=g)
    w = torch.randn(k, n, device="cuda", generator=g)
    chip = sample_chip(torch.Generator().manual_seed(7),
                       dims={nm: kk for nm, (kk, _) in proj.items()},
                       device="cuda")
    key = torch.Generator("cuda").manual_seed(2)
    args, static = ops.operands(x, w, key, chip[name], mapping=Mapping.IS,
                                act_per_vector=True, noise=TM.PAPER_NOISE)
    y = ops.launch(*args, **static)
    y_plain = ops.plain(*args, **static)
    torch.cuda.synchronize()
    assert_quantized_parity(y, y_plain)
    assert torch.equal(y, ops.launch(*args, **static))
