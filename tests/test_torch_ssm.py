"""Port parity of the SSM family (mamba2) and its SSD scan kernel.

Inputs are made with numpy from a seed and fed to the port and to the JAX
reference; the reference's Pallas `ssd_scan` runs in interpret mode.

  * the plain scan (what the CUDA kernel computes; the wrapper runs it for
    CPU tensors) against the reference kernel and the sequential oracle,
    with ragged L, head groups and batch 2: max abs error
    <= 1e-5 * max(1, max|ref|), for y and for the final state (float32
    contractions summed in another order);
  * the blocks (`ssm_apply`, `_ssm_prefill`, `ssm_decode`) at mamba2-smoke
    with the reference's params: <= 1e-5 relative;
  * the whole model, prefill and 4 decode steps: logits <= 1e-4 relative,
    equal argmax;
  * serving: the Scheduler's greedy tokens equal the reference
    Scheduler's, optical path off and on (no projection of the block is
    routed, so the plan and the ledger are empty in both);
  * the slot API, `pad_cache` and the 2-token prompt, whose conv cache the
    port left-pads with zeros where the reference keeps 2 rows.

The test marked `cuda` launches the kernel and skips without a card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core.constants import ROSA_OPTIMAL
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.model import (build_model, evict_slot, pad_cache,
                                      params_from_reference, read_slot,
                                      write_slot)
from repro_torch.serve import (Scheduler, ServeConfig, poisson_requests,
                               run_sequential, serving_model_config)
from test_torch_ref import reference, to_np

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def R():
    return reference()


@pytest.fixture(scope="module")
def jcfg(R):
    return R.configs.get_smoke("mamba2-1.3b")


@pytest.fixture(scope="module")
def ref_params(R, jcfg):
    return R.model.build_model(jcfg).init(R.jax.random.PRNGKey(0))


def _scan_inputs(bsz, l, h, p, g, s, seed, decay=(0.05, 1.0)):
    """x, loga, b, c as numpy float32; loga in -decay (log a <= 0)."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(bsz, l, h, p)).astype(np.float32)
    loga = -r.uniform(*decay, size=(bsz, l, h)).astype(np.float32)
    b = r.normal(size=(bsz, l, g, s)).astype(np.float32)
    c = r.normal(size=(bsz, l, g, s)).astype(np.float32)
    return x, loga, b, c


def _assert_close_abs(got, want, tol=1e-5):
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"max abs error {err:.3e} > {bound:.3e}"


def _assert_rel(got, want, tol):
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    assert err <= tol, f"relative error {err:.3e} > {tol:.0e}"


# (B, L, H, P, G, S, chunk, decay range): ragged L everywhere; G < H; the
# last case decays to l ~ -90 within a 128-step chunk (exp(l) subnormal)
SCAN_CASES = [(2, 40, 4, 16, 2, 16, 8, (0.05, 1.0)),
              (1, 37, 4, 8, 1, 16, 16, (0.05, 1.0)),
              (2, 300, 2, 8, 2, 16, 128, (0.2, 1.2))]


@pytest.mark.parametrize("case", SCAN_CASES)
def test_plain_scan_matches_reference_kernel_and_oracle(R, case):
    bsz, l, h, p, g, s, chunk, decay = case
    x, loga, b, c = _scan_inputs(bsz, l, h, p, g, s, seed=l, decay=decay)
    y, st = ssd_ops.ssd_scan(*map(torch.from_numpy, (x, loga, b, c)),
                             chunk=chunk)
    jnp = R.jnp
    jy, jst = R.ssd_ops.ssd_scan(jnp.asarray(x), jnp.asarray(loga),
                                 jnp.asarray(b), jnp.asarray(c), chunk=chunk)
    _assert_close_abs(y, jy)
    _assert_close_abs(st, jst)
    # the sequential oracle, per (batch, head), on the head's group
    rep = h // g
    for bi in range(bsz):
        for hi in range(h):
            gi = hi // rep
            oy, ost = R.ssd_ref.ssd_scan_ref(
                jnp.asarray(x[bi, :, hi]),
                jnp.exp(jnp.asarray(loga[bi, :, hi])),
                jnp.asarray(b[bi, :, gi]), jnp.asarray(c[bi, :, gi]))
            _assert_close_abs(y[bi, :, hi], oy)
            _assert_close_abs(st[bi, hi], ost)


def test_wrapper_runs_plain_version_on_cpu():
    x, loga, b, c = map(torch.from_numpy,
                        _scan_inputs(2, 21, 4, 8, 2, 16, seed=3))
    before = ssd_ops.LAUNCHES.count
    y, st = ssd_ops.ssd_scan(x, loga, b, c, chunk=8)
    y2, st2 = ssd_ref.ssd_chunked(x, loga, b, c, 8)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    assert ssd_ops.LAUNCHES.count == before
    with pytest.raises(ValueError, match="CUDA"):
        ssd_ops.launch(x, loga, b, c, 8)


@pytest.mark.parametrize("with_s0", [False, True])
def test_oracles_match_reference(R, with_s0):
    r = np.random.default_rng(11)
    l, p, s = 48, 8, 16
    x = r.normal(size=(l, p)).astype(np.float32)
    a = np.exp(-r.uniform(0.05, 1.0, size=(l,))).astype(np.float32)
    b = r.normal(size=(l, s)).astype(np.float32)
    c = r.normal(size=(l, s)).astype(np.float32)
    s0 = r.normal(size=(s, p)).astype(np.float32) if with_s0 else None
    t = lambda v: None if v is None else torch.from_numpy(v)
    j = lambda v: None if v is None else R.jnp.asarray(v)
    want = R.ssd_ref.ssd_scan_ref(j(x), j(a), j(b), j(c), j(s0))
    for got in (ssd_ref.ssd_scan_ref(t(x), t(a), t(b), t(c), t(s0)),
                ssd_ref.ssd_scan_chunked_ref(t(x), t(a), t(b), t(c), 16,
                                             t(s0))):
        _assert_close_abs(got[0], want[0])
        _assert_close_abs(got[1], want[1])
    jc = R.ssd_ref.ssd_scan_chunked_ref(j(x), j(a), j(b), j(c), 16, j(s0))
    _assert_close_abs(ssd_ref.ssd_scan_chunked_ref(
        t(x), t(a), t(b), t(c), 16, t(s0))[0], jc[0])


def test_batched_chunked_matches_reference_ssd_chunked(R):
    """G = H (groups pre-broadcast) and an initial state: the reference's
    `ssm.ssd_chunked` semantics."""
    x, loga, b, c = _scan_inputs(2, 29, 4, 8, 4, 16, seed=5)
    s0 = np.random.default_rng(6).normal(size=(2, 4, 16, 8)).astype(
        np.float32)
    y, st = SSM.ssd_chunked(*map(torch.from_numpy, (x, loga, b, c)), 8,
                            torch.from_numpy(s0))
    jy, jst = R.ssm.ssd_chunked(*map(R.jnp.asarray, (x, loga, b, c)), 8,
                                R.jnp.asarray(s0))
    _assert_close_abs(y, jy)
    _assert_close_abs(st, jst)


# ---------------------------------------------------------------------------
# Blocks and the whole model at mamba2-smoke
# ---------------------------------------------------------------------------
def _u(l, d=64, seed=0, bsz=2):
    return np.random.default_rng(seed).normal(size=(bsz, l, d)).astype(
        np.float32)


def test_blocks_match_reference(R, jcfg, ref_params):
    scfg = get_smoke("mamba2-1.3b").ssm
    jp = R.jax.tree.map(lambda a: a[0], ref_params["layers"]["ssm"])
    p = params_from_reference(jp)
    u = _u(19)
    _assert_rel(SSM.ssm_apply(p, scfg, torch.from_numpy(u)),
                R.ssm.ssm_apply(jp, jcfg.ssm, R.jnp.asarray(u)), 1e-5)
    out, cache = T._ssm_prefill(p, scfg, torch.from_numpy(u))
    jout, jcache = R.transformer._ssm_prefill(jp, jcfg.ssm, R.jnp.asarray(u))
    _assert_rel(out, jout, 1e-5)
    assert sorted(cache) == sorted(jcache)
    for k in cache:
        _assert_rel(cache[k], jcache[k], 1e-5)
    ut = _u(1, seed=1)
    y, new = SSM.ssm_decode(p, scfg, torch.from_numpy(ut), cache)
    jy, jnew = R.ssm.ssm_decode(jp, jcfg.ssm, R.jnp.asarray(ut), jcache)
    _assert_rel(y, jy, 1e-5)
    for k in new:
        _assert_rel(new[k], jnew[k], 1e-5)


def test_whole_model_prefill_and_decode_match_reference(R, jcfg,
                                                        ref_params):
    cfg = get_smoke("mamba2-1.3b")
    p = params_from_reference(ref_params)
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (2, 13)).astype(
        np.int32)
    lg, cache = T.prefill(p, cfg, {"tokens": torch.from_numpy(tok)})
    jlg, jc = R.transformer.prefill(ref_params, jcfg,
                                    {"tokens": R.jnp.asarray(tok)})
    _assert_rel(lg, jlg, 1e-4)
    assert np.array_equal(to_np(lg).argmax(-1), to_np(jlg).argmax(-1))
    for k in cache["layers"]:
        _assert_rel(cache["layers"][k], jc["layers"][k], 1e-4)
    for step in range(4):
        t = np.array([step + 3, 250 - step], np.int32)
        lg, cache = T.decode_step(p, cfg, {"token": torch.from_numpy(t),
                                           "pos": cache["pos"],
                                           "cache": cache})
        jlg, jc = R.transformer.decode_step(ref_params, jcfg, {
            "token": R.jnp.asarray(t), "pos": jc["pos"], "cache": jc})
        _assert_rel(lg, jlg, 1e-4)
        assert np.array_equal(to_np(lg).argmax(-1), to_np(jlg).argmax(-1))
    np.testing.assert_array_equal(to_np(cache["pos"]), to_np(jc["pos"]))
    for k in cache["layers"]:
        _assert_rel(cache["layers"][k], jc["layers"][k], 1e-4)


def test_tied_logits_match_reference_at_full_vocab(R):
    """`logits_of`'s tie branch at mamba2-1.3b's vocab (50280) and width."""
    cfg, jcfg = get_config("mamba2-1.3b"), R.configs.get_config("mamba2-1.3b")
    r = np.random.default_rng(4)
    emb = (0.02 * r.normal(size=(cfg.vocab, cfg.d_model))).astype(np.float32)
    x = r.normal(size=(1, 2, cfg.d_model)).astype(np.float32)
    got = T.logits_of({"embed": torch.from_numpy(emb)}, cfg,
                      torch.from_numpy(x))
    want = R.transformer.logits_of({"embed": R.jnp.asarray(emb)}, jcfg,
                                   R.jnp.asarray(x))
    _assert_rel(got, want, 1e-5)


def test_full_config_matches_reference(R):
    cfg, jcfg = get_config("mamba2-1.3b"), R.configs.get_config("mamba2-1.3b")
    assert build_model(cfg).n_params == 1_343_532_032 == \
        R.model.param_count(R.model.build_model(jcfg).skeleton)
    assert dataclasses.asdict(cfg.ssm) == dataclasses.asdict(jcfg.ssm)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.tie_embeddings) == \
        (48, 2048, 50280, True)


def test_chunk_step_raises_for_ssm():
    cfg = get_smoke("mamba2-1.3b")
    with pytest.raises(ValueError, match="chunked prefill unsupported"):
        T.chunk_step({}, cfg, {"tokens": None, "n_valid": None,
                               "cache": None})


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rosa_on", [False, True])
def test_scheduler_greedy_tokens_equal_reference(R, jcfg, rosa_on):
    kw = dict(n_slots=2, max_len=24, rosa=rosa_on,
              variation_seed=7 if rosa_on else None)
    jsched = R.serve.Scheduler(jcfg, R.serve.ServeConfig(**kw),
                               plan_cache=False)
    jrep = jsched.run(R.serve.poisson_requests(3, 1.0, vocab=jcfg.vocab,
                                               seed=0))
    sched = Scheduler(get_smoke("mamba2-1.3b"), ServeConfig(**kw),
                      params=params_from_reference(jsched.params),
                      device="cpu")
    rep = sched.run(poisson_requests(3, 1.0, vocab=jcfg.vocab, seed=0))
    assert {r: c.tokens for r, c in rep.completions.items()} == \
        {r: c.tokens for r, c in jrep.completions.items()}
    assert (rep.ticks, rep.decode_steps, rep.prefill_chunks) == \
        (jrep.ticks, jrep.decode_steps, jrep.prefill_chunks)
    if rosa_on:
        # the block routes nothing: an empty trace, plan and ledger
        assert len(sched.program.trace) == 0 == len(jsched.program.trace)
        assert sched.program.plan.mapping_plan() == {}
        e = sched.engine.ledger.per_token(ROSA_OPTIMAL, batch=2)
        assert e == jsched.engine.ledger.per_token(
            R.constants.ROSA_OPTIMAL, batch=2)


def test_continuous_equals_sequential_oracle():
    cfg = get_smoke("mamba2-1.3b")
    scfg = ServeConfig(n_slots=2, max_len=32, evict_on_done=True,
                       collect_logits=True)
    sched = Scheduler(cfg, scfg, device="cpu")
    reqs = poisson_requests(5, 1.0, vocab=cfg.vocab, prompt_len=(4, 20),
                            gen_len=(2, 9), seed=3)
    rep = sched.run(reqs)
    seq = run_sequential(cfg, scfg, sched.params, reqs, device="cpu")
    assert rep.prefill_chunks == len(reqs)       # one whole prefill each
    for rid, r in seq.items():
        assert rep.completions[rid].tokens == r["tokens"]
        for a, b in zip(rep.completions[rid].logits, r["logits"],
                        strict=True):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_slot_api_touches_one_row():
    cfg = serving_model_config(get_smoke("mamba2-1.3b"))
    c = T.init_cache(cfg, 3, 8)
    req = T.init_cache(cfg, 1, 8)
    for t in req["layers"].values():
        t.fill_(1.0)
    req["pos"].fill_(5)
    before = {k: t.clone() for k, t in c["layers"].items()}
    write_slot(cfg, c, req, 1)
    assert to_np(c["pos"]).tolist() == [0, 5, 0]
    for k, t in c["layers"].items():
        assert t.shape[1] == 3
        assert torch.all(t[:, 1] == 1)
        assert torch.equal(t[:, 0], before[k][:, 0])
        assert torch.equal(t[:, 2], before[k][:, 2])
    got = read_slot(cfg, c, 1)
    for k in req["layers"]:
        assert torch.equal(got["layers"][k], req["layers"][k])
    evict_slot(cfg, c, 1)
    assert all(torch.count_nonzero(t) == 0 for t in c["layers"].values())
    write_slot(cfg, c, req, 2, valid=False)
    assert torch.count_nonzero(c["pos"]) == 0


def test_pad_cache_grows_only_sequence_axes(R):
    mcfg, dcfg = get_smoke("mamba2-1.3b"), get_smoke("qwen3-32b")
    mc = T.init_cache(mcfg, 1, 8)
    assert pad_cache(mcfg, mc, 5) is mc          # no sequence axis
    dc = T.init_cache(dcfg, 1, 8)
    grown = pad_cache(dcfg, dc, 5)
    jgrown = R.model.pad_cache(
        R.configs.get_smoke("qwen3-32b"),
        R.transformer.init_cache(R.configs.get_smoke("qwen3-32b"), 1, 8), 5)
    assert [tuple(t.shape) for t in grown["layers"]] == \
        [tuple(t.shape) for t in jgrown["layers"]]
    assert tuple(grown["pos"].shape) == tuple(jgrown["pos"].shape)


def _conv_leaves(cache) -> list:
    """(path, leaf) of every conv cache leaf, keys sorted; a leaf's rows
    lie on axis ndim - 3 ((..., B, rows, heads or groups, width))."""
    if isinstance(cache, dict):
        return [(f"{k}/{p}" if p else k, t) for k in sorted(cache)
                for p, t in ([("", cache[k])] if k.startswith("conv_")
                             else _conv_leaves(cache[k]))]
    return []


def _left_pad_conv(jnp, cache):
    """A reference cache with one zero row in front of every conv leaf."""
    if not isinstance(cache, dict):
        return cache
    out = {}
    for k, v in cache.items():
        if k.startswith("conv_"):
            widths = [(0, 0)] * v.ndim
            widths[v.ndim - 3] = (1, 0)
            v = jnp.pad(v, widths)
        out[k] = _left_pad_conv(jnp, v)
    return out


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_two_token_prompt_conv_cache_left_padded(R, arch):
    """A prompt shorter than d_conv - 1 = 3 tokens, through mamba2's
    layers and zamba2's hybrid groups and tail: the reference's conv cache
    keeps its 2 rows (no slot cache takes it); the port's holds a zero row
    in front of the same 2, and decoding from it continues the sequence
    exactly as a 3-token prefill does.  zamba2's deeper conv inputs have
    passed the shared attention block: its rows are held to the
    whole-model bound, 1e-4 of the leaf's max."""
    cfg, jcfg = get_smoke(arch), R.configs.get_smoke(arch)
    jp = R.model.build_model(jcfg).init(R.jax.random.PRNGKey(0))
    p = params_from_reference(jp)
    tok = np.array([[17, 42, 99]], np.int32)
    _, cache = T.prefill(p, cfg, {"tokens": torch.from_numpy(tok[:, :2])})
    _, jc = R.transformer.prefill(jp, jcfg,
                                  {"tokens": R.jnp.asarray(tok[:, :2])})
    convs, jconvs = _conv_leaves(cache), _conv_leaves(jc)
    assert [k for k, _ in convs] == [k for k, _ in jconvs]
    assert len(convs) == (6 if cfg.family == "hybrid" else 3)
    for (_, t), (_, jt) in zip(convs, jconvs):
        got, jt, ax = to_np(t), to_np(jt), t.ndim - 3
        assert jt.shape[ax] == 2                 # the reference's fault
        assert got.shape[ax] == 3
        assert np.all(np.take(got, 0, axis=ax) == 0)
        tol = (dict(rtol=1e-5, atol=1e-6) if cfg.family == "ssm"
               else dict(rtol=0, atol=1e-4 * np.abs(jt).max()))
        np.testing.assert_allclose(np.take(got, [1, 2], axis=ax), jt, **tol)
    cache = pad_cache(cfg, cache, 1)             # room for zamba2's KV
    lg, _ = T.decode_step(p, cfg, {"token": torch.from_numpy(tok[:, 2]),
                                   "pos": cache["pos"], "cache": cache})
    if cfg.family == "ssm":
        full, _ = T.prefill(p, cfg, {"tokens": torch.from_numpy(tok)})
        jfull, _ = R.transformer.prefill(jp, jcfg,
                                         {"tokens": R.jnp.asarray(tok)})
        _assert_rel(lg, full, 1e-5)
        _assert_rel(lg, jfull, 1e-4)
    else:
        # the shared attention reads the first two tokens' K/V from the
        # bfloat16 cache, where a 3-token prefill has them in float32:
        # held instead to the reference decoding from its own cache with
        # its conv rows left-padded as the port pads them
        jc = R.model.pad_cache(jcfg, _left_pad_conv(R.jnp, jc), 1)
        jlg, _ = R.transformer.decode_step(jp, jcfg, {
            "token": R.jnp.asarray(tok[:, 2]), "pos": jc["pos"],
            "cache": jc})
        _assert_rel(lg, jlg, 1e-4)
    # and a 2-token request is served
    sched = Scheduler(cfg, ServeConfig(n_slots=2, max_len=16),
                      params=p, device="cpu")
    from repro_torch.serve import Request
    rep = sched.run([Request(0, tok[0, :2], 4), Request(1, tok[0], 3)])
    assert [len(c.tokens) for c in rep.completions.values()] == [4, 3]


# ---------------------------------------------------------------------------
# On the card: the kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_CASES + [
    (1, 200, 8, 64, 1, 128, 128, (0.2, 1.2))])
def test_kernel_matches_plain_on_cuda(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (kernels build on first "
                    "use)")
    bsz, l, h, p, g, s, chunk, decay = case
    ins = [torch.from_numpy(a) for a in
           _scan_inputs(bsz, l, h, p, g, s, seed=l, decay=decay)]
    y_cpu, st_cpu = ssd_ops.ssd_scan(*ins, chunk=chunk)
    y, st = ssd_ops.ssd_scan(*[a.cuda() for a in ins], chunk=chunk)
    torch.cuda.synchronize()
    _assert_close_abs(y, y_cpu, 1e-4)
    _assert_close_abs(st, st_cpu, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (1, 1, 8, 64, 1, 128, 128), (1, 127, 8, 64, 1, 128, 128),
    (1, 128, 8, 64, 1, 128, 128), (1, 129, 8, 64, 1, 128, 128),
    (1, 1000, 8, 64, 1, 128, 128), (2, 300, 4, 64, 4, 64, 128),
    (1, 200, 4, 30, 2, 18, 24)])
def test_chunk_parallel_kernel_matches_plain_on_cuda(case):
    """The chunk-parallel launches at one step, a chunk's edges, a long
    ragged sequence, G = H, and widths that take 4-byte copies; two
    launches give equal bits (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (kernels build on first "
                    "use)")
    bsz, l, h, p, g, s, chunk = case
    ins = [torch.from_numpy(a) for a in
           _scan_inputs(bsz, l, h, p, g, s, seed=l, decay=(0.2, 1.2))]
    y_cpu, st_cpu = ssd_ops.ssd_scan(*ins, chunk=chunk)
    dev = [a.cuda() for a in ins]
    y, st = ssd_ops.ssd_scan(*dev, chunk=chunk)
    y2, st2 = ssd_ops.ssd_scan(*dev, chunk=chunk)
    torch.cuda.synchronize()
    _assert_close_abs(y, y_cpu, 1e-4)
    _assert_close_abs(st, st_cpu, 1e-4)
    assert torch.equal(y, y2) and torch.equal(st, st2)
