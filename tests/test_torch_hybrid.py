"""Port parity of the hybrid family (zamba2-1.2b: groups of Mamba-2 layers
with one shared attention + MLP block) against the JAX reference, on the
CPU.

Inputs are made with numpy from a seed and fed to both packages with the
reference's parameters; the reference's Pallas `ssd_scan` is not on its
model path (its model scans with jnp chunking).

  * zamba2-smoke (5 layers: 2 groups of 2 and a tail of 1) and the same
    cut to 4 layers (no tail, in the params and in the cache): prefill
    logits, then `pad_cache` and 4 decode steps, within 1e-4 of max|ref|
    with the argmax equal (the bound of `test_torch_ssm.py`); every
    float32 cache leaf within 1e-4 of its max, the bfloat16 shared KV
    within one bfloat16 step (2^-8) of its max: a float32 value within
    float noise of a bfloat16 rounding boundary may round the other way;
  * `cache_axes`, `init_cache` and `pad_cache` equal the reference's;
    the slot API touches one row of every leaf (the ssm leaves' slot axis
    is axis 2);
  * serving: the Scheduler's greedy tokens equal the reference
    Scheduler's for prompts of 4-8 tokens, optical path off and on (the
    shared MLP bypasses the engine, so the plan and the ledger are empty
    in both), and so do the port's sequential oracle's;
  * at full width (abstract traces): the parameter count, an empty
    serving plan, energy_per_token 0.0 and `energy_metrics` as the
    reference (which divides by the empty plan's EDP: ZeroDivisionError);
  * the serving CLI end to end on the CPU.

The 2-token prompt (left-padded conv cache) is
`test_torch_ssm.py::test_two_token_prompt_conv_cache_left_padded`.  The
test marked `cuda` holds `ssd_scan` to its plain version at zamba2's
scan shape (S 64) and skips without a card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import rosa
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.constants import ROSA_OPTIMAL
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.models.model import (build_model, cache_axes, evict_slot,
                                      pad_cache, params_from_reference,
                                      read_slot, write_slot)
from repro_torch.serve import (Scheduler, ServeConfig, build_serving_program,
                               energy_metrics, poisson_requests,
                               run_sequential, serving_model_config,
                               trace_serving_shapes)
from test_torch_ref import (assert_caches_match, assert_logits_match,
                            cache_leaves, reference)

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "zamba2-1.2b"


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


def _cfgs(R, n_layers):
    cfg, jcfg = get_smoke(ARCH), R.configs.get_smoke(ARCH)
    return (dataclasses.replace(cfg, n_layers=n_layers),
            dataclasses.replace(jcfg, n_layers=n_layers))


@pytest.fixture(scope="module")
def ref_params(R):
    return {n: R.model.build_model(_cfgs(R, n)[1]).init(
        R.jax.random.PRNGKey(0)) for n in (5, 4)}


def _with_axes(cache, axes) -> list:
    """(leaf, logical axes) pairs of a port cache and its `cache_axes`."""
    if isinstance(cache, dict):
        return [p for k in sorted(cache)
                for p in _with_axes(cache[k], axes[k])]
    if isinstance(cache, tuple):
        return [p for c, a in zip(cache, axes, strict=True)
                for p in _with_axes(c, a)]
    return [(cache, axes)]


@pytest.mark.parametrize("n_layers", [5, 4])
def test_prefill_and_decode_match_reference(R, ref_params, n_layers):
    cfg, jcfg = _cfgs(R, n_layers)
    jp = ref_params[n_layers]
    p = params_from_reference(jp)
    assert ("tail" in p) == (n_layers % cfg.shared_every != 0)
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (2, 13)).astype(
        np.int32)
    lg, cache = T.prefill(p, cfg, {"tokens": torch.from_numpy(tok)})
    jlg, jc = R.transformer.prefill(jp, jcfg, {"tokens": R.jnp.asarray(tok)})
    assert_logits_match(lg, jlg)
    assert_caches_match(cache, jc)
    assert ("tail" in cache) == ("tail" in p)
    cache, jc = pad_cache(cfg, cache, 4), R.model.pad_cache(jcfg, jc, 4)
    for step in range(4):
        t = np.array([step + 3, 250 - step], np.int32)
        lg, cache = T.decode_step(p, cfg, {"token": torch.from_numpy(t),
                                           "pos": cache["pos"],
                                           "cache": cache})
        jlg, jc = R.transformer.decode_step(jp, jcfg, {
            "token": R.jnp.asarray(t), "pos": jc["pos"], "cache": jc})
        assert_logits_match(lg, jlg)
    assert_caches_match(cache, jc)


def test_chunk_step_raises_for_hybrid():
    with pytest.raises(ValueError, match="chunked prefill unsupported"):
        T.chunk_step({}, get_smoke(ARCH), {"tokens": None, "n_valid": None,
                                           "cache": None})


# ---------------------------------------------------------------------------
# Cache axes and the slot API
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_layers", [5, 4])
def test_cache_axes_and_pad_cache_equal_reference(R, n_layers):
    cfg, jcfg = _cfgs(R, n_layers)
    assert cache_axes(cfg) == R.model.cache_axes(jcfg)
    c = T.init_cache(cfg, 3, 8)
    jc = R.transformer.init_cache(jcfg, 3, 8)
    shapes = lambda tree: [(p, tuple(t.shape), str(t.dtype).split(".")[-1])
                           for p, t in cache_leaves(tree)]
    assert shapes(c) == shapes(jc)
    grown = pad_cache(cfg, c, 5)
    assert shapes(grown) == shapes(R.model.pad_cache(jcfg, jc, 5))
    # only the shared KV (cache_seq) grows; the ssm states keep theirs
    for (path, g), (_, a) in zip(cache_leaves(grown), cache_leaves(c)):
        grew = path.startswith("/groups/shared")
        assert (g.shape != a.shape) == grew
        assert not grew or g.shape[2] == 13


@pytest.mark.parametrize("n_layers", [5, 4])
def test_slot_api_touches_one_row(R, n_layers):
    cfg = serving_model_config(_cfgs(R, n_layers)[0])
    c, req = T.init_cache(cfg, 3, 8), T.init_cache(cfg, 1, 8)
    pairs = _with_axes(c, cache_axes(cfg))
    leaves = [t for t, _ in pairs]
    bdims = [a.index("cache_batch") for _, a in pairs]
    # groups: shared (G, B, S, KV, D), then ssm (G, k, B, ...)
    assert bdims[:6] == [1, 1, 2, 2, 2, 2]
    for _, t in cache_leaves(req):
        t.fill_(1)
    before = [t.clone() for t in leaves]
    write_slot(cfg, c, req, 1)
    for t, b, ax in zip(leaves, before, bdims, strict=True):
        assert torch.all(t.select(ax, 1) == 1)
        for other in (0, 2):
            assert torch.equal(t.select(ax, other), b.select(ax, other))
    for (_, a), (_, b) in zip(cache_leaves(read_slot(cfg, c, 1)),
                              cache_leaves(req), strict=True):
        assert torch.equal(a, b)
    evict_slot(cfg, c, 1)
    assert all(torch.count_nonzero(t) == 0 for t in leaves)
    write_slot(cfg, c, req, 2, valid=False)
    assert all(torch.count_nonzero(t) == 0 for t in leaves)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rosa_on", [False, True])
def test_scheduler_greedy_tokens_equal_reference(R, rosa_on):
    kw = dict(n_slots=2, max_len=24, rosa=rosa_on,
              variation_seed=7 if rosa_on else None)
    jsched = R.serve.Scheduler(R.configs.get_smoke(ARCH),
                               R.serve.ServeConfig(**kw), plan_cache=False)
    vocab = jsched.cfg.vocab
    jrep = jsched.run(R.serve.poisson_requests(
        4, 1.0, vocab=vocab, prompt_len=(4, 8), seed=0))
    sched = Scheduler(get_smoke(ARCH), ServeConfig(**kw),
                      params=params_from_reference(jsched.params),
                      device="cpu", plan_cache=False)
    reqs = poisson_requests(4, 1.0, vocab=vocab, prompt_len=(4, 8), seed=0)
    rep = sched.run(reqs)
    want = {r: c.tokens for r, c in jrep.completions.items()}
    assert {r: c.tokens for r, c in rep.completions.items()} == want
    assert (rep.ticks, rep.decode_steps, rep.prefill_chunks) == \
        (jrep.ticks, jrep.decode_steps, jrep.prefill_chunks)
    assert rep.prefill_chunks == len(reqs)       # one whole prefill each
    seq = run_sequential(get_smoke(ARCH), ServeConfig(**kw), sched.params,
                         reqs, device="cpu")
    assert {r: v["tokens"] for r, v in seq.items()} == want
    if rosa_on:
        # the shared MLP bypasses the engine: empty trace, plan and ledger
        assert len(sched.program.trace) == 0 == len(jsched.program.trace)
        assert sched.program.plan.mapping_plan() == {}
        e = sched.engine.ledger.per_token(ROSA_OPTIMAL, batch=2)
        assert e == jsched.engine.ledger.per_token(
            R.constants.ROSA_OPTIMAL, batch=2) == 0.0


def test_full_width_param_count_and_serving_plan_equal_reference(R):
    """zamba2-1.2b at full width and depth (chip_smoke.py phase 15(a)),
    traced abstractly: 38 layers, 6 groups of 6 and a tail of 2; nothing
    routes through the optical engine."""
    cfg, jcfg = get_config(ARCH), R.configs.get_config(ARCH)
    bundle = build_model(serving_model_config(cfg, rosa=True))
    assert bundle.n_params == R.model.build_model(jcfg).n_params \
        == 1_104_777_344
    assert T.hybrid_depth(cfg) == (6, 2)
    assert dataclasses.asdict(cfg.ssm) == dataclasses.asdict(jcfg.ssm)
    scfg = ServeConfig(n_slots=4, max_len=768, rosa=True,
                       rosa_backend="fused")
    prog = build_serving_program(bundle, scfg, device="cpu", cache=False)
    ledger = trace_serving_shapes(
        bundle, scfg, prog.engine.with_ledger(rosa.EnergyLedger()))
    jscfg = R.serve.ServeConfig(n_slots=4, max_len=768, rosa=True,
                                rosa_backend="fused")
    jbundle = R.model.build_model(R.serve.serving_model_config(jcfg,
                                                               rosa=True))
    jprog = R.metrics.build_serving_program(jbundle, jscfg, cache=False)
    jledger = R.metrics.trace_serving_shapes(
        jbundle, jscfg, jprog.engine.with_ledger(R.rosa.EnergyLedger()))
    assert list(prog.trace.entries) == [] == list(jprog.trace.entries)
    assert prog.plan.mapping_plan() == {} == jprog.plan.mapping_plan()
    assert ledger.per_token(ROSA_OPTIMAL, batch=4) == jledger.per_token(
        R.constants.ROSA_OPTIMAL, batch=4) == 0.0


def test_energy_metrics_of_the_empty_plan_as_reference(R):
    """The plan is empty, so the hybrid-vs-WS EDP ratio is 0 / 0: the
    reference raises ZeroDivisionError, and so does the port."""
    scfg = dict(n_slots=4, max_len=56, prefill_chunk=8)
    with pytest.raises(ZeroDivisionError):
        R.metrics.energy_metrics(R.configs.get_smoke(ARCH),
                                 R.serve.ServeConfig(**scfg))
    with pytest.raises(ZeroDivisionError):
        energy_metrics(get_smoke(ARCH), ServeConfig(**scfg), cache=False,
                       device="cpu")


def test_serve_cli_on_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--requests", "3", "--rosa", "--variation-seed", "7"])
    out = capsys.readouterr().out
    assert "arch=zamba2-smoke layers=5" in out
    assert "plan {}" in out
    assert "energy_per_token         0 J" in out
    assert out.count("rid=") == 3


# ---------------------------------------------------------------------------
# On the card: ssd_scan at zamba2's scan shape
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("l", [128, 700])
def test_ssd_scan_at_state_64_matches_plain_on_cuda(l):
    """(1, L, H 64, P 64, G 1, S 64): zamba2-1.2b's prefill scan, as
    chip_smoke.py phase 6 holds it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (kernels build on first "
                    "use)")
    g = torch.Generator().manual_seed(l)
    x = torch.randn(1, l, 64, 64, generator=g)
    loga = -torch.nn.functional.softplus(torch.randn(1, l, 64, generator=g))
    b = torch.randn(1, l, 1, 64, generator=g)
    c = torch.randn(1, l, 1, 64, generator=g)
    y_cpu, st_cpu = ssd_ops.ssd_scan(x, loga, b, c, chunk=128)
    y, st = ssd_ops.ssd_scan(x.cuda(), loga.cuda(), b.cuda(), c.cuda(),
                             chunk=128)
    torch.cuda.synchronize()
    for got, want in ((y, y_cpu), (st, st_cpu)):
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-4 * max(1.0, float(want.abs().max()))
