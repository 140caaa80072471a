"""Port parity of the serving stack on the smoke qwen3-32b config (2 layers,
d=64), with the reference's params and chip carried across as numbers.

  * prefill / chunk / decode logits match the reference at float32
    tolerance (rtol 1e-4, atol 1e-4: attention and MLP sum in another
    order; the bfloat16 KV cache rounds the same values);
  * the Scheduler's greedy tokens equal the reference Scheduler's for the
    same Poisson requests, with the optical path off and on (backends ref,
    fused, pallas; chip 7 pinned);
  * continuous batching equals the port's per-request oracle, and the
    one-shot policy, seeded sampling and the slot API keep their
    invariants.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.models import transformer as T
from repro_torch.models.model import (build_model, evict_slot,
                                      params_from_reference, read_slot,
                                      write_slot)
from repro_torch.robust.variation import from_reference
from repro_torch.serve import (Scheduler, ServeConfig, poisson_requests,
                               run_sequential, serving_model_config)
from test_torch_ref import reference, to_np


@pytest.fixture(scope="module")
def R():
    return reference()


@pytest.fixture(scope="module")
def cfg():
    return serving_model_config(get_smoke("qwen3-32b"))


@pytest.fixture(scope="module")
def ref_params(R):
    cfg = R.configs.get_smoke("qwen3-32b")
    return R.model.build_model(cfg).init(R.jax.random.PRNGKey(0))


def _reqs(vocab, n=3, seed=0):
    return poisson_requests(n, 1.0, vocab=vocab, seed=seed)


def test_loadgen_identical(R):
    a = poisson_requests(7, 0.5, vocab=256, prompt_len=(3, 9),
                         gen_len=(2, 12), seed=4, start_rid=3)
    b = R.serve.poisson_requests(7, 0.5, vocab=256, prompt_len=(3, 9),
                                 gen_len=(2, 12), seed=4, start_rid=3)
    for x, y in zip(a, b, strict=True):
        assert (x.rid, x.max_new_tokens, x.arrival) == \
            (y.rid, y.max_new_tokens, y.arrival)
        np.testing.assert_array_equal(x.prompt, y.prompt)


def _close(a, b):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-4, atol=1e-4)


def test_prefill_chunk_decode_logits_match(R, cfg, ref_params):
    jcfg = R.serve.serving_model_config(R.configs.get_smoke("qwen3-32b"))
    p = params_from_reference(ref_params)
    jp = ref_params
    jnp = R.jnp
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (2, 7))
    tok = tok.astype(np.int32)

    lg, cache = T.prefill(p, cfg, {"tokens": torch.from_numpy(tok)})
    jlg, jcache = R.transformer.prefill(jp, jcfg,
                                        {"tokens": jnp.asarray(tok)})
    _close(lg, jlg)
    np.testing.assert_array_equal(to_np(cache["pos"]), to_np(jcache["pos"]))
    np.testing.assert_allclose(
        to_np(cache["layers"][0].float()),
        np.asarray(jcache["layers"][0].astype(jnp.float32)), rtol=1e-2,
        atol=1e-2)

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


@pytest.mark.parametrize("backend", [None, "ref", "fused", "pallas"])
def test_scheduler_greedy_tokens_equal_reference(R, backend):
    """Same requests, same weights, same chip: same greedy tokens."""
    rosa_on = backend is not None
    jcfg = R.configs.get_smoke("qwen3-32b")
    jscfg = R.serve.ServeConfig(n_slots=2, max_len=24, rosa=rosa_on,
                                variation_seed=7 if rosa_on else None,
                                rosa_backend=backend or "ref")
    jsched = R.serve.Scheduler(jcfg, jscfg, plan_cache=False)
    reqs = _reqs(jcfg.vocab)
    jrep = jsched.run(R.serve.poisson_requests(3, 1.0, vocab=jcfg.vocab,
                                               seed=0))
    chip = (from_reference(jsched.engine.variation) if rosa_on
            else None)
    scfg = ServeConfig(n_slots=2, max_len=24, rosa=rosa_on,
                       variation_seed=7 if rosa_on else None,
                       rosa_backend=backend or "ref")
    sched = Scheduler(get_smoke("qwen3-32b"), scfg,
                      params=params_from_reference(jsched.params),
                      chip=chip, device="cpu")
    rep = sched.run(reqs)
    got = {r: c.tokens for r, c in rep.completions.items()}
    want = {r: c.tokens for r, c in jrep.completions.items()}
    assert got == want
    assert (rep.ticks, rep.decode_steps, rep.prefill_chunks) == \
        (jrep.ticks, jrep.decode_steps, jrep.prefill_chunks)
    if rosa_on:
        assert {k: v.name for k, v in
                sched.program.plan.mapping_plan().items()} == \
            {k: v.name for k, v in
             jsched.program.plan.mapping_plan().items()}


@pytest.fixture(scope="module")
def fused_sched():
    scfg = ServeConfig(n_slots=2, max_len=24, prefill_chunk=4, rosa=True,
                       rosa_backend="fused", variation_seed=7,
                       collect_logits=True)
    # plan_cache=False: a module fixture runs before conftest points the
    # plan cache at its per-run directory
    return Scheduler(get_smoke("qwen3-32b"), scfg, device="cpu",
                     plan_cache=False)


def _staggered(vocab, n=5, seed=1):
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, int(rng.integers(3, 10))),
                    int(rng.integers(2, 8)), arrival=i) for i in range(n)]


def test_continuous_equals_sequential_oracle(fused_sched):
    """Through 2 slots with eviction and refill, each request's greedy
    stream equals decoding it alone (act_per_vector: no row coupling)."""
    s = fused_sched
    reqs = _staggered(s.cfg.vocab)
    rep = s.run(reqs, policy="continuous")
    seq = run_sequential(get_smoke("qwen3-32b"), s.scfg, s.params, reqs,
                         device="cpu")
    assert len({c.slot for c in rep.completions.values()}) == 2
    for rid, r in seq.items():
        comp = rep.completions[rid]
        assert comp.tokens == r["tokens"]
        for a, b in zip(comp.logits, r["logits"], strict=True):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_oneshot_and_sampling_invariants(fused_sched):
    s = fused_sched
    reqs = _staggered(s.cfg.vocab, n=4, seed=2)
    cont = s.run(reqs, policy="continuous")
    ones = s.run(reqs, policy="oneshot")
    assert {r: c.tokens for r, c in cont.completions.items()} == \
        {r: c.tokens for r, c in ones.completions.items()}
    assert ones.total_tokens == cont.total_tokens == \
        sum(r.max_new_tokens for r in reqs)
    hot = s.run(reqs, temperature=0.8)
    seq = run_sequential(get_smoke("qwen3-32b"), s.scfg, s.params, reqs,
                         temperature=0.8, device="cpu")
    assert {r: c.tokens for r, c in hot.completions.items()} == \
        {r: v["tokens"] for r, v in seq.items()}
    assert {e.tag for e in s.engine.ledger.events} == {"prefill", "decode"}


def test_slot_api_touches_one_row(cfg):
    c = T.init_cache(cfg, 3, 8)
    req = T.init_cache(cfg, 1, 8)
    req["layers"][0].fill_(1.0)
    req["pos"].fill_(5)
    before = [t.clone() for t in (*c["layers"], c["pos"])]
    write_slot(cfg, c, req, 1)
    assert to_np(c["pos"]).tolist() == [0, 5, 0]
    assert torch.all(c["layers"][0][:, 1] == 1)
    for t, b in zip((*c["layers"], c["pos"]), before):
        assert torch.equal(t[..., 0, :, :, :] if t.ndim == 5 else t[0],
                           b[..., 0, :, :, :] if b.ndim == 5 else b[0])
    got = read_slot(cfg, c, 1)
    assert torch.equal(got["layers"][0], req["layers"][0])
    evict_slot(cfg, c, 1)
    assert torch.count_nonzero(c["layers"][0]) == 0
    write_slot(cfg, c, req, 2, valid=False)
    assert torch.count_nonzero(c["pos"]) == 0


def test_other_families_raise():
    cfg = dataclasses.replace(get_smoke("qwen3-32b"), family="moe")
    with pytest.raises(NotImplementedError, match="moe"):
        build_model(cfg)
    with pytest.raises(NotImplementedError, match="not ported"):
        get_smoke("gemma3-12b")
