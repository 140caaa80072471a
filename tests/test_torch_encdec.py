"""Port parity of the encdec family (seamless-m4t-medium: a bidirectional
encoder over the audio frontend's frame embeddings, decoder layers with
cross attention) and of the fixed-batch `--policy batch` path against the
JAX reference, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; source
embeddings are rounded to bfloat16 on both sides, as the serving CLI
feeds them.

  * attention: causal, bidirectional (the encoder's: RoPE, no mask) and
    cross (K/V from the memory, no RoPE, masked by `memory_pos` only) at
    GQA widths, and the cross branch of `attn_decode` reading a bfloat16
    cache: within 1e-5 of max|ref|;
  * the encoder runs in the parameter dtype whatever the input's;
  * seamless-smoke: prefill logits, a chunk step, then `pad_cache` and 4
    decode steps within 1e-4 of max|ref| with the argmax equal; the
    bfloat16 caches within one bfloat16 step (2^-8) of their max (a
    float32 value within float noise of a rounding boundary may round the
    other way), `memory_pos` equal;
  * `cache_axes`, `init_cache(src_len=)` and `pad_cache` (only the self
    cache grows) equal the reference's; the slot API touches one row;
  * `--policy batch`: greedy tokens equal the reference's
    `make_sampling_decode_step` loop on the same prompt and source
    embeddings; the sampling step; the CLI end to end;
  * serving refuses the family (`serving_model_config`), as the
    reference does.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.steps import make_sampling_decode_step
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import (build_model, cache_axes, evict_slot,
                                      pad_cache, params_from_reference,
                                      read_slot, write_slot)
from repro_torch.serve import Scheduler, ServeConfig, serving_model_config
from test_torch_ref import (assert_caches_match, assert_logits_match,
                            cache_leaves, reference, rel_err, to_np)

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "seamless-m4t-medium"


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
    return R.model.build_model(R.configs.get_smoke(ARCH)).init(
        R.jax.random.PRNGKey(0))


def _src(R, b, s, d, seed):
    """Source embeddings rounded to bfloat16 in both packages."""
    x = np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)
    return (torch.from_numpy(x).to(torch.bfloat16),
            R.jnp.asarray(x).astype(R.jnp.bfloat16))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def _attn_params(cfg: L.AttnConfig, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for name, d in L.attn_def(cfg).items():
        a = (np.ones(d.shape) if d.init == "ones"
             else rng.normal(size=d.shape) * d.std)
        out[name] = a.astype(np.float32)
    return out


ATTN = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
            rope_theta=1e4)


@pytest.mark.parametrize("kind", ["causal", "bidirectional", "cross",
                                  "cross_qk_norm"])
def test_attn_apply_matches_reference(R, kind):
    kw = dict(ATTN, qk_norm=kind.endswith("qk_norm"),
              causal=kind == "causal", cross=kind.startswith("cross"))
    cfg, jcfg = L.AttnConfig(**kw), R.layers.AttnConfig(**kw)
    p = _attn_params(cfg, 1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    mem = rng.normal(size=(2, 5, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7), (2, 7)).astype(np.int32)
    mpos = np.broadcast_to(np.arange(5), (2, 5)).astype(np.int32)
    t = torch.from_numpy
    got = L.attn_apply({k: t(v) for k, v in p.items()}, cfg, t(x),
                       t(pos.copy()), memory=t(mem),
                       memory_pos=t(mpos.copy()))
    jnp = R.jnp
    want = R.layers.attn_apply({k: jnp.asarray(v) for k, v in p.items()},
                               jcfg, jnp.asarray(x), jnp.asarray(pos),
                               memory=jnp.asarray(mem),
                               memory_pos=jnp.asarray(mpos))
    assert rel_err(got, want) <= 1e-5


def test_cross_decode_reads_the_static_cache(R):
    kw = dict(ATTN, cross=True, causal=False)
    cfg, jcfg = L.AttnConfig(**kw), R.layers.AttnConfig(**kw)
    p = _attn_params(cfg, 3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 2, 32)).astype(np.float32)
    kv = [rng.normal(size=(2, 5, 2, 8)).astype(np.float32) for _ in "kv"]
    mpos = np.broadcast_to(np.arange(5), (2, 5)).astype(np.int32)
    cache = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in kv)
    jnp = R.jnp
    out, back = L.attn_decode({k: torch.from_numpy(v) for k, v in p.items()},
                              cfg, torch.from_numpy(x), cache,
                              torch.tensor([3, 6], dtype=torch.int32),
                              memory_pos=torch.from_numpy(mpos.copy()))
    want, _ = R.layers.attn_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(x),
        tuple(jnp.asarray(a).astype(jnp.bfloat16) for a in kv),
        jnp.asarray([3, 6], jnp.int32), memory_pos=jnp.asarray(mpos))
    assert rel_err(out, want) <= 1e-5
    assert back is cache


def test_cache_write_differs_from_uniform_reference_only_off_its_contract(R):
    """The reference's uniform path (a dynamic-update-slice at pos[0])
    equals the port's `cache_write` while the rows share a position inside
    the cache; past the end it clamps onto the last slot where the port
    drops the write, and for ragged rows it writes every row at pos[0]
    where the port writes each at its own position, as the reference's
    ragged path does."""
    jnp = R.jnp
    cache = np.zeros((2, 4, 1), np.float32)
    new = np.array([[[1.0]], [[2.0]]], np.float32)

    def both(pos):
        got = L.cache_write(torch.from_numpy(cache.copy()),
                            torch.from_numpy(new),
                            torch.tensor(pos, dtype=torch.int32))
        return [to_np(got)] + [to_np(R.layers.cache_write(
            jnp.asarray(cache), jnp.asarray(new),
            jnp.asarray(pos, jnp.int32), u)) for u in (True, False)]

    port, uniform, ragged = both([2, 2])
    np.testing.assert_array_equal(port, uniform)
    np.testing.assert_array_equal(port, ragged)
    port, uniform, ragged = both([4, 4])          # past the end
    assert not port.any() and not ragged.any()
    assert uniform[:, 3, 0].tolist() == [1.0, 2.0]
    port, uniform, ragged = both([1, 3])          # ragged rows
    np.testing.assert_array_equal(port, ragged)
    assert uniform[1, 1, 0] == 2.0 and port[1, 3, 0] == 2.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_reference_in_param_dtype(R, ref_params, dtype):
    cfg = get_smoke(ARCH)
    p = params_from_reference(ref_params)
    x = np.random.default_rng(5).normal(size=(2, 9, cfg.d_model))
    x = x.astype(np.float32)
    src = torch.from_numpy(x).to(getattr(torch, dtype))
    jsrc = R.jnp.asarray(x).astype(getattr(R.jnp, dtype))
    mem = T._encode(p, cfg, {"src_embeds": src})
    jmem = R.transformer._encode(ref_params, R.configs.get_smoke(ARCH),
                                 {"src_embeds": jsrc})
    assert mem.dtype == torch.float32 and str(jmem.dtype) == "float32"
    assert rel_err(mem, jmem) <= 1e-5


# ---------------------------------------------------------------------------
# The whole model at seamless-smoke
# ---------------------------------------------------------------------------
def test_prefill_chunk_and_decode_match_reference(R, ref_params):
    # ragged rows after the chunk: the scatter cache writes of serving
    cfg = dataclasses.replace(get_smoke(ARCH), uniform_decode=False)
    jcfg = dataclasses.replace(R.configs.get_smoke(ARCH),
                               uniform_decode=False)
    p, jp, jnp = params_from_reference(ref_params), ref_params, R.jnp
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (2, 13)).astype(
        np.int32)
    src, jsrc = _src(R, 2, 9, cfg.d_model, 3)
    lg, cache = T.prefill(p, cfg, {"tokens": torch.from_numpy(tok[:, :9]),
                                   "src_embeds": src})
    jlg, jc = R.transformer.prefill(jp, jcfg, {
        "tokens": jnp.asarray(tok[:, :9]), "src_embeds": jsrc})
    assert_logits_match(lg, jlg)
    assert_caches_match(cache, jc)
    cache, jc = pad_cache(cfg, cache, 8), R.model.pad_cache(jcfg, jc, 8)
    # a ragged chunk of 4 (3 and 1 real tokens) against the padded cache
    n_valid = np.array([3, 1], np.int32)
    lg, cache = T.chunk_step(p, cfg, {
        "tokens": torch.from_numpy(tok[:, 9:]),
        "n_valid": torch.from_numpy(n_valid), "cache": cache})
    jlg, jc = R.transformer.chunk_step(jp, jcfg, {
        "tokens": jnp.asarray(tok[:, 9:]), "n_valid": jnp.asarray(n_valid),
        "cache": jc})
    assert_logits_match(lg, jlg)
    np.testing.assert_array_equal(to_np(cache["pos"]), [12, 10])
    for step in range(4):
        t = np.array([step + 3, 250 - step], np.int32)
        lg, cache = T.decode_step(p, cfg, {"token": torch.from_numpy(t),
                                           "pos": cache["pos"],
                                           "cache": cache})
        jlg, jc = R.transformer.decode_step(jp, jcfg, {
            "token": jnp.asarray(t), "pos": jc["pos"], "cache": jc})
        assert_logits_match(lg, jlg)
    assert_caches_match(cache, jc)


def test_decoder_reads_the_memory(R, ref_params):
    """Zero source embeddings change the logits (a decoder that never
    reads the memory would not)."""
    cfg = get_smoke(ARCH)
    p = params_from_reference(ref_params)
    tok = torch.tensor([[5, 9, 200, 31]], dtype=torch.int32)
    src, _ = _src(R, 1, 6, cfg.d_model, 7)
    lg, _ = T.prefill(p, cfg, {"tokens": tok, "src_embeds": src})
    lz, _ = T.prefill(p, cfg, {"tokens": tok,
                               "src_embeds": torch.zeros_like(src)})
    assert rel_err(lz, lg) > 1e-2


def test_vision_frontend_is_not_ported():
    """Once refused; since slice 11 the vision frontend prepends the patch
    embeddings (cast to the embedding dtype) to the token embeddings, and
    positions run over both: the cache holds S_img + S_tok positions."""
    cfg = dataclasses.replace(get_smoke("qwen3-32b"), frontend="vision")
    bundle = build_model(cfg)
    p = bundle.init(torch.Generator().manual_seed(0))
    tok = torch.tensor([[5, 9, 200]], dtype=torch.int32)
    img = torch.randn(1, 4, cfg.d_model,
                      generator=torch.Generator().manual_seed(1))
    x, pos = T._embed_in(p, cfg, {"tokens": tok,
                                  "patch_embeds": img.to(torch.bfloat16)})
    assert x.dtype == p["embed"].dtype and x.shape == (1, 7, cfg.d_model)
    assert torch.equal(x[:, :4], img.to(torch.bfloat16).float())
    assert torch.equal(x[:, 4:], p["embed"][tok])
    assert torch.equal(pos, torch.arange(7)[None])
    lg, cache = T.prefill(p, cfg, {"tokens": tok, "patch_embeds": img})
    assert cache["layers"][0].shape[2] == 7 and int(cache["pos"][0]) == 7
    text, _ = T.prefill(p, dataclasses.replace(cfg, frontend="none"),
                        {"tokens": tok})
    assert rel_err(lg, text) > 1e-3


# ---------------------------------------------------------------------------
# Cache axes and the slot API
# ---------------------------------------------------------------------------
def test_cache_axes_init_and_pad_cache_equal_reference(R):
    cfg, jcfg = get_smoke(ARCH), R.configs.get_smoke(ARCH)
    assert cache_axes(cfg) == R.model.cache_axes(jcfg)
    shapes = lambda tree: [(p, tuple(t.shape), str(t.dtype).split(".")[-1])
                           for p, t in cache_leaves(tree)]
    for src_len in (0, 5):
        c = T.init_cache(cfg, 3, 8, src_len=src_len)
        jc = R.transformer.init_cache(jcfg, 3, 8, src_len=src_len)
        assert shapes(c) == shapes(jc)
        np.testing.assert_array_equal(to_np(c["memory_pos"]),
                                      to_np(jc["memory_pos"]))
    grown = pad_cache(cfg, c, 5)
    assert shapes(grown) == shapes(R.model.pad_cache(jcfg, jc, 5))
    got = {p: shape for p, shape, _ in shapes(grown)}
    assert got["/layers/self/0"][2] == 13 and got["/layers/cross/0"][2] == 5
    assert got["/memory_pos"] == (3, 5)


def test_slot_api_touches_one_row():
    cfg = get_smoke(ARCH)
    c = T.init_cache(cfg, 3, 8, src_len=5)
    req = T.init_cache(cfg, 1, 8, src_len=5)
    axes = cache_axes(cfg)
    pairs = [(c["layers"][k][i], axes["layers"][k][i])
             for k in ("cross", "self") for i in (0, 1)]
    pairs += [(c["memory_pos"], axes["memory_pos"]), (c["pos"], axes["pos"])]
    for _, t in cache_leaves(req):
        t.fill_(1)
    c["memory_pos"].zero_()
    before = [t.clone() for t, _ in pairs]
    write_slot(cfg, c, req, 1)
    for (t, a), b in zip(pairs, before, strict=True):
        ax = a.index("cache_batch")
        assert torch.all(t.select(ax, 1) == 1)
        for other in (0, 2):
            assert torch.equal(t.select(ax, other), b.select(ax, other))
    for (_, a), (_, b) in zip(cache_leaves(read_slot(cfg, c, 1)),
                              cache_leaves(req), strict=True):
        assert torch.equal(a, b)
    evict_slot(cfg, c, 1)
    assert all(torch.count_nonzero(t) == 0 for t, _ in pairs)


# ---------------------------------------------------------------------------
# --policy batch
# ---------------------------------------------------------------------------
def test_batch_policy_greedy_tokens_equal_reference(R, ref_params):
    """`generate` (prefill, pad_cache(gen + 1), gen - 1 sampling steps at
    temperature 0) against the reference's loop over
    `make_sampling_decode_step` on the same prompt and source."""
    cfg, jcfg = get_smoke(ARCH), R.configs.get_smoke(ARCH)
    b, s, gen = 3, 8, 6
    tok = np.random.default_rng(9).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)
    src, jsrc = _src(R, b, s, cfg.d_model, 10)
    res = serve_cli.generate(
        build_model(cfg), params_from_reference(ref_params),
        {"tokens": torch.from_numpy(tok), "src_embeds": src}, gen, 0.0,
        torch.Generator().manual_seed(0))

    jnp, jax = R.jnp, R.jax
    jbundle = R.model.build_model(jcfg)
    logits, cache = jbundle.prefill(ref_params, {"tokens": jnp.asarray(tok),
                                                 "src_embeds": jsrc})
    cache = R.model.pad_cache(jcfg, cache, gen + 1)
    step = R.steps.make_sampling_decode_step(jbundle)
    t, key = jnp.argmax(logits, -1), jax.random.PRNGKey(0)
    want = [t]
    for _ in range(gen - 1):
        t, cache, key = step(ref_params, t, cache, 0.0, key)
        want.append(t)
    assert_logits_match(res["logits"], logits)
    assert res["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(to_np(res["tokens"]),
                                  np.stack([to_np(w) for w in want], 1))
    assert res["cache"]["layers"]["self"][0].shape[2] == s + gen + 1
    assert res["cache"]["layers"]["cross"][0].shape[2] == s


def test_sampling_step(ref_params):
    """Greedy at temperature 0; above it a draw that the generator
    decides: the same seed gives the same tokens."""
    cfg = get_smoke(ARCH)
    bundle = build_model(cfg)
    p = params_from_reference(ref_params)
    step = make_sampling_decode_step(bundle)

    def run(temperature, seed):
        cache = T.init_cache(cfg, 2, 8, src_len=4)
        tok = torch.tensor([3, 7], dtype=torch.int32)
        g = torch.Generator().manual_seed(seed)
        out = []
        for _ in range(4):
            tok, cache, g = step(p, tok, cache, temperature, g)
            out.append(tok)
        return torch.stack(out, 1)

    greedy = run(0.0, 0)
    assert torch.equal(greedy, run(0.0, 1))
    hot = run(0.7, 5)
    assert hot.dtype == torch.int32 and torch.equal(hot, run(0.7, 5))
    assert bool(((hot >= 0) & (hot < cfg.vocab)).all())


@pytest.mark.parametrize("temperature", ["0.0", "0.7"])
def test_serve_cli_batch_policy_on_cpu(capsys, temperature):
    res = serve_cli.run_batch(serve_cli.build_parser().parse_args([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--policy", "batch",
        "--batch", "2", "--prompt-len", "6", "--gen", "5",
        "--temperature", temperature]))
    out = capsys.readouterr().out
    assert "arch=seamless-smoke layers=2" in out and "tok/s" in out
    assert f"sample token ids: {res['tokens'][0].tolist()}" in out
    assert res["tokens"].shape == (2, 5)
    assert res["batch"]["src_embeds"].dtype == torch.bfloat16
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--policy", "batch", "--gen", "3"])
    assert "decoded 3 tokens x 4 seqs" in capsys.readouterr().out


def test_serving_refuses_encdec(R):
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        serving_model_config(get_smoke(ARCH))
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        R.serve.serving_model_config(R.configs.get_smoke(ARCH))
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        Scheduler(get_smoke(ARCH), ServeConfig(), device="cpu")


def test_full_width_param_count_equals_reference(R):
    """seamless-m4t-medium at full width and depth (chip_smoke.py phase
    15(b)): 12 + 12 layers, vocab 256206, untied."""
    cfg, jcfg = get_config(ARCH), R.configs.get_config(ARCH)
    bundle = build_model(cfg)
    assert bundle.n_params == R.model.build_model(jcfg).n_params \
        == 977_758_208
    assert sorted(bundle.skeleton) == sorted(
        R.model.build_model(jcfg).skeleton) == [
            "embed", "encoder", "final_norm", "layers", "unembed"]
    assert bundle.skeleton["layers"]["cross"]["wk"].shape == (12, 1024, 16,
                                                             64)
