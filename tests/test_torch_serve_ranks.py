"""Serving across ranks under `SERVE_RULES` (`launch.steps.serve_layout` /
`make_serve_step`): `prefill` and `decode_step` of the dense, ssm, moe
and mla_moe families on the ranks of a (data, model) mesh, each rank
holding its 2-D shards of the weights (embed dims over "data", heads, KV
heads, MLP, experts and vocab over "model"), its rows of the batch and
its part of the cache.

The reference's partitioned steps come from ONE subprocess on four forced
host devices with the `enable_x64` alias of `test_torch_ref.reference`:
`jax.jit(bundle.prefill / bundle.decode_step, in_shardings=...)` under
`SERVE_RULES`, as its dry run builds them, on Auto-axis meshes (jax 0.9's
default Explicit axes refuse the model's `with_sharding_constraint`; a
(1, 4) mesh fails there, so the meshes are (2, 2) and (4, 1)), from the
port's initial params carried across as numpy.  Each case prefills a
prompt made from a numpy seed, pads the cache and decodes greedily.  The
reference also runs every case on one device and on both meshes: the
spread of its own layouts is the float-order floor.  Both sides keep the
cache in float32: a bfloat16 cache rounds K / V that the packages compute
in different float orders, and one rounding flips between them (ROADMAP
Queue 3), which is not the split's doing.  The port's side is
one `runtime.spawn` group of four gloo ranks on the CPU a mesh.

The long_500k-style cases (one row) show what `SERVE_RULES` makes of a
batch that cannot take "data": on (2, 2) the KV heads take "model" and
the cache's sequence stays whole (every suffix of its rule holds
"model"), the data ranks computing the same row; with one KV head the
sequence takes ("data", "model") while the query heads split over
"model" (`flash_decode` with every rank's queries gathered); on (4, 1)
the sequence takes the four data ranks.

qwen3-moe-smoke and deepseek-v2-smoke run with `moe_ep` off (their smoke
value: `moe_ref` on gathered routed experts, the shared experts split)
and on (`moe_ep_local` on the rank's experts, both packages alike), at
their smoke capacity factor: each rank drops the assignments its experts
cannot take, the reference's ranks the same ones (counted on both sides
around `_pack_local`).  Its drops depend on the rows a rank routes, so
an expert-parallel case's float-order floor is the spread of the same
model's `moe_ref` layouts.  deepseek-v2's latent cache, which has no
heads, lays its sequence over "model" on (2, 2) while its heads split
over "model": MLA's decode then gathers the query heads and combines
the slices with `flash_decode`'s statistics (`layers.seq_combine`).
"""

import contextlib
import dataclasses
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.distributed import runtime
from repro_torch.distributed.sharding import (P, SERVE_RULES, gather,
                                              local_shape, local_spec,
                                              param_shardings, shard_tree,
                                              use_sharding)
from repro_torch.launch import dryrun
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import MeshShape, make_test_mesh
from repro_torch.models import layers as L
from repro_torch.models.model import (ShapeSpec, build_model,
                                      params_from_reference)
from repro_torch.models.module import leaves, map_tree

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TIMEOUT = 480.0                  # seconds a group of ranks may take
S, MAX_LEN, STEPS = 12, 24, 4    # prompt, cache length, decode steps
MESHES = ((2, 2), (4, 1))
REF_LAYOUTS = ((1, 1), (2, 2), (4, 1))
# (arch, ModelConfig overrides, global batch): the served configs' smoke
# sizes (gemma3-smoke: layers 2 and 5 global, the others local), and the
# one-row long_500k-style cases
KEYS = [("qwen3-32b", (), 4), ("gemma3-12b", (), 4), ("mamba2-1.3b", (), 4),
        ("gemma3-12b", (), 1), ("gemma3-12b", (("n_kv_heads", 1),), 1)]
CASES = [(k, m) for k in KEYS[:3] for m in MESHES] + [
    (KEYS[3], (2, 2)), (KEYS[4], (2, 2)), (KEYS[3], (4, 1))]
# the MoE families, with moe_ep off (the smoke configs') and on
MOE_KEYS = [(a, ov, 4) for a in ("qwen3-moe-235b-a22b", "deepseek-v2-236b")
            for ov in ((), (("moe_ep", True),))]
MOE_CASES = [(k, m) for k in MOE_KEYS for m in MESHES]
KEYS += MOE_KEYS
CASES += MOE_CASES


def _id(key, mesh) -> str:
    arch, ov, b = key
    tag = "".join(f"-{k}{v}" for k, v in ov)
    return f"{arch}{tag}-b{b}-{mesh[0]}x{mesh[1]}"


def _cfg(key):
    arch, ov, _ = key
    return dataclasses.replace(get_smoke(arch), cache_dtype=torch.float32,
                               **dict(ov))


@pytest.fixture(scope="module")
def np_params() -> dict:
    return {key: map_tree(lambda t: t.numpy(), build_model(_cfg(key)).init(
        torch.Generator().manual_seed(0))) for key in dict.fromkeys(
            (a, ov, 1) for a, ov, _ in KEYS)}


def _tokens(key) -> np.ndarray:
    rng = np.random.default_rng(1)
    return rng.integers(0, _cfg(key).vocab, (key[2], S)).astype(np.int32)


# ---------------------------------------------------------------------------
# The reference's side: one subprocess, four forced host devices
# ---------------------------------------------------------------------------
REF_SCRIPT = r"""
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke
from repro.distributed.sharding import (SERVE_RULES, param_shardings,
                                        tree_shardings, use_sharding)
from repro.models.model import ShapeSpec, build_model, make_inputs, pad_cache
import repro.models.moe as MOE

inp = pickle.load(open(sys.argv[1], "rb"))
# each shard's dropped assignments of its expert-parallel MoE: local ones
# past capacity (its callback runs once a device inside the shard_map)
DROPS = []
_pack = MOE._pack_local


def _counting_pack(x2, w, ids, e_first, e_local, capacity):
    out = _pack(x2, w, ids, e_first, e_local, capacity)
    e = ids.reshape(-1) - e_first
    local = jnp.sum((e >= 0) & (e < e_local))
    jax.debug.callback(lambda n: DROPS.append(int(n)),
                       local - jnp.sum(out[2]))
    return out


MOE._pack_local = _counting_pack


def drops():
    jax.effects_barrier()
    n = sum(DROPS)
    DROPS.clear()
    return n
s, max_len, steps = inp["seq"], inp["max_len"], inp["steps"]


def host(tree):
    return jax.tree.map(lambda a: np.asarray(
        a, np.float32 if a.dtype == jnp.bfloat16 else a.dtype), tree)


out = {}
for (arch, ov, b), shape, tokens in inp["cases"]:
    cfg = dataclasses.replace(get_smoke(arch), cache_dtype=jnp.float32,
                              **dict(ov))
    bundle = build_model(cfg)
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    with use_sharding(mesh, SERVE_RULES):
        p_sh = param_shardings(bundle.skeleton, mesh, SERVE_RULES)
        params = jax.device_put(inp["params"][(arch, ov, 1)], p_sh)
        _, pax = make_inputs(cfg, ShapeSpec("p", "prefill", s, b))
        batch = {"tokens": jnp.asarray(tokens)}
        b_sh = tree_shardings(batch, pax, mesh, SERVE_RULES)
        drops()
        logits, cache = jax.jit(bundle.prefill,
                                in_shardings=(p_sh, b_sh))(params, batch)
        cache = pad_cache(cfg, cache, max_len - s)
        rec = {"prefill": np.asarray(logits), "cache0": host(cache),
               "drops": [drops()]}
        dbatch, dax = make_inputs(cfg, ShapeSpec("d", "decode", max_len, b))
        d_sh = tree_shardings(dbatch, dax, mesh, SERVE_RULES)
        step = jax.jit(bundle.decode_step, in_shardings=(p_sh, d_sh))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks, lgs = [np.asarray(tok)], []
        for i in range(steps):
            # laid out as the step takes them (a jitted step refuses a
            # committed argument laid out otherwise)
            logits, cache = step(params, jax.device_put(
                {"token": tok, "pos": cache["pos"], "cache": cache}, d_sh))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            lgs.append(np.asarray(logits))
            toks.append(np.asarray(tok))
        rec["drops"].append(drops())
        rec.update(decode=lgs, tokens=toks, cache=host(cache))
    out[((arch, ov, b), shape)] = rec
pickle.dump(out, open(sys.argv[2], "wb"))
print("OK")
"""


@pytest.fixture(scope="module")
def ref_run(np_params, tmp_path_factory):
    """The reference's subprocess, started first: it runs while the
    port's groups do."""
    d = tmp_path_factory.mktemp("serve_ranks_ref")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    src = {"params": np_params, "seq": S, "max_len": MAX_LEN,
           "steps": STEPS, "cases": [(k, m, _tokens(k)) for k in KEYS
                                     for m in REF_LAYOUTS]}
    (d / "in.pkl").write_bytes(pickle.dumps(src))
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                             str(d / "in.pkl"), str(d / "out.pkl")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_run, port):
    proc, d = ref_run
    so, se = proc.communicate(timeout=600)
    assert proc.returncode == 0, (so[-1000:], se[-3000:])
    return pickle.loads((d / "out.pkl").read_bytes())


# ---------------------------------------------------------------------------
# The port's side: four gloo ranks on the CPU, one group a mesh
# ---------------------------------------------------------------------------
def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _flat(tree))


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _flat(x)]
    return [tree]


def _whole(tree, specs, mesh):
    """A tree of local shards gathered whole by its spec tree, as numpy
    (float32 for bfloat16 leaves)."""
    if isinstance(tree, dict):
        return {k: _whole(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_whole(t, s, mesh)
                          for t, s in zip(tree, specs, strict=True))
    t = gather(tree, specs, mesh)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _rows(t, layout, mesh) -> np.ndarray:
    """Logits of this rank's rows gathered over the batch's ranks."""
    return gather(t, P(layout.batch_axes or None), mesh).numpy()


COUNTS = {"drops": 0, "mla_combines": 0}   # a rank's, counted


def _count_drops_and_combines() -> None:
    """Count this rank's dropped MoE assignments (the local ones
    `_pack_local` finds past capacity) and MLA's sequence-sharded
    combines (its `seq_combine` calls)."""
    from repro_torch.models import mla as MLA
    from repro_torch.models import moe as MOE
    pack, combine = MOE._pack_local, MLA.seq_combine

    def counting_pack(x2, w, ids, e_first, e_local, capacity):
        out = pack(x2, w, ids, e_first, e_local, capacity)
        e = ids.reshape(-1) - e_first
        COUNTS["drops"] += int(((e >= 0) & (e < e_local)).sum()
                               - out[2].sum())
        return out

    def counting_combine(*a, **k):
        COUNTS["mla_combines"] += 1
        return combine(*a, **k)
    MOE._pack_local, MLA.seq_combine = counting_pack, counting_combine


def _taken(name: str) -> int:
    n, COUNTS[name] = COUNTS[name], 0
    return n


def _serve(mesh, key, np_p: dict, rank: int) -> dict:
    """A case on this rank: the prefill, the cache laid out for decode,
    STEPS greedy decode steps; logits, tokens and caches gathered (rank
    0's returned), the rank's bytes, flash_decode's calls, its dropped
    MoE assignments (the prefill's, the steps') and MLA's combines."""
    cfg = _cfg(key)
    bundle = build_model(cfg)
    b = key[2]
    pl = ST.serve_layout(bundle, mesh, ShapeSpec("p", "prefill", S, b))
    dl = ST.serve_layout(bundle, mesh, ShapeSpec("d", "decode", MAX_LEN, b))
    params = shard_tree(params_from_reference(np_p), pl.specs, mesh)
    batch = pl.local_inputs({"tokens": torch.from_numpy(_tokens(key))})
    held = {"prefill": _nbytes(params) + _nbytes(batch)}
    _taken("drops")
    _taken("mla_combines")
    with torch.no_grad():
        logits, cache = ST.make_serve_step(bundle, pl)(params, batch)
        drops = [_taken("drops")]
        cache = dl.cache_from_prefill(cfg, cache)
        out = {"prefill": _rows(logits, pl, mesh),
               "cache0": _whole(cache, dl.inputs["cache"], mesh)}
        step = ST.make_serve_step(bundle, dl)
        tok = torch.argmax(logits, -1).to(torch.int32)
        toks, lgs = [_rows(tok, pl, mesh)], []
        calls = L.FLASH_DECODES["calls"]
        for i in range(STEPS):
            dbatch = {"token": tok, "pos": cache["pos"], "cache": cache}
            if i == 0:
                held["decode"] = _nbytes(params) + _nbytes(dbatch)
            logits, cache = step(params, dbatch)
            tok = torch.argmax(logits, -1).to(torch.int32)
            lgs.append(_rows(logits, dl, mesh))
            toks.append(_rows(tok, dl, mesh))
        out.update(decode=lgs, tokens=toks,
                   cache=_whole(cache, dl.inputs["cache"], mesh))
    out = out if rank == 0 else {}
    out.update(held=held, flash=L.FLASH_DECODES["calls"] - calls,
               kv_spec=tuple(dl.inputs["cache"]["layers"][0])
               if cfg.family != "ssm" else None,
               rows=pl.batch_axes, drops=drops + [_taken("drops")],
               mla_combines=_taken("mla_combines"))
    return out


NOISY_ARCHS = ("qwen3-32b", "deepseek-v2-236b")


def _noisy_engine(backend: str, arch: str):
    """An IS engine with per-shot noise on the activations and a pinned
    chip (chip 7: its lanes over each MLP projection's K, so a rank's
    `wo` rows read their own lanes; deepseek-v2's optical MLP is its
    `layer0`, of width `first_dense_ff`)."""
    from repro_torch import rosa
    from repro_torch.core import mrr
    from repro_torch.core.constants import Mapping
    from repro_torch.robust.variation import sample_chip
    from repro_torch.rosa.backends import RosaConfig
    cfg = get_smoke(arch)
    chip = sample_chip(torch.Generator().manual_seed(7),
                       {"mlp/wi": cfg.d_model,
                        "mlp/wo": cfg.first_dense_ff or cfg.d_ff})
    return rosa.Engine.from_config(
        RosaConfig(noise=mrr.PAPER_NOISE, mapping=Mapping.IS,
                   backend=backend),
        key=torch.Generator().manual_seed(3)).with_variation(chip)


@contextlib.contextmanager
def _float64():
    """Every op of the model in float64 (`Tensor.float()` made
    `double()` while the context is live)."""
    real = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        torch.Tensor.float = real


NOISY_B = 4


def _noisy_run(bundle, params, tokens, mesh=None):
    """An optical smoke model's prefill and STEPS decode steps
    teacher-forced with `tokens`' last column, one process (`mesh` None)
    or on this rank's shards: the logits (the rank's rows gathered)."""
    from repro_torch.models.model import pad_cache
    cfg = bundle.cfg
    b = tokens.shape[0]
    with torch.no_grad():
        if mesh is None:
            logits, cache = bundle.prefill(params, {"tokens": tokens})
            cache = pad_cache(cfg, cache, MAX_LEN - S)
            dec, rows = bundle.decode_step, (lambda t: t.numpy())
            feed = tokens
        else:
            pl = ST.serve_layout(bundle, mesh,
                                 ShapeSpec("p", "prefill", S, b))
            dl = ST.serve_layout(bundle, mesh,
                                 ShapeSpec("d", "decode", MAX_LEN, b))
            params = shard_tree(params, pl.specs, mesh)
            logits, cache = ST.make_serve_step(bundle, pl)(
                params, pl.local_inputs({"tokens": tokens}))
            cache = dl.cache_from_prefill(cfg, cache)
            dec = ST.make_serve_step(bundle, dl)
            feed = pl.local_inputs({"tokens": tokens})["tokens"]

            def rows(t):
                return _rows(t, dl, mesh)
        out = [rows(logits)]
        for i in range(STEPS):
            logits, cache = dec(params, {"token": feed[:, -1 - i],
                                         "pos": cache["pos"],
                                         "cache": cache})
            out.append(rows(logits))
    return np.stack(out)


def _noisy_inputs(arch: str):
    cfg = dataclasses.replace(get_smoke(arch), rosa_mlp=True)
    bundle = build_model(cfg)
    params = map_tree(lambda t: t.double(), bundle.init(
        torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (NOISY_B, S))
                              .astype(np.int32))
    return bundle, params, tokens


def _noisy(mesh) -> dict:
    """The noisy IS arm of each of NOISY_ARCHS on this mesh in float64,
    through the composed "ref" chain and the plain `rosa_fused` version:
    {arch: {backend: logits}}."""
    from repro_torch import rosa
    out = {}
    with _float64():
        for arch in NOISY_ARCHS:
            bundle, params, tokens = _noisy_inputs(arch)
            for backend in ("ref", "fused"):
                with rosa.engine_context(_noisy_engine(backend, arch)):
                    out.setdefault(arch, {})[backend] = _noisy_run(
                        bundle, params, tokens, mesh)
    return out


def serve_group(rank: int, world: int, device, shape, keys, np_params,
                extras: tuple) -> dict:
    torch.set_num_threads(1)
    _count_drops_and_combines()
    mesh = make_test_mesh(*shape)
    out = {"cases": {key: _serve(mesh, key, np_params[(*key[:2], 1)], rank)
                     for key in keys}}
    if "noisy" in extras:
        out["noisy"] = _noisy(mesh)
    return out


@pytest.fixture(scope="module")
def port(ref_run, np_params):
    """Both meshes' groups at once, beside the reference's subprocess."""
    from concurrent.futures import ThreadPoolExecutor
    groups = [(m, [k for k, mm in CASES if mm == m],
               ("noisy",) if m == (2, 2) else ()) for m in MESHES]

    def group(g):
        shape, keys, extras = g
        return runtime.spawn(serve_group, shape[0] * shape[1],
                             device_type="cpu", backend="gloo",
                             args=(shape, keys, np_params, extras),
                             timeout=TIMEOUT)
    with ThreadPoolExecutor(len(groups)) as ex:
        return dict(zip(MESHES, ex.map(group, groups)))


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------
def _spread(arrays) -> np.ndarray:
    a = np.stack([np.asarray(x, np.float64) for x in arrays])
    return a.max(0) - a.min(0)


def _close(got, want, runs, what):
    """Within 1e-5 of max|want| or 4x the reference layouts' spread of
    the largest entry, whichever is larger (the repo's float-order
    rule)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = max(1e-5 * float(np.abs(want).max()),
                4 * float(_spread(runs).max()))
    dev = float(np.abs(got - want).max())
    assert dev <= bound, (what, dev, bound)


def _cache_pairs(a, b, runs, prefix=""):
    if isinstance(a, dict):
        for k in sorted(a):
            yield from _cache_pairs(a[k], b[k], [r[k] for r in runs],
                                    f"{prefix}/{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            yield from _cache_pairs(x, y, [r[i] for r in runs],
                                    f"{prefix}/{i}")
    else:
        yield prefix, a, b, runs


def _floor_key(key):
    """The case whose reference layouts' spread is `key`'s float-order
    floor: an expert-parallel case's `moe_ref` twin (the experts' drops
    depend on the rows a layout gives a rank), else the case itself."""
    arch, ov, b = key
    return arch, tuple(kv for kv in ov if kv[0] != "moe_ep"), b


@pytest.mark.parametrize("key,mesh", CASES,
                         ids=[_id(k, m) for k, m in CASES])
def test_sharded_serving_matches_reference_sharded(ref, port, key, mesh):
    """The ranks' prefill and greedy decode steps against the reference's
    partitioned ones on the same mesh: the prefill's and every step's
    logits and every leaf of the cache (after the prefill, padded, and
    after the steps) within 1e-5 of max|.| or 4x the reference's own
    layouts' spread (one device, (2, 2), (4, 1)); the greedy tokens
    equal."""
    want = ref[(key, mesh)]
    runs = [ref[(_floor_key(key), m)] for m in REF_LAYOUTS]
    got = port[mesh][0]["cases"][key]
    _close(got["prefill"], want["prefill"], [r["prefill"] for r in runs],
           "prefill logits")
    for i in range(STEPS):
        _close(got["decode"][i], want["decode"][i],
               [r["decode"][i] for r in runs], f"step {i} logits")
    for t_got, t_want in zip(got["tokens"], want["tokens"], strict=True):
        np.testing.assert_array_equal(t_got, t_want)
    for name in ("cache0", "cache"):
        for path, a, b, rs in _cache_pairs(got[name], want[name],
                                           [r[name] for r in runs]):
            _close(a, b, rs, f"{name}{path}")


def _cell_overrides(key) -> dict:
    """The fields of a case's config that differ from the arch's full
    config (`dryrun.cell_bytes`' overrides)."""
    cfg, full = _cfg(key), get_config(key[0])
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "name" and getattr(cfg, f.name) != getattr(full,
                                                                    f.name)}


@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "4x1"])
def test_rank_bytes_equal_cell_bytes(port, mesh):
    """Each rank's params and inputs (the prompt; the token, cursor and
    cache of a decode step) are exactly `dryrun.cell_bytes` of the cell
    on that mesh at the cut shape with float32 params: 2-D weight shards,
    the rows over "data", the KV or SSM heads over "model", the cache's
    sequence over what is left."""
    shape = MeshShape(("data", "model"), mesh)
    for r in port[mesh]:
        for key, res in r["cases"].items():
            for kind, seq in (("prefill", S), ("decode", MAX_LEN)):
                want = dryrun.cell_bytes(
                    key[0], None, None, _cell_overrides(key), mesh=shape,
                    shape=ShapeSpec(kind, kind, seq, key[2]),
                    param_dtype=torch.float32)
                assert res["held"][kind] == want["argument_bytes"], \
                    (key, kind, res["held"], want)


def test_long_context_layouts_and_flash_decode(port):
    """The one-row cases' layouts: on (2, 2) the KV heads over "model"
    and the sequence whole (no flash_decode); with one KV head the
    sequence over ("data", "model"), `flash_decode` at every step of
    every layer with the query heads gathered; on (4, 1) the sequence
    over the four data ranks; no rank splits the row."""
    n = get_smoke("gemma3-12b").n_layers * STEPS
    for r in port[(2, 2)]:
        c = r["cases"][KEYS[3]]
        assert c["kv_spec"] == (None, None, None, "model") and c["flash"] == 0
        c = r["cases"][KEYS[4]]
        assert c["kv_spec"] == (None, None, ("data", "model")) \
            and c["flash"] == n
        assert c["rows"] == ()
    for r in port[(4, 1)]:
        c = r["cases"][KEYS[3]]
        assert c["kv_spec"] == (None, None, ("data", "model")) \
            and c["flash"] == n
        c = r["cases"][KEYS[0]]
        assert c["kv_spec"] == (None, "data") and c["flash"] == 0


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_noisy_optical_serving_equals_one_process(port, backend):
    """qwen3-32b-smoke's optical MLPs under a noisy IS engine (per-shot
    noise on the activations, chip 7 pinned) served on (2, 2): each rank
    reads the chip's lanes of its MLP columns and rows, draws its rows
    and MLP columns of the global activations' offsets and takes its
    full-scales over "data" and "model", so the prefill's and the decode
    steps' logits equal one process's, through the composed "ref" chain
    and the plain `rosa_fused` version.  Both sides in float64 within
    1e-10 of max|.|: in float32 the split's partial sums may flip one
    8-bit code, as in the train step."""
    from repro_torch import rosa
    arch = NOISY_ARCHS[0]
    with _float64():
        bundle, params, tokens = _noisy_inputs(arch)
        with rosa.engine_context(_noisy_engine(backend, arch)):
            want = _noisy_run(bundle, params, tokens)
    for r in port[(2, 2)]:
        got = r["noisy"][arch][backend]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("key,mesh", MOE_CASES,
                         ids=[_id(k, m) for k, m in MOE_CASES])
def test_moe_drops_equal_reference(ref, port, key, mesh):
    """The assignments the ranks' experts drop (the prefill's, then the
    decode steps'), summed over the ranks, equal those the reference's
    shards drop on the same mesh at the smoke capacity factor (each
    rank's capacity from its own rows' tokens); `moe_ref` drops none."""
    got = np.sum([r["cases"][key]["drops"] for r in port[mesh]],
                 axis=0).tolist()
    assert got == ref[(key, mesh)]["drops"]
    if not dict(key[1]).get("moe_ep"):
        assert got == [0, 0]


def test_expert_parallel_serving_drops_assignments(port):
    """The smoke capacity factor makes the expert-parallel cases drop
    assignments, so the drops above are held where they happen."""
    assert sum(sum(r["cases"][k]["drops"]) for k, m in MOE_CASES
               for r in port[m] if dict(k[1]).get("moe_ep")) > 0


def test_latent_cache_sequence_over_model_with_split_heads(port):
    """deepseek-v2-smoke on (2, 2): the latent cache's rows over "data"
    and its sequence over "model" while the MLA heads split over "model",
    so every layer's decode (`layer0`'s too) combines its slices at every
    step; on (4, 1) the rows take the four data ranks and the sequence
    stays whole."""
    n = get_smoke("deepseek-v2-236b").n_layers * STEPS
    for key in MOE_KEYS[2:]:
        for r in port[(2, 2)]:
            c = r["cases"][key]
            assert c["kv_spec"] == (None, "data", "model")
            assert c["mla_combines"] == n and c["flash"] == 0
        for r in port[(4, 1)]:
            c = r["cases"][key]
            assert c["kv_spec"] == (None, "data") and c["mla_combines"] == 0
    for r in port[(2, 2)]:
        assert r["cases"][MOE_KEYS[0]]["kv_spec"] == (None, "data", None,
                                                      "model")


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_noisy_optical_layer0_serving_equals_one_process(port, backend):
    """deepseek-v2-smoke's optical `layer0` FFN (its d_ff split over
    "model", `ProductSplit`) beside its MLA and MoE layers, under the
    noisy IS engine with chip 7 pinned over layer 0's projections, served
    on (2, 2): the prefill's and the decode steps' logits equal one
    process's in float64 within 1e-10 of max|.|."""
    from repro_torch import rosa
    arch = NOISY_ARCHS[1]
    with _float64():
        bundle, params, tokens = _noisy_inputs(arch)
        with rosa.engine_context(_noisy_engine(backend, arch)):
            want = _noisy_run(bundle, params, tokens)
    for r in port[(2, 2)]:
        got = r["noisy"][arch][backend]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-10 * np.abs(want).max())


def test_moe_serve_layouts_ep_choice_and_latent_spec():
    """Under `SERVE_RULES` on (2, 2) and (4, 1) the expert-parallel
    choice is the reference's `_ffn_apply`'s: FSDP over "data", no
    all-to-all (the rows are over "data" only); the experts lie over
    "model" and their d_model over "data", the router over "data"; a
    rank's latent cache slice resolves to (cache_batch, cache_seq)
    with the sequence live in the context."""
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_smoke("deepseek-v2-236b"), moe_ep=True)
    bundle = build_model(cfg)
    for shape, x_rows, latent, kv in (((2, 2), 2, (2, MAX_LEN // 2, 16),
                                       P("data", "model")),
                                      ((4, 1), 1, (1, MAX_LEN, 16),
                                       P("data"))):
        mesh = MeshShape(("data", "model"), shape)
        lay = ST.serve_layout(bundle, mesh,
                              ShapeSpec("d", "decode", MAX_LEN, 4))
        ffn = lay.specs["layers"]["ffn"]
        m = "model" if shape[1] > 1 else None
        assert ffn["wi"] == P(None, m, "data")
        assert ffn["wo"] == P(None, m, None, "data")
        assert ffn["router"] == P(None, "data")
        assert lay.sizes == {"batch": 4, "cache_batch": 4,
                             "cache_seq": MAX_LEN}
        with use_sharding(mesh, SERVE_RULES, lay.sizes) as ctx:
            assert T.ep_choice(cfg, ctx, (x_rows, 1, cfg.d_model)) \
                == (("data",), False)
            assert local_spec(ctx, latent, L.LATENT_AXES) == kv


def test_serve_layout_refuses_an_expert_layout_moe_ep_local_cannot_take():
    """With `moe_ep`, experts that do not divide over "model" and shared
    experts whose d_ff does not are refused, naming the leaf.  A d_model
    that does not divide over "data" is no refusal: the layout leaves the
    experts' d_model whole as `ep_choice` (the reference's `_ffn_apply`)
    drops their FSDP, and the two agree."""
    from repro_torch.models import transformer as T
    base = dataclasses.replace(get_smoke("deepseek-v2-236b"), moe_ep=True)

    def experts(n):
        return dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, n_experts=n))
    dec = ShapeSpec("d", "decode", MAX_LEN, 3)
    with pytest.raises(ValueError, match="moe_ep: wi is laid out"):
        ST.serve_layout(build_model(experts(6)),
                        MeshShape(("data", "model"), (1, 4)), dec)
    with pytest.raises(ValueError, match="moe_ep: shared_wi is laid out"):
        ST.serve_layout(build_model(experts(6)),
                        MeshShape(("data", "model"), (1, 3)), dec)
    mesh = MeshShape(("data", "model"), (3, 2))
    lay = ST.serve_layout(build_model(base), mesh, dec)
    assert lay.specs["layers"]["ffn"]["wi"] == P(None, "model")
    with use_sharding(mesh, SERVE_RULES, lay.sizes) as ctx:
        assert T.ep_choice(base, ctx, (1, 1, base.d_model)) == ((), False)


def test_serve_layout_specs_and_context_sizes():
    """The layout's params are `param_shardings` under `SERVE_RULES` (the
    embed dims over "data", heads, KV heads, MLP and vocab over
    "model"); its inputs' the batch's rows over "data" and the cache's KV
    heads over "model"; `local_spec` resolves a rank's cache slice with
    cache_batch, kv_heads and cache_seq all live in the context."""
    bundle = build_model(get_smoke("qwen3-32b"))
    mesh = MeshShape(("data", "model"), (2, 2))
    lay = ST.serve_layout(bundle, mesh, ShapeSpec("d", "decode", MAX_LEN, 4))
    want = map_tree(lambda sh: sh.spec, param_shardings(
        bundle.skeleton, mesh, SERVE_RULES))
    assert lay.specs == want
    assert lay.specs["layers"]["attn"]["wq"] == P(None, "data", "model")
    assert lay.specs["layers"]["ffn"]["wi"] == P(None, "data", None, "model")
    assert lay.specs["embed"] == P("model", "data")
    assert lay.inputs["cache"]["layers"][0] == P(None, "data", None, "model")
    assert lay.batch_axes == ("data",)
    assert lay.sizes == {"batch": 4, "cache_batch": 4, "cache_seq": MAX_LEN,
                         "kv_heads": 2}
    with use_sharding(mesh, SERVE_RULES, lay.sizes) as ctx:
        assert local_spec(ctx, (2, MAX_LEN, 1, 16), L.KV_AXES) \
            == P("data", None, "model")
    one = ST.serve_layout(build_model(_cfg(KEYS[4])), mesh,
                          ShapeSpec("d", "decode", MAX_LEN, 1))
    with use_sharding(mesh, SERVE_RULES, one.sizes) as ctx:
        assert local_spec(ctx, (1, MAX_LEN // 4, 1, 16), L.KV_AXES) \
            == P(None, ("data", "model"))
        with pytest.raises(ValueError, match="not 24 over 4 devices"):
            local_spec(ctx, (1, MAX_LEN, 1, 16), L.KV_AXES)


def test_serve_layout_refuses_what_does_not_divide():
    """A global batch of more than one row that does not divide over the
    data ranks, SSM heads whose share straddles their groups, and a
    family not served across ranks are refused, naming the dim."""
    mesh = MeshShape(("data", "model"), (4, 1))
    bundle = build_model(get_smoke("qwen3-32b"))
    for kind, dim in (("prefill", "batch"), ("decode", "cache_batch")):
        with pytest.raises(ValueError, match=f"{dim}: global batch 6 does "
                           "not divide over the 4 ranks"):
            ST.serve_layout(bundle, mesh, ShapeSpec(kind, kind, 16, 6))
    assert ST.serve_layout(bundle, mesh, ShapeSpec(
        "d", "decode", 16, 1)).batch_axes == ()
    ssm = dataclasses.replace(get_smoke("mamba2-1.3b").ssm, expand=3,
                              n_groups=3)
    cfg = dataclasses.replace(get_smoke("mamba2-1.3b"), ssm=ssm)
    with pytest.raises(ValueError, match="heads: 6 SSM heads a rank "
                       "straddle the groups of 4"):
        ST.serve_layout(build_model(cfg), MeshShape(("data", "model"),
                                                    (1, 2)),
                        ShapeSpec("p", "prefill", 16, 2))
    with pytest.raises(NotImplementedError, match="not 'hybrid'"):
        ST.serve_layout(build_model(get_smoke("zamba2-1.2b")), mesh,
                        ShapeSpec("p", "prefill", 16, 4))


def test_cell_bytes_on_a_small_mesh_and_a_cut_shape():
    """`cell_bytes` takes a (data, model) mesh, a cut shape and float32
    params: the params at the serve layout's shard bytes, the cache's K /
    V over the rows' and the KV heads' ranks; the production mesh's
    figures as before."""
    mesh = MeshShape(("data", "model"), (2, 2))
    shape = ShapeSpec("d", "decode", 32768, 8)
    rec = dryrun.cell_bytes("qwen3-32b", None, None, {"n_layers": 2},
                            mesh=mesh, shape=shape,
                            param_dtype=torch.float32)
    bundle = build_model(dataclasses.replace(get_config("qwen3-32b"),
                                             n_layers=2))
    lay = ST.serve_layout(bundle, mesh, shape)
    assert rec["n_devices"] == 4 and rec["n_params"] == bundle.n_params
    spec_of = dict(leaves(lay.specs))
    assert rec["params_bytes"] == sum(
        math.prod(local_shape(d.shape, spec_of[p], mesh)) * 4
        for p, d in leaves(bundle.skeleton))
    assert bundle.n_params < rec["params_bytes"] < bundle.n_params * 4 // 2
    kv = 2 * 2 * 8 * 32768 * 8 * 128 * 2 // 4     # rows / 2, KV heads / 2
    # the token, the cursor and the cache's own cursor: 4 rows of int32
    assert rec["batch_bytes"] == kv + 3 * (8 // 2) * 4
    prod = dryrun.cell_bytes("qwen3-32b", "decode_32k", "single")
    assert prod["n_devices"] == 256


@pytest.mark.parametrize("b,c,h,kv", [(2, 1, 8, 2), (3, 4, 4, 1),
                                      (1, 1, 4, 4), (2, 3, 6, 3)])
def test_grouped_attention_equals_repeated_kv(b, c, h, kv):
    """`attention_core`, each KV head serving its query heads in place,
    equals the plain attention over copies of the KV heads repeated to
    one a query head (a bfloat16 cache, masked keys, chunks of c tokens),
    within float order."""
    g = torch.Generator().manual_seed(b * 100 + c * 10 + h)
    s, d = 24, 8
    q = torch.randn(b, c, h, d, generator=g)
    k, v = (torch.randn(b, s, kv, d, generator=g).bfloat16()
            for _ in "kv")
    bias = torch.where(torch.rand(b, c, s, generator=g) > 0.3, 0.0,
                       L.NEG_INF)
    kr, vr = (torch.repeat_interleave(t.float(), h // kv, dim=2)
              for t in (k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kr) * d ** -0.5
    want = torch.einsum("bhqk,bkhd->bqhd",
                        torch.softmax(scores + bias[:, None], dim=-1), vr)
    got = L.attention_core(q, k, v, bias)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("shape,axis,chunk", [
    ((4, 6, 5), 1, 7), ((4, 6, 5), 0, 7), ((4, 6, 5), 2, 7),
    ((3, 2, 50), 1, 64), ((5, 8), 1, 1 << 20), ((2, 0, 3), 1, 7)])
def test_card_gather_writes_each_rank_block_in_place(monkeypatch, shape,
                                                     axis, chunk):
    """The card buffers' gather (gloo ranks sharing one card) writes each
    member's part straight into its place of the result, in blocks of
    whole rows or pieces of one row (chunks of a few elements here): the
    result equals the parts concatenated in rank order.  Three members
    run as threads, the buffers' exchange a shared list and a barrier."""
    import threading
    n = 3
    barrier = threading.Barrier(n, timeout=30)
    slots: list = [None] * n
    me = threading.local()
    monkeypatch.setattr(runtime, "_CHUNK_BYTES", chunk * 4)
    monkeypatch.setattr(runtime, "_group_ranks",
                        lambda group: (list(range(n)), me.rank))

    def exchange(piece, group):
        slots[me.rank] = piece.clone()
        barrier.wait()
        return list(slots), me.rank
    monkeypatch.setattr(runtime, "_exchange", exchange)
    monkeypatch.setattr(runtime, "_done", lambda piece, group: barrier.wait())
    xs = [torch.randn(shape, generator=torch.Generator().manual_seed(r))
          for r in range(n)]
    got: list = [None] * n

    def run(r):
        me.rank = r
        got[r] = runtime._card_gather(xs[r], None, axis)
    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for g in got:
        assert torch.equal(g, torch.cat(xs, dim=axis))
