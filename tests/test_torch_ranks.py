"""Serving across ranks (`repro_torch.distributed.runtime`): the port's
collectives, the slot-sharded Scheduler and `launch.serve --devices`,
`flash_decode` over a sequence-sharded KV cache and the expert-parallel
`moe_ep_local`, each on several gloo ranks on the CPU.

The port's side runs in processes of its own (`runtime.spawn`, a timeout
on every group: a rank that dies fails the test rather than hanging it).
The reference's sharded results come from one subprocess with forced host
devices (`XLA_FLAGS=--xla_force_host_platform_device_count=4`) and the
`enable_x64` alias of `test_torch_ref.reference`, fed the same numpy
inputs made from a seed.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.distributed import runtime
from repro_torch.distributed.sharding import (SERVE_RULES, ep_param_specs,
                                              shard_local, use_sharding)
from repro_torch.launch.mesh import MeshShape, make_test_mesh
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.model import params_from_reference
from repro_torch.models.module import map_tree
from test_torch_ref import reference, to_np

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TIMEOUT = 240.0                  # seconds a group of ranks may take

# flash_decode at tests/test_flash_decode.py's shapes
FD = dict(B=2, S=64, H=4, KV=2, D=8, pos=40)
# the MoE block: 8 experts, top 2, one shared expert, capacity 1.25
MOE_CFG = dict(n_experts=8, top_k=2, d_model=16, d_ff=8, n_shared=1,
               capacity_factor=1.25)
MOE_X = (8, 6)                   # batch x tokens
ZERO3_RULES = dict(SERVE_RULES, batch=("pod", "data", "model"))
# (mesh, a2a): the tokens' spec over the mesh, the FSDP axes ("data")
MOE_CASES = [((1, 4), False), ((1, 4), True), ((2, 2), False),
             ((2, 2), True)]


def _np_params(skel, rng) -> dict:
    from repro_torch.models.module import leaves
    out: dict = {}
    for path, d in leaves(skel):
        a = (np.ones(d.shape, np.float32) if d.init == "ones" else
             (rng.normal(size=d.shape) * d.std).astype(np.float32))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return out


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    b, s, h, kv, d = (FD[k] for k in ("B", "S", "H", "KV", "D"))
    moe = _np_params(MOE.moe_def(MOE.MoEConfig(**MOE_CFG)), rng)
    return {
        "q": rng.normal(size=(b, 1, h, d)).astype(np.float32),
        "kc": rng.normal(size=(b, s, kv, d)).astype(np.float32),
        "vc": rng.normal(size=(b, s, kv, d)).astype(np.float32),
        "moe": moe,
        "moe_x": rng.normal(size=(*MOE_X, MOE_CFG["d_model"]))
        .astype(np.float32),
    }


# ---------------------------------------------------------------------------
# The reference's side: one subprocess, four forced host devices
# ---------------------------------------------------------------------------
REF_SCRIPT = r"""
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
import jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_smoke
from repro.serve import ServeConfig, Scheduler, Request
from repro.distributed.sharding import (SERVE_RULES, use_sharding,
    resolve_spec, shard_map_compat, ep_param_specs)
from repro.models import layers as L, moe as MOE, transformer as T

inp = pickle.load(open(sys.argv[1], "rb"))
out = {}

# -- the slot-sharded Scheduler (tests/test_serve.py's _SHARD_SCRIPT) ----
cfg = get_smoke("qwen3-32b")
scfg = ServeConfig(n_slots=4, max_len=24, prefill_chunk=4)
mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
rng = np.random.default_rng(3)
rs = [Request(i, rng.integers(0, cfg.vocab, int(rng.integers(3, 10))),
              int(rng.integers(2, 8)), arrival=i) for i in range(6)]
sched = Scheduler(cfg, scfg, mesh=mesh)
rep = sched.run(rs, policy="continuous")
out["serve_tokens"] = {r: c.tokens for r, c in rep.completions.items()}
out["serve_params"] = jax.tree.map(np.asarray, sched.params)

# -- flash_decode on a (1, 4) mesh, the sequence over "model" -----------
mesh = jax.make_mesh((1, 4), ("data", "model"))
q, kc, vc = (jnp.asarray(inp[k]) for k in ("q", "kc", "vc"))
b = q.shape[0]
pos = jnp.full((b,), inp["pos"], jnp.int32)
with use_sharding(mesh, SERVE_RULES):
    spec = resolve_spec(kc.shape, ("cache_batch", "cache_seq", "kv_heads",
                                   "head_dim"), SERVE_RULES, mesh)
    out["fd_spec"] = tuple(spec)
    kc_s = jax.device_put(kc, NamedSharding(mesh, spec))
    vc_s = jax.device_put(vc, NamedSharding(mesh, spec))
    for w in (0, 8):
        out[f"fd_{w}"] = np.asarray(jax.jit(
            lambda q, k, v, p: L.flash_decode(q, k, v, p, w, q.shape[2]))(
                q, kc_s, vc_s, pos))

# -- moe_ep_local on (1, 4) and (2, 2), both dispatch modes -------------
mcfg = MOE.MoEConfig(**inp["moe_cfg"])
p = jax.tree.map(jnp.asarray, inp["moe"])
x = jnp.asarray(inp["moe_x"])
fsdp = ("data",)
route = jax.jit(lambda p, x2: MOE._route(p, mcfg, x2))
pack = jax.jit(MOE._pack_local, static_argnums=(3, 4, 5))
for shape, a2a in inp["moe_cases"]:
    mesh = jax.make_mesh(shape, ("data", "model"))
    xs = P(("data", "model")) if a2a else P("data")
    y = jax.jit(shard_map_compat(
        lambda pl_, xl: MOE.moe_ep_local(pl_, mcfg, x_local=xl,
                                         fsdp_axes=fsdp, a2a=a2a),
        mesh=mesh, in_specs=(ep_param_specs(p, fsdp), xs),
        out_specs=xs))(p, x)
    out[f"moe_{shape}_{a2a}"] = np.asarray(y)
    # each rank's dropped assignments (its local routing)
    n = shape[0] * shape[1]
    e_local = mcfg.n_experts // shape[1]
    xr = np.asarray(x).reshape(n if a2a else shape[0], -1, x.shape[-1])
    valid = []
    for r in range(n):
        d_i, m_i = divmod(r, shape[1])
        x2 = jnp.asarray(xr[r if a2a else d_i])
        w, ids = route(p, x2)
        cap = MOE.capacity_of(x2.shape[0], mcfg)
        first, count = ((0, mcfg.n_experts) if a2a
                        else (m_i * e_local, e_local))
        valid.append(np.asarray(pack(x2, w, ids, first, count, cap)[2]))
    out[f"moe_valid_{shape}_{a2a}"] = valid

# -- _ffn_apply under a live context: its own choice of path ------------
import dataclasses
tcfg = dataclasses.replace(get_smoke("qwen3-moe-235b-a22b"), moe=mcfg,
                           moe_ep=True, d_model=mcfg.d_model)
zero3 = dict(SERVE_RULES, batch=("pod", "data", "model"))
for shape, rules_name in inp["ffn_cases"]:
    mesh = jax.make_mesh(shape, ("data", "model"))
    rules = zero3 if rules_name == "zero3" else SERVE_RULES
    with use_sharding(mesh, rules):
        out[f"ffn_{shape}_{rules_name}"] = np.asarray(
            jax.jit(lambda p, x: T._ffn_apply(p, tcfg, x))(p, x))
out["moe_ep"] = {}
from repro.configs import get_config, get_smoke as gs, ARCH_IDS
for a in ARCH_IDS:
    out["moe_ep"][a] = (get_config(a).moe_ep, gs(a).moe_ep)
pickle.dump(out, open(sys.argv[2], "wb"))
print("OK")
"""

FFN_CASES = [((1, 4), "serve"), ((1, 4), "zero3"), ((2, 2), "serve")]


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ref(inputs, tmp_path_factory):
    import pickle
    d = tmp_path_factory.mktemp("ranks_ref")
    src = dict(inputs, pos=FD["pos"], moe_cfg=MOE_CFG, moe_cases=MOE_CASES,
               ffn_cases=FFN_CASES)
    (d / "in.pkl").write_bytes(pickle.dumps(src))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(d / "in.pkl"),
                        str(d / "out.pkl")], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-3000:])
    return pickle.loads((d / "out.pkl").read_bytes())


# ---------------------------------------------------------------------------
# The port's side: four gloo ranks on the CPU
# ---------------------------------------------------------------------------
def _collectives(mesh, rank: int, device="cpu") -> dict:
    """Each collective on a (2, 2) mesh, values a function of the rank,
    on tensors of `device`."""
    def ar(n, *shape):
        return torch.arange(n, dtype=torch.float32,
                            device=device).reshape(*shape)

    def host(t):
        return t.cpu().numpy()
    x = ar(6, 2, 3) + 10 * rank
    return {
        "axis_index": (runtime.axis_index("data", mesh),
                       runtime.axis_index("model", mesh),
                       runtime.axis_index(("data", "model"), mesh)),
        "psum_model": host(runtime.psum(x, "model", mesh)),
        "psum_all": host(runtime.psum(x, ("data", "model"), mesh)),
        "pmax_data": host(runtime.pmax(x, "data", mesh)),
        "gather_tiled": host(runtime.all_gather(x, ("data", "model"), axis=1,
                                                tiled=True, mesh=mesh)),
        "gather_stacked": host(runtime.all_gather(x, "model", axis=0,
                                                  mesh=mesh)),
        "a2a": host(runtime.all_to_all(ar(8, 4, 2) + 100 * rank, "model", 0,
                                       1, tiled=True, mesh=mesh)),
        "a2a_untiled": host(runtime.all_to_all(ar(4, 2, 2) + 100 * rank,
                                               "data", 0, 1, mesh=mesh)),
    }


def _flash(inp, mesh, rank: int) -> dict:
    """flash_decode on this rank's quarter of the cache; attn_decode's
    cache write on a sequence-sharded cache."""
    b, s = FD["B"], FD["S"]
    sizes = {"cache_seq": s}
    spec = ("cache_batch", "cache_seq", "kv_heads", "head_dim")
    q = torch.from_numpy(inp["q"])
    pos = torch.full((b,), FD["pos"], dtype=torch.int32)
    out = {}
    with use_sharding(mesh, SERVE_RULES, sizes) as ctx:
        from repro_torch.distributed.sharding import local_spec
        kspec = local_spec(ctx, (b, s // 4, FD["KV"], FD["D"]), spec)
        out["spec"] = tuple(kspec)
        kc = shard_local(torch.from_numpy(inp["kc"]), kspec, mesh)
        vc = shard_local(torch.from_numpy(inp["vc"]), kspec, mesh)
        for w in (0, 8):
            out[f"fd_{w}"] = L.flash_decode(q, kc, vc, pos, w,
                                            FD["H"]).numpy()
        # one decode step of an attention layer: its K/V lands on the
        # rank whose slice holds position pos only
        acfg = L.AttnConfig(d_model=16, n_heads=FD["H"], n_kv_heads=FD["KV"],
                            head_dim=FD["D"], uniform_decode=False)
        g = torch.Generator().manual_seed(5)
        p = {k: torch.randn(v.shape, generator=g) * 0.3
             for k, v in L.attn_def(acfg).items()}
        xin = torch.randn((b, 1, 16), generator=g)
        kl, vl = kc.clone(), vc.clone()
        before = L.FLASH_DECODES["calls"]
        y, _ = L.attn_decode(p, acfg, xin, (kl, vl), pos)
        out["decode_calls"] = L.FLASH_DECODES["calls"] - before
        out["decode_y"] = y.numpy()
        out["written"] = sorted({int(c) for c in torch.nonzero(
            (kl != kc).any(-1).any(-1).any(0)).flatten()})
        out["attn_params"] = {k: v.numpy() for k, v in p.items()}
        out["attn_x"] = xin.numpy()
    # a context without a live mesh: the whole-cache path, no flash_decode
    with use_sharding(MeshShape(("data", "model"), (1, 4)), SERVE_RULES,
                      sizes):
        kw, vw = (torch.from_numpy(inp[k]).clone() for k in ("kc", "vc"))
        before = L.FLASH_DECODES["calls"]
        L.attn_decode(p, acfg, xin, (kw, vw), pos)
        out["unlive_calls"] = L.FLASH_DECODES["calls"] - before
    return out


def _moe(inp, meshes, rank: int) -> dict:
    cfg = MOE.MoEConfig(**MOE_CFG)
    p = map_tree(torch.from_numpy, inp["moe"])
    x = torch.from_numpy(inp["moe_x"])
    fsdp = ("data",)
    out = {}
    for shape, a2a in MOE_CASES:
        mesh = meshes[shape]
        specs = ep_param_specs(p, fsdp)
        pl = {k: shard_local(v, specs[k], mesh).contiguous()
              for k, v in p.items()}
        bytes_ = {k: v.numel() * v.element_size() for k, v in pl.items()}
        xs = (("data", "model"),) if a2a else ("data",)
        xl = shard_local(x, xs, mesh)
        y = MOE.moe_ep_local(pl, cfg, xl, fsdp_axes=fsdp, a2a=a2a,
                             mesh=mesh)
        x2 = xl.reshape(-1, cfg.d_model)
        w, ids = MOE._route(pl, cfg, x2)
        e_local = cfg.n_experts // shape[1]
        first, count = ((0, cfg.n_experts) if a2a else
                        (runtime.axis_index("model", mesh) * e_local,
                         e_local))
        valid = MOE._pack_local(x2, w, ids, first, count,
                                MOE.capacity_of(x2.shape[0], cfg))[2]
        out[(shape, a2a)] = (y.numpy(), valid.numpy(), bytes_)
    return out


def _ffn(inp, meshes, rank: int) -> dict:
    """`_ffn_apply` under a live context, the local shards in hand."""
    mcfg = MOE.MoEConfig(**MOE_CFG)
    cfg = dataclasses.replace(get_smoke("qwen3-moe-235b-a22b"), moe=mcfg,
                              moe_ep=True, d_model=mcfg.d_model)
    p = map_tree(torch.from_numpy, inp["moe"])
    x = torch.from_numpy(inp["moe_x"])
    chosen = []
    real = MOE.moe_ep_local

    def spy(*a, **kw):
        chosen.append((tuple(kw["fsdp_axes"]), kw["a2a"]))
        return real(*a, **kw)

    MOE.moe_ep_local = spy
    out = {}
    try:
        for shape, rules_name in FFN_CASES:
            mesh = meshes[shape]
            rules = ZERO3_RULES if rules_name == "zero3" else SERVE_RULES
            with use_sharding(mesh, rules, {"batch": MOE_X[0]}) as ctx:
                from repro_torch.distributed.sharding import resolve_spec
                x_spec = resolve_spec(tuple(x.shape), ("batch", None, None),
                                      rules, mesh)
                xl = shard_local(x, x_spec, mesh)
                fsdp, _ = T.ep_choice(cfg, ctx, tuple(xl.shape))
                specs = ep_param_specs(p, fsdp)
                pl = {k: shard_local(v, specs[k], mesh).contiguous()
                      for k, v in p.items()}
                y = T._ffn_apply(pl, cfg, xl)
            out[(shape, rules_name)] = (y.numpy(), chosen[-1])
        # without a live mesh: moe_ref, as on one device
        n = len(chosen)
        with use_sharding(MeshShape(("data", "model"), (1, 4)),
                          SERVE_RULES):
            y = T._ffn_apply(p, cfg, x)
        out["unlive"] = (len(chosen) - n,
                         float((y - MOE.moe_ref(p, mcfg, x)).abs().max()))
    finally:
        MOE.moe_ep_local = real
    return out


def ranks4(rank: int, world: int, device, inp) -> dict:
    torch.set_num_threads(1)
    meshes = {(1, 4): make_test_mesh(1, 4, "cpu"),
              (2, 2): make_test_mesh(2, 2, "cpu")}
    return {"collectives": _collectives(meshes[(2, 2)], rank),
            "flash": _flash(inp, meshes[(1, 4)], rank),
            "moe": _moe(inp, meshes, rank),
            "ffn": _ffn(inp, meshes, rank)}


@pytest.fixture(scope="module")
def port4(inputs):
    return runtime.spawn(ranks4, 4, device_type="cpu", backend="gloo",
                         args=(inputs,), timeout=TIMEOUT)


def _rows(outs, shape, key, xs_model: bool):
    """The global (B, S, d) output from the ranks' local ones: blocks in
    device-index order along the batch (over data, or data and model)."""
    n = shape[0] * shape[1]
    if xs_model:
        return np.concatenate([outs[r][key] for r in range(n)], 0)
    return np.concatenate([outs[d * shape[1]][key] for d in range(shape[0])],
                          0)


# ---------------------------------------------------------------------------
# Tests: the runtime
# ---------------------------------------------------------------------------
def test_collectives_on_a_2x2_mesh(port4):
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    xs = [base + 10 * r for r in range(4)]
    for r, out in enumerate(port4):
        c = out["collectives"]
        d, m = divmod(r, 2)
        assert c["axis_index"] == (d, m, r)
        np.testing.assert_array_equal(c["psum_model"],
                                      xs[2 * d] + xs[2 * d + 1])
        np.testing.assert_array_equal(c["psum_all"], sum(xs))
        np.testing.assert_array_equal(c["pmax_data"],
                                      np.maximum(xs[m], xs[2 + m]))
        np.testing.assert_array_equal(c["gather_tiled"],
                                      np.concatenate(xs, 1))
        np.testing.assert_array_equal(c["gather_stacked"],
                                      np.stack([xs[2 * d], xs[2 * d + 1]]))
        # tiled all_to_all over "model": block i of each (4, 2) goes to
        # model rank i, received blocks concatenated along dim 1
        a = [np.arange(8, dtype=np.float32).reshape(4, 2) + 100 * q
             for q in range(4)]
        peers = [a[2 * d], a[2 * d + 1]]
        np.testing.assert_array_equal(
            c["a2a"], np.concatenate([pk[2 * m:2 * m + 2] for pk in peers],
                                     1))
        u = [np.arange(4, dtype=np.float32).reshape(2, 2) + 100 * q
             for q in range(4)]
        np.testing.assert_array_equal(
            c["a2a_untiled"], np.stack([u[m][d], u[2 + m][d]], 1))


def test_a_dead_rank_fails_the_group():
    with pytest.raises(runtime.RankError, match="rank 1 of 2 raised"):
        runtime.spawn(_dies, 2, device_type="cpu", backend="gloo",
                      timeout=60.0)


def _dies(rank, world, device):
    if rank == 1:
        raise ValueError("rank 1 fails")
    # rank 0 waits in a collective its peer never joins
    import torch.distributed as dist
    dist.all_reduce(torch.ones(1))


def test_layouts_are_named_and_refused(monkeypatch):
    assert runtime.rank_device(3, 4, "cpu", "gloo") == torch.device("cpu")
    with pytest.raises(ValueError, match="gloo"):
        runtime.rank_device(0, 2, "cpu", "nccl")
    with pytest.raises(ValueError, match="backend"):
        runtime.rank_device(0, 2, "cpu", "mpi")
    # a host that shows one card: gloo ranks share it, nccl refuses
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert runtime.rank_device(3, 4, "cuda", "gloo") == \
        torch.device("cuda", 0)
    assert runtime.rank_device(0, 1, "cuda", "nccl") == \
        torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="4 ranks over nccl need 4 "
                       "cards .one a rank.; 1 visible"):
        runtime.rank_device(0, 4, "cuda", "nccl")
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="--devices 2 over nccl needs 2 "
                       "cards, one a rank; 1 visible"):
        serve.main(["--smoke", "--devices", "2"])


# ---------------------------------------------------------------------------
# Tests: slots over ranks
# ---------------------------------------------------------------------------
def _shard_requests(vocab):
    from repro_torch.serve import Request
    rng = np.random.default_rng(3)
    return [Request(i, rng.integers(0, vocab, int(rng.integers(3, 10))),
                    int(rng.integers(2, 8)), arrival=i) for i in range(6)]


def serve2(rank, world, device, params) -> dict:
    torch.set_num_threads(1)
    from repro_torch.serve import Scheduler, ServeConfig
    cfg = get_smoke("qwen3-32b")
    scfg = ServeConfig(n_slots=4, max_len=24, prefill_chunk=4)
    sched = Scheduler(cfg, scfg, params=params_from_reference(params),
                      mesh=make_test_mesh(world, 1, "cpu"), device=device)
    rep = sched.run(_shard_requests(cfg.vocab), policy="continuous")
    rep1 = sched.run(_shard_requests(cfg.vocab), policy="oneshot")
    return {"n_local": sched.n_local,
            "tokens": {r: c.tokens for r, c in rep.completions.items()},
            "oneshot": {r: c.tokens for r, c in rep1.completions.items()},
            "steps": (rep.decode_steps, rep.prefill_chunks)}


def test_slot_sharded_scheduler_matches_reference_and_oracle(ref):
    from repro_torch.serve import ServeConfig, run_sequential
    outs = runtime.spawn(serve2, 2, device_type="cpu", backend="gloo",
                         args=(ref["serve_params"],), timeout=TIMEOUT)
    cfg = get_smoke("qwen3-32b")
    scfg = ServeConfig(n_slots=4, max_len=24, prefill_chunk=4)
    seq = run_sequential(cfg, scfg, params_from_reference(ref["serve_params"]),
                         _shard_requests(cfg.vocab), device="cpu")
    want = ref["serve_tokens"]
    assert [o["n_local"] for o in outs] == [2, 2]
    for o in outs:
        assert o["tokens"] == want
        assert o["oneshot"] == want
        assert o["steps"] == outs[0]["steps"]
    assert {r: v["tokens"] for r, v in seq.items()} == want


def test_slot_layout_refuses_an_indivisible_mesh():
    from repro_torch.serve import ServeConfig
    from repro_torch.serve.decode import slot_layout
    mesh = MeshShape(("data", "model"), (3, 1))
    with pytest.raises(ValueError, match="not divisible"):
        slot_layout(ServeConfig(n_slots=4), mesh)
    assert slot_layout(ServeConfig(n_slots=4)) == (4, 0, ())


def _serve_cli(devices: int, *extra) -> list:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--smoke", "--device", "cpu", "--requests", "4",
                        "--devices", str(devices), *extra],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-3000:])
    return r.stdout.splitlines()


def test_serve_cli_devices_2_prints_the_tokens_of_devices_1():
    two, one = _serve_cli(2), _serve_cli(1)
    toks = [ln for ln in one if ln.strip().startswith("rid=")]
    assert len(toks) == 3
    assert [ln for ln in two if ln.strip().startswith("rid=")] == toks
    assert "ranks=2 x 2 slots" in two[0]


def test_serve_cli_refuses_batch_over_ranks():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="one device"):
        serve.main(["--smoke", "--device", "cpu", "--policy", "batch",
                    "--devices", "2"])


# ---------------------------------------------------------------------------
# Tests: flash_decode over a sequence-sharded cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [0, 8])
def test_flash_decode_matches_reference_sharded(ref, port4, window):
    want = ref[f"fd_{window}"]
    scale = float(np.abs(want).max())
    for out in port4:
        got = out["flash"][f"fd_{window}"]
        assert float(np.abs(got - want).max()) <= 1e-5 * scale
    # the sequence over the mesh's (data, model) axes (data of size 1)
    assert tuple(port4[0]["flash"]["spec"]) == tuple(ref["fd_spec"]) \
        == (None, ("data", "model"))


def test_attn_decode_takes_flash_decode_and_writes_one_rank(port4, inputs):
    """Under the live context attn_decode takes flash_decode and writes
    position 40 into rank 2's slice ([32, 48)) only, at its local column
    8; its output equals the whole-cache decode's.  Without a live mesh
    it takes the whole-cache path."""
    for r, out in enumerate(port4):
        f = out["flash"]
        assert f["decode_calls"] == 1
        assert f["unlive_calls"] == 0
        assert f["written"] == ([FD["pos"] - 32] if r == 2 else [])
    f = port4[0]["flash"]
    acfg = L.AttnConfig(d_model=16, n_heads=FD["H"], n_kv_heads=FD["KV"],
                        head_dim=FD["D"], uniform_decode=False)
    p = {k: torch.from_numpy(v) for k, v in f["attn_params"].items()}
    kc, vc = (torch.from_numpy(inputs[k]).clone() for k in ("kc", "vc"))
    pos = torch.full((FD["B"],), FD["pos"], dtype=torch.int32)
    y, _ = L.attn_decode(p, acfg, torch.from_numpy(f["attn_x"]), (kc, vc),
                         pos)
    for out in port4:
        np.testing.assert_allclose(out["flash"]["decode_y"], to_np(y),
                                   rtol=0, atol=1e-5 * float(y.abs().max()))


def test_cache_write_drops_positions_outside_a_slice():
    """A slice [16, 32): positions below it must not wrap to its end."""
    cache = torch.zeros((3, 16, 1))
    new = torch.ones((3, 2, 1))
    L.cache_write(cache, new, torch.tensor([15, 20, 31]), offset=16)
    assert torch.nonzero(cache[..., 0]).tolist() == [[0, 0], [1, 4],
                                                     [1, 5], [2, 15]]


# ---------------------------------------------------------------------------
# Tests: experts over ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,a2a", MOE_CASES)
def test_moe_ep_local_matches_reference_sharded(ref, port4, shape, a2a):
    want = ref[f"moe_{shape}_{a2a}"]
    outs = [o["moe"][(shape, a2a)] for o in port4]
    got = _rows([{"y": y} for y, _, _ in outs], shape, "y", a2a)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want)
                                                           .max())
    # the same assignments dropped on every rank, and some dropped
    valid = ref[f"moe_valid_{shape}_{a2a}"]
    for r, (_, v, _) in enumerate(outs):
        np.testing.assert_array_equal(v, valid[r])
    assert not all(v.all() for v in valid)
    # each rank holds 1/4 of the expert bytes (fsdp over "data" on (2, 2))
    whole = {k: v.nbytes for k, v in _inputs()["moe"].items()}
    for _, _, b in outs:
        for k in ("wi", "wo"):
            assert b[k] * 4 == whole[k]


@pytest.mark.parametrize("shape,rules", FFN_CASES)
def test_ffn_apply_takes_moe_ep_local_under_a_live_mesh(ref, port4, shape,
                                                        rules):
    want = ref[f"ffn_{shape}_{rules}"]
    outs = [o["ffn"][(shape, rules)] for o in port4]
    a2a = rules == "zero3"
    for _, choice in outs:
        assert choice == (("data",), a2a)
    got = _rows([{"y": y} for y, _ in outs], shape, "y", a2a)
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want)
                                                           .max())


def test_ffn_apply_without_a_live_mesh_takes_moe_ref(port4):
    for o in port4:
        calls, diff = o["ffn"]["unlive"]
        assert calls == 0 and diff == 0.0


def test_moe_ep_values_of_all_configs_equal_reference(ref):
    got = {a: (get_config(a).moe_ep, get_smoke(a).moe_ep) for a in ARCH_IDS}
    assert got == ref["moe_ep"]
    assert got["qwen3-moe-235b-a22b"] == (True, False)
    assert got["deepseek-v2-236b"] == (True, False)


def test_moe_ep_local_as_one_rank_equals_moe_ref():
    """The counterpart of tests/test_models_smoke.py's 1x1-mesh case: no
    group, every axis of size 1, capacity large enough to drop nothing."""
    R = reference()
    cfg = MOE.MoEConfig(n_experts=4, top_k=2, d_model=16, d_ff=8,
                        capacity_factor=8.0, n_shared=1)
    rng = np.random.default_rng(1)
    p = _np_params(MOE.moe_def(cfg), rng)
    x = rng.normal(size=(2, 6, 16)).astype(np.float32)
    tp = map_tree(torch.from_numpy, p)
    mesh = MeshShape(("data", "model"), (1, 1))
    y_ep = MOE.moe_ep_local(tp, cfg, torch.from_numpy(x), fsdp_axes=(),
                            mesh=mesh)
    y_ref = MOE.moe_ref(tp, cfg, torch.from_numpy(x))
    jcfg = R.moe.MoEConfig(**dataclasses.asdict(cfg))
    jy = np.asarray(R.moe.moe_ref(map_tree(R.jnp.asarray, p), jcfg,
                                  R.jnp.asarray(x)))
    scale = float(np.abs(jy).max())
    assert float((y_ep - y_ref).abs().max()) <= 1e-5 * scale
    assert float(np.abs(to_np(y_ep) - jy).max()) <= 1e-5 * scale
    for a2a in (True,):
        y2 = MOE.moe_ep_local(tp, cfg, torch.from_numpy(x), fsdp_axes=(),
                              a2a=a2a, mesh=mesh)
        assert float((y2 - y_ref).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_and_unpack_match_reference_with_overflow(seed):
    R = reference()
    rng = np.random.default_rng(seed)
    t, k, e, d = 24, 3, 8, 5
    x2 = rng.normal(size=(t, d)).astype(np.float32)
    # skewed routing: experts 0 and 1 overflow a capacity of 4
    ids = np.stack([rng.choice(e, size=k, replace=False,
                               p=[.3, .3] + [.4 / 6] * 6)
                    for _ in range(t)]).astype(np.int32)
    w = rng.random(size=(t, k)).astype(np.float32)
    for first, count in ((0, e), (2, 4), (4, 4)):
        got = MOE._pack_local(torch.from_numpy(x2), torch.from_numpy(w),
                              torch.from_numpy(ids).long(), first, count, 4)
        want = R.moe._pack_local(R.jnp.asarray(x2), R.jnp.asarray(w),
                                 R.jnp.asarray(ids), first, count, 4)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(to_np(a), np.asarray(b))
        y_buf = rng.normal(size=(count, 4, d)).astype(np.float32)
        y = MOE._unpack_local(torch.from_numpy(y_buf), *got[1:], t)
        jy = R.moe._unpack_local(R.jnp.asarray(y_buf), *want[1:], t)
        np.testing.assert_allclose(to_np(y), np.asarray(jy), rtol=1e-6,
                                   atol=1e-6)
    assert MOE.dropped_assignments(torch.from_numpy(ids).long(), e, 4) > 0
