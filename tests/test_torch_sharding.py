"""The sharding rules and the production mesh of the port
(`repro_torch.distributed.sharding`, `repro_torch.launch.mesh`) against the
reference's (`repro.distributed.sharding`):

  * the six resolution cases of `tests/test_sharding.py`, on the port;
  * the rules tables and priority equal the reference's;
  * every ParamDef leaf of the ten configs, under the train and the serve
    rules, and every batch and cache leaf of every applicable (arch,
    shape) under its cell's rules, resolves to the reference's spec on
    both production mesh shapes (the reference's `resolve_spec` reads
    only `mesh.shape`, so a stand-in mesh serves it);
  * `spec_on_dim`, `slot_dim_specs` and `ep_param_specs` equal the
    reference's;
  * `to_placements` on meta DTensors over a "fake" process group of 256
    and 512 ranks: each local shard is the dim over its group's size;
    every group the rules can yield lies in mesh order;
  * `shard_act` is the identity outside a context; `opt_state_shardings`;
    the mesh factories.

Specs are compared as tuples (a jax PartitionSpec iterates its parts).
"""

import types

import jax
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.distributed import sharding as S
from repro_torch.distributed.sharding import (SERVE_RULES, TRAIN_RULES, P,
                                              resolve_spec)
from repro_torch.launch import dryrun, mesh as M
from repro_torch.launch.steps import opt_state_shardings
from repro_torch.models import module
from repro_torch.models.model import (ASSIGNED_SHAPES, applicable,
                                      build_model, cache_axes)
from test_torch_ref import reference

MESH = M.production_mesh_shape(multi_pod=True)
MESH1 = M.production_mesh_shape()
ARCHS = list(ARCH_IDS)


@pytest.fixture(scope="module")
def R():
    return reference()


@pytest.fixture()
def fake_group():
    """A "fake" process group of 256 ranks (this process rank 0), swapped
    for one of 512 where a test builds the multi-pod mesh; destroyed after
    the test."""
    dryrun.fake_group(256)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _stand_in(mesh):
    return types.SimpleNamespace(shape=mesh.shape)


# ---------------------------------------------------------------------------
# tests/test_sharding.py's cases
# ---------------------------------------------------------------------------
def test_train_weight_fsdp_plus_tp():
    spec = resolve_spec((4096, 64, 128), ("embed", "heads", "head_dim"),
                        TRAIN_RULES, MESH)
    assert spec == P(("pod", "data"), "model")


def test_divisibility_fallback_drops_axis():
    # vocab 256206 not divisible by model=16 -> replicated
    spec = resolve_spec((1024, 256206), ("embed", "vocab"), TRAIN_RULES,
                        MESH1)
    assert spec == P("data")


def test_batch_suffix_fallback():
    # batch 8 can't take (pod,data)=32 nor (data,)=16 -> replicated
    spec = resolve_spec((8, 128, 512), ("batch", None, None), TRAIN_RULES,
                        MESH)
    assert spec == P()
    # batch 16 falls back to the ("data",) suffix
    spec = resolve_spec((16, 128, 512), ("batch", None, None), TRAIN_RULES,
                        MESH)
    assert spec == P("data")


def test_no_axis_reuse_within_tensor():
    # both cache_batch and cache_seq want (pod,data): only one gets it
    spec = resolve_spec((64, 32768, 8, 128),
                        ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
                        SERVE_RULES, MESH)
    used = [a for part in spec if part
            for a in (part if isinstance(part, tuple) else (part,))]
    assert len(used) == len(set(used))


def test_priority_kv_heads_beats_cache_seq():
    # kv divisible: kv_heads takes model, seq gets nothing on 1-pod mesh
    spec = resolve_spec((128, 32768, 16, 64),
                        ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
                        SERVE_RULES, MESH1)
    assert spec[2] == "model"
    # kv NOT divisible (8 over 16): cache_seq picks up model instead
    spec = resolve_spec((128, 32768, 8, 64),
                        ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
                        SERVE_RULES, MESH1)
    assert spec[1] == "model" and (len(spec) < 3 or spec[2] is None)


def test_long_context_batch1_shards_seq_everywhere():
    spec = resolve_spec((1, 524288, 8, 256),
                        ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
                        SERVE_RULES, MESH)
    assert spec[1] == ("pod", "data", "model")


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------
def test_rules_tables_equal_reference(R):
    assert S.TRAIN_RULES == R.sharding.TRAIN_RULES
    assert S.ZERO3_TRAIN_RULES == R.sharding.ZERO3_TRAIN_RULES
    assert S.SERVE_RULES == R.sharding.SERVE_RULES
    assert S._PRIORITY == R.sharding._PRIORITY


def _ref_flat(tree, is_leaf=None):
    """(path, leaf) of a reference tree, paths as tuples of dict keys and
    sequence indices."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
             leaf) for p, leaf in flat]


def _port_flat(tree, prefix=()):
    """(path, leaf) of a port tree of dicts and tuples, keys sorted."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _port_flat(tree[k], prefix + (k,))]
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return [pair for i, t in enumerate(tree)
                for pair in _port_flat(t, prefix + (i,))]
    return [(prefix, tree)]


def _axes_at(axes, path):
    for k in path:
        axes = axes[k]
    return axes


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(R, arch):
    """Every ParamDef leaf, under the train and the serve rules, on both
    production meshes."""
    jskel = R.model.build_model(R.configs.get_config(arch)).skeleton
    want = dict(_ref_flat(jskel,
                          is_leaf=lambda x: isinstance(x, R.module.ParamDef)))
    got = dict(module.leaves(build_model(get_config(arch)).skeleton))
    assert set(got) == set(want)
    for mesh in (MESH1, MESH):
        for rules in (TRAIN_RULES, SERVE_RULES):
            for path, d in got.items():
                jd = want[path]
                assert (d.shape, d.axes) == (jd.shape, jd.axes)
                spec = resolve_spec(d.shape, d.axes, rules, mesh)
                jspec = R.sharding.resolve_spec(jd.shape, jd.axes, rules,
                                                _stand_in(mesh))
                assert tuple(spec) == tuple(jspec), (path, rules is
                                                     TRAIN_RULES)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(R, arch):
    """Every batch and cache leaf of every applicable shape of `arch`,
    under its cell's rules, on both production meshes; the skips are the
    reference's."""
    cfg, jcfg = get_config(arch), R.configs.get_config(arch)
    bundle, jbundle = build_model(cfg), R.model.build_model(jcfg)
    for name, shape in ASSIGNED_SHAPES.items():
        jshape = R.model.ASSIGNED_SHAPES[name]
        ok, why = applicable(cfg, shape)
        assert (ok, why) == R.model.applicable(jcfg, jshape)
        if not ok:
            continue
        rules = dryrun.cell_rules(shape.kind)
        batch, axes = bundle.input_specs(shape)
        jbatch, jaxes = jbundle.input_specs(jshape)
        jflat, jdef = jax.tree_util.tree_flatten_with_path(jbatch)
        want = {tuple(getattr(k, "key", getattr(k, "idx", None))
                      for k in p): (leaf, a)
                for (p, leaf), a in zip(jflat, jdef.flatten_up_to(jaxes))}
        got = _port_flat(batch)
        assert {p for p, _ in got} == set(want)
        for path, t in got:
            jleaf, ja = want[path]
            a = _axes_at(axes, path)
            assert tuple(t.shape) == tuple(jleaf.shape) and a == ja
            for mesh in (MESH1, MESH):
                spec = resolve_spec(tuple(t.shape), a, rules, mesh)
                jspec = R.sharding.resolve_spec(jleaf.shape, ja, rules,
                                                _stand_in(mesh))
                assert tuple(spec) == tuple(jspec), (name, path)


def test_slot_specs_equal_reference(R):
    """`slot_dim_specs` over every smoke config's decode cache (and
    `spec_on_dim`, which it places each leaf's slot dim with)."""
    for arch in ARCHS:
        cfg, jcfg = get_smoke(arch), R.configs.get_smoke(arch)
        cache = build_model(cfg).input_specs(
            ASSIGNED_SHAPES["decode_32k"])[0]["cache"]
        jcache = R.model.build_model(jcfg).input_specs(
            R.model.ASSIGNED_SHAPES["decode_32k"])[0]["cache"]
        for axes in (("data",), ("pod", "data"), "model"):
            got = _port_flat(S.slot_dim_specs(cache_axes(cfg), cache, axes))
            want = _ref_flat(R.sharding.slot_dim_specs(
                R.model.cache_axes(jcfg), jcache, axes),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            assert [(p, tuple(s)) for p, s in got] \
                == [(p, tuple(s)) for p, s in want], arch
    for ndim, dim, axes in ((4, 1, ("data",)), (3, 0, ("pod", "data")),
                            (2, 1, "model")):
        assert tuple(S.spec_on_dim(ndim, dim, axes)) \
            == tuple(R.sharding.spec_on_dim(ndim, dim, axes))


@pytest.mark.parametrize("fsdp", [None, (), ("data",), ("pod", "data")])
@pytest.mark.parametrize("shared", [False, True])
def test_ep_param_specs_equal_reference(R, fsdp, shared):
    p = {"router": 0, "wi": 0, "wo": 0}
    if shared:
        p.update(shared_wi=0, shared_wo=0)
    got = S.ep_param_specs(p, fsdp)
    want = R.sharding.ep_param_specs(p, fsdp)
    assert {k: tuple(v) for k, v in got.items()} \
        == {k: tuple(v) for k, v in want.items()}


# ---------------------------------------------------------------------------
# Placements on meta DTensors
# ---------------------------------------------------------------------------
def test_every_rules_group_lies_in_mesh_order():
    for rules in (S.TRAIN_RULES, S.ZERO3_TRAIN_RULES, S.SERVE_RULES):
        for group in rules.values():
            idx = [MESH.axes.index(a) for a in group]
            assert idx == sorted(idx)


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_to_placements_local_shapes(fake_group, kind):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = dryrun.production_mesh(kind)
    sizes = S.mesh_axes(mesh)
    cases = [((4096, 64, 128), ("embed", "heads", "head_dim"), TRAIN_RULES),
             ((1, 524288, 8, 256),
              ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
              SERVE_RULES),
             ((128, 32768, 8, 64),
              ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
              SERVE_RULES),
             ((8, 128, 512), ("batch", None, None), TRAIN_RULES)]
    for shape, axes, rules in cases:
        spec = resolve_spec(shape, axes, rules, mesh)
        placements = S.to_placements(spec, mesh)
        assert len(placements) == mesh.ndim
        want = []
        for i, n in enumerate(shape):
            part = spec[i] if i < len(spec) else None
            group = (part,) if isinstance(part, str) else (part or ())
            div = 1
            for a in group:
                div *= sizes[a]
                assert placements[list(sizes).index(a)] == Shard(i)
            want.append(n // div)
        assert sum(p == Replicate() for p in placements) \
            == mesh.ndim - sum(len((pt,) if isinstance(pt, str) else pt)
                               for pt in spec if pt)
        from torch.distributed.tensor import distribute_tensor
        dt = distribute_tensor(torch.empty(shape, device="meta"), mesh,
                               placements)
        assert tuple(dt.to_local().shape) == tuple(want) \
            == S.local_shape(shape, spec, mesh)
        assert tuple(dt.shape) == shape and isinstance(dt, DTensor)


def test_to_placements_refuses_groups_out_of_mesh_order():
    with pytest.raises(ValueError, match="order"):
        S.to_placements(P(("data", "pod")), MESH)
    with pytest.raises(ValueError, match="twice"):
        S.to_placements(P("data", "data"), MESH)


def test_shard_act(fake_group):
    x = torch.ones(4, 8)
    assert S.shard_act(x, "batch", None) is x
    mesh = dryrun.production_mesh("single")
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with S.use_sharding(mesh, SERVE_RULES):
        assert S.current_ctx().rules is SERVE_RULES
        assert S.shard_act(x, "batch", None) is x       # a plain tensor
        dt = distribute_tensor(torch.empty((64, 128), device="meta"), mesh,
                               [Replicate(), Replicate()])
        out = S.shard_act(dt, "batch", "heads")
        assert tuple(out.placements) == (Shard(0), Shard(1))
        assert tuple(out.to_local().shape) == (4, 8)
    assert S.current_ctx() is None


def test_opt_state_shardings_follow_params():
    skel = build_model(get_smoke("qwen3-32b")).skeleton
    p_sh = S.param_shardings(skel, MESH1, TRAIN_RULES)
    for compress in (False, True):
        st = opt_state_shardings(p_sh, compress)
        assert st["adam"]["mu"] is p_sh and st["adam"]["nu"] is p_sh
        assert st["adam"]["step"] == S.replicated(MESH1)
        assert st["adam"]["step"].spec == P()
        assert ("err" in st) == compress
        if compress:
            assert st["err"] is p_sh


def test_production_mesh_needs_a_group_of_its_size(fake_group):
    assert (MESH1.axes, MESH1.sizes, MESH1.size) \
        == (("data", "model"), (16, 16), 256)
    assert (MESH.axes, MESH.sizes, MESH.size) \
        == (("pod", "data", "model"), (2, 16, 16), 512)
    mesh = M.make_production_mesh()
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (16, 16)
    with pytest.raises(ValueError, match="512"):
        M.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="world size 4"):
        M.make_test_mesh(2, 2)
    dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="none is open"):
        M.make_production_mesh()
    dryrun.fake_group(4)
    assert tuple(M.make_test_mesh(2, 2).shape) == (2, 2)
