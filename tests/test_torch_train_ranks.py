"""Training across ranks (`launch.steps.train_layout` / `make_train_step(
layout=)`, `launch.train --devices N`): params and AdamW moments sharded
as `TRAIN_RULES` lays them out, the model's gathers with their
transposes, tensor-parallel compute over "model" (heads, MLP, SSM heads,
vocab; the optical MLP's full-scales and draws the global operands'),
experts over ranks in the train step, checkpoints between device counts.

The reference's sharded steps come from ONE subprocess on four forced
host devices with the `enable_x64` alias of `test_torch_ref.reference`.
Under jax 0.9 `jax.make_mesh` gives Explicit axes, on which the model's
`with_sharding_constraint` raises, so the subprocess builds its meshes
with Auto axes (nothing of `src/repro/` changes).  It runs the
reference's jitted `make_train_step` under `TRAIN_RULES` shardings, as
`repro.launch.train` does, from the port's initial params carried across
as numpy.  The port's side is one `runtime.spawn` group of four gloo
ranks on the CPU per mesh, one more on (2, 2) for the other families
(under `TRAIN_RULES` and `ZERO3_TRAIN_RULES`), and one of two ranks on
(1, 2) for the split layers against their whole ones.
"""

import contextlib
import dataclasses
import os
import pickle
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as CK
from repro_torch.configs import get_smoke
from repro_torch.data import TokenPipeline
from repro_torch.distributed import runtime
from repro_torch.distributed.sharding import (P, TRAIN_RULES,
                                              ZERO3_TRAIN_RULES, gather,
                                              shard_tree, use_sharding)
from repro_torch.launch import steps as ST
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import MeshShape, make_test_mesh
from repro_torch.models.model import build_model
from repro_torch.models.module import leaves, map_tree, unflatten
from repro_torch.optim import AdamWConfig, cosine_schedule

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TIMEOUT = 240.0                  # seconds a group of ranks may take
ARCHS = ("mistral-large-123b", "mamba2-1.3b", "qwen3-moe-235b-a22b")
MESHES = ((2, 2), (4, 1))
CASES = [(a, m, False) for a in ARCHS for m in MESHES] + [
    ("mistral-large-123b", (2, 2), True)]          # --compress-grads
# the reference runs each (arch, compress) on one device and on both
# meshes: the spread of its own layouts is the float-order floor
REF_LAYOUTS = ((1, 1), (2, 2), (4, 1))
# the other families and frontends: zamba2's groups, tail and shared
# block, deepseek-v2's MLA and `layer0`, seamless's encoder and cross
# attention, phi-3-vision's patch rows; on (2, 2) against the reference's
# (2, 2) steps, its one-device steps giving the floor
FAMILY_ARCHS = ("zamba2-1.2b", "deepseek-v2-236b", "seamless-m4t-medium",
                "phi-3-vision-4.2b")
FAMILY_LAYOUTS = ((1, 1), (2, 2))
REF_CASES = [(a, m, c) for a, c in dict.fromkeys(
    (a, c) for a, _, c in CASES) for m in REF_LAYOUTS] + [
    (a, m, False) for a in FAMILY_ARCHS for m in FAMILY_LAYOUTS]
# the reference's elastic CLI test's configuration (tests/test_system.py:
# batch 4 x 32, the CLI's lr 3e-4 and 20 warmup steps)
B, S, STEPS, LR, WARMUP = 4, 32, 3, 3e-4, 20


def _cfg(arch: str):
    """The smoke config; the MoE one expert-parallel (`moe_ep_local` in
    the train step, in both packages)."""
    cfg = get_smoke(arch)
    return dataclasses.replace(cfg, moe_ep=True) if cfg.moe else cfg


def _opt():
    return AdamWConfig(lr=cosine_schedule(LR, WARMUP, STEPS))


@pytest.fixture(scope="module")
def np_params() -> dict:
    return {a: map_tree(lambda t: t.numpy(), build_model(_cfg(a)).init(
        torch.Generator().manual_seed(0))) for a in ARCHS + FAMILY_ARCHS}


def _np_batch(arch: str) -> dict:
    """A family's train batch (its frontend's inputs too), the same at
    every step of both sides: {name: (numpy, bfloat16?)}, a bfloat16
    leaf carried as float32 (which holds it exactly)."""
    from repro_torch.models.model import ShapeSpec, make_inputs
    batch, _ = make_inputs(_cfg(arch), ShapeSpec("t", "train", S, B),
                           concrete=True,
                           generator=torch.Generator().manual_seed(3))
    return {k: (v.float().numpy() if v.dtype == torch.bfloat16
                else v.numpy(), v.dtype == torch.bfloat16)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The reference's side: one subprocess, four forced host devices
# ---------------------------------------------------------------------------
REF_SCRIPT = r"""
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
import numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke
from repro.data import TokenPipeline
from repro.distributed.sharding import (TRAIN_RULES, param_shardings,
                                        tree_shardings, use_sharding)
from repro.launch.steps import (init_opt_state, make_train_step,
                                opt_state_shardings)
from repro.models.model import ShapeSpec, build_model, make_inputs
from repro.optim import AdamWConfig, cosine_schedule

inp = pickle.load(open(sys.argv[1], "rb"))
b, s, steps, lr = inp["batch"], inp["seq"], inp["steps"], inp["lr"]
warmup = inp["warmup"]
given = {a: {k: jax.numpy.asarray(v, jax.numpy.bfloat16) if bf else v
             for k, (v, bf) in bt.items()}
         for a, bt in inp["batches"].items()}
out = {}
for arch, shape, compress in inp["cases"]:
    cfg = get_smoke(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe_ep=True)
    bundle = build_model(cfg)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=0)
    step_fn = make_train_step(bundle, AdamWConfig(
        lr=cosine_schedule(lr, warmup, steps)), grad_compress=compress)
    # Auto axes: jax 0.9's default Explicit axes refuse shard_act's
    # with_sharding_constraint
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    with use_sharding(mesh, TRAIN_RULES):
        p_sh = param_shardings(bundle.skeleton, mesh, TRAIN_RULES)
        params = jax.device_put(inp["params"][arch], p_sh)
        o_sh = opt_state_shardings(p_sh, compress)
        opt = jax.jit(lambda p: init_opt_state(p, compress),
                      out_shardings=o_sh)(params)
        _, baxes = make_inputs(cfg, ShapeSpec("cli", "train", s, b))
        batch_of = ((lambda i: given[arch]) if arch in given
                    else pipe.batch)
        b_sh = tree_shardings(jax.eval_shape(lambda: batch_of(0)), baxes,
                              mesh, TRAIN_RULES)
        step = jax.jit(step_fn, in_shardings=(p_sh, o_sh, b_sh))
        losses, norms = [], []
        for i in range(steps):
            params, opt, m = step(params, opt, batch_of(i))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out[(arch, shape, compress)] = (losses, norms,
                                    jax.tree.map(np.asarray, params))
pickle.dump(out, open(sys.argv[2], "wb"))
print("OK")
"""


@pytest.fixture(scope="module")
def ref_run(np_params, tmp_path_factory):
    """The reference's subprocesses, started first: they run while the
    port's groups do (the families' cases in a second one)."""
    d = tmp_path_factory.mktemp("train_ranks_ref")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    batches = {a: _np_batch(a) for a in FAMILY_ARCHS}
    procs = []
    for i, family in enumerate((False, True)):
        cases = [c for c in REF_CASES if (c[0] in FAMILY_ARCHS) == family]
        src = {"params": np_params, "cases": cases, "batch": B, "seq": S,
               "steps": STEPS, "lr": LR, "warmup": WARMUP,
               "batches": batches if family else {}}
        (d / f"in{i}.pkl").write_bytes(pickle.dumps(src))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, str(d / f"in{i}.pkl"),
             str(d / f"out{i}.pkl")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env))
    yield procs, d
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_run, port):
    procs, d = ref_run
    out = {}
    for i, proc in enumerate(procs):
        so, se = proc.communicate(timeout=600)
        assert proc.returncode == 0, (so[-1000:], se[-3000:])
        out.update(pickle.loads((d / f"out{i}.pkl").read_bytes()))
    return out


# ---------------------------------------------------------------------------
# The port's side: four gloo ranks on the CPU, one group a mesh
# ---------------------------------------------------------------------------
def _train(mesh, arch: str, compress: bool, np_p: dict, rank: int) -> dict:
    cfg = _cfg(arch)
    bundle = build_model(cfg)
    layout = ST.train_layout(bundle, mesh, B)
    params = shard_tree(np_p, layout.specs, mesh)
    opt = ST.init_opt_state(params, compress)
    step = ST.make_train_step(bundle, _opt(), compress, layout)
    pipe = TokenPipeline(cfg.vocab, S, B, seed=0)
    given = ({k: torch.from_numpy(v).to(torch.bfloat16 if bf else None)
              for k, (v, bf) in _np_batch(arch).items()}
             if arch in FAMILY_ARCHS else None)
    losses, norms = [], []
    for i in range(STEPS):
        batch = given if given is not None else pipe.batch(i)
        params, opt, m = step(params, opt, layout.local_batch(batch))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    held = sum(t.numel() * t.element_size()
               for _, t in leaves({"params": params, "opt": opt}))
    # params, mu, nu (and err) at their shard bytes, the 0-d step counter
    want = layout.shard_bytes(bundle.skeleton) * (4 if compress else 3) + 4
    whole = {"/".join(p): gather(t, dict(leaves(layout.specs))[p],
                                 mesh).numpy()
             for p, t in leaves(params)}
    return {"losses": losses, "norms": norms, "held": held, "want": want,
            "params": whole if rank == 0 else None}


def _toy(mesh) -> dict:
    """The collective transposes: the toy step as it is, with every model
    rank's copy counted whole, and with psum's transpose dropping the
    other ranks' cotangents."""
    out = {"right": runtime.toy_grads(mesh),
           "copies": runtime.toy_grads(mesh, weigh_copies=False)}
    real = runtime._PSum.backward
    runtime._PSum.backward = staticmethod(lambda ctx, g: (g, None, None))
    try:
        out["dropped"] = runtime.toy_grads(mesh)
    finally:
        runtime._PSum.backward = real
    return {k: {n: (a.numpy(), b.numpy()) for n, (a, b) in v.items()}
            for k, v in out.items()}


def _scales(mesh) -> dict:
    """The activations' per-tensor full-scale under data parallelism: the
    plain `rosa_fused` version and the composed "ref" chain on this
    rank's rows, in a live train context, against the whole batch's."""
    from repro_torch import rosa
    from repro_torch.core import quant as Q
    from repro_torch.kernels.rosa_fused import ops as fused
    from repro_torch.rosa.backends import RosaConfig
    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, 16, generator=g)
    x[5, 3] = 9.0                  # the max on one data rank's rows only
    w = torch.randn(16, 12, generator=g) * 0.3
    lo = runtime.axis_index("data", mesh) * 4
    xl = x[lo:lo + 4]
    eng = rosa.Engine.from_config(RosaConfig(backend="ref"))
    out = {"whole_fused": fused.rosa_fused_matmul(x, w)[lo:lo + 4].numpy(),
           "whole_ref": eng.matmul(x, w, name="mlp/wi")[lo:lo + 4].numpy(),
           "local_scale": float(Q.act_absmax_scale(xl))}
    with use_sharding(mesh, TRAIN_RULES, {"batch": 8}, params={},
                      batch_axes=("data",)):
        out["scale"] = float(Q.act_absmax_scale(xl))
        out["fused"] = fused.rosa_fused_matmul(xl, w).numpy()
        out["ref"] = eng.matmul(xl, w, name="mlp/wi").numpy()
        # the masked loss: both sums over the data ranks
        from repro_torch.models import layers as L
        logits = torch.randn(8, 3, 5, generator=g)
        labels = torch.randint(0, 5, (8, 3), generator=g)
        mask = (torch.rand(8, 3, generator=g) > 0.3).float()
        out["xent"] = float(L.softmax_xent(logits[lo:lo + 4],
                                           labels[lo:lo + 4],
                                           mask[lo:lo + 4]))
    out["xent_whole"] = float(L.softmax_xent(logits, labels, mask))
    return out


def _ckpt(mesh, np_p: dict, root: str, rank: int) -> dict:
    """A state of known numbers saved from the ranks, and the one-process
    file of the same state restored onto them."""
    bundle = build_model(_cfg("mistral-large-123b"))
    layout = ST.train_layout(bundle, mesh, B)
    specs = train_cli.state_specs(layout, False)
    state = _known_state(np_p)
    local = shard_tree(state, specs, mesh)
    CK.save(os.path.join(root, "ranks"), 2, local, {"arch": "x"},
            specs=specs, mesh=mesh)
    back = CK.restore(os.path.join(root, "one"), 2, local, specs=specs,
                      mesh=mesh)
    ok = all(torch.equal(a, b) for (_, a), (_, b)
             in zip(leaves(back), leaves(local), strict=True))
    # a leaf above 1 MiB, split over both axes: restored from its mapped
    # member (`checkpoint._mapped`)
    big, bspec = _big_leaf(), {"w": P("data", "model")}
    mine = shard_tree(big, bspec, mesh)
    CK.save(os.path.join(root, "big"), 1, mine, specs=bspec, mesh=mesh)
    back = CK.restore(os.path.join(root, "big"), 1, mine, specs=bspec,
                      mesh=mesh)
    return {"restored_equal": ok,
            "big_equal": torch.equal(back["w"], mine["w"])}


def _big_leaf() -> dict:
    return {"w": torch.arange(1024 * 512, dtype=torch.float32).reshape(
        1024, 512)}


def _model_shard(mesh) -> dict:
    """What a rank computes with under a live train context: a layer
    slice and the top-level leaves as `gather_layer` / `gather_top` hand
    them on (the FSDP dims gathered, the tensor-parallel ones local),
    each against this rank's block of the whole leaf by the local specs;
    the experts of an expert-parallel MoE layer left split over "model"
    and FSDP-sharded (`moe_ep_local` gathers them)."""
    from repro_torch.distributed.sharding import shard_local
    from repro_torch.models import transformer as T
    out = {}
    for arch in ("mistral-large-123b", "mamba2-1.3b", "qwen3-moe-235b-a22b"):
        bundle = build_model(_cfg(arch))
        layout = ST.train_layout(bundle, mesh, B)
        full = bundle.init(torch.Generator().manual_seed(0))
        local = shard_tree(full, layout.specs, mesh)
        with use_sharding(mesh, TRAIN_RULES, {"batch": B},
                          params=layout.specs, batch_axes=layout.batch_axes):
            got, tp = T.gather_layer(T.layer_at(local["layers"], 0),
                                     bundle.cfg, "layers")
            top, tp_top = T.gather_top(local)
        pairs = [(("layers",) + p, t, dict(leaves(tp))[p],
                  dict(leaves(T.layer_at(full["layers"], 0)))[p])
                 for p, t in leaves(got)]
        pairs += [((k,), top[k], tp_top[k], full[k])
                  for k in ("embed", "unembed") if k in top]
        res = {}
        for p, t, spec, whole in pairs:
            mine = shard_local(whole, spec, mesh)
            res["/".join(p)] = (tuple(t.shape), tuple(whole.shape),
                                tuple(spec),
                                t.shape == mine.shape
                                and bool(torch.equal(t, mine)))
        out[arch] = res
    return out


def _flops(mesh) -> dict:
    """A rank's matmul FLOPs of one sharded loss-and-gradient of
    mistral-smoke (`FlopCounterMode`) and the one-process step's."""
    from torch.utils.flop_counter import FlopCounterMode
    bundle, params, batch = _family_inputs("mistral-large-123b")
    layout = ST.train_layout(bundle, mesh, B)
    local = shard_tree(params, layout.specs, mesh)
    with FlopCounterMode(display=False) as rank:
        ST.sharded_loss_and_grads(bundle, local, layout.local_batch(batch),
                                  layout)
    with FlopCounterMode(display=False) as one:
        ST.loss_and_grads(bundle, params, batch)
    return {"rank": rank.get_total_flops(), "one": one.get_total_flops()}


def _family_inputs(arch: str):
    from repro_torch.models.model import ShapeSpec, make_inputs
    cfg = get_smoke(arch)
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(2))
    batch, _ = make_inputs(cfg, ShapeSpec("t", "train", 16, B),
                           concrete=True,
                           generator=torch.Generator().manual_seed(3))
    return bundle, params, batch


def _family_grads(mesh, arch: str, rank: int,
                  rules: dict = TRAIN_RULES) -> dict:
    """One sharded loss-and-gradient of `arch`'s smoke config on this
    mesh under `rules`, the gradient gathered whole (rank 0's returned),
    and the tensor-parallel axes of its train context."""
    from repro_torch.distributed.sharding import tp_axes as model_axes
    bundle, params, batch = _family_inputs(arch)
    layout = ST.train_layout(bundle, mesh, B, rules)
    local = shard_tree(params, layout.specs, mesh)
    loss, grads = ST.sharded_loss_and_grads(
        bundle, local, layout.local_batch(batch), layout)
    with use_sharding(mesh, rules, {"batch": B}, params=layout.specs,
                      batch_axes=layout.batch_axes):
        tp_axes = model_axes()
    spec_of = dict(leaves(layout.specs))
    whole = {"/".join(p): gather(g, spec_of[p], mesh).numpy()
             for p, g in leaves(grads)}
    return {"loss": float(loss), "grads": whole if rank == 0 else None,
            "tp_axes": tp_axes}


def _noisy_engine(backend: str):
    """An IS engine with per-shot noise on the activations."""
    from repro_torch import rosa
    from repro_torch.core import mrr
    from repro_torch.core.constants import Mapping
    from repro_torch.rosa.backends import RosaConfig
    return rosa.Engine.from_config(
        RosaConfig(noise=mrr.PAPER_NOISE, mapping=Mapping.IS,
                   backend=backend), key=torch.Generator().manual_seed(3))


def _noisy_inputs(float64: bool = False):
    cfg = dataclasses.replace(get_smoke("qwen3-32b"), rosa_mlp=True)
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    batch = TokenPipeline(cfg.vocab, S, B, seed=1).batch(0)
    if float64:
        params = map_tree(lambda t: t.double(), params)
        batch = {k: v.double() if v.is_floating_point() else v
                 for k, v in batch.items()}
    return bundle, params, batch


@contextlib.contextmanager
def _float64():
    """Every op of the model in float64: its statistics' `Tensor.float()`
    casts made `double()` while the context is live (as
    `tools/split_float_order.py --float64` runs it)."""
    real = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        torch.Tensor.float = real


# the noisy step's layouts: under `TRAIN_RULES` (the rows over "data",
# heads and MLP split over "model") in float64; under `ZERO3_TRAIN_RULES`
# (the rows over every rank, each layer gathered whole) in float32
NOISY_LAYOUTS = {"train": (TRAIN_RULES, True),
                 "zero3": (ZERO3_TRAIN_RULES, False)}


def _noisy(mesh, rank: int) -> dict:
    """A noisy IS step's loss and gradient (rank 0's gathered whole) on
    this mesh in each of `NOISY_LAYOUTS`, through the composed "ref"
    chain and the plain `rosa_fused` version."""
    from repro_torch import rosa
    from repro_torch.distributed.sharding import tp_axes as model_axes
    out = {}
    for name, (rules, wide) in NOISY_LAYOUTS.items():
        with _float64() if wide else contextlib.nullcontext():
            bundle, params, batch = _noisy_inputs(wide)
            layout = ST.train_layout(bundle, mesh, B, rules)
            local = shard_tree(params, layout.specs, mesh)
            spec_of = dict(leaves(layout.specs))
            with use_sharding(mesh, rules, {"batch": B}, params=layout.specs,
                              batch_axes=layout.batch_axes):
                tp_axes = model_axes()
            for backend in ("ref", "fused"):
                with rosa.engine_context(_noisy_engine(backend)):
                    loss, grads = ST.sharded_loss_and_grads(
                        bundle, local, layout.local_batch(batch), layout)
                # every rank joins the gathers; rank 0's are returned
                whole = {"/".join(p): gather(g, spec_of[p], mesh).numpy()
                         for p, g in leaves(grads)}
                out[name, backend] = {"loss": float(loss), "tp_axes": tp_axes,
                                      "grads": whole if rank == 0 else None}
    return out


def _chip_engine(backend: str, mapping: str):
    """A noisy engine with a pinned chip (its lanes over each MLP
    projection's K) and a ledger, `mapping` "WS" or "IS"."""
    from repro_torch import rosa
    from repro_torch.core import mrr
    from repro_torch.core.constants import Mapping
    from repro_torch.robust.variation import sample_chip
    from repro_torch.rosa.backends import RosaConfig
    from repro_torch.rosa.ledger import EnergyLedger
    cfg = get_smoke("qwen3-32b")
    chip = sample_chip(torch.Generator().manual_seed(7),
                       {"mlp/wi": cfg.d_model, "mlp/wo": cfg.d_ff})
    return rosa.Engine.from_config(
        RosaConfig(noise=mrr.PAPER_NOISE, mapping=Mapping[mapping],
                   backend=backend), key=torch.Generator().manual_seed(3),
        ledger=EnergyLedger()).with_variation(chip)


OPTICAL_CASES = [(m, b) for m in ("WS", "IS") for b in ("ref", "fused")]


def _optical(mesh, rank: int) -> dict:
    """(b): the noisy optical step with a pinned chip on this mesh, WS
    and IS, through the composed "ref" chain and the plain `rosa_fused`
    version: loss, gradient (rank 0's, gathered whole) and the ledger's
    events; and the WS "ref" step with the weights' draws made at the
    local shape (the fault a split must not make)."""
    from repro_torch import rosa
    from repro_torch.core import mrr
    bundle, params, batch = _noisy_inputs()
    layout = ST.train_layout(bundle, mesh, B)
    local = shard_tree(params, layout.specs, mesh)
    spec_of = dict(leaves(layout.specs))

    def step(mapping, backend):
        eng = _chip_engine(backend, mapping)
        with rosa.engine_context(eng):
            loss, grads = ST.sharded_loss_and_grads(
                bundle, local, layout.local_batch(batch), layout)
        whole = {"/".join(p): gather(g, spec_of[p], mesh).numpy()
                 for p, g in leaves(grads)}
        return {"loss": float(loss), "grads": whole if rank == 0 else None,
                "ledger": [dataclasses.astuple(e) for e in eng.ledger.events]}
    out = {c: step(*c) for c in OPTICAL_CASES}
    real = mrr.draw_eps
    mrr.draw_eps = mrr._eps_pair
    try:
        out["local_draws"] = step("WS", "ref")
    finally:
        mrr.draw_eps = real
    return out


def _vocab(mesh) -> dict:
    """(a): a tied table's lookup and logits split by vocab rows over
    "model" (`embed_apply`, `softmax_xent(vocab_axes=)`, masked), against
    the whole table's: the loss, each position's -log softmax and the
    logits' max, and the table's gradient (this rank's rows; the one
    table collects both uses)."""
    from repro_torch.distributed import runtime as rt
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(5)
    v, d, n = 256, 64, runtime.axis_index("model", mesh)
    table = torch.randn(v, d, generator=g)
    x = torch.randn(B, S, d, generator=g)
    tokens = torch.randint(0, v, (B, S), generator=g)
    labels = torch.randint(0, v, (B, S), generator=g)
    mask = (torch.rand(B, S, generator=g) > 0.3).float()

    def run(t, axes):
        h = torch.tanh(L.embed_apply(t, tokens, axes) + x)
        logits = torch.einsum("bsd,vd->bsv", h, t)
        return logits, L.softmax_xent(logits, labels, mask, axes)
    whole = table.clone().requires_grad_()
    logits, loss = run(whole, ())
    loss.backward()
    rows = v // mesh.size(1)
    mine = table[n * rows:(n + 1) * rows].clone().requires_grad_()
    with use_sharding(mesh, TRAIN_RULES):
        part, split = run(mine, ("model",))
        nll = L._split_nll(part.float(), labels, ("model",))
        top = rt.pmax(part.detach().amax(-1), "model")
    (split / mesh.size(1)).backward()       # the model ranks' copies
    want_nll = (torch.logsumexp(logits, -1)
                - torch.gather(logits, -1, labels[..., None])[..., 0])
    return {"loss": (float(split), float(loss)),
            "nll": (nll.detach().numpy(), want_nll.detach().numpy()),
            "max": (top.numpy(), logits.detach().amax(-1).numpy()),
            "grad": (mine.grad.numpy(),
                     whole.grad[n * rows:(n + 1) * rows].numpy())}


def _ssm_split(mesh, groups: int = 1) -> dict:
    """(c): mamba2-smoke's block (with `groups` B / C groups) on this
    rank's heads (the scan over them and the groups they read, the gated
    norm's statistics and `w_out`'s partial output summed over "model")
    against the whole block: output, the input's gradient and every
    leaf's (this rank's block; the group leaves' summed over the
    copies), and the split `rmsnorm` alone."""
    from repro_torch.distributed import runtime as rt
    from repro_torch.distributed.sharding import (local_specs,
                                                  param_shardings,
                                                  shard_local)
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SSM
    from repro_torch.models.module import init_params
    cfg = dataclasses.replace(get_smoke("mamba2-1.3b").ssm,
                              n_groups=groups)
    skel = SSM.ssm_def(cfg)
    p = init_params(skel, torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(6)
    u = torch.randn(B, S, cfg.d_model, generator=g)
    gy = torch.randn(B, S, cfg.d_model, generator=g)
    specs = map_tree(lambda sh: sh.spec,
                     param_shardings(skel, mesh, TRAIN_RULES))
    tp = local_specs(specs, lambda path: ("model",))
    whole = {k: t.clone().requires_grad_() for k, t in p.items()}
    uw = u.clone().requires_grad_()
    y = SSM.ssm_apply(whole, cfg, uw)
    (y * gy).sum().backward()
    mine = {k: shard_local(t, tp[k], mesh).clone().requires_grad_()
            for k, t in p.items()}
    ul = u.clone().requires_grad_()
    copies = mesh.size(1)
    with use_sharding(mesh, TRAIN_RULES):
        yl = SSM.ssm_apply(mine, cfg, ul, tp)
        ((yl * gy).sum() / copies).backward()
        # a leaf held whole on every model rank: its copies' gradients
        grads = {k: (rt.psum(t.grad, "model") if not tp[k] else t.grad)
                 for k, t in mine.items()}
        du = rt.psum(ul.grad, "model")
        # the gated norm alone, over 2 x 3 rows of a (2, 3, 128) input
        xn = torch.randn(2, 3, cfg.d_inner, generator=g)
        sc = torch.rand(cfg.d_inner, generator=g) + 0.5
        gn = torch.randn(2, 3, cfg.d_inner, generator=g)
        k = cfg.d_inner // copies
        lo = runtime.axis_index("model", mesh) * k
        xs = xn[..., lo:lo + k].clone().requires_grad_()
        ss = sc[lo:lo + k].clone().requires_grad_()
        yn = L.rmsnorm(ss, xs, axes=("model",), n=cfg.d_inner)
        (yn * gn[..., lo:lo + k]).sum().backward()
    xw, sw = xn.clone().requires_grad_(), sc.clone().requires_grad_()
    yw = L.rmsnorm(sw, xw)
    (yw * gn).sum().backward()
    return {"y": (yl.detach().numpy(), y.detach().numpy()),
            "du": (du.numpy(), uw.grad.numpy()),
            "grads": {k: (grads[k].numpy(), shard_local(
                whole[k].grad, tp[k], mesh).numpy()) for k in p},
            "norm": {"y": (yn.detach().numpy(), yw[..., lo:lo + k]
                           .detach().numpy()),
                     "dx": (xs.grad.numpy(), xw.grad[..., lo:lo + k]
                            .numpy()),
                     "dscale": (ss.grad.numpy(), sw.grad[lo:lo + k]
                                .numpy())}}


def _gqa_split(mesh) -> dict:
    """Grouped-query attention whose one KV head does not split over the
    2 model ranks while its 4 query heads do: each rank takes its 2 query
    heads and the KV head they read, `wo`'s rows summed over "model";
    output, the input's gradient and every leaf's (this rank's block, the
    whole KV projections' summed over the copies) against the whole
    layer's."""
    from repro_torch.distributed import runtime as rt
    from repro_torch.distributed.sharding import (local_specs,
                                                  param_shardings,
                                                  shard_local)
    from repro_torch.models import layers as L
    from repro_torch.models.module import init_params
    cfg = L.AttnConfig(d_model=32, n_heads=4, n_kv_heads=1, head_dim=8,
                       qk_norm=True)
    skel = L.attn_def(cfg)
    p = init_params(skel, torch.Generator().manual_seed(8))
    g = torch.Generator().manual_seed(9)
    x = torch.randn(B, S, cfg.d_model, generator=g)
    gy = torch.randn(B, S, cfg.d_model, generator=g)
    pos = torch.arange(S)[None].expand(B, S)
    tp = local_specs(map_tree(lambda sh: sh.spec, param_shardings(
        skel, mesh, TRAIN_RULES)), lambda path: ("model",))
    whole = {k: t.clone().requires_grad_() for k, t in p.items()}
    xw = x.clone().requires_grad_()
    (L.attn_apply(whole, cfg, xw, pos) * gy).sum().backward()
    mine = {k: shard_local(t, tp[k], mesh).clone().requires_grad_()
            for k, t in p.items()}
    xl = x.clone().requires_grad_()
    with use_sharding(mesh, TRAIN_RULES):
        y = L.attn_apply(mine, cfg, xl, pos, tp=tp)
        ((y * gy).sum() / mesh.size(1)).backward()
        grads = {k: (rt.psum(t.grad, "model") if not tuple(tp[k])
                     else t.grad) for k, t in mine.items()}
        dx = rt.psum(xl.grad, "model")
    return {"specs": {k: tuple(v) for k, v in tp.items()},
            "y": (y.detach().numpy(), (L.attn_apply(p, cfg, x, pos))
                  .detach().numpy()),
            "dx": (dx.numpy(), xw.grad.numpy()),
            "grads": {k: (grads[k].numpy(), shard_local(
                whole[k].grad, tp[k], mesh).numpy()) for k in p}}


def _known_state(np_p: dict) -> dict:
    """{"params", "opt"} of mistral-smoke with moments of known numbers."""
    params = map_tree(torch.from_numpy, np_p)
    mu = map_tree(lambda t: t * 0.5 + 1.0, params)
    nu = map_tree(lambda t: t * t, params)
    return {"params": params,
            "opt": {"adam": {"mu": mu, "nu": nu,
                             "step": torch.tensor(2, dtype=torch.int32)}}}


def train_group(rank: int, world: int, device, shape, cases, np_params,
                root, extras: tuple) -> dict:
    torch.set_num_threads(1)
    mesh = make_test_mesh(*shape)
    out = {"train": {(a, c): _train(mesh, a, c, np_params[a], rank)
                     for a, c in cases}}
    if "toy" in extras:
        out["toy"] = _toy(mesh)
    if "collectives" in extras:
        from test_torch_ranks import _collectives
        out["collectives"] = _collectives(mesh, rank)
    if "scales" in extras:
        out["scales"] = _scales(mesh)
    if "families" in extras:
        out["families"] = {a: _family_grads(mesh, a, rank)
                           for a in FAMILY_ARCHS}
        out["zero3"] = {a: _family_grads(mesh, a, rank, ZERO3_TRAIN_RULES)
                        for a in FAMILY_ARCHS}
    if "noisy" in extras:
        out["noisy"] = _noisy(mesh, rank)
    if "tp" in extras:
        out["model_shard"] = _model_shard(mesh)
        out["flops"] = _flops(mesh)
    if "split" in extras:
        out["optical"] = _optical(mesh, rank)
        out["vocab"] = _vocab(mesh)
        out["ssm"] = {g: _ssm_split(mesh, g) for g in (1, 2)}
        out["gqa"] = _gqa_split(mesh)
    if "ckpt" in extras:
        out["ckpt"] = _ckpt(mesh, np_params["mistral-large-123b"], root,
                            rank)
    return out


@pytest.fixture(scope="module")
def port(ref_run, np_params, tmp_path_factory):
    """Both meshes' groups at once (each a group of its own), beside the
    reference's subprocess."""
    from concurrent.futures import ThreadPoolExecutor
    root = str(tmp_path_factory.mktemp("train_ranks_ckpt"))
    # the one-process file the (2, 2) group restores
    CK.save(os.path.join(root, "one"), 2,
            _known_state(np_params["mistral-large-123b"]), {"arch": "x"})

    # (key, mesh, cases, extras): the groups of CASES, and the other
    # families' steps, gradients and the noisy step on (2, 2)
    groups = [(m, m, [(a, c) for a, mm, c in CASES if mm == m],
               ("toy", "scales", "ckpt", "tp") if m == (2, 2) else ())
              for m in MESHES]
    groups.append(("families", (2, 2), [(a, False) for a in FAMILY_ARCHS],
                   ("families", "noisy")))
    # the tensor-parallel checks on (data 1, model 2)
    groups.append(("split", (1, 2), [], ("split",)))

    def group(g):
        _, shape, cases, extras = g
        return runtime.spawn(train_group, shape[0] * shape[1],
                             device_type="cpu",
                             backend="gloo",
                             args=(shape, cases, np_params, root, extras),
                             timeout=TIMEOUT)
    with ThreadPoolExecutor(len(groups)) as ex:
        out = dict(zip([g[0] for g in groups], ex.map(group, groups)))
    out["root"] = root
    return out


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------
def _spread(arrays) -> np.ndarray:
    a = np.stack([np.asarray(x, np.float64) for x in arrays])
    return a.max(0) - a.min(0)


@pytest.mark.parametrize("arch,shape,compress", CASES,
                         ids=[f"{a}-{m[0]}x{m[1]}" + ("-compress" if c else "")
                              for a, m, c in CASES])
def test_sharded_steps_match_reference_sharded_steps(ref, port, np_params,
                                                     arch, shape, compress):
    """The gloo groups' steps against the reference's sharded steps
    (`_hold_to_reference`)."""
    _hold_to_reference(ref, port[shape], np_params, arch, shape, compress)


def card_group(rank: int, world: int, device) -> dict:
    """The collectives and the toy step on CUDA tensors of ranks that
    share card 0 (the card buffers), and a `gather_many` and its
    backward."""
    from test_torch_ranks import _collectives
    mesh = make_test_mesh(2, 2, "cuda")
    toy = runtime.toy_grads(mesh, device=device)
    ts = [torch.arange(6, dtype=torch.float32, device=device).reshape(2, 3)
          + 10 * rank,
          torch.arange(4, dtype=torch.float32, device=device) + rank]
    ts = [t.requires_grad_() for t in ts]
    got = runtime.gather_many(ts, [((0, ("data", "model")),),
                                   ((0, ("model",)),)], mesh)
    torch.autograd.backward(got, [torch.ones_like(g) for g in got])
    return {"collectives": _collectives(mesh, rank, device),
            "toy": {n: (a.cpu().numpy(), b.cpu().numpy())
                    for n, (a, b) in toy.items()},
            "gathered": [g.detach().cpu().numpy() for g in got],
            "grads": [t.grad.cpu().numpy() for t in ts]}


@pytest.mark.cuda
def test_shm_transport_steps_and_collectives():
    """The card buffers that carry the CUDA collectives of ranks sharing
    card 0 (a gloo group): the collectives' values those of gloo on the
    CPU (`test_torch_ranks`' numpy expectations), the toy step's gradient
    blocks the one-process ones, and `gather_many` (two tensors, one
    collective a mesh axis) with its reduce-scatter backward: every
    rank's copy of a gathered tensor feeds the sum, so each block's
    gradient is the number of ranks that gathered it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (ranks sharing card 0)")
    from test_torch_ranks import test_collectives_on_a_2x2_mesh
    outs = runtime.spawn(card_group, 4, device_type="cuda", backend="gloo",
                         timeout=TIMEOUT)
    test_collectives_on_a_2x2_mesh(outs)
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    for r, out in enumerate(outs):
        for n, (got, want) in out["toy"].items():
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=n)
        d = r // 2
        np.testing.assert_array_equal(out["gathered"][0], np.concatenate(
            [base + 10 * q for q in range(4)]))
        np.testing.assert_array_equal(out["gathered"][1], np.concatenate(
            [np.arange(4, dtype=np.float32) + q for q in (2 * d, 2 * d + 1)]))
        np.testing.assert_array_equal(out["grads"][0], np.full((2, 3), 4.0))
        np.testing.assert_array_equal(out["grads"][1], np.full(4, 2.0))


def _hold_to_reference(ref, group, np_params, arch, shape, compress,
                       layouts=REF_LAYOUTS):
    """The port's steps on four ranks against the reference's on the same
    mesh: losses and |g| within 1e-5, or within 4x the spread of the
    reference's own `layouts` (one device, (2, 2), (4, 1)) at that step
    where that is wider (the repo's 4x float-order floor; the spread
    reached 2.1e-5 of mistral's third |g|: float order, which AdamW's
    normalization of near-cancelling gradients grows from step to step).
    The params after them gathered, each leaf by
    `test_torch_train.py::test_train_step_loop_matches_reference`'s rule
    (all but 0.1 % of the entries within 1e-5 of the leaf's max, or within
    4x the reference layouts' largest spread on that leaf where that is
    wider: a zero-initialized leaf holds only updates; every entry within
    the largest update the reference made to it)."""
    runs = [ref[(arch, m, compress)] for m in layouts]
    losses, norms, want_p = ref[(arch, shape, compress)]
    got = [r["train"][(arch, compress)] for r in group]
    for r in got:                  # every rank reports the global numbers
        for name, want, i in (("losses", losses, 0), ("norms", norms, 1)):
            want = np.asarray(want)
            bound = np.maximum(1e-5 * np.abs(want),
                               4 * _spread([run[i] for run in runs]))
            dev = np.abs(np.asarray(r[name]) - want)
            assert (dev <= bound).all(), (name, r[name], want, bound)
    flat = [dict(("/".join(p), np.asarray(v)) for p, v in leaves(run[2]))
            for run in runs]
    want, p0 = (dict(("/".join(p), np.asarray(v)) for p, v in leaves(t))
                for t in (want_p, np_params[arch]))
    assert set(got[0]["params"]) == set(want)
    for k, v in got[0]["params"].items():
        d = np.abs(v - want[k])
        thr = max(1e-5 * np.abs(want[k]).max(),
                  4 * _spread([f[k] for f in flat]).max())
        assert (d > thr).mean() <= 1e-3, k
        assert d.max() <= np.abs(want[k] - p0[k]).max(), k


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "4x1"])
def test_rank_bytes_equal_train_rules_shard_bytes(port, shape):
    """Each rank holds exactly its `TRAIN_RULES` shards: params, moments
    (and `err`) at the sum of their `local_shape` bytes."""
    for r in port[shape]:
        for case, res in r["train"].items():
            assert res["held"] == res["want"], (case, res)
            if shape == (2, 2):
                # a quarter of every leaf that splits four ways, and so
                # strictly less than the one-process state
                n = build_model(_cfg(case[0])).n_params
                assert res["held"] < 4 * n * (4 if case[1] else 3), case


def test_collective_transposes_on_a_toy_step(port):
    """The toy step's gradient shards equal the one-process gradient's
    blocks on every rank: a leaf replicated on every rank, one sharded
    over "data" and gathered (replicated over "model"), a column-split /
    row-split pair under a `psum`, a vocab-parallel cross entropy, and a
    global `amax` scale.  The two faults are
    caught: counting every model rank's copy whole, and a `psum` whose
    transpose drops the other ranks' cotangents."""
    for r in port[(2, 2)]:
        toy = r["toy"]
        for n, (got, want) in toy["right"].items():
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=n)
        copies = toy["copies"]
        assert not np.allclose(*copies["w1"], rtol=1e-3)
        assert not np.allclose(*copies["b"], rtol=1e-3)
        dropped = toy["dropped"]
        for n in ("w2", "w3", "w4"):
            assert not np.allclose(*dropped[n], rtol=1e-3), n


def test_activation_full_scale_spans_the_global_batch(port):
    """Under data parallelism a per-tensor activation full-scale is the
    whole batch's (`jnp.max` over a sharded batch): the plain
    `rosa_fused` version and the "ref" chain on a rank's rows equal the
    whole batch's rows, though only one data rank holds the max; the
    masked loss's sums span the ranks too."""
    for r, out in enumerate(port[(2, 2)]):
        sc = out["scales"]
        assert sc["scale"] == 9.0
        if r // 2 == 0:
            assert sc["local_scale"] < 9.0     # this rank's rows alone
        np.testing.assert_array_equal(sc["fused"], sc["whole_fused"])
        np.testing.assert_array_equal(sc["ref"], sc["whole_ref"])
        np.testing.assert_allclose(sc["xent"], sc["xent_whole"], rtol=1e-6)


def _members(path: str) -> dict:
    with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_rank_save_equals_one_process_save_byte_for_byte(port):
    """A save from the (2, 2) ranks writes the one-process files: every
    npz member and the manifest byte for byte (the zip's timestamps
    aside); the one-process file restores onto the ranks' shards, a leaf
    above 1 MiB through its member mapped in place."""
    root = port["root"]
    one, ranks = (os.path.join(root, d, "step_00000002")
                  for d in ("one", "ranks"))
    assert _members(ranks) == _members(one)
    for d in (one, ranks):
        assert sorted(os.listdir(d)) == ["arrays.npz", "manifest.json"]
    with open(os.path.join(one, "manifest.json"), "rb") as a, \
            open(os.path.join(ranks, "manifest.json"), "rb") as b:
        assert a.read() == b.read()
    assert all(r["ckpt"]["restored_equal"] for r in port[(2, 2)])
    # the large leaf: written whole, mapped in place, each rank's shard
    big = os.path.join(root, "big", "step_00000001", "arrays.npz")
    with zipfile.ZipFile(big) as z:
        mapped = CK._mapped(big, z, "w.npy")
        assert mapped is not None
        np.testing.assert_array_equal(mapped, _big_leaf()["w"].numpy())
    assert all(r["ckpt"]["big_equal"] for r in port[(2, 2)])


# the leaves a rank keeps split over "model" (the tensor-parallel dims:
# heads, KV heads, MLP, vocab, SSM heads) on (2, 2)
MODEL_SHARD = {
    "mistral-large-123b": ("layers/attn/wq", "layers/attn/wk",
                           "layers/attn/wv", "layers/attn/wo",
                           "layers/ffn/wi", "layers/ffn/wo", "embed",
                           "unembed"),
    "mamba2-1.3b": tuple(f"layers/ssm/{k}" for k in (
        "w_x", "w_z", "w_dt", "dt_bias", "a_log", "d_skip", "conv_x",
        "gate_norm", "w_out")) + ("embed",),
    "qwen3-moe-235b-a22b": ("layers/attn/wq", "layers/attn/wk",
                            "layers/attn/wv", "layers/attn/wo", "embed",
                            "unembed"),
}


def test_ranks_compute_their_model_shard(port):
    """Tensor-parallel compute: under a live train context a rank's layer
    slice and top-level leaves come gathered over "data" but keep their
    "model" dim local (heads, KV heads, MLP, vocab, SSM heads): each is
    this rank's block of the whole leaf by its local spec, which splits
    exactly the tensor-parallel leaves over "model" (half of the dim on
    (2, 2)); every other leaf whole; the MoE experts, which
    `moe_ep_local` takes split over "model", 4 of 8 a rank and not
    gathered."""
    for r in port[(2, 2)]:
        for arch, res in r["model_shard"].items():
            for k, (shape, whole, spec, equal) in res.items():
                if arch.startswith("qwen3-moe") and k in (
                        "layers/ffn/wi", "layers/ffn/wo"):
                    assert shape[0] == 4 and not equal, (arch, k)
                    continue
                assert equal, (arch, k)
                if k in MODEL_SHARD[arch]:
                    assert tuple(spec) and all(
                        p in (None, "model") for p in spec), (arch, k, spec)
                    dim = list(spec).index("model")
                    assert shape[dim] * 2 == whole[dim], (arch, k)
                else:
                    assert not any(spec) and shape == whole, (arch, k)


def test_rank_flops_are_a_share_of_the_step(port):
    """(d) A rank's matmul FLOPs of a sharded loss-and-gradient
    (`FlopCounterMode`, mistral-smoke on (2, 2)) are 1 / (data x model)
    of the one-process step's, within 3 %: no rank computes another's
    heads, MLP units or vocab rows."""
    for r in port[(2, 2)]:
        f = r["flops"]
        assert abs(f["rank"] / f["one"] - 0.25) <= 0.03 * 0.25, f


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_sharded_steps_match_reference_sharded_steps(ref, port,
                                                            np_params, arch):
    """zamba2, deepseek-v2 (expert-parallel), seamless and phi-3-vision on
    (2, 2): the port's steps against the reference's (2, 2) steps on the
    same batch with its frontend's inputs (`_hold_to_reference`, the
    reference's one-device steps giving the spread)."""
    _hold_to_reference(ref, port["families"], np_params, arch, (2, 2),
                       False, FAMILY_LAYOUTS)


def _permuted_floor(bundle, params, batch, grads, seeds=(1, 2)) -> dict:
    """The one-process step's float-order floor a leaf: the largest
    distance of its gradient (over its max) from the same step with the
    params' d_model axis permuted (the same function, every contraction
    over d_model summed in another order), over `seeds`."""
    axes = dict(leaves(map_tree(lambda d: d.axes, bundle.skeleton)))
    d = bundle.cfg.d_model
    floor = {"/".join(p): 0.0 for p, _ in leaves(grads)}
    for seed in seeds:
        perm = torch.randperm(d, generator=torch.Generator().manual_seed(seed))

        def pm(path, t):
            for ax, name in enumerate(axes[path]):
                if name == "embed":
                    t = t.index_select(ax, perm)
            return t
        _, g2 = ST.loss_and_grads(bundle, unflatten(
            (p, pm(p, t)) for p, t in leaves(params)), batch)
        got = dict(leaves(g2))
        for p, g in leaves(grads):
            k = "/".join(p)
            floor[k] = max(floor[k], float((pm(p, g) - got[p]).abs().max())
                           / float(g.abs().max() + 1e-30))
    return floor


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_every_family_gradient_across_ranks_equals_one_process(port, arch):
    """zamba2's groups, tail and shared block, deepseek-v2's MLA and
    `layer0`, seamless's encoder and cross attention, phi-3-vision's patch
    rows under `TRAIN_RULES` on (2, 2): each rank computes
    its heads, MLP units, SSM heads and vocab rows (`("model",)` its
    tensor-parallel axes), and the loss and gathered gradient equal the
    one-process ones within 1e-5 (the loss) and, per leaf, 1e-5 of its
    max or 4x the one-process step's float-order floor where that is
    wider (`_permuted_floor`: the split sums over heads and MLP units in
    another order, and zamba2-smoke's gradient moves up to 8.7e-4 under
    a permuted d_model: `tools/split_float_order.py`)."""
    bundle, params, batch = _family_inputs(arch)
    loss, grads = ST.loss_and_grads(bundle, params, batch)
    floor = _permuted_floor(bundle, params, batch, grads)
    for r in port["families"]:
        assert r["families"][arch]["tp_axes"] == ("model",)
        np.testing.assert_allclose(r["families"][arch]["loss"], float(loss),
                                   rtol=1e-5)
    got = port["families"][0]["families"][arch]["grads"]
    for p, g in leaves(grads):
        k = "/".join(p)
        scale = float(g.abs().max())
        np.testing.assert_allclose(
            got[k], g.numpy(), rtol=0,
            atol=max(1e-5, 4 * floor[k]) * scale + 1e-12, err_msg=k)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_every_family_gradient_under_zero3_equals_one_process(port, arch):
    """(e) The same families with every layer gathered whole: under `ZERO3_TRAIN_RULES` (the
    batch over the whole (2, 2) mesh, so no tensor-parallel axis: (e))
    the ranks' loss and gathered gradient equal the port's one-process
    ones (1e-5; float order only: the rows' sums split)."""
    bundle, params, batch = _family_inputs(arch)
    loss, grads = ST.loss_and_grads(bundle, params, batch)
    for r in port["families"]:
        assert r["zero3"][arch]["tp_axes"] == ()
        np.testing.assert_allclose(r["zero3"][arch]["loss"], float(loss),
                                   rtol=1e-5)
    got = port["families"][0]["zero3"][arch]["grads"]
    for p, g in leaves(grads):
        k = "/".join(p)
        scale = float(g.abs().max())
        np.testing.assert_allclose(got[k], g.numpy(), rtol=0,
                                   atol=1e-5 * scale + 1e-12, err_msg=k)


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_noisy_step_across_ranks_equals_one_process(port, backend):
    """A noisy IS step (per-shot noise on the activations) on (2, 2) under
    `TRAIN_RULES`, the layout `launch.train --devices 4 --data-axis 2`
    trains with: each rank draws its rows and MLP columns of the global
    activations' offsets (`draw_act_eps` cuts a row offset and columns),
    and its full-scales span "data" and "model" together
    (`act_absmax_scale`), so the loss and the gathered gradient equal the
    one-process step's, through the composed "ref" chain and the plain
    `rosa_fused` version.  Both sides run every op in float64 and are
    held within 1e-10 of each leaf's max: in float32 the split's partial
    sums reorder this config's activations enough to flip one 8-bit code
    (2.37e-5 off on the loss; 2.5e-15 in float64,
    `tools/split_float_order.py --noisy ref [--float64]`), and a permuted
    d_model is no floor here, since the draws do not move with it (the
    tool's 5.4e-1).  Drawn at the local shape, ranks would repeat each
    other's offsets."""
    from repro_torch import rosa
    with _float64():
        bundle, params, batch = _noisy_inputs(True)
        with rosa.engine_context(_noisy_engine(backend)):
            loss, grads = ST.loss_and_grads(bundle, params, batch)
    for r in port["families"]:
        got = r["noisy"]["train", backend]
        assert got["tp_axes"] == ("model",)
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-10)
    got = port["families"][0]["noisy"]["train", backend]["grads"]
    for p, g in leaves(grads):
        k = "/".join(p)
        scale = float(g.abs().max())
        np.testing.assert_allclose(got[k], g.numpy(), rtol=0,
                                   atol=1e-10 * scale + 1e-30, err_msg=k)


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_noisy_step_under_zero3_equals_one_process(port, backend):
    """(e) The same noisy step in float32 under `ZERO3_TRAIN_RULES`: the
    (2, 2) ranks, each with one row of the batch and every layer gathered
    whole, draw their rows' offsets of the global batch's draws, so the
    loss and the gathered gradient equal the one-process step's (1e-5 of
    each leaf's max; float order only)."""
    from repro_torch import rosa
    bundle, params, batch = _noisy_inputs()
    with rosa.engine_context(_noisy_engine(backend)):
        loss, grads = ST.loss_and_grads(bundle, params, batch)
    for r in port["families"]:
        got = r["noisy"]["zero3", backend]
        assert got["tp_axes"] == ()
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    got = port["families"][0]["noisy"]["zero3", backend]["grads"]
    for p, g in leaves(grads):
        k = "/".join(p)
        scale = float(g.abs().max())
        np.testing.assert_allclose(got[k], g.numpy(), rtol=0,
                                   atol=1e-5 * scale + 1e-12, err_msg=k)


@pytest.mark.parametrize("mapping,backend", OPTICAL_CASES,
                         ids=[f"{m}-{b}" for m, b in OPTICAL_CASES])
def test_optical_split_step_equals_one_process(port, mapping, backend):
    """(b) A noisy optical step with a pinned chip on (data 1, model 2):
    `wi`'s columns and `wo`'s rows split, its full-scales the global
    operands' and its draws made at the whole operand's shape (each rank
    keeping its block), through the composed "ref" chain and the plain
    `rosa_fused` version, WS and IS.  The loss and the gathered gradient
    equal the one-process step's (1e-5 of each leaf's max), and so does
    the ledger: each product recorded once at its global shape."""
    from repro_torch import rosa
    bundle, params, batch = _noisy_inputs()
    eng = _chip_engine(backend, mapping)
    with rosa.engine_context(eng):
        loss, grads = ST.loss_and_grads(bundle, params, batch)
    want_ledger = [dataclasses.astuple(e) for e in eng.ledger.events]
    for r in port["split"]:
        got = r["optical"][(mapping, backend)]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        assert got["ledger"] == want_ledger
    got = port["split"][0]["optical"][(mapping, backend)]["grads"]
    for p, g in leaves(grads):
        k = "/".join(p)
        scale = float(g.abs().max())
        np.testing.assert_allclose(got[k], g.numpy(), rtol=0,
                                   atol=1e-5 * scale + 1e-12, err_msg=k)


def test_optical_split_draws_span_the_whole_weight(port):
    """Drawn at the local shape (the fault), both model ranks realize the
    same offsets on their different columns: the WS step's MLP gradients
    move off the one-process step's, where the global draws hold them
    (`test_optical_split_step_equals_one_process`)."""
    from repro_torch import rosa
    bundle, params, batch = _noisy_inputs()
    with rosa.engine_context(_chip_engine("ref", "WS")):
        _, grads = ST.loss_and_grads(bundle, params, batch)
    got = port["split"][0]["optical"]["local_draws"]["grads"]
    g = dict(leaves(grads))[("layers", "ffn", "wi")].numpy()
    assert not np.allclose(got["layers/ffn/wi"], g, rtol=0,
                           atol=1e-3 * np.abs(g).max())


def test_vocab_split_loss_and_table_gradient(port):
    """(a) A tied table split by vocab rows over "model" on (1, 2): the
    masked loss, each position's -log softmax (the logsumexp from the
    `pmax` of the blocks' maxima and the `psum` of their shifted sums,
    the gold logit from its owner), the logits' max, and the table's
    gradient rows (its lookup and its logits) equal the whole table's."""
    for r in port["split"]:
        v = r["vocab"]
        np.testing.assert_allclose(*v["loss"], rtol=1e-6)
        np.testing.assert_allclose(*v["nll"], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(*v["max"])
        got, want = v["grad"]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("groups", [1, 2])
def test_ssm_split_heads_equal_whole(port, groups):
    """(c) mamba2-smoke's block on a rank's 4 of 8 heads on (1, 2), with
    one B / C group and with two (a rank's heads reading one): the scan
    over them, the gated norm's statistics and its hand-written backward
    `psum`-med over "model" (`rmsnorm(axes=)`), `w_out`'s partial output
    summed: the output, the input's gradient and every leaf's equal the
    whole block's (1e-5 of each one's max), and so does the split
    `rmsnorm` against the whole one (1e-6)."""
    for r in port["split"]:
        s = r["ssm"][groups]
        for name, (got, want) in [("y", s["y"]), ("du", s["du"])] + list(
                s["grads"].items()):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=name)
        for name, (got, want) in s["norm"].items():
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=name)


def test_gqa_split_over_whole_kv_heads(port):
    """Grouped-query attention on (1, 2) whose KV head does not divide
    over the model ranks (4 query heads, 1 KV head): the query heads and
    `wo` split, `wk` / `wv` whole, each rank's heads reading their KV
    head; the output, the input's gradient and every leaf's equal the
    whole layer's (1e-5 of each one's max)."""
    for r in port["split"]:
        q = r["gqa"]
        assert "model" in q["specs"]["wq"] and "model" in q["specs"]["wo"]
        assert not any(q["specs"]["wk"]) and not any(q["specs"]["wv"])
        for name, (got, want) in [("y", q["y"]), ("dx", q["dx"])] + list(
                q["grads"].items()):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=name)


def test_refusals():
    """An N that --data-axis does not divide, and a global batch that does
    not divide over the data ranks, are refused."""
    with pytest.raises(SystemExit, match="does not divide"):
        train_cli.main(["--smoke", "--device", "cpu", "--devices", "4",
                        "--data-axis", "3"])
    with pytest.raises(SystemExit, match="does not divide"):
        train_cli.main(["--smoke", "--device", "cpu", "--data-axis", "2"])
    bundle = build_model(_cfg("mistral-large-123b"))
    mesh = MeshShape(("data", "model"), (4, 1))
    with pytest.raises(ValueError, match="does not divide over"):
        ST.train_layout(bundle, mesh, 6)
    assert ST.train_layout(bundle, mesh, 8).batch_axes == ("data",)
    with pytest.raises(ValueError, match="does not divide"):
        TokenPipeline(256, 8, 6, seed=0).shard_batch(0, 0, 4)


def test_train_layout_specs_are_train_rules():
    """The layout's specs are `param_shardings` under `TRAIN_RULES`: the
    embed dims over "data", heads / mlp / vocab / experts over "model",
    the stacked layer dim whole."""
    from repro_torch.distributed.sharding import param_shardings
    bundle = build_model(_cfg("qwen3-moe-235b-a22b"))
    mesh = MeshShape(("data", "model"), (2, 2))
    lay = ST.train_layout(bundle, mesh, B)
    want = map_tree(lambda sh: sh.spec, param_shardings(
        bundle.skeleton, mesh, TRAIN_RULES))
    assert lay.specs == want
    assert lay.specs["embed"] == P("model", "data")
    assert lay.specs["layers"]["ffn"]["wi"] == P(None, "model", "data")
    assert (lay.n_row_shards, lay.n_copies) == (2, 2)


# ---------------------------------------------------------------------------
# The CLI: checkpoint and resume, the elastic restart across device counts
# ---------------------------------------------------------------------------
CLI = ["--arch", "mistral-large-123b", "--smoke", "--device", "cpu",
       "--batch", "4", "--seq", "32", "--lr", "1e-3", "--warmup", "2",
       "--log-every", "1"]


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    """`tests/test_system.py::test_train_cli_checkpoints_and_resumes` on
    the port's CLI: a checkpoint at step 4, then a resumed run."""
    base = CLI + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "4"]
    train_cli.main(base + ["--steps", "4"])
    assert os.listdir(tmp_path) == ["step_00000004"]
    train_cli.main(base + ["--steps", "6", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "done: 2 steps" in out


def test_train_cli_elastic_restart_different_device_count(tmp_path, capfd):
    """`tests/test_system.py::test_train_cli_elastic_restart_different_
    device_count` on the port's CLI: one process writes step 4, then
    `--devices 4 --data-axis 2 --resume` (a (2, 2) mesh) runs to step 6;
    its losses equal a one-process continuation from the same file."""
    base = CLI + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "4",
                  "--steps", "6"]
    train_cli.main(base[:-1] + ["4"])
    one = train_cli.run(train_cli.build_parser().parse_args(
        base + ["--resume", "--ckpt-every", "100"]))
    capfd.readouterr()
    ranks = train_cli.run(train_cli.build_parser().parse_args(
        base + ["--resume", "--ckpt-every", "100", "--devices", "4",
                "--data-axis", "2"]))
    out = capfd.readouterr().out
    assert out.count("resumed from step 4") == 1
    assert ranks["start"] == 4 and [h["step"] for h in ranks["history"]] \
        == [4, 5]
    np.testing.assert_allclose([h["loss"] for h in ranks["history"]],
                               [h["loss"] for h in one["history"]],
                               atol=6e-5)
    np.testing.assert_allclose([h["grad_norm"] for h in ranks["history"]],
                               [h["grad_norm"] for h in one["history"]],
                               rtol=1e-5)
