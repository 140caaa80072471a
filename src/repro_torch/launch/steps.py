"""Step-function factories of the launchers and the dry run (PyTorch port
of `repro.launch.steps`).  The dry run reads `opt_state_shardings` to lay
the optimizer state out on a mesh.

The train step runs on one device, or across the ranks of a live mesh
(`make_train_step(..., layout=train_layout(bundle, mesh, global_batch))`),
where the reference jits its step under `TRAIN_RULES` shardings and GSPMD
partitions it.  There each rank holds its shards of the params and the
AdamW moments (`init_sharded`, `init_opt_state`), and its rows of the
global batch (`TrainLayout.local_batch`).  The model gathers each
layer's FSDP dims where it uses them and computes its share of the
heads, MLP units and vocab over "model" (`models.transformer`: tensor
parallel, as the reference's GSPMD partitions the step), and the
gradient follows one convention (`distributed.runtime`): a rank's loss
contribution is the mean over its rows times its rows over the global
rows, over the number of ranks that hold the same rows (the product of
the mesh axes the batch does not use), so the global loss is the `psum`
of the contributions; a leaf replicated over an axis has its gradient
`psum`-med over it, and a tensor-parallel leaf, "model" in its spec,
none over "model" (each rank's block is its own).

Serving runs the same way across the ranks of a live mesh
(`make_serve_step(bundle, serve_layout(bundle, mesh, shape))`), where
the reference jits `bundle.prefill` / `bundle.decode_step` under
`SERVE_RULES` shardings (its dry run).  Each rank holds its shards of
the params (2-D: the embed dims over "data", heads, KV heads, MLP,
experts and vocab over "model"), its rows of the batch and its part of
the cache (`ServeLayout.local_inputs`: rows over "data", KV or SSM heads
over "model", the cache's sequence over what is left: all of "model" for
MLA's latent cache, which has no heads); the model gathers each layer's
"data" dims where it uses them (an expert-parallel MoE's experts are
`moe_ep_local`'s own to gather) and computes its share of the heads, MLP
units, experts and vocab, and every rank returns whole logits of its
rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.distributed import compress as C
from repro_torch.distributed.sharding import (SERVE_RULES, TRAIN_RULES, P,
                                              mesh_axes, param_shardings,
                                              replicated, resolve_spec,
                                              spec_axes, use_sharding,
                                              zip_tree)
from repro_torch.models.model import ModelBundle
from repro_torch.models.module import init_leaves, leaves, map_tree, unflatten
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


def make_sampling_decode_step(bundle: ModelBundle):
    """-> step(params, tok, cache, temperature, generator) -> (tok, cache,
    generator).

    The step of the fixed-batch decode loop (`--policy batch`): one token
    per row, the cache advanced in place (the reference donates it to its
    jitted step).  `temperature` is a plain float: at 0 the token is the
    argmax, above 0 a Gumbel-max draw from `logits / temperature` with
    `generator`, a `torch.Generator` on the logits' device that the loop
    carries from step to step (the reference carries a key).  Tokens are
    int32."""

    def step(params, tok: torch.Tensor, cache: dict, temperature: float,
             generator: torch.Generator):
        logits, cache = bundle.decode_step(
            params, {"token": tok, "pos": cache["pos"], "cache": cache})
        if temperature > 0.0:
            u = torch.rand(logits.shape, generator=generator,
                           device=logits.device)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
            logits = logits.float() / temperature + gumbel
        return torch.argmax(logits, -1).to(torch.int32), cache, generator

    return step


def loss_and_grads(bundle: ModelBundle, params, batch):
    """(loss, grads) of `bundle.train_loss` at `params`: the gradient of
    every leaf (zeros for a leaf the loss does not read, as `jax.grad`
    gives), through detached aliases, so `params` are left as they are."""
    pairs = [(path, t.detach().requires_grad_())
             for path, t in leaves(params)]
    with torch.enable_grad():
        loss = bundle.train_loss(unflatten(pairs), batch)
        grads = torch.autograd.grad(loss, [t for _, t in pairs],
                                    allow_unused=True, materialize_grads=True)
    return loss.detach(), unflatten(
        [(path, g) for (path, _), g in zip(pairs, grads, strict=True)])


@dataclasses.dataclass(frozen=True)
class TrainLayout:
    """A train step's layout on a live mesh: the params' spec tree under
    `rules`, the mesh axes the global batch's rows split over, and the
    global batch size."""
    mesh: Any
    rules: dict
    specs: dict
    batch_axes: tuple[str, ...]
    global_batch: int

    @property
    def axes(self) -> tuple[str, ...]:
        return tuple(mesh_axes(self.mesh))

    @property
    def n_row_shards(self) -> int:
        sizes = mesh_axes(self.mesh)
        return math.prod(sizes[a] for a in self.batch_axes)

    @property
    def n_copies(self) -> int:
        """Ranks that hold the same rows (the mesh axes the batch does
        not use)."""
        sizes = mesh_axes(self.mesh)
        return math.prod(n for a, n in sizes.items()
                         if a not in self.batch_axes)

    def rows(self) -> tuple[int, int]:
        """This rank's rows [start, stop) of the global batch."""
        from repro_torch.distributed.runtime import axis_index
        per = self.global_batch // self.n_row_shards
        i = axis_index(self.batch_axes, self.mesh) if self.batch_axes else 0
        return i * per, (i + 1) * per

    def local_batch(self, batch: dict, device=None) -> dict:
        """This rank's rows of a global batch (every leaf's dim 0)."""
        lo, hi = self.rows()
        return {k: v[lo:hi].contiguous().to(device or v.device)
                for k, v in batch.items()}

    def shard_bytes(self, skel, itemsize: int = 4) -> int:
        """Bytes of one rank's shards of a tree of `skel`'s shapes."""
        from repro_torch.distributed.sharding import local_shape
        spec_of = dict(leaves(self.specs))
        return sum(math.prod(local_shape(d.shape, spec_of[p], self.mesh))
                   * itemsize for p, d in leaves(skel))


def train_layout(bundle: ModelBundle, mesh, global_batch: int,
                 rules: dict = TRAIN_RULES) -> TrainLayout:
    """The reference's layout of a train step on `mesh` (`param_shardings`
    of the skeleton, the "batch" rule on the global batch).  A global
    batch that does not divide over the batch rule's mesh axes is refused,
    and so is an expert-parallel MoE whose experts do not split over
    "model" as `moe_ep_local` takes them."""
    sizes = mesh_axes(mesh)
    want = tuple(a for a in rules.get("batch", ()) if a in sizes
                 and sizes[a] > 1)
    spec = resolve_spec((global_batch,), ("batch",), rules, mesh)
    got = spec_axes(spec)
    if got != want:
        n = math.prod(sizes[a] for a in want)
        raise ValueError(f"global batch {global_batch} does not divide over "
                         f"the {n} ranks of {want}")
    specs = map_tree(lambda sh: sh.spec,
                     param_shardings(bundle.skeleton, mesh, rules))
    cfg = bundle.cfg
    if cfg.moe is not None and cfg.moe_ep and "layers" in specs:
        _check_ep_specs(cfg, specs["layers"]["ffn"], mesh, rules)
    return TrainLayout(mesh, rules, specs, got, global_batch)


def _check_ep_specs(cfg, ffn_specs: dict, mesh, rules) -> None:
    """The stacked expert weights' specs must be the ones `moe_ep_local`
    takes (`ep_param_specs` with `ep_choice`'s FSDP axes)."""
    from repro_torch.distributed.sharding import P, drop_dims, ep_param_specs
    from repro_torch.models.transformer import EP_LOCAL
    sizes = mesh_axes(mesh)
    fsdp = tuple(a for a in (rules.get("embed") or ()) if a in sizes)
    if fsdp and cfg.moe.d_model % math.prod(sizes[a] for a in fsdp):
        fsdp = ()
    want = ep_param_specs(ffn_specs, fsdp)
    got = drop_dims(ffn_specs, 1)

    def norm(spec):
        # an axis of size 1 splits nothing
        parts = [tuple(a for a in ((p,) if isinstance(p, str) else p or ())
                       if sizes[a] > 1) or None for p in spec]
        while parts and parts[-1] is None:
            parts.pop()
        return P(*parts)
    for k in EP_LOCAL:
        if k in got and norm(got[k]) != norm(want[k]):
            raise ValueError(f"moe_ep: {k} is laid out {got[k]} under the "
                             f"rules, but moe_ep_local takes {want[k]} (the "
                             f"experts or d_ff do not split over the mesh)")


def init_sharded(bundle: ModelBundle, generator: torch.Generator,
                 layout: "TrainLayout | ServeLayout", dtype=torch.float32,
                 device=None) -> dict:
    """This rank's shards of `bundle.init(generator)`: the same draws, one
    whole leaf at a time, each cut to its shard."""
    from repro_torch.distributed.sharding import shard_local
    spec_of = dict(leaves(layout.specs))
    return unflatten(
        (path, shard_local(t, spec_of[path], layout.mesh).clone())
        for path, t in init_leaves(bundle.skeleton, generator, dtype,
                                   device))


def sharded_loss_and_grads(bundle: ModelBundle, params, batch,
                           layout: TrainLayout):
    """(global loss, this rank's gradient shards) of `bundle.train_loss`
    on this rank's param shards and rows (see the module's docstring)."""
    from repro_torch.distributed import runtime as rt
    mesh = layout.mesh
    pairs = [(path, t.detach().requires_grad_())
             for path, t in leaves(params)]
    weight = 1.0 / (layout.n_row_shards * layout.n_copies)
    with use_sharding(mesh, layout.rules, {"batch": layout.global_batch},
                      params=layout.specs, batch_axes=layout.batch_axes), \
            torch.enable_grad():
        part = bundle.train_loss(unflatten(pairs), batch) * weight
        grads = torch.autograd.grad(part, [t for _, t in pairs],
                                    allow_unused=True, materialize_grads=True)
    spec_of = dict(leaves(layout.specs))
    reps = [tuple(a for a in layout.axes
                  if a not in spec_axes(spec_of[path])) for path, _ in pairs]
    grads = rt.psum_many(list(grads), reps, mesh)
    return (rt.psum(part.detach(), layout.axes, mesh),
            unflatten((path, g) for (path, _), g in zip(pairs, grads,
                                                        strict=True)))


def make_train_step(bundle: ModelBundle, opt_cfg: AdamWConfig,
                    grad_compress: bool = False,
                    layout: TrainLayout | None = None):
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {loss, grad_norm, lr}).

    With grad_compress the gradient goes through bfloat16 with float32
    error feedback (`opt_state["err"]`) before the update, as the
    reference casts it ahead of its data-parallel all-reduce.  params and
    the moments are updated in place (the reference donates them).  With
    a `layout` the step runs on this rank's shards and rows (see the
    module's docstring): `--compress-grads` compresses this rank's shard
    of the global gradient against its shard of `err`."""

    def train_step(params, opt_state, batch):
        if layout is None:
            loss, grads = loss_and_grads(bundle, params, batch)
        else:
            loss, grads = sharded_loss_and_grads(bundle, params, batch,
                                                 layout)
        if grad_compress:
            g16, err = C.compress(grads, opt_state["err"])
            grads = C.decompress(g16)
            opt_state = dict(opt_state, err=err)
        params, inner, metrics = adamw_update(
            params, grads, opt_state["adam"], opt_cfg,
            specs=None if layout is None else layout.specs,
            mesh=None if layout is None else layout.mesh)
        metrics["loss"] = loss
        return params, dict(opt_state, adam=inner), metrics

    return train_step


@dataclasses.dataclass(frozen=True)
class ServeLayout:
    """A serving step's layout on a live mesh under `rules`: the params'
    spec tree, the cell's `shape`, the spec tree of its inputs (the batch
    and, for a decode cell, the cache: `models.model.input_shardings`),
    the mesh axes the batch's rows split over, and the global sizes of
    the logical dims laid out sharded (the context's `sizes`)."""
    mesh: Any
    rules: dict
    specs: dict
    shape: Any
    inputs: dict
    batch_axes: tuple[str, ...]
    sizes: dict

    def local_inputs(self, batch: dict, device=None) -> dict:
        """This rank's shards of a global batch (and cache), each leaf
        cut by its spec into a fresh tensor."""
        from repro_torch.distributed.sharding import shard_tree
        return shard_tree(batch, self.inputs, self.mesh, device)

    def whole_sequence(self, batch: dict) -> dict:
        """A prefill batch with every dim but the rows gathered whole (a
        prompt of one row lays its sequence over "data", `act_seq`; the
        reference's model gathers it on entry)."""
        from repro_torch.distributed.sharding import gather

        def whole(t, spec):
            return gather(t, P(None, *spec[1:]), self.mesh) \
                if spec_axes(P(*spec[1:])) else t
        return zip_tree(batch, self.inputs, whole)

    def cache_from_prefill(self, cfg, cache: dict) -> dict:
        """This decode layout's part of the cache a prefill on the same
        rows left on this rank (its KV or SSM heads, or MLA's latent cache
        and `layer0`'s, which have no heads; every position): grown to the
        layout's length (`models.model.pad_cache`) and cut to the rank's
        slice of a sequence-sharded cache."""
        from repro_torch.distributed.sharding import shard_tree
        from repro_torch.models.model import (cache_axes, cache_len,
                                              make_inputs, pad_cache)
        n = cache_len(cfg, cache)
        if n is not None:
            cache = pad_cache(cfg, cache, self.shape.seq_len - n)
        seq_only = zip_tree(
            make_inputs(cfg, self.shape)[0]["cache"], cache_axes(cfg),
            lambda t, a: P(*(p if a[i] == "cache_seq" else None
                             for i, p in enumerate(resolve_spec(
                                 tuple(t.shape), a, self.rules,
                                 self.mesh)))))
        return shard_tree(cache, seq_only, self.mesh)


def serve_layout(bundle: ModelBundle, mesh, shape,
                 rules: dict = SERVE_RULES) -> ServeLayout:
    """The reference's layout of a serving cell (`models.model.ShapeSpec`,
    prefill or decode) on `mesh`: `param_shardings` of the skeleton and
    `input_shardings` of the cell's inputs under `rules`.  Refused, naming
    the dim or leaf: a family `models.transformer.check_served` does not
    admit (hybrid and encdec are not served across ranks yet); a global
    batch of more than one row that does not divide over the batch rule's
    mesh axes (one row is whole on every rank, as the reference lays out
    long_500k); SSM heads whose share on a rank straddles their B / C
    groups; an expert-parallel MoE whose experts or shared d_ff do not
    split over "model" as `moe_ep_local` takes them."""
    from repro_torch.models.model import input_shardings
    from repro_torch.models.transformer import check_served
    cfg = bundle.cfg
    check_served(cfg)
    sizes = mesh_axes(mesh)
    b = shape.global_batch
    rows = "batch" if shape.kind == "prefill" else "cache_batch"
    want = tuple(a for a in rules.get(rows, ()) if a in sizes
                 and sizes[a] > 1)
    got = spec_axes(resolve_spec((b,), (rows,), rules, mesh))
    if b > 1 and got != want:
        n = math.prod(sizes[a] for a in want)
        raise ValueError(f"{rows}: global batch {b} does not divide over "
                         f"the {n} ranks of {want}")
    if cfg.ssm is not None:
        h, g = cfg.ssm.n_heads, cfg.ssm.n_groups
        m = math.prod(sizes[a] for a in spec_axes(
            resolve_spec((h,), ("heads",), rules, mesh)))
        per, local = h // g, h // m
        if local % per and per % local:
            raise ValueError(f"heads: {local} SSM heads a rank straddle the "
                             f"groups of {per} heads")
    specs = map_tree(lambda sh: sh.spec,
                     param_shardings(bundle.skeleton, mesh, rules))
    if cfg.moe is not None and cfg.moe_ep:
        _check_ep_specs(cfg, specs["layers"]["ffn"], mesh, rules)
    ctx_sizes = {"batch": b, "cache_batch": b}
    if shape.kind != "prefill" and cfg.family != "ssm":
        # the attention caches' sequence (MLA's latent one has no heads)
        ctx_sizes["cache_seq"] = shape.seq_len
        if cfg.mla is None:
            ctx_sizes["kv_heads"] = cfg.n_kv_heads
    return ServeLayout(mesh, rules, specs, shape,
                       input_shardings(cfg, shape, mesh, rules), got,
                       ctx_sizes)


def make_serve_step(bundle: ModelBundle, layout: ServeLayout):
    """-> step(params, batch) -> (logits (rows, V), cache): the cell's
    `bundle.prefill` or `bundle.decode_step` on this rank's param shards
    and inputs (`layout.local_inputs`) under the layout's live context:
    whole logits of the rank's rows, its part of the cache (a prefill's:
    its rows and KV or SSM heads, every position; a decode step's written
    in place)."""
    prefill = layout.shape.kind == "prefill"
    fn = bundle.prefill if prefill else bundle.decode_step

    def step(params, batch):
        with use_sharding(layout.mesh, layout.rules, layout.sizes,
                          params=layout.specs, batch_axes=layout.batch_axes):
            if prefill:
                batch = layout.whole_sequence(batch)
            return fn(params, batch)
    return step


def init_opt_state(params, grad_compress: bool = False) -> dict:
    """AdamW's moments (and `err`) shaped like `params`: on a rank, like
    its shards, so they follow `opt_state_shardings`."""
    st = {"adam": adamw_init(params)}
    if grad_compress:
        st["err"] = C.init_error_state(params)
    return st


def opt_state_shardings(param_sh, grad_compress: bool = False) -> dict:
    """Moments (and `err`) shard like their params; the step counter is
    replicated.  `param_sh` is a nested dict of
    `distributed.sharding.NamedSharding` (`param_shardings`)."""
    mesh = next(sh for _, sh in leaves(param_sh)).mesh
    st = {"adam": {"mu": param_sh, "nu": param_sh,
                   "step": replicated(mesh)}}
    if grad_compress:
        st["err"] = param_sh
    return st
