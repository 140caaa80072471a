"""Step-function factories of the launchers and the dry run (PyTorch port
of `repro.launch.steps`).  The steps run on one device; the dry run reads
`opt_state_shardings` to lay the optimizer state out on a mesh."""

from __future__ import annotations

import torch

from repro_torch.distributed import compress as C
from repro_torch.distributed.sharding import replicated
from repro_torch.models.model import ModelBundle
from repro_torch.models.module import leaves, unflatten
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


def make_train_step(bundle: ModelBundle, opt_cfg: AdamWConfig,
                    grad_compress: bool = False):
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {loss, grad_norm, lr}).

    With grad_compress the gradient goes through bfloat16 with float32
    error feedback (`opt_state["err"]`) before the update, as the
    reference casts it ahead of its data-parallel all-reduce.  params and
    the moments are updated in place (the reference donates them)."""

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(bundle, params, batch)
        if grad_compress:
            g16, err = C.compress(grads, opt_state["err"])
            grads = C.decompress(g16)
            opt_state = dict(opt_state, err=err)
        params, inner, metrics = adamw_update(params, grads,
                                              opt_state["adam"], opt_cfg)
        metrics["loss"] = loss
        return params, dict(opt_state, adam=inner), metrics

    return train_step


def init_opt_state(params, grad_compress: bool = False) -> dict:
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
