"""Step-function factories of the launchers (PyTorch port of the serving
part of `repro.launch.steps`; the training step and its optimizer state
come with the LM training path)."""

from __future__ import annotations

import torch

from repro_torch.models.model import ModelBundle


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
