"""Serving configuration: slots, chunking, sampling, optical engine
(PyTorch port of `repro.serve.config`).

`serving_model_config` derives the serving variant of a `ModelConfig`:
continuous batching decodes at ragged per-slot positions, so every
attention cache write takes the scatter path (MLA's compressed cache
included), and with `rosa` the MLP projections route through the optical
engine.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import ModelConfig


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Continuous-batching serving knobs.

    n_slots        concurrent sequences in the decode batch
    max_len        per-slot cache capacity: prompt + generated tokens
    prefill_chunk  tokens per prefill chunk
    temperature    sampling temperature (0 = greedy)
    seed           base sampling seed; a request's i-th token draws from
                   (seed, request id, i), so its stream does not depend on
                   how it was scheduled
    collect_logits the serving step also returns per-slot logits (tests)
    evict_on_done  zero a slot's cache rows when its request completes
    rosa           route MLP projections through the optical engine: the
                   decode step is compiled into one `rosa.Program` (plan
                   autotuned on the decode trace), optional pinned chip
    rosa_backend   backend name for the optical path
    variation_seed pin ONE sampled fabricated chip; None = ideal device
    """

    n_slots: int = 4
    max_len: int = 64
    prefill_chunk: int = 8
    temperature: float = 0.0
    seed: int = 0
    collect_logits: bool = False
    evict_on_done: bool = False
    rosa: bool = False
    rosa_backend: str = "ref"
    variation_seed: int | None = None

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.max_len < self.prefill_chunk:
            raise ValueError("max_len must be >= prefill_chunk")


def serving_model_config(cfg: ModelConfig, rosa: bool = False) -> ModelConfig:
    """Ragged (scatter) cache writes, and optionally the optical MLP path.

    Encoder-decoder configs are refused: the serving prefill has no
    encoder pass, so their requests would cross-attend to an all-zero
    memory."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder serving is not supported — the "
            "request path has no encoder invocation (prompts are token "
            "ids, not source embeddings)")
    kw: dict = {"uniform_decode": False}
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(cfg.mla, uniform_decode=False)
    if rosa:
        kw["rosa_mlp"] = True
    return dataclasses.replace(cfg, **kw)
