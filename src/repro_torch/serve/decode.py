"""Serving steps: continuous-batch decode + chunked prefill (PyTorch port of
`repro.serve.decode`, single device).

The decode state (slot cache + per-slot bookkeeping) lives on the device
and is updated in place, where the reference donates it to its jitted
step.  Admission (refill of one slot) rides inside the decode step: the
admit payload carries a prefilled batch-1 cache, and `valid` says whether
there is anything to admit this tick.

Sampling is scheduling-invariant: a request's i-th token is drawn with a
generator seeded from (seed, request id, i), so continuous batching,
one-shot batching and the sequential oracle draw identical samples.  At
temperature 0 the token is the argmax.  The draws are not the reference's.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.model import (ModelBundle, evict_slot, pad_cache,
                                      write_slot)
from repro_torch.serve.config import ServeConfig


@dataclasses.dataclass
class DecodeState:
    """Per-step serving state.  All vectors are (n_slots,) on the device."""

    cache: dict             # model decode cache, batch = n_slots
    tok: torch.Tensor       # last sampled token per slot
    rid: torch.Tensor       # request id per slot (0 when never assigned)
    tidx: torch.Tensor      # tokens generated so far per slot
    budget: torch.Tensor    # generation budget per slot
    active: torch.Tensor    # bool: slot currently serving a request
    seed: int               # base sampling seed


def init_state(cfg: T.ModelConfig, scfg: ServeConfig,
               device=None) -> DecodeState:
    s = scfg.n_slots
    z = lambda dt=torch.int32: torch.zeros((s,), dtype=dt, device=device)
    return DecodeState(cache=T.init_cache(cfg, s, scfg.max_len, device),
                       tok=z(), rid=z(), tidx=z(), budget=z(),
                       active=z(torch.bool), seed=scfg.seed)


def null_admit() -> dict:
    """An admission payload that admits nothing."""
    return {"valid": False}


def make_admit(req_cache, slot: int, rid: int, token: int,
               budget: int) -> dict:
    """Request `rid` (first generated token `token`, prefilled `req_cache`)
    takes slot `slot` with `budget` tokens to go."""
    return {"valid": True, "slot": int(slot), "cache": req_cache,
            "token": int(token), "rid": int(rid), "budget": int(budget)}


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------
def _sample_generator(seed: int, rid: int, tidx: int,
                      device) -> torch.Generator:
    h = zlib.crc32(f"{seed}:{rid}:{tidx}".encode())
    return torch.Generator(device).manual_seed(
        (seed * 0x9E3779B97F4A7C15 + h) & ((1 << 63) - 1))


def sample_token(seed: int, rid: int, tidx: int, logits: torch.Tensor,
                 temperature: float) -> torch.Tensor:
    """Token for request `rid`'s `tidx`-th generation from logits (V,):
    argmax at temperature 0, else a Gumbel-max draw from a generator
    seeded by (seed, rid, tidx)."""
    if temperature <= 0.0:
        return torch.argmax(logits, -1).to(torch.int32)
    g = _sample_generator(seed, rid, tidx, logits.device)
    u = torch.rand(logits.shape, generator=g, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits.float() / max(temperature, 1e-6) + gumbel,
                        -1).to(torch.int32)


def _sample_rows(seed: int, rid: torch.Tensor, tidx: torch.Tensor,
                 logits: torch.Tensor, temperature: float) -> torch.Tensor:
    if temperature <= 0.0:
        return torch.argmax(logits, -1).to(torch.int32)
    return torch.stack([sample_token(seed, r, t, logits[i], temperature)
                        for i, (r, t) in enumerate(zip(rid.tolist(),
                                                       tidx.tolist()))])


# ---------------------------------------------------------------------------
# The serving step
# ---------------------------------------------------------------------------
def _apply_admission(cfg: T.ModelConfig, state: DecodeState,
                     admit: dict) -> DecodeState:
    """Refill one slot in place; a no-op when nothing is admitted."""
    if admit["valid"]:
        s = admit["slot"]
        write_slot(cfg, state.cache, admit["cache"], s)
        state.tok[s] = admit["token"]
        state.rid[s] = admit["rid"]
        state.tidx[s] = 1     # the prefill already produced token #1
        state.budget[s] = admit["budget"]
        state.active[s] = True
    return state


def _bind(program, fn):
    """`fn` with the program's frozen engine installed (or as is)."""
    return fn if program is None else program.bind(fn)


def _step_body(bundle: ModelBundle, scfg: ServeConfig, params,
               state: DecodeState, admit: dict, temperature: float
               ) -> tuple[DecodeState, dict]:
    """One decode token for every slot (inactive rows compute masked
    garbage; their cache rows never influence active rows), with the
    admission riding in front.  The serving step and the drift step
    (`serve.adaptive.make_drift_step`) both run it."""
    state = _apply_admission(bundle.cfg, state, admit)
    cache = state.cache
    logits, cache = bundle.decode_step(
        params, {"token": state.tok, "pos": cache["pos"], "cache": cache})
    tok_next = _sample_rows(state.seed, state.rid, state.tidx, logits,
                            temperature)
    active = state.active
    tidx_next = torch.where(active, state.tidx + 1, state.tidx)
    done = active & (tidx_next >= state.budget)
    new_state = DecodeState(cache=cache, tok=tok_next, rid=state.rid,
                            tidx=tidx_next, budget=state.budget,
                            active=active & ~done, seed=state.seed)
    out = {"token": tok_next, "emitted": active, "done": done,
           "pos": cache["pos"]}
    if scfg.collect_logits:
        out["logits"] = logits
    return new_state, out


def make_serve_step(bundle: ModelBundle, scfg: ServeConfig, program=None):
    """-> step(params, state, admit, temperature) -> (state, out)."""

    def step(params, state: DecodeState, admit: dict, temperature: float):
        return _step_body(bundle, scfg, params, state, admit, temperature)

    return _bind(program, step)


def make_admit_step(bundle: ModelBundle, scfg: ServeConfig, program=None):
    """-> admit(state, payload) -> state: admission without a decode step
    (the one-shot policy forms its batch with it)."""
    return _bind(program, lambda state, payload: _apply_admission(
        bundle.cfg, state, payload))


def make_evict(bundle: ModelBundle, scfg: ServeConfig, program=None):
    """-> evict(state, slot) -> state with that slot's cache zeroed."""

    def evict(state: DecodeState, slot: int) -> DecodeState:
        evict_slot(bundle.cfg, state.cache, slot)
        state.active[slot] = False
        return state

    return _bind(program, evict)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------
def make_chunk_fn(bundle: ModelBundle, program=None):
    """The shared chunk step (params, tokens (1, C), n_valid (1,), cache)."""
    return _bind(program, lambda params, tokens, n_valid, cache:
                 bundle.chunk_step(params, {"tokens": tokens,
                                            "n_valid": n_valid,
                                            "cache": cache}))


def make_whole_fn(bundle: ModelBundle, program=None):
    """The whole-prompt prefill (params, {"tokens": (1, L)}) of the
    families that cannot prefill in chunks."""
    return _bind(program, bundle.prefill)


class PrefillTask:
    """One request's prefill, advanced one chunk per scheduler tick.

    Attention-cache families stream `prefill_chunk`-token chunks through
    `chunk_step` against a request-private max_len cache, so a long prompt
    never blocks the decode batch for more than one chunk.  The ssm family
    prefills whole, in one tick: one `prefill` of exactly the prompt, then
    `pad_cache` to the slot cache's shape.

    After `advance()` returns True, `.cache` is the admit-ready batch-1
    cache and `.logits` the last-token logits (V,)."""

    def __init__(self, bundle: ModelBundle, scfg: ServeConfig, prompt,
                 chunk_fn=None, device=None, whole_fn=None):
        self.bundle, self.scfg = bundle, scfg
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(self.prompt) == 0:
            raise ValueError("empty prompt")
        if len(self.prompt) >= scfg.max_len:
            raise ValueError(f"prompt length {len(self.prompt)} >= "
                             f"max_len {scfg.max_len}: no decode room")
        self.device = device
        self.chunked = bundle.cfg.family != "ssm"
        self._chunk_fn = chunk_fn if chunk_fn is not None \
            else make_chunk_fn(bundle)
        self._whole_fn = whole_fn if whole_fn is not None \
            else make_whole_fn(bundle)
        self._off = 0
        self.cache = (T.init_cache(bundle.cfg, 1, scfg.max_len, device)
                      if self.chunked else None)
        self.logits = None
        self.done = False

    def advance(self, params) -> bool:
        """Run one chunk (the whole prompt for ssm); True when the prefill
        is complete."""
        if self.done:
            return True
        if not self.chunked:
            logits, cache = self._whole_fn(
                params, {"tokens": torch.from_numpy(self.prompt)[None]
                         .to(self.device)})
            self.cache = pad_cache(self.bundle.cfg, cache,
                                   self.scfg.max_len - len(self.prompt))
            self.logits = logits[0]
            self.done = True
            return True
        c = self.scfg.prefill_chunk
        lo = self._off
        chunk = self.prompt[lo:lo + c]
        n_valid = len(chunk)
        if n_valid < c:                       # pad the tail chunk
            chunk = np.pad(chunk, (0, c - n_valid))
        logits, self.cache = self._chunk_fn(
            params, torch.from_numpy(chunk)[None].to(self.device),
            torch.full((1,), n_valid, dtype=torch.int32, device=self.device),
            self.cache)
        self._off += n_valid
        if self._off >= len(self.prompt):
            self.logits = logits[0]
            self.done = True
        return self.done
