"""Serving steps: continuous-batch decode + chunked prefill (PyTorch port of
`repro.serve.decode`).

The decode state (slot cache + per-slot bookkeeping) lives on the device
and every step updates it in place, where the reference donates it to its
jitted step (`repro_torch.analysis`'s DON001 holds the steps to it).
Admission (refill of one slot) rides inside the decode step: the admit
payload carries a prefilled batch-1 cache, and `valid` says whether there
is anything to admit this tick.

Sampling is scheduling-invariant: a request's i-th token is drawn with a
generator seeded from (seed, request id, i), so continuous batching,
one-shot batching and the sequential oracle draw identical samples.  At
temperature 0 the token is the argmax.  The draws are not the reference's.

Slots over ranks (`make_serve_step(mesh=)`, the reference's slot-sharded
`shard_map`): each rank of the mesh holds n_slots / d slots of the state,
slot `offset + i` its local row i (`slot_layout`), with the params whole
on every rank.  Every rank is handed the same admit payload and turns it
into a local write or a no-op; the step's outputs are all-gathered along
the slot axis, so every rank's host loop sees the whole batch.  A local
row draws with its request's (seed, rid, tidx) generator, the same on
every rank.
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


def init_state(cfg: T.ModelConfig, scfg: ServeConfig, device=None,
               n_slots: int | None = None) -> DecodeState:
    """The empty state of `n_slots` slots (default: all of scfg's; a rank
    of a slot-sharded step holds its local ones)."""
    s = scfg.n_slots if n_slots is None else n_slots
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
def slot_layout(scfg: ServeConfig, mesh=None) -> tuple[int, int, tuple]:
    """(local slots, first global slot, mesh axes) of this rank when the
    slots shard over every axis of `mesh` in order; (n_slots, 0, ()) with
    no mesh.  Refuses a mesh whose device count does not divide
    n_slots, as the reference does."""
    if mesh is None:
        return scfg.n_slots, 0, ()
    import math
    from repro_torch.distributed import runtime
    from repro_torch.distributed.sharding import mesh_axes
    sizes = mesh_axes(mesh)
    d = math.prod(sizes.values())
    if scfg.n_slots % d:
        raise ValueError(f"n_slots={scfg.n_slots} not divisible by "
                         f"mesh size {d}")
    axes = tuple(sizes)
    n_local = scfg.n_slots // d
    return n_local, runtime.axis_index(axes, mesh) * n_local, axes


def _local_slot(state: DecodeState, slot: int, offset: int) -> int | None:
    """The local row of global slot `slot`, or None on another rank."""
    s = slot - offset
    return s if 0 <= s < state.tok.shape[0] else None


def _apply_admission(cfg: T.ModelConfig, state: DecodeState,
                     admit: dict, slot_offset: int = 0) -> DecodeState:
    """Refill one slot in place; a no-op when nothing is admitted or the
    slot lives on another rank (`slot_offset` localizes its index)."""
    s = _local_slot(state, admit["slot"], slot_offset) \
        if admit["valid"] else None
    if s is not None:
        write_slot(cfg, state.cache, admit["cache"], s)
        # fill_ takes the host scalar as a kernel argument; item
        # assignment would copy it from host memory and sync the stream
        state.tok[s].fill_(admit["token"])
        state.rid[s].fill_(admit["rid"])
        state.tidx[s].fill_(1)    # the prefill already produced token #1
        state.budget[s].fill_(admit["budget"])
        state.active[s].fill_(True)
    return state


def _bind(program, fn):
    """`fn` with the program's frozen engine installed (or as is)."""
    return fn if program is None else program.bind(fn)


def _step_body(bundle: ModelBundle, scfg: ServeConfig, params,
               state: DecodeState, admit: dict, temperature: float,
               slot_offset: int = 0) -> tuple[DecodeState, dict]:
    """One decode token for every slot (inactive rows compute masked
    garbage; their cache rows never influence active rows), with the
    admission riding in front.  The serving step and the drift step
    (`serve.adaptive.make_drift_step`) both run it; a rank of the
    slot-sharded step runs it on its local slots, from global slot
    `slot_offset`."""
    state = _apply_admission(bundle.cfg, state, admit, slot_offset)
    cache = state.cache
    logits, stepped = bundle.decode_step(
        params, {"token": state.tok, "pos": cache["pos"], "cache": cache})
    _write_back(cache, stepped)
    tok_next = _sample_rows(state.seed, state.rid, state.tidx, logits,
                            temperature)
    emitted = state.active.clone()
    tidx_next = torch.where(emitted, state.tidx + 1, state.tidx)
    done = emitted & (tidx_next >= state.budget)
    state.tok.copy_(tok_next)
    state.tidx.copy_(tidx_next)
    state.active.copy_(emitted & ~done)
    out = {"token": tok_next, "emitted": emitted, "done": done,
           "pos": cache["pos"]}
    if scfg.collect_logits:
        out["logits"] = logits
    return state, out


def _write_back(cache: dict, stepped: dict) -> dict:
    """Keep a step's cache in the caller's storage: the model writes the
    K/V (and state-space) leaves in place but returns the advanced `pos`
    as a new tensor, which is copied back.  Returns `cache`."""
    cache["pos"].copy_(stepped["pos"])
    return cache


def _gather_out(out: dict, axes: tuple, mesh) -> dict:
    """A rank's step outputs all-gathered along the slot axis: the int
    and bool vectors in one int32 collective, the logits in another."""
    from repro_torch.distributed import runtime
    keys = ("token", "emitted", "done", "pos")
    packed = torch.stack([out[k].to(torch.int32) for k in keys], 1)
    packed = runtime.all_gather(packed, axes, axis=0, tiled=True, mesh=mesh)
    full = {k: packed[:, i].to(out[k].dtype) for i, k in enumerate(keys)}
    if "logits" in out:
        full["logits"] = runtime.all_gather(out["logits"], axes, axis=0,
                                            tiled=True, mesh=mesh)
    return full


def make_serve_step(bundle: ModelBundle, scfg: ServeConfig, mesh=None,
                    program=None):
    """-> step(params, state, admit, temperature) -> (state, out).  With
    `mesh` (a live `DeviceMesh` whose device count divides n_slots) each
    rank steps its own n_slots / d slots (`slot_layout`) and `out` holds
    every slot's row, gathered from the ranks."""
    if mesh is None:
        def step(params, state: DecodeState, admit: dict,
                 temperature: float):
            return _step_body(bundle, scfg, params, state, admit,
                              temperature)

        return _bind(program, step)

    _, offset, axes = slot_layout(scfg, mesh)

    def sharded(params, state: DecodeState, admit: dict, temperature: float):
        state, out = _step_body(bundle, scfg, params, state, admit,
                                temperature, offset)
        return state, _gather_out(out, axes, mesh)

    return _bind(program, sharded)


def make_admit_step(bundle: ModelBundle, scfg: ServeConfig, program=None,
                    mesh=None):
    """-> admit(state, payload) -> state: admission without a decode step
    (the one-shot policy forms its batch with it); on a rank of `mesh`,
    a no-op unless the slot is local."""
    offset = slot_layout(scfg, mesh)[1]
    return _bind(program, lambda state, payload: _apply_admission(
        bundle.cfg, state, payload, offset))


def make_evict(bundle: ModelBundle, scfg: ServeConfig, program=None,
               mesh=None):
    """-> evict(state, slot) -> state with that slot's cache zeroed (on a
    rank of `mesh`, only where the slot is local)."""
    offset = slot_layout(scfg, mesh)[1]

    def evict(state: DecodeState, slot: int) -> DecodeState:
        s = _local_slot(state, slot, offset)
        if s is not None:
            evict_slot(bundle.cfg, state.cache, s)
            state.active[s].fill_(False)
        return state

    return _bind(program, evict)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------
def make_chunk_fn(bundle: ModelBundle, program=None):
    """The shared chunk step (params, tokens (1, C), n_valid (1,), cache)
    -> (logits, cache), the cache advanced in place."""

    def chunk(params, tokens, n_valid, cache):
        logits, stepped = bundle.chunk_step(
            params, {"tokens": tokens, "n_valid": n_valid, "cache": cache})
        return logits, _write_back(cache, stepped)

    return _bind(program, chunk)


def make_whole_fn(bundle: ModelBundle, program=None):
    """The whole-prompt prefill (params, {"tokens": (1, L)}) of the
    families that cannot prefill in chunks."""
    return _bind(program, bundle.prefill)


class PrefillTask:
    """One request's prefill, advanced one chunk per scheduler tick.

    Attention-cache families stream `prefill_chunk`-token chunks through
    `chunk_step` against a request-private max_len cache, so a long prompt
    never blocks the decode batch for more than one chunk.  The ssm and
    hybrid families prefill whole, in one tick: one `prefill` of exactly
    the prompt, then `pad_cache` to the slot cache's shape.

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
        self.chunked = bundle.cfg.family not in ("ssm", "hybrid")
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
        """Run one chunk (the whole prompt for ssm and hybrid); True when
        the prefill is complete."""
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
