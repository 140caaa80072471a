"""Continuous-batching scheduler: slot admission, prefill/decode interleave
(PyTorch port of `repro.serve.scheduler`; of its tracing, the prefill
chunk and decode step spans).

Two admission policies over the same step:

  continuous  a completed request's slot is refilled on the very next tick
              (admission rides inside the decode step);
  oneshot     static batching: wait for a full batch of prefilled
              requests, admit them together, decode until the last one
              finishes, then form the next batch.

Each tick runs at most one prefill chunk and one decode step, so cost is
countable in deterministic step units.  `run_sequential` (same prefill
path, batch-1 decode, same sampling seeds) is the per-request oracle the
scheduler is held against.  A `TickHook` extends the loop per tick (the
drift-adaptive controller of `serve.adaptive` is one).
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import time
from collections import deque

import numpy as np
import torch

from repro_torch.models.model import build_model
from repro_torch.obs import trace as obs
from repro_torch.serve.config import ServeConfig, serving_model_config
from repro_torch.serve.decode import (PrefillTask, init_state, make_admit,
                                      make_admit_step, make_chunk_fn,
                                      make_evict, make_serve_step,
                                      make_whole_fn, null_admit,
                                      sample_token)


@dataclasses.dataclass
class Request:
    """One serving request; `arrival` is in scheduler ticks."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival: int = 0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


@dataclasses.dataclass
class Completion:
    rid: int
    prompt_len: int
    arrival: int
    tokens: list = dataclasses.field(default_factory=list)
    logits: list = dataclasses.field(default_factory=list)
    first_token_tick: int = -1
    admit_tick: int = -1
    done_tick: int = -1
    slot: int = -1
    # wall-clock stamps (seconds relative to the run's start)
    enqueue_wall: float = 0.0
    first_token_wall: float = 0.0
    done_wall: float = 0.0

    @property
    def ttft_ticks(self) -> int:
        return self.first_token_tick - self.arrival

    @property
    def latency_ticks(self) -> int:
        return self.done_tick - self.arrival

    @property
    def ttft_s(self) -> float:
        return self.first_token_wall - self.enqueue_wall

    @property
    def latency_s(self) -> float:
        return self.done_wall - self.enqueue_wall


@dataclasses.dataclass(frozen=True)
class EmptyStat:
    """Percentile over an empty completion set: falsy, floats to NaN."""

    q: float
    kind: str

    def __float__(self) -> float:
        return float("nan")

    def __bool__(self) -> bool:
        return False


@dataclasses.dataclass
class ServeReport:
    policy: str
    completions: dict
    ticks: int = 0
    decode_steps: int = 0
    prefill_chunks: int = 0
    wall_s: float = 0.0
    n_slots: int = 1

    @property
    def total_tokens(self) -> int:
        return sum(len(c.tokens) for c in self.completions.values())

    @property
    def step_units(self) -> int:
        """Deterministic cost: decode steps + prefill chunks."""
        return self.decode_steps + self.prefill_chunks

    @property
    def tokens_per_unit(self) -> float:
        return self.total_tokens / max(self.step_units, 1)

    @property
    def occupancy(self) -> float:
        """Mean fraction of decode slots doing useful work (each request's
        first token comes from its prefill and is excluded)."""
        decoded = self.total_tokens - sum(
            1 for c in self.completions.values() if c.tokens)
        return decoded / max(self.decode_steps * self.n_slots, 1)

    @property
    def tokens_per_s(self) -> float:
        return self.total_tokens / max(self.wall_s, 1e-9)

    def latencies(self, kind: str = "latency") -> np.ndarray:
        vals = [getattr(c, f"{kind}_ticks")
                for c in self.completions.values()]
        return np.asarray(sorted(vals), np.float64)

    def percentile(self, q: float, kind: str = "latency"):
        vals = self.latencies(kind)
        if vals.size == 0:
            return EmptyStat(q, kind)
        return float(np.percentile(vals, q))

    def wall_latencies(self, kind: str = "latency") -> np.ndarray:
        vals = [getattr(c, f"{kind}_s") for c in self.completions.values()]
        return np.asarray(sorted(vals), np.float64)

    def wall_percentile_ms(self, q: float, kind: str = "latency"):
        vals = self.wall_latencies(kind)
        if vals.size == 0:
            return EmptyStat(q, kind)
        return float(np.percentile(vals, q) * 1e3)


class TickHook:
    """Protocol for per-tick scheduler extensions (drift injection and the
    adaptive controller live in `repro_torch.serve.adaptive`).

    `step_args(tick)` returns extra positional args appended to the
    decode-step call; the installed `Scheduler.step` must accept them (the
    adaptive package installs a drift step that takes the residual thermal
    offset).  `on_tick_end` runs on the host between ticks, after the
    tick's decode completed: the one place a controller may swap the
    serving program and steps without touching an in-flight step.  Ticks
    that make no progress (an idle jump to the next arrival) skip both.
    """

    def step_args(self, tick: int) -> tuple:
        return ()

    def on_tick_end(self, sched: "Scheduler", tick: int, state,
                    idle_slots: int) -> None:
        pass


def _to_device(params, device):
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    return params.to(device)


class Scheduler:
    """Builds the serving machinery once; `run` replays a request list under
    a policy.  With `scfg.rosa` the decode step is compiled into ONE
    `rosa.Program` (hybrid plan autotuned on the decode trace through the
    plan cache `plan_cache`, as `rosa.compile` takes it; pinned chip;
    energy ledger) and every step is built from it.  `chip` pins the given
    `{name: StaticVariation}` instead of sampling one from
    `scfg.variation_seed`; `engine` serves under a caller's engine, plan
    as-is.  Everything runs on `device`."""

    def __init__(self, model_cfg, scfg: ServeConfig, params=None,
                 init_seed: int = 0, chip=None,
                 device: str | torch.device = "cuda", engine=None,
                 plan_cache=None):
        self.device = torch.device(device)
        self.cfg = serving_model_config(model_cfg, rosa=scfg.rosa)
        self.scfg = scfg
        self.bundle = build_model(self.cfg)
        self.engine = engine
        self.program = None
        if engine is not None:
            self.program = serving_program(self.bundle, scfg, engine)
        elif scfg.rosa:
            self.program = _serving_program(self.bundle, scfg, chip,
                                            self.device, plan_cache)
            self.engine = self.program.engine
        if params is None:
            gen = torch.Generator(self.device).manual_seed(init_seed)
            params = self.bundle.init(gen, device=self.device)
        self.params = _to_device(params, self.device)
        self.step = make_serve_step(self.bundle, scfg, program=self.program)
        self.admit_step = make_admit_step(self.bundle, scfg,
                                          program=self.program)
        self.chunk_fn = make_chunk_fn(self.bundle, program=self.program)
        self.whole_fn = make_whole_fn(self.bundle, program=self.program)
        self.evict = make_evict(self.bundle, scfg, program=self.program) \
            if scfg.evict_on_done else None

    def _scope(self, tag: str):
        return _ledger_scope(self.engine, tag)

    def _check(self, req: Request) -> None:
        """Fail before any request is served (bounds of PrefillTask)."""
        if len(req.prompt) >= self.scfg.max_len:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} >= "
                f"max_len {self.scfg.max_len}: no decode room")
        need = len(req.prompt) + req.max_new_tokens - 1
        if need > self.scfg.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + "
                f"{req.max_new_tokens} new tokens needs cache {need} > "
                f"max_len {self.scfg.max_len}")

    @torch.inference_mode()
    def run(self, requests: list[Request], policy: str = "continuous",
            temperature: float | None = None,
            hook: TickHook | None = None) -> ServeReport:
        """Serve `requests` under `policy`; `temperature` overrides
        scfg.temperature.  `hook` is a `TickHook`: extra decode-step args
        and an end-of-tick host callback."""
        if policy not in ("continuous", "oneshot"):
            raise ValueError(policy)
        for r in requests:
            self._check(r)
        scfg = self.scfg
        n_slots = scfg.n_slots
        temp = float(scfg.temperature if temperature is None
                     else temperature)

        completions = {r.rid: Completion(r.rid, len(r.prompt), r.arrival)
                       for r in requests}
        pending = deque(sorted(requests, key=lambda r: (r.arrival, r.rid)))
        prefill_q: deque[Request] = deque()
        ready: deque[tuple] = deque()        # (req, cache, first_token)
        inflight: tuple | None = None        # (req, PrefillTask)
        free = list(range(n_slots))
        heapq.heapify(free)
        slot_rid: list[int | None] = [None] * n_slots
        n_done = 0
        state = init_state(self.cfg, scfg, self.device)
        rep = ServeReport(policy=policy, completions=completions,
                          n_slots=n_slots)
        tick = 0
        # tracing is ambient and fixed for the run: the span contexts are
        # built once and re-entered every tick
        tr = obs.current_tracer()
        if tr is not None:
            prefill_ctx = tr.span("serve.prefill_chunk", "serve")
            decode_ctx = tr.span("serve.decode_step", "serve")
        else:
            prefill_ctx = decode_ctx = contextlib.nullcontext()
        t0 = time.perf_counter()

        def finish(comp: Completion) -> None:
            comp.done_tick = tick
            comp.done_wall = time.perf_counter() - t0

        def mark_admit(comp: Completion, slot: int) -> None:
            comp.admit_tick = tick
            comp.slot = slot

        while n_done < len(requests):
            progressed = False
            while pending and pending[0].arrival <= tick:
                r = pending.popleft()
                completions[r.rid].enqueue_wall = time.perf_counter() - t0
                prefill_q.append(r)

            # -- one prefill chunk per tick -----------------------------------
            if inflight is None and prefill_q:
                req = prefill_q.popleft()
                inflight = (req, PrefillTask(self.bundle, scfg, req.prompt,
                                             self.chunk_fn, self.device,
                                             self.whole_fn))
            if inflight is not None:
                req, task = inflight
                with prefill_ctx, self._scope("prefill"):
                    task.advance(self.params)
                rep.prefill_chunks += 1
                progressed = True
                if task.done:
                    comp = completions[req.rid]
                    tok0 = int(sample_token(scfg.seed, req.rid, 0,
                                            task.logits, temp))
                    comp.tokens.append(tok0)
                    comp.first_token_tick = tick
                    comp.first_token_wall = time.perf_counter() - t0
                    if scfg.collect_logits:
                        comp.logits.append(task.logits.cpu().numpy())
                    if req.max_new_tokens == 1:      # done at prefill
                        finish(comp)
                        n_done += 1
                    else:
                        ready.append((req, task.cache, tok0))
                    inflight = None

            # -- admission ----------------------------------------------------
            admit = null_admit()
            if policy == "continuous":
                if ready and free:
                    slot = heapq.heappop(free)
                    req, cache0, tok0 = ready.popleft()
                    admit = make_admit(cache0, slot, req.rid, tok0,
                                       req.max_new_tokens)
                    slot_rid[slot] = req.rid
                    mark_admit(completions[req.rid], slot)
            else:
                outstanding = (len(pending) + len(prefill_q) + len(ready)
                               + (1 if inflight is not None else 0))
                if (len(free) == n_slots and ready
                        and (len(ready) >= min(n_slots, outstanding)
                             or (not pending and not prefill_q
                                 and inflight is None))):
                    while ready and free:
                        slot = heapq.heappop(free)
                        req, cache0, tok0 = ready.popleft()
                        state = self.admit_step(
                            state, make_admit(cache0, slot, req.rid, tok0,
                                              req.max_new_tokens))
                        slot_rid[slot] = req.rid
                        mark_admit(completions[req.rid], slot)
                    progressed = True

            # -- one decode step for the whole batch --------------------------
            if any(r is not None for r in slot_rid):
                extra = hook.step_args(tick) if hook is not None else ()
                # the span ends at the host's read of the step's result, so
                # on the card it covers the step's device work
                with decode_ctx, self._scope("decode"):
                    state, out = self.step(self.params, state, admit, temp,
                                           *extra)
                    tok = out["token"].cpu().numpy()
                    emitted = out["emitted"].cpu().numpy()
                    done = out["done"].cpu().numpy()
                rep.decode_steps += 1
                progressed = True
                logits = (out["logits"].cpu().numpy()
                          if scfg.collect_logits else None)
                for s in range(n_slots):
                    if not emitted[s]:
                        continue
                    comp = completions[slot_rid[s]]
                    comp.tokens.append(int(tok[s]))
                    if logits is not None:
                        comp.logits.append(logits[s])
                    if done[s]:
                        finish(comp)
                        n_done += 1
                        slot_rid[s] = None
                        heapq.heappush(free, s)
                        if self.evict is not None:
                            state = self.evict(state, s)

            if not progressed:
                if pending:                 # idle: jump to the next arrival
                    tick = pending[0].arrival
                    continue
                raise RuntimeError("scheduler deadlock")  # pragma: no cover
            if hook is not None:
                hook.on_tick_end(self, tick, state, len(free))
            tick += 1

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        rep.ticks = tick
        rep.wall_s = time.perf_counter() - t0
        return rep


def _serving_program(bundle, scfg: ServeConfig, chip, device, cache=None):
    """With `scfg.rosa`, the serving Program with a fresh EnergyLedger."""
    if not scfg.rosa:
        return None
    from repro_torch import rosa
    from repro_torch.serve.metrics import build_serving_program
    return build_serving_program(bundle, scfg, chip=chip, device=device,
                                 cache=cache) \
        .with_ledger(rosa.EnergyLedger())


def serving_program(bundle, scfg: ServeConfig, engine):
    """Freeze a caller's engine into a `rosa.Program` (no plan autotune:
    the caller's plan is taken as-is) so the serving machinery can build
    its steps from it."""
    from repro_torch import rosa
    from repro_torch.serve.metrics import abstract_decode_batch

    params = bundle.abstract(torch.float32)
    batch = abstract_decode_batch(bundle.cfg, scfg)
    # compiled with the ledger detached: the serving ledger carries only
    # the scoped prefill/decode events of the scheduler's steps
    prog = rosa.compile(lambda eng, p, b: bundle.decode_step(p, b),
                        engine.with_ledger(None), (params, batch),
                        autotune=None)
    return prog.with_engine(engine)


def _ledger_scope(engine, tag: str):
    if engine is not None and engine.ledger is not None:
        return engine.ledger.scope(tag)
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Per-request sequential oracle
# ---------------------------------------------------------------------------
@torch.inference_mode()
def run_sequential(model_cfg, scfg: ServeConfig, params,
                   requests: list[Request], temperature: float | None = None,
                   chip=None, device: str | torch.device = "cuda") -> dict:
    """Decode every request ALONE (batch 1), same prefill path, same
    sampling seeds.  Returns {rid: {"tokens": [...], "logits": [...]}}:
    whatever the scheduler interleaves, each request's stream must equal
    this."""
    device = torch.device(device)
    cfg = serving_model_config(model_cfg, rosa=scfg.rosa)
    bundle = build_model(cfg)
    program = _serving_program(bundle, scfg, chip, device)
    engine = program.engine if program is not None else None
    params = _to_device(params, device)
    chunk_fn = make_chunk_fn(bundle, program=program)
    whole_fn = make_whole_fn(bundle, program=program)
    decode1_fn = lambda p, t, c: bundle.decode_step(
        p, {"token": t, "pos": c["pos"], "cache": c})
    decode1 = program.bind(decode1_fn) if program is not None else decode1_fn
    temp = float(scfg.temperature if temperature is None else temperature)

    out = {}
    for req in requests:
        task = PrefillTask(bundle, scfg, req.prompt, chunk_fn, device,
                           whole_fn)
        with _ledger_scope(engine, "prefill"):
            while not task.advance(params):
                pass
        tok = sample_token(scfg.seed, req.rid, 0, task.logits, temp)
        toks, logs = [int(tok)], [task.logits.cpu().numpy()]
        cache = task.cache
        for i in range(1, req.max_new_tokens):
            with _ledger_scope(engine, "decode"):
                logits, cache = decode1(params, tok.reshape(1), cache)
            tok = sample_token(scfg.seed, req.rid, i, logits[0], temp)
            toks.append(int(tok))
            logs.append(logits[0].cpu().numpy())
        out[req.rid] = {"tokens": toks, "logits": logs}
    return out
