"""Golden-token drift probes: cheap accuracy telemetry for the controller
(PyTorch port of `repro.serve.adaptive.probes`).

A probe is a small fixed batch of prompts run through the serving model's
prefill forward under the CURRENT thermal residual, scored as argmax
agreement against the GOLDEN reference: this chip, zero drift, the fixed
probe noise key, i.e. the fleet's behaviour at calibration time.  (The
clean no-chip reference would charge the probe for static fabrication
variation the controller cannot act on; against golden, agreement is
exactly 1.0 at zero residual and decays only with drift.)  The evaluator
is `robust.ensemble.make_plan_eval(gated=True)`, the same one-hot-gate
evaluator that backs the sensitivity degradation matrix, so one evaluator
serves every probe use:

  * plain health probe        sel = current plan, g = all-ones
  * per-layer localization    g one-hot (which layer is melting?)
  * replan measurement        (sel, g one-hot) grid -> degradation rows
                              in the `{layer: {mapping: pp}}` format
                              `rosa.compile(degradation=...)` takes

Probes run with the ledger detached: telemetry forwards must not move the
serving energy accounting.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import mrr
from repro_torch.core.constants import Mapping
from repro_torch.robust import variation as V
from repro_torch.robust.ensemble import (chunk_eval_set, chunked_argmax_preds,
                                         make_plan_eval)
from repro_torch.rosa.engine import engine_context

# the floor the sensitivity matrix applies: a measured-zero row must not make
# a mapping look infinitely safe to the accuracy-aware plan search
_ROW_FLOOR = 1e-3


@dataclasses.dataclass(frozen=True)
class ProbeConfig:
    """Probe batch shape and determinism knobs."""

    n_probes: int = 8      # prompts per probe batch
    prompt_len: int = 6    # tokens per prompt
    seed: int = 2024       # prompt content + the probe noise key


def plan_selector(engine, names) -> np.ndarray:
    """The current plan as a mapping-gate vector (1 = IS, else WS-side)."""
    mp = engine.plan.mapping_plan()
    return np.asarray([1.0 if mp.get(n) is Mapping.IS else 0.0
                       for n in names], np.float32)


def _one_chip(chip: V.Chip) -> V.Chip:
    """A chip as an ensemble of one (a leading chip axis of 1)."""
    return {n: mrr.StaticVariation(v.dv[None], v.ddt[None], v.dlam[None])
            for n, v in chip.items()}


class ProbeSet:
    """The probe evaluator bound to a serving program's engine.

    Construction runs nothing; the first `agreement` call computes the
    golden reference.  `tokens` ((n_probes, prompt_len) int32 on the
    chip's device, drawn from ``cfg.seed``) may be replaced before the
    first call."""

    def __init__(self, bundle, program, cfg: ProbeConfig = ProbeConfig()):
        if not program.engine.variation:
            raise ValueError(
                "drift probes need a pinned chip: build the serving "
                "program with scfg.variation_seed set")
        self.cfg = cfg
        self.names = list(program.trace.names)
        self.chip = dict(program.engine.variation)
        device = next(iter(self.chip.values())).dv.device
        gen = torch.Generator().manual_seed(cfg.seed)
        self.tokens = torch.randint(
            1, bundle.cfg.vocab, (cfg.n_probes, cfg.prompt_len),
            generator=gen, dtype=torch.int32).to(device)
        def probe_apply(params, xc, eng):
            with engine_context(eng):
                logits, _ = bundle.prefill(params, {"tokens": xc})
            return logits                              # (B, V) last-token

        self._apply = probe_apply
        self._base = program.engine.with_ledger(None)
        self._run = make_plan_eval(probe_apply, self._base, self.names,
                                   eval_batch=cfg.n_probes, gated=True)
        self.sel = plan_selector(program.engine, self.names)
        self._ones = np.ones(len(self.names), np.float32)
        # ONE fixed probe noise key: probe scores are functions of the
        # residual alone (the detector sees drift, not dice)
        self._keys = [torch.Generator(device).manual_seed(cfg.seed + 1)]
        self._golden = None      # resolved on first scoring (needs params)

    def golden(self, params) -> torch.Tensor:
        """Next-token argmax of THIS chip at zero residual under the fixed
        probe key: the calibration-time behaviour every probe is scored
        against.  Computed once; it survives replans (the yardstick must
        not move when the plan does)."""
        if self._golden is None:
            names = self.names
            eng = self._base.with_variation(self.chip) \
                .with_key(self._keys[0]) \
                .with_mapping_gates({n: float(self.sel[i])
                                     for i, n in enumerate(names)}) \
                .with_gates({n: 1.0 for n in names})
            with torch.no_grad():
                self._golden = chunked_argmax_preds(
                    self._apply, params,
                    chunk_eval_set(self.tokens, self.cfg.n_probes), eng)
        return self._golden

    def rebind(self, program) -> None:
        """Point the probe scoring at a re-planned program: only the
        mapping selector changes (trace, chip and prompts are the same)."""
        self.sel = plan_selector(program.engine, self.names)

    def agreement(self, params, resid_k: float, tick: int = 0, *,
                  sel=None, g=None) -> float:
        """Golden-token agreement in [0, 1] under thermal residual
        `resid_k` [K]: the fraction of probe prompts whose next-token
        argmax matches the zero-drift golden reference (1.0 at 0)."""
        golden = self.golden(params)
        shifted = V.shift_thermal(self.chip, float(np.float32(resid_k)))
        accs, _, _ = self._run(params, self.tokens, golden,
                               _one_chip(shifted), self._keys,
                               self.sel if sel is None else sel,
                               self._ones if g is None else g)
        return float(np.asarray(accs)[0]) / 100.0

    def degradation_rows(self, params, resid_k: float,
                         tick: int = 0) -> dict:
        """`{layer: {mapping.value: drop_pp}}` at the current residual, the
        REPLAN input: every (mapping x layer) cell is one evaluation with a
        one-hot `g` (only that layer analog) and a constant `sel`."""
        eye = np.eye(len(self.names), dtype=np.float32)
        rows: dict[str, dict[str, float]] = {n: {} for n in self.names}
        for mp in (Mapping.WS, Mapping.IS):
            sel = np.full(len(self.names), 1.0 if mp is Mapping.IS else 0.0,
                          np.float32)
            for i, name in enumerate(self.names):
                agree = self.agreement(params, resid_k, tick, sel=sel,
                                       g=eye[i])
                rows[name][mp.value] = max(100.0 * (1.0 - agree),
                                           _ROW_FLOOR)
        return rows
