"""`Engine` — the single entry point onto the optical path (PyTorch port of
`repro.rosa.engine`).

The Engine owns an `ExecutionPlan` (per-layer RosaConfig, hybrid IS/WS
mapping included), a base key with deterministic per-layer / per-step
folding, and an optional `EnergyLedger` that records each routed matmul's
GEMM shape.  Model code that takes no engine argument resolves the ambient
engine installed by `engine_context` (a ContextVar, so threads and tasks
each see their own).

A call on `meta` tensors records the matmul (or, for `effective_weight`,
returns the weight) without running a backend: that is how `rosa.program`
traces a model at full width without computing anything.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import warnings
import zlib
from typing import Iterable, Mapping as TMapping

import torch

from repro_torch.core import mrr
from repro_torch.core.constants import Mapping
from repro_torch.obs import trace as obs
from repro_torch.rosa.backends import (DEFAULT, RosaConfig, condition_weight,
                                       rosa_matmul)
from repro_torch.rosa.ledger import EnergyLedger
from repro_torch.rosa.plan import ExecutionPlan

_ENGINE_VAR: contextvars.ContextVar["Engine | None"] = \
    contextvars.ContextVar("rosa_torch_ambient_engine", default=None)


def ambient_engine() -> "Engine | None":
    """The innermost engine installed by `engine_context`, or None."""
    return _ENGINE_VAR.get()


@contextlib.contextmanager
def engine_context(engine: "Engine | None"):
    """Install `engine` as the ambient optical engine for model code
    (context-local; nested installs restore the previous engine)."""
    token = _ENGINE_VAR.set(engine)
    try:
        yield engine
    finally:
        _ENGINE_VAR.reset(token)


def current_engine() -> "Engine | None":
    """Deprecated alias of `ambient_engine` (pre-Program API)."""
    warnings.warn(
        "rosa.current_engine is deprecated; use rosa.ambient_engine(), or "
        "better, rosa.compile(...) which threads the engine for you",
        DeprecationWarning, stacklevel=2)
    return ambient_engine()


def use_engine(engine: "Engine"):
    """Deprecated alias of `engine_context` (pre-Program API)."""
    warnings.warn(
        "rosa.use_engine is deprecated; use rosa.engine_context(engine), or "
        "better, rosa.compile(...) which installs the engine around its own "
        "traces", DeprecationWarning, stacklevel=2)
    return engine_context(engine)


def layer_key(base: torch.Generator, name: str, step: int = 0
              ) -> torch.Generator:
    """Deterministic per-layer/per-step key: fold the layer name's CRC and
    the step counter into the base key."""
    k = mrr.fold_in(base, zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF)
    return mrr.fold_in(k, int(step))


@dataclasses.dataclass(frozen=True)
class Engine:
    """Routes every named matmul through the resolved execution plan.

    `variation` pins one sampled chip (`{layer: mrr.StaticVariation}`);
    `gates` holds per-layer scalars in [0, 1] blending the analog path
    against the exact digital one (the perturb-one-layer selector of
    `robust.sensitivity`); `mapping_gates` per-layer WS/IS selectors
    ({0=WS, 1=IS}) that superpose the two mappings, so a whole hybrid plan
    is a vector of floats (the plan search of `robust.sensitivity`).
    """

    plan: ExecutionPlan = ExecutionPlan()
    key: torch.Generator | None = None
    ledger: EnergyLedger | None = None
    variation: TMapping[str, mrr.StaticVariation] | None = None
    gates: TMapping[str, float | torch.Tensor] | None = None
    mapping_gates: TMapping[str, float | torch.Tensor] | None = None

    # -- constructors -------------------------------------------------------
    @classmethod
    def dense(cls) -> "Engine":
        """All layers exact dense contraction (no optical path)."""
        return cls(ExecutionPlan())

    @classmethod
    def from_config(cls, cfg: RosaConfig = DEFAULT,
                    layers: Iterable[str] | None = None,
                    key: torch.Generator | None = None,
                    ledger: EnergyLedger | None = None) -> "Engine":
        """Every layer runs the same RosaConfig."""
        return cls(ExecutionPlan.build(cfg, None, layers), key, ledger)

    @classmethod
    def from_hybrid_plan(cls, cfg: RosaConfig,
                         plan: TMapping[str, Mapping] | None,
                         layers: Iterable[str] | None = None,
                         key: torch.Generator | None = None,
                         ledger: EnergyLedger | None = None) -> "Engine":
        """`cfg` everywhere, with the mapping overridden per layer."""
        return cls(ExecutionPlan.from_mapping_plan(cfg, plan or {}, layers),
                   key, ledger)

    # -- derivations --------------------------------------------------------
    def with_key(self, key: torch.Generator | None) -> "Engine":
        return dataclasses.replace(self, key=key)

    def with_ledger(self, ledger: EnergyLedger | None) -> "Engine":
        return dataclasses.replace(self, ledger=ledger)

    def with_plan(self, plan: ExecutionPlan) -> "Engine":
        return dataclasses.replace(self, plan=plan)

    def with_variation(self, variation: TMapping[str, mrr.StaticVariation]
                       | None) -> "Engine":
        """Pin one sampled chip (None unpins)."""
        return dataclasses.replace(
            self, variation=dict(variation) if variation is not None
            else None)

    def with_gates(self, gates: TMapping[str, float | torch.Tensor] | None
                   ) -> "Engine":
        """Per-layer analog/digital blend gates in [0, 1] (None unsets)."""
        return dataclasses.replace(
            self, gates=dict(gates) if gates is not None else None)

    def with_mapping_gates(self, mapping_gates: TMapping[
            str, float | torch.Tensor] | None) -> "Engine":
        """Per-layer WS/IS selectors ({0=WS, 1=IS}) superposing the two
        mappings (None unsets)."""
        return dataclasses.replace(
            self, mapping_gates=dict(mapping_gates)
            if mapping_gates is not None else None)

    # -- resolution ---------------------------------------------------------
    @property
    def is_dense(self) -> bool:
        return self.plan.is_dense

    def config(self, name: str) -> RosaConfig | None:
        return self.plan.resolve(name)

    def key_for(self, name: str, step: int = 0) -> torch.Generator | None:
        return None if self.key is None else layer_key(self.key, name, step)

    def variation_for(self, name: str) -> mrr.StaticVariation | None:
        return None if self.variation is None else self.variation.get(name)

    def gate_for(self, name: str):
        """The analog-blend gate of one layer, if any."""
        return None if self.gates is None else self.gates.get(name)

    def mapping_gate_for(self, name: str):
        """The WS/IS mapping gate of one layer, if any."""
        return None if self.mapping_gates is None \
            else self.mapping_gates.get(name)

    # -- the routed matmul --------------------------------------------------
    def matmul(self, x: torch.Tensor, w: torch.Tensor, *, name: str = "",
               step: int = 0, key: torch.Generator | None = None,
               split=None) -> torch.Tensor:
        """y = x @ w through this layer's resolved config; x (..., K),
        w (K, N).  Dense layers contract exactly in the caller's dtype.

        `split` (a `distributed.sharding.ProductSplit`) says how this
        rank's x and w are cut from the global product's (a rank of a
        tensor-parallel train step): the full-scales and per-shot draws
        are the global operands' (`use_product_split`), the pinned chip's
        lanes are cut alike, and the ledger records the global shape, as
        the reference's trace of its partitioned step does; a K split
        returns this rank's partial product, which the caller sums."""
        cfg = self.plan.resolve(name)
        m = math.prod(x.shape[:-1])
        k, n = int(x.shape[-1]), int(w.shape[-1])
        if obs.enabled():
            # once per (layer, shape) and tracer: the compile timeline shows
            # every shape the engine routes (and which fall through to dense)
            layer = name or "unnamed"
            obs.instant_once((layer, m, k, n), "rosa.matmul", "compile",
                             layer=layer, m=m, k=k, n=n, dense=cfg is None)
        if cfg is None:
            return torch.einsum("...k,kn->...n", x, w)
        if self.ledger is not None:
            from repro_torch.distributed.sharding import global_gemm
            m, k, n = global_gemm(m, k, n, split)
            self.ledger.record(name or f"unnamed_{m}x{k}x{n}",
                               m=m, k=k, n=n, cfg=cfg)
        if x.device.type == "meta":
            return torch.empty((*x.shape[:-1], w.shape[-1]),
                               dtype=torch.float32, device="meta")
        if key is None:
            key = self.key_for(name, step)
        var = self.variation_for(name)
        if split is not None and var is not None:
            var = mrr.StaticVariation(*(split.cut_field(a, tuple(w.shape))
                                        for a in (var.dv, var.ddt, var.dlam)))
        from repro_torch.distributed.sharding import use_product_split
        with use_product_split(split):
            return rosa_matmul(x.float(), w.float(), cfg, key, var,
                               self.gate_for(name),
                               self.mapping_gate_for(name))

    def effective_weight(self, w: torch.Tensor, *, name: str = "",
                         step: int = 0, key: torch.Generator | None = None
                         ) -> torch.Tensor:
        """Noise-place a weight for a contraction the engine does not route
        itself (the per-channel depthwise conv): the analog realization,
        with the layer's key, pinned chip and gate, that `matmul` gives its
        WS side; identity for dense or fully ideal layers."""
        if w.device.type == "meta":
            return w
        if key is None:
            key = self.key_for(name, step)
        return condition_weight(w, self.plan.resolve(name), key,
                                self.variation_for(name),
                                self.gate_for(name))

