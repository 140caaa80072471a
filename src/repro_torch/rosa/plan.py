"""`ExecutionPlan` — frozen, hashable per-layer config resolution (PyTorch
port of `repro.rosa.plan`; its JSON round-trip waits with the plan cache).

A plan is the single object that says, for every named matmul in a network,
which `RosaConfig` executes it: a `default` config (None = plain dense
einsum, i.e. the layer never touches the optical path) plus per-layer
`overrides` (the paper's layer-wise hybrid IS/WS mapping is exactly such an
override set).  Optionally the plan carries the known `layers` tuple, in
which case override names are validated at build time and lookups of
undeclared names fail loudly instead of silently falling back.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping as TMapping

from repro_torch.core.constants import Mapping
from repro_torch.rosa.backends import RosaConfig


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Resolves layer name -> RosaConfig (None = exact dense einsum)."""

    default: RosaConfig | None = None
    overrides: tuple[tuple[str, RosaConfig | None], ...] = ()
    layers: tuple[str, ...] | None = None   # declared layer set (optional)

    # -- constructors -------------------------------------------------------
    @classmethod
    def build(cls, default: RosaConfig | None = None,
              overrides: TMapping[str, RosaConfig | None] | None = None,
              layers: Iterable[str] | None = None) -> "ExecutionPlan":
        """Validating constructor: override names must be declared layers."""
        layers_t = tuple(layers) if layers is not None else None
        ov = dict(overrides or {})
        if layers_t is not None:
            unknown = sorted(set(ov) - set(layers_t))
            if unknown:
                raise ValueError(
                    f"plan overrides name unknown layers {unknown}; "
                    f"declared layers: {sorted(layers_t)}")
        return cls(default, tuple(sorted(ov.items())), layers_t)

    @classmethod
    def from_mapping_plan(cls, default: RosaConfig,
                          plan: TMapping[str, Mapping],
                          layers: Iterable[str] | None = None
                          ) -> "ExecutionPlan":
        """Lift a `{layer: Mapping}` hybrid plan (core.mapping.hybrid_plan)
        into per-layer configs: the default config with the mapping field
        swapped per layer.
        """
        ov = {name: dataclasses.replace(default, mapping=m)
              for name, m in plan.items()}
        return cls.build(default, ov, layers)

    # -- resolution ---------------------------------------------------------
    def resolve(self, name: str) -> RosaConfig | None:
        """Config for a named layer; raises KeyError on undeclared names
        when the plan carries a declared layer set.
        """
        for n, cfg in self.overrides:
            if n == name:
                return cfg
        if self.layers is not None and name not in self.layers:
            raise KeyError(
                f"layer {name!r} not in declared plan layers "
                f"{sorted(self.layers)}")
        return self.default

    def map_configs(self, fn) -> "ExecutionPlan":
        """Derived plan with `fn(cfg)` applied to every non-None config
        (default and overrides)."""
        return ExecutionPlan(
            fn(self.default) if self.default is not None else None,
            tuple((n, fn(c) if c is not None else None)
                  for n, c in self.overrides),
            self.layers)

    @property
    def is_dense(self) -> bool:
        """True when no layer can reach the optical path."""
        return self.default is None and all(c is None
                                            for _, c in self.overrides)

    def mapping_plan(self) -> dict[str, Mapping]:
        """Project back to a `{layer: Mapping}` dict (optical layers only)."""
        return {n: c.mapping for n, c in self.overrides if c is not None}
