"""JSON (de)serialization for the plan/program layer (PyTorch port of
`repro.rosa.serialize`).

Everything `rosa.compile` persists — `RosaConfig`, `ExecutionPlan`,
`ProgramTrace`, autotune settings — round-trips through plain JSON dicts,
so searched plans live in the content-addressed on-disk plan cache and can
be inspected and diffed offline.  Serialization is canonical (sorted keys,
minimal separators) because the cache key is a hash of these documents.
The same config values lower to the same bytes as in the reference, so
the two packages share cache keys and cached plans.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
from typing import Any

from repro_torch.core import energy as E
from repro_torch.core import mrr, osa
from repro_torch.core.constants import ComputeMode, Mapping, OPEConfig
from repro_torch.rosa.backends import RosaConfig


def to_jsonable(obj: Any) -> Any:
    """Recursively lower dataclasses/enums/tuples to JSON-native values."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, enum.Enum):
        return obj.value
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    raise TypeError(f"cannot serialize {type(obj).__name__} to JSON")


def canonical_json(doc: Any) -> str:
    """Deterministic JSON text (sorted keys, minimal separators)."""
    return json.dumps(to_jsonable(doc), sort_keys=True,
                      separators=(",", ":"))


def content_hash(*docs: Any) -> str:
    """SHA-256 over the canonical JSON of `docs`: the cache-key primitive."""
    h = hashlib.sha256()
    for doc in docs:
        h.update(canonical_json(doc).encode("utf-8"))
        h.update(b"\x00")
    return h.hexdigest()


# ---------------------------------------------------------------------------
# RosaConfig
# ---------------------------------------------------------------------------
def config_to_json(cfg: RosaConfig | None) -> dict | None:
    """RosaConfig -> JSON-able dict (None passes through)."""
    return None if cfg is None else to_jsonable(cfg)


def config_from_json(doc: dict | None) -> RosaConfig | None:
    """Inverse of `config_to_json`."""
    if doc is None:
        return None
    return RosaConfig(
        mapping=Mapping(doc["mapping"]),
        mode=ComputeMode(doc["mode"]),
        quant_bits=int(doc["quant_bits"]),
        pam_bits=int(doc["pam_bits"]),
        noise=mrr.NoiseModel(**doc["noise"]),
        osa_cfg=osa.OSAConfig(**doc["osa_cfg"]),
        mrr_params=mrr.MRRParams(**doc["mrr_params"]),
        backend=doc["backend"],
        act_per_vector=bool(doc["act_per_vector"]),
    )


# ---------------------------------------------------------------------------
# Energy-model configs (autotune settings)
# ---------------------------------------------------------------------------
def ope_from_json(doc: dict) -> OPEConfig:
    """OPEConfig from its JSON dict."""
    return OPEConfig(rows=int(doc["rows"]), cols=int(doc["cols"]),
                     tiles=int(doc["tiles"]))


def osa_energy_from_json(doc: dict) -> E.OSAEnergyConfig:
    """OSAEnergyConfig from its JSON dict."""
    return E.OSAEnergyConfig(enabled=bool(doc["enabled"]),
                             ode_len=int(doc["ode_len"]))
