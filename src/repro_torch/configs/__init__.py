"""Architecture registry of the port: one module per ported architecture.

Each module defines CONFIG (the published dims) and SMOKE (a reduced
same-family config for CPU tests).  Ported so far: qwen3-32b (dense)
and mamba2-1.3b (ssm).

    from repro_torch.configs import get_config, get_smoke
"""

from __future__ import annotations

import importlib

ARCHS = ["qwen3_32b", "mamba2_1p3b"]

# assignment ids -> module names
ARCH_IDS = {"qwen3-32b": "qwen3_32b", "mamba2-1.3b": "mamba2_1p3b"}


def _module(name: str):
    mod = ARCH_IDS.get(name, name.replace("-", "_").replace(".", "p"))
    if mod not in ARCHS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported to repro_torch yet; "
            f"ported: {sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE
