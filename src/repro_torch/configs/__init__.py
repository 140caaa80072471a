"""Architecture registry of the port: one module per architecture of the
reference's registry (`repro.configs`).

Each module defines CONFIG (the published dims) and SMOKE (a reduced
same-family config for CPU tests).  The model code of all ten is ported
and held against the reference (`PORTED_ARCHS`); the model zoo lowers
every CONFIG to GEMM rows (`zoo_config`, `get_workload_zoo`).

    from repro_torch.configs import get_config, get_smoke, ARCHS
"""

from __future__ import annotations

import importlib

ARCHS = [
    "qwen3_moe_235b",
    "deepseek_v2_236b",
    "qwen3_32b",
    "deepseek_67b",
    "mistral_large_123b",
    "gemma3_12b",
    "mamba2_1p3b",
    "seamless_m4t_medium",
    "phi3_vision_4p2b",
    "zamba2_1p2b",
]

# assignment ids -> module names
ARCH_IDS = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen3-32b": "qwen3_32b",
    "deepseek-67b": "deepseek_67b",
    "mistral-large-123b": "mistral_large_123b",
    "gemma3-12b": "gemma3_12b",
    "mamba2-1.3b": "mamba2_1p3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "zamba2-1.2b": "zamba2_1p2b",
}

# assignment ids whose model code is ported (launch/serve.py --arch)
PORTED_ARCHS = tuple(ARCH_IDS)


def _module(name: str):
    name = ARCH_IDS.get(name, name).replace("-", "_").replace(".", "p")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE


def zoo_config(name: str):
    """CONFIG of any registry architecture, as the model zoo reads it
    (the same object `get_config` hands out)."""
    return _module(name).CONFIG


def get_workload_zoo(**kw):
    """GEMM-lowered DSE workloads: paper CNNs + every registry arch.

    Imported on call: `model_zoo` reads this registry back."""
    from repro_torch.configs.model_zoo import zoo_workloads
    return zoo_workloads(**kw)
