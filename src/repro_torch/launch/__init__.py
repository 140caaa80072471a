"""Program entry points of the port (`python -m repro_torch.launch.<name>`)."""

from __future__ import annotations

import json

import torch


def cli_device(device: str) -> str:
    """A launcher's `--device`: CUDA without a card exits, naming the flag
    that runs on the CPU instead (no silent fallback)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    return device


def write_json(path: str | None, result) -> None:
    """Write a launcher's result to `path` (objects as their str)."""
    if path:
        with open(path, "w") as f:
            json.dump(result, f, indent=1, default=str)
