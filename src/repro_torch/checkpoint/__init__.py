"""Atomic keep-K checkpoints (PyTorch port of `repro.checkpoint`)."""

from repro_torch.checkpoint.checkpoint import (CheckpointManager,  # noqa
                                               latest_step, read_meta,
                                               restore, save)
