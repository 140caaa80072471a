"""Optimizer of the LM training path (PyTorch port of `repro.optim`)."""

from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: F401
                                     adamw_update, clip_by_global_norm,
                                     global_norm)
from repro_torch.optim.schedules import (cosine_schedule,  # noqa: F401
                                         linear_warmup)
