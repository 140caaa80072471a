"""Synthetic datasets of the port (numpy copies of `repro.data`)."""

from repro_torch.data.tokens import TokenPipeline  # noqa: F401
