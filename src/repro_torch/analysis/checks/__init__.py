"""Check modules: importing this package populates the registry."""

from repro_torch.analysis.checks import (donation, kernels,  # noqa: F401
                                         prng, purity, recompile)
