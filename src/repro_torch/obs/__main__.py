"""Module entry point: ``python -m repro_torch.obs summarize trace.json``."""

import sys

from repro_torch.obs.cli import main

sys.exit(main())
