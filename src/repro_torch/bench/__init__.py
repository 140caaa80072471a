"""BENCH JSON reports (the port's copy of `repro.bench.schema`) and the
baseline regression gate `compare` (`python -m repro_torch.bench.compare
BASE CUR`)."""
