"""BENCH JSON reports (the port's copy of `repro.bench.schema`; the
baseline gate `compare` is not ported yet, ROADMAP Queue 1 item 6)."""
