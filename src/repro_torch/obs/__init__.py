"""Observability: the span tracer (`trace`, the port's copy of
`repro.obs.trace`).  The metrics registry, energy counters and
`launch/serve.py --trace` wait (ROADMAP Queue 1 item 6)."""
