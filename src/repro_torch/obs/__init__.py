"""Observability: the span tracer (`trace`, the port's copy of
`repro.obs.trace`) and the metrics registry (`metrics`: counters, gauges
and histograms the plan cache and the drift controller write).  Energy
counters and `launch/serve.py --trace` wait (ROADMAP Queue 1 item 6)."""
