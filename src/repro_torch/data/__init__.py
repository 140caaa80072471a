"""Synthetic datasets of the port (numpy copies of `repro.data`)."""
