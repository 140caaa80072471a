"""Training loops of the port (PyTorch port of `repro.training`)."""
