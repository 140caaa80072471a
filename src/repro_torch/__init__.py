"""repro_torch — the PyTorch / CUDA port of the ROSA reproduction.

Same subpackage layout as the JAX reference package `repro` (core,
kernels, rosa, robust, models, configs, serve, launch); each module maps
onto the reference module of the same name.  The package imports torch and
numpy, never jax and nothing of `repro`.  Entry points run on the CUDA
device unless the caller passes `device="cpu"`; the hand-written kernels
(`kernels/csrc/*.cu`) build with nvcc on first use.
"""
