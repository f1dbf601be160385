"""Attention and normalisation ops; kernels live in ``../csrc``."""
