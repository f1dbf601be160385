"""Tune internals."""
