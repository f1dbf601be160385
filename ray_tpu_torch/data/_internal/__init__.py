"""Data internals (reference: ``python/ray/data/_internal/``)."""
