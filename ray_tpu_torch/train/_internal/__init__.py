"""Train internals (reference: ``python/ray/train/_internal/``)."""
