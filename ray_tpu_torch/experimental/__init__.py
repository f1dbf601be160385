"""Experimental APIs (reference: ``python/ray/experimental/``)."""
