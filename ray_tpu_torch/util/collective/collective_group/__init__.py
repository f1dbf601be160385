"""Collective group backends."""
