"""Shared helpers for the model zoo."""

from __future__ import annotations

import torch


def normal_init(gen: torch.Generator, shape, dtype,
                scale: float = 0.02) -> torch.Tensor:
    """N(0, scale²) drawn from ``gen`` on the generator's device."""
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)
