"""Shared helpers for the model zoo."""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch


def normal_init(gen: torch.Generator, shape, dtype,
                scale: float = 0.02) -> torch.Tensor:
    """N(0, scale²) drawn from ``gen`` on the generator's device (scaled
    in place: an 8 B-parameter init holds no second copy of a leaf)."""
    return torch.randn(shape, generator=gen, device=gen.device) \
        .mul_(scale).to(dtype)


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf of a nest of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def param_count(params: Any) -> int:
    """Elements over every leaf of a param tree."""
    counts: List[int] = []
    tree_map(lambda t: counts.append(t.numel()), params)
    return sum(counts)


def layer_views(blocks: Dict[str, Any], n_layer: int) -> List[Dict[str, Any]]:
    """Every layer's params as views of the stacked leaves, one ``unbind``
    per leaf (its backward is one stack, not one scatter per layer)."""
    per_leaf = tree_map(lambda t: t.unbind(0), blocks)
    return [tree_map(lambda u: u[i], per_leaf) for i in range(n_layer)]
