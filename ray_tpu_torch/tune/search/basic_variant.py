"""Variant generation: grid expansion × random sampling.

Reference: ``python/ray/tune/search/basic_variant.py``
(``BasicVariantGenerator``) — every ``grid_search`` key is expanded into
its cross-product; ``Domain`` leaves are sampled per trial; the product is
repeated ``num_samples`` times.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.tune.search.sample import Domain


def _walk(space: Any, path: Tuple) -> Iterator[Tuple[Tuple, Any]]:
    if isinstance(space, dict):
        if set(space.keys()) == {"grid_search"}:
            yield (path, space)
            return
        for k, v in space.items():
            yield from _walk(v, path + (k,))
    else:
        yield (path, space)


def _set(d: Dict, path: Tuple, value: Any) -> None:
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


class BasicVariantGenerator:
    def __init__(self, seed: Optional[int] = None):
        self._rng = np.random.default_rng(seed)

    def generate(self, param_space: Dict[str, Any],
                 num_samples: int = 1) -> List[Dict[str, Any]]:
        leaves = list(_walk(param_space, ()))
        grid_paths = [(p, v["grid_search"]) for p, v in leaves
                      if isinstance(v, dict) and set(v) == {"grid_search"}]
        other = [(p, v) for p, v in leaves
                 if not (isinstance(v, dict) and set(v) == {"grid_search"})]
        grids = [list(vals) for _, vals in grid_paths]
        configs: List[Dict[str, Any]] = []
        for _ in range(num_samples):
            for combo in itertools.product(*grids) if grids else [()]:
                cfg: Dict[str, Any] = {}
                for (p, _), val in zip(grid_paths, combo):
                    _set(cfg, p, val)
                for p, v in other:
                    _set(cfg, p, v.sample(self._rng)
                         if isinstance(v, Domain) else v)
                configs.append(cfg)
        return configs
