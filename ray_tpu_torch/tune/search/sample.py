"""Search-space domains.

Reference: ``python/ray/tune/search/sample.py`` — ``tune.uniform``/
``loguniform``/``randint``/``choice``/``grid_search``/``sample_from``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


class Domain:
    def sample(self, rng: np.random.Generator) -> Any:
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False,
                 q: Optional[float] = None):
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng):
        if self.log:
            v = math.exp(rng.uniform(math.log(self.lower),
                                     math.log(self.upper)))
        else:
            v = rng.uniform(self.lower, self.upper)
        if self.q:
            v = round(v / self.q) * self.q
        return float(v)


class Integer(Domain):
    def __init__(self, lower: int, upper: int, q: Optional[int] = None):
        self.lower, self.upper, self.q = lower, upper, q

    def sample(self, rng):
        v = int(rng.integers(self.lower, self.upper))
        if self.q:
            v = int(round(v / self.q) * self.q)
        return v


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return self.categories[int(rng.integers(0, len(self.categories)))]


class Normal(Domain):
    def __init__(self, mean: float, sd: float):
        self.mean, self.sd = mean, sd

    def sample(self, rng):
        return float(rng.normal(self.mean, self.sd))


class Function(Domain):
    def __init__(self, fn: Callable[[Optional[Dict]], Any]):
        self.fn = fn

    def sample(self, rng):
        try:
            return self.fn(None)
        except TypeError:
            return self.fn()


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, q=q)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def qrandint(lower: int, upper: int, q: int) -> Integer:
    return Integer(lower, upper, q=q)


def randn(mean: float = 0.0, sd: float = 1.0) -> Normal:
    return Normal(mean, sd)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def sample_from(fn: Callable) -> Function:
    return Function(fn)


def grid_search(values: Sequence[Any]) -> Dict[str, List[Any]]:
    """Reference encoding: {'grid_search': [...]} in the param space."""
    return {"grid_search": list(values)}
