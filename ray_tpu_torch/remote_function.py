"""``@ray_tpu_torch.remote`` for plain functions.

Reference: ``python/ray/remote_function.py`` (SURVEY.md §2.3, §3.2).
``f.remote(*args)`` returns ObjectRef(s); ``f.options(**over).remote(...)``
overrides per-call options with the same names as the reference
(``num_cpus``, ``num_gpus``, ``resources``,
``num_returns``, ``max_retries``, ``retry_exceptions``,
``scheduling_strategy``, ``name``, ``runtime_env``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private import worker as _worker
from ray_tpu_torch.util.scheduling_strategies import strategy_to_spec

_DEFAULTS = dict(num_returns=1, num_cpus=1, num_gpus=0, resources=None,
                 max_retries=None, retry_exceptions=False,
                 scheduling_strategy=None, name=None, runtime_env=None)


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        self._function = fn
        self._options = {**_DEFAULTS, **(options or {})}
        functools.update_wrapper(self, fn)

    def remote(self, *args: Any, **kwargs: Any):
        o = self._options
        w = _worker.global_worker()
        refs = w.submit(
            self._function, args, kwargs,
            num_returns=o["num_returns"], num_cpus=o["num_cpus"],
            num_gpus=o["num_gpus"], resources=o["resources"],
            max_retries=o["max_retries"], retry_exceptions=o["retry_exceptions"],
            scheduling_strategy=strategy_to_spec(o["scheduling_strategy"]),
            name=o["name"] or getattr(self._function, "__name__", "task"),
            runtime_env=o["runtime_env"])
        return refs[0] if o["num_returns"] == 1 else refs

    def options(self, **overrides: Any) -> "RemoteFunction":
        merged = {**self._options}
        for k, v in overrides.items():
            if k not in _DEFAULTS:
                raise ValueError(f"unknown option {k!r}")
            merged[k] = v
        return RemoteFunction(self._function, merged)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._function.__name__!r} cannot be called "
            "directly; use .remote()")

    @property
    def func(self):
        """The underlying local function (for testing)."""
        return self._function
