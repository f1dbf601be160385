"""``@serve.deployment`` decorator, ``Deployment``, and ``Application``.

Reference: ``python/ray/serve/deployment.py`` + the 2.x DAG/bind API
(SURVEY.md §2.5): ``@serve.deployment`` wraps a class or function;
``.bind(*args)`` builds an application graph node whose arguments may be
other bound deployments (model composition); ``serve.run(app)`` deploys the
whole graph with the outermost node as HTTP ingress.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional, Tuple, Union

from ray_tpu_torch.serve._replica import HandleMarker
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig


def _wrap_function(fn: Callable) -> type:
    """Function deployments become a class whose __call__ is the function."""
    if inspect.iscoroutinefunction(fn):
        class FuncDeployment:
            async def __call__(self, *args, **kwargs):
                return await fn(*args, **kwargs)
    else:
        class FuncDeployment:
            def __call__(self, *args, **kwargs):
                return fn(*args, **kwargs)
    FuncDeployment.__name__ = getattr(fn, "__name__", "FuncDeployment")
    return FuncDeployment


class Application:
    """One node of a bound deployment graph."""

    def __init__(self, deployment: "Deployment", args: Tuple, kwargs: Dict):
        self._deployment = deployment
        self._args = args
        self._kwargs = kwargs

    def _collect(self, out: Dict[str, "Application"]) -> None:
        existing = out.get(self._deployment.name)
        if existing is not None and existing is not self:
            raise ValueError(
                f"two different deployments named {self._deployment.name!r} "
                "in one application")
        out[self._deployment.name] = self
        for child in self._children():
            child._collect(out)

    def _children(self):
        def walk(obj):
            if isinstance(obj, Application):
                yield obj
            elif isinstance(obj, (list, tuple)):
                for o in obj:
                    yield from walk(o)
            elif isinstance(obj, dict):
                for o in obj.values():
                    yield from walk(o)
        for a in self._args:
            yield from walk(a)
        for a in self._kwargs.values():
            yield from walk(a)

    def _marked_args(self, app_name: str) -> Tuple[Tuple, Dict]:
        def mark(obj):
            if isinstance(obj, Application):
                return HandleMarker(f"{app_name}#{obj._deployment.name}")
            if isinstance(obj, list):
                return [mark(o) for o in obj]
            if isinstance(obj, tuple):
                return tuple(mark(o) for o in obj)
            if isinstance(obj, dict):
                return {k: mark(v) for k, v in obj.items()}
            return obj
        return (tuple(mark(a) for a in self._args),
                {k: mark(v) for k, v in self._kwargs.items()})


class Deployment:
    def __init__(self, cls_or_fn: Union[type, Callable],
                 name: Optional[str] = None,
                 num_replicas: Union[int, str] = 1,
                 autoscaling_config: Optional[Union[dict, AutoscalingConfig]] = None,
                 max_ongoing_requests: int = 8,
                 ray_actor_options: Optional[dict] = None,
                 graceful_shutdown_wait_s: float = 2.0,
                 health_check_period_s: float = 5.0):
        self._target = cls_or_fn
        self.name = name or getattr(cls_or_fn, "__name__", "deployment")
        if isinstance(autoscaling_config, dict):
            autoscaling_config = AutoscalingConfig(**autoscaling_config)
        if num_replicas == "auto":
            autoscaling_config = autoscaling_config or AutoscalingConfig(
                min_replicas=1, max_replicas=100)
            num_replicas = autoscaling_config.min_replicas or 1
        self._options = dict(
            num_replicas=num_replicas, autoscaling_config=autoscaling_config,
            max_ongoing_requests=max_ongoing_requests,
            ray_actor_options=ray_actor_options,
            graceful_shutdown_wait_s=graceful_shutdown_wait_s,
            health_check_period_s=health_check_period_s)

    def options(self, **overrides: Any) -> "Deployment":
        name = overrides.pop("name", self.name)
        merged = {**self._options}
        for k, v in overrides.items():
            if k not in merged:
                raise ValueError(f"unknown deployment option {k!r}")
            merged[k] = v
        return Deployment(self._target, name=name, **merged)

    def bind(self, *args: Any, **kwargs: Any) -> Application:
        return Application(self, args, kwargs)

    @property
    def user_class(self) -> type:
        if inspect.isclass(self._target):
            return self._target
        return _wrap_function(self._target)

    def to_config(self) -> DeploymentConfig:
        o = self._options
        return DeploymentConfig(
            num_replicas=int(o["num_replicas"]),
            max_ongoing_requests=o["max_ongoing_requests"],
            autoscaling_config=o["autoscaling_config"],
            ray_actor_options=o["ray_actor_options"],
            graceful_shutdown_wait_s=o["graceful_shutdown_wait_s"],
            health_check_period_s=o["health_check_period_s"])

    def __repr__(self):
        return f"Deployment({self.name!r})"


def deployment(_target=None, **options: Any):
    """``@serve.deployment`` / ``@serve.deployment(num_replicas=..., ...)``."""
    if _target is not None:
        return Deployment(_target)

    def wrap(target):
        return Deployment(target, **options)
    return wrap
