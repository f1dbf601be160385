"""``@ray_tpu_torch.remote`` classes: ActorClass / ActorHandle / ActorMethod.

Reference: ``python/ray/actor.py`` (SURVEY.md §2.3, §3.3).  Semantics kept:
``Cls.remote(...)`` returns a handle immediately (creation is async);
``handle.method.remote(...)`` returns ObjectRef(s) with per-handle ordering;
``max_restarts``/``max_task_retries`` drive the GCS actor FSM; named actors
via ``name=`` + ``ray_tpu_torch.get_actor``; handles are serializable and can be
passed to tasks/actors.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private import worker as _worker
from ray_tpu_torch.util.scheduling_strategies import strategy_to_spec

_ACTOR_DEFAULTS = dict(
    # num_cpus=None means the reference's default actor semantics: 1 CPU
    # for creation SCHEDULING, 0 held while alive.  Explicit num_cpus /
    # num_gpus / resources are held for the actor's lifetime.
    num_cpus=None, num_gpus=0, resources=None, max_restarts=0,
    max_task_retries=0, max_concurrency=1, name=None, namespace="default",
    lifetime=None, get_if_exists=False, scheduling_strategy=None,
    runtime_env=None)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def remote(self, *args: Any, **kwargs: Any):
        h = self._handle
        w = _worker.global_worker()
        refs = w.call_actor(
            h._actor_id, self._method_name, args, kwargs,
            num_returns=self._num_returns,
            max_task_retries=h._max_task_retries)
        return refs[0] if self._num_returns == 1 else refs

    def options(self, num_returns: int = 1, **_ignored):
        return ActorMethod(self._handle, self._method_name, num_returns)


class ActorHandle:
    def __init__(self, actor_id: str, method_meta: Dict[str, dict],
                 max_task_retries: int = 0, class_name: str = "Actor"):
        self._actor_id = actor_id
        self._method_meta = method_meta
        self._max_task_retries = max_task_retries
        self._class_name = class_name

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        meta = self._method_meta.get(name)
        if meta is None and name not in ("__ray_ready__", "__ray_terminate__"):
            raise AttributeError(
                f"actor {self._class_name} has no method {name!r}")
        return ActorMethod(self, name, (meta or {}).get("num_returns", 1))

    @property
    def __ray_ready__(self) -> ActorMethod:
        return ActorMethod(self, "__ray_ready__", 1)

    @property
    def __ray_terminate__(self) -> ActorMethod:
        return ActorMethod(self, "__ray_terminate__", 1)

    @property
    def __ray_apply__(self) -> ActorMethod:
        """Run ``fn(instance, *args, **kwargs)`` inside the actor process.

        Reference: ``ActorHandle.__ray_call__`` — the generic escape hatch
        used by ``ray.util.collective`` setup and Train's worker group.
        """
        return ActorMethod(self, "__ray_apply__", 1)

    # Reference-compatible alias.
    __ray_call__ = __ray_apply__

    def __repr__(self) -> str:
        return f"ActorHandle({self._class_name}, {self._actor_id[:8]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._method_meta,
                              self._max_task_retries, self._class_name))


class ActorClass:
    def __init__(self, cls: type, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = {**_ACTOR_DEFAULTS, **(options or {})}
        functools.update_wrapper(self, cls, updated=[])

    def remote(self, *args: Any, **kwargs: Any) -> ActorHandle:
        o = self._options
        w = _worker.global_worker()
        hold = (o["num_cpus"] is not None or bool(o["num_gpus"])
                or bool(o["resources"]))
        info = w.create_actor(
            self._cls, args, kwargs,
            hold_resources=hold,
            num_cpus=1 if o["num_cpus"] is None else o["num_cpus"],
            num_gpus=o["num_gpus"],
            resources=o["resources"], max_restarts=o["max_restarts"],
            max_task_retries=o["max_task_retries"],
            max_concurrency=o["max_concurrency"],
            name=o["name"], namespace=o["namespace"],
            detached=(o["lifetime"] == "detached"),
            get_if_exists=o["get_if_exists"],
            scheduling_strategy=strategy_to_spec(o["scheduling_strategy"]),
            runtime_env=o["runtime_env"])
        return ActorHandle(info["actor_id"], info["method_meta"],
                           o["max_task_retries"], self._cls.__name__)

    def options(self, **overrides: Any) -> "ActorClass":
        merged = {**self._options}
        for k, v in overrides.items():
            if k not in _ACTOR_DEFAULTS:
                raise ValueError(f"unknown actor option {k!r}")
            merged[k] = v
        return ActorClass(self._cls, merged)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self._cls.__name__!r} cannot be instantiated "
            "directly; use .remote()")

    @property
    def cls(self) -> type:
        return self._cls


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    w = _worker.global_worker()
    resp = w.rpc("get_actor_by_name", name=name, namespace=namespace)
    return ActorHandle(resp["actor_id"], resp.get("method_meta") or {},
                       0, name)
