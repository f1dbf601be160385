"""Model multiplexing: many models behind one deployment.

Reference: ``python/ray/serve/multiplex.py`` +
``api.get_multiplexed_model_id`` — one replica pool serves MANY model
checkpoints; each request names a model id, replicas hold an LRU of
loaded models, and the router prefers replicas that already hold the
requested model (so a hot model stays resident on some replica instead
of being reloaded per request).  Port of ``ray_tpu/serve/multiplex.py``.

On the card a model load copies its weights to the device (and an LLM
engine allocates its KV pool there), which is why affinity routing and
LRU retention matter; an evicted model's ``__serve_unload__`` runs so
its device memory goes back.

Usage::

    @serve.deployment
    class Multi:
        @serve.multiplexed(max_num_models_per_replica=3)
        async def get_model(self, model_id: str):
            return load_checkpoint(model_id)       # slow: runs on miss

        async def __call__(self, x):
            model = await self.get_model(
                serve.get_multiplexed_model_id())
            return model(x)

    handle.options(multiplexed_model_id="ckpt-7").remote(x)
    # HTTP: curl -H "serve_multiplexed_model_id: ckpt-7" ...
"""

from __future__ import annotations

import asyncio
import collections
import contextvars
import functools
import inspect
import threading
from typing import Any, Callable, Optional

_current_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")

_wrappers_lock = threading.Lock()    # guards lazy per-instance creation


def get_multiplexed_model_id() -> str:
    """Inside a replica: the model id of the CURRENT request
    (reference: ``serve.get_multiplexed_model_id``)."""
    return _current_model_id.get()


def _set_model_id(model_id: str):
    return _current_model_id.set(model_id)


class _MultiplexWrapper:
    """Per-(replica, method) LRU of model_id → loaded model."""

    def __init__(self, fn: Callable, max_models: int):
        self.fn = fn
        self.max_models = max_models
        self._models: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._locks: dict = {}          # model_id -> asyncio.Lock
        self._global_lock = threading.Lock()

    def model_ids(self) -> list:
        with self._global_lock:
            return list(self._models)

    def pop_all(self) -> list:
        """Drain the LRU (replica teardown): returns the loaded models;
        the caller runs their unload hooks — kept sync-callable because
        graceful drain runs outside the replica's asyncio loop."""
        with self._global_lock:
            models = list(self._models.values())
            self._models.clear()
            return models

    async def load(self, owner, model_id: Optional[str]) -> Any:
        if model_id is None:
            model_id = get_multiplexed_model_id()
        if not model_id:
            raise ValueError(
                "no multiplexed model id: pass one explicitly or route the "
                "request with handle.options(multiplexed_model_id=...)")
        with self._global_lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return self._models[model_id]
            lock = self._locks.setdefault(model_id, asyncio.Lock())
        async with lock:
            with self._global_lock:
                if model_id in self._models:   # loaded while we waited
                    self._models.move_to_end(model_id)
                    return self._models[model_id]
            if inspect.iscoroutinefunction(self.fn):
                model = await self.fn(owner, model_id)
            else:
                model = self.fn(owner, model_id)
            with self._global_lock:
                self._models[model_id] = model
                evicted = []
                while len(self._models) > self.max_models:
                    evicted.append(self._models.popitem(last=False))
            for _mid, old in evicted:
                # reference behavior: call __del__ via dropping the ref;
                # honor an explicit __serve_unload__/unload hook if present
                hook = getattr(old, "__serve_unload__",
                               getattr(old, "unload", None))
                if callable(hook):
                    try:
                        res = hook()
                        if inspect.isawaitable(res):
                            await res
                    except Exception:  # noqa: BLE001 - best-effort unload
                        pass
            return model


def _lazy_wrapper(owner: Any, attr: str, fn: Callable,
                  max_models: int) -> "_MultiplexWrapper":
    """Get-or-create the per-instance LRU wrapper (replica side)."""
    wrapper = getattr(owner, attr, None)
    if wrapper is None:
        with _wrappers_lock:
            wrapper = getattr(owner, attr, None)
            if wrapper is None:
                wrapper = _MultiplexWrapper(fn, max_models)
                setattr(owner, attr, wrapper)
    return wrapper


def multiplexed(_fn: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorator for the model-loading method of a deployment
    (reference: ``serve.multiplexed``).

    The LRU wrapper is created LAZILY on the instance at first use: the
    deployment class is cloudpickled to replicas, and a decoration-time
    wrapper (locks, loaded models) must not ride along."""

    def wrap(fn: Callable) -> Callable:
        attr = f"__serve_mux_{fn.__name__}"
        max_models = max_num_models_per_replica

        @functools.wraps(fn)
        async def load(self, model_id: Optional[str] = None):
            # call-time import: a module-global reference here would get
            # cloudpickled BY VALUE with the deployment class (locks are
            # unpicklable); an import resolves by name on the replica
            from ray_tpu_torch.serve.multiplex import _lazy_wrapper
            wrapper = _lazy_wrapper(self, attr, fn, max_models)
            return await wrapper.load(self, model_id)

        load.__serve_multiplexed__ = True
        return load

    if _fn is not None:
        return wrap(_fn)
    return wrap
