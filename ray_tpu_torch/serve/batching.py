"""``@serve.batch`` — opportunistic request batching inside a replica.

Reference: ``python/ray/serve/batching.py`` (port of
``ray_tpu/serve/batching.py``).  On the card this is the main lever for
tensor-core utilization: individual requests are gathered (up to
``max_batch_size`` or ``batch_wait_timeout_s``) and the wrapped method is
invoked once with the list of inputs; results are scattered back.

The wrapped method must be ``async def method(self, items: List[T]) ->
List[R]`` and is called on the replica's asyncio loop, so batching works
with the actor's thread-pool concurrency (each blocked caller thread awaits
its future on the shared loop).
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any, List, Optional


class _BatchQueue:
    def __init__(self, fn, max_batch_size: int, timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._timeout = timeout_s
        self._queue: "asyncio.Queue" = asyncio.Queue()
        self._flusher: Optional[asyncio.Task] = None

    async def submit(self, owner: Any, item: Any):
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        await self._queue.put((owner, item, fut))
        if self._flusher is None or self._flusher.done():
            self._flusher = loop.create_task(self._flush_loop())
        return await fut

    async def _flush_loop(self):
        while not self._queue.empty():
            owner, item, fut = await self._queue.get()
            batch = [(owner, item, fut)]
            deadline = asyncio.get_running_loop().time() + self._timeout
            while len(batch) < self._max:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(
                        self._queue.get(), timeout=remaining))
                except asyncio.TimeoutError:
                    break
            items: List[Any] = [b[1] for b in batch]
            try:
                results = await self._fn(batch[0][0], items)
                if len(results) != len(items):
                    raise ValueError(
                        f"@serve.batch function returned {len(results)} "
                        f"results for a batch of {len(items)}")
                for (_, _, f), r in zip(batch, results):
                    if not f.done():
                        f.set_result(r)
            except Exception as e:  # noqa: BLE001 - scatter the failure
                for _, _, f in batch:
                    if not f.done():
                        f.set_exception(e)


def batch(_func=None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: ``async def m(self, items: list) -> list`` → per-item calls."""

    def decorator(fn):
        if not asyncio.iscoroutinefunction(fn):
            raise TypeError("@serve.batch requires an async def method")
        attr = f"__serve_batch_queue_{fn.__name__}"

        @functools.wraps(fn)
        async def wrapper(self, item):
            q = getattr(self, attr, None)
            if q is None:
                q = _BatchQueue(fn, max_batch_size, batch_wait_timeout_s)
                setattr(self, attr, q)
            return await q.submit(self, item)

        wrapper.__serve_is_batched__ = True
        return wrapper

    if _func is not None:
        return decorator(_func)
    return decorator
