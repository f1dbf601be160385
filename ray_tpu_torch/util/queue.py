"""Distributed FIFO queue backed by an async actor.

Reference: ``python/ray/util/queue.py`` (SURVEY.md §2.3) — same API:
put/get (blocking w/ timeout), put_nowait/get_nowait, qsize/empty/full,
put_async/get_async, shutdown.

Every actor method is a coroutine, so all queue state lives on the actor's
event-loop thread (no cross-thread asyncio hazards) and a parked ``get``
holds no executor thread — the actor server replies from the loop when the
coroutine completes, so hundreds of blocked consumers cost nothing.
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote(max_concurrency=16)
class _QueueActor:
    def __init__(self, maxsize: int):
        self._q: asyncio.Queue = asyncio.Queue(maxsize)

    async def put(self, item: Any, timeout: Optional[float] = None) -> bool:
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: Optional[float] = None):
        try:
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    async def put_nowait(self, item: Any) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def get_nowait(self):
        try:
            return True, self._q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    # item-returning forms for put_async/get_async (block until done)
    async def put_item(self, item: Any) -> bool:
        await self._q.put(item)
        return True

    async def get_item(self) -> Any:
        return await self._q.get()

    async def qsize(self) -> int:
        return self._q.qsize()


class Queue:
    def __init__(self, maxsize: int = 0, *,
                 actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        self.maxsize = maxsize
        self.actor = _QueueActor.options(**opts).remote(maxsize) if opts \
            else _QueueActor.remote(maxsize)

    # -- blocking ------------------------------------------------------------
    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            return self.put_nowait(item)
        ok = ray_tpu_torch.get(self.actor.put.remote(item, timeout))
        if not ok:
            raise Full("queue full")

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if not block:
            return self.get_nowait()
        ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty("queue empty")
        return item

    # -- non-blocking --------------------------------------------------------
    def put_nowait(self, item: Any) -> None:
        if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
            raise Full("queue full")

    def get_nowait(self) -> Any:
        ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
        if not ok:
            raise Empty("queue empty")
        return item

    # -- async refs (for use inside other actors/tasks) ----------------------
    def put_async(self, item: Any):
        """ObjectRef resolving to True once the item is enqueued."""
        return self.actor.put_item.remote(item)

    def get_async(self):
        """ObjectRef resolving to the dequeued ITEM (blocks until one)."""
        return self.actor.get_item.remote()

    # -- introspection -------------------------------------------------------
    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self.actor)
