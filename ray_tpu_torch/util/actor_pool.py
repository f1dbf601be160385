"""ActorPool — map work over a fixed set of actors.

Reference: ``python/ray/util/actor_pool.py`` (SURVEY.md §2.3 "ray.util
misc") — same API surface: submit / get_next / get_next_unordered / map /
map_unordered / has_next / push / pop_idle.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional, Tuple

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        if not self._idle:
            raise ValueError("ActorPool needs at least one actor")
        self._future_to_actor: dict = {}
        self._index_to_future: dict = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._consumed_unordered: set = set()
        self._pending_submits: List[Tuple[Callable, Any]] = []

    # -- submission ----------------------------------------------------------
    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """fn(actor, value) -> ObjectRef; queued if no actor is idle."""
        if self._idle:
            self._dispatch(fn, value, reraise=True)
        else:
            self._pending_submits.append((fn, value))

    def _dispatch(self, fn: Callable, value: Any, *, reraise: bool) -> None:
        actor = self._idle.pop()
        try:
            ref = fn(actor, value)
        except BaseException:
            # a raising submit fn must not leak the actor out of the pool —
            # and when invoked from a drain inside get_next's finally,
            # must not mask the result being returned
            self._idle.append(actor)
            if reraise:
                raise
            import logging
            logging.getLogger(__name__).exception(
                "ActorPool submit fn raised; dropping queued item")
            return
        self._future_to_actor[ref] = actor
        self._index_to_future[self._next_task_index] = ref
        self._next_task_index += 1

    def _maybe_drain(self) -> None:
        while self._pending_submits and self._idle:
            fn, value = self._pending_submits.pop(0)
            self._dispatch(fn, value, reraise=False)

    # -- retrieval -----------------------------------------------------------
    def has_next(self) -> bool:
        return bool(self._index_to_future) or bool(self._pending_submits)

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in submission order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        # skip indices already taken by get_next_unordered
        while self._next_return_index in self._consumed_unordered:
            self._consumed_unordered.discard(self._next_return_index)
            self._next_return_index += 1
        idx = self._next_return_index
        if idx not in self._index_to_future:
            self._maybe_drain()
            if idx not in self._index_to_future:
                raise StopIteration("no pending results")
        # wait non-destructively first: a timeout must leave pool state
        # intact, and a task exception must still return the actor
        ref = self._index_to_future[idx]
        ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next timed out")
        del self._index_to_future[idx]
        self._next_return_index += 1
        try:
            return ray_tpu_torch.get(ref)
        finally:
            self._return_actor(ref)

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Next result to finish, any order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        self._maybe_drain()
        ready, _ = ray_tpu_torch.wait(list(self._future_to_actor),
                                      num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        ref = ready[0]
        for idx, f in list(self._index_to_future.items()):
            if f == ref:
                del self._index_to_future[idx]
                self._consumed_unordered.add(idx)
                break
        try:
            return ray_tpu_torch.get(ref)
        finally:
            self._return_actor(ref)

    def _return_actor(self, ref) -> None:
        actor = self._future_to_actor.pop(ref, None)
        if actor is not None:
            self._idle.append(actor)
            self._maybe_drain()

    # -- bulk ----------------------------------------------------------------
    def map(self, fn: Callable[[Any, Any], Any], values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # -- membership ----------------------------------------------------------
    def push(self, actor: Any) -> None:
        self._idle.append(actor)
        self._maybe_drain()

    def pop_idle(self) -> Optional[Any]:
        return self._idle.pop() if self._idle else None

    def has_free(self) -> bool:
        return bool(self._idle)
