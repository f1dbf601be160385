"""ParallelIterator: sharded lazy iteration over actors.

Reference: ``python/ray/util/iter.py`` (older-vintage forks; SURVEY.md
§2.3 ray.util misc) — ``from_items``/``from_range`` shard a sequence
across shard ACTORS; transformations (``for_each``/``filter``/
``batch``/``flat_map``) compose lazily per shard; ``gather_sync``
round-robins shards in order while ``gather_async`` yields whichever
shard produces next.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterator, List, Sequence

import ray_tpu_torch

__all__ = ["from_items", "from_range", "from_iterators",
           "ParallelIterator"]


@ray_tpu_torch.remote
class _ShardActor:
    """Holds one shard's source items and applies the op chain lazily."""

    def __init__(self, items: List[Any]):
        self._items = items
        self._cursors: dict = {}  # cursor_id -> (live iterator, position)

    def _build(self, ops: List[tuple]) -> Iterator[Any]:
        import cloudpickle
        it: Iterator[Any] = iter(self._items)
        for kind, blob in ops:
            # "batch" carries its size as a plain int, not a pickled fn
            fn = blob if kind == "batch" else cloudpickle.loads(blob)
            if kind == "for_each":
                it = map(fn, it)
            elif kind == "filter":
                it = filter(fn, it)
            elif kind == "flat_map":
                it = itertools.chain.from_iterable(map(fn, it))
            elif kind == "batch":
                def batched(src=it, n=fn):
                    buf: List[Any] = []
                    for x in src:
                        buf.append(x)
                        if len(buf) == n:
                            yield buf
                            buf = []
                    if buf:
                        yield buf
                it = batched()
        return it

    def take(self, ops: List[tuple], cursor: str, start: int,
             count: int) -> List[Any]:
        """Return result slice [start, start+count).  A live iterator is
        kept per ``cursor`` so consuming a shard is O(N), not O(N^2);
        ``start`` is the restart fallback — if the actor died and lost
        the cursor (or the id is new), the chain is rebuilt and skipped
        forward, preserving at-least-once restartability."""
        state = self._cursors.get(cursor)
        if state is None or state[1] != start:
            it = self._build(ops)
            if start:
                next(itertools.islice(it, start, start), None)  # skip
            state = [it, start]
        out = list(itertools.islice(state[0], count))
        state[1] = start + len(out)
        self._cursors[cursor] = state
        if len(self._cursors) > 64:  # abandoned consumers
            self._cursors.pop(next(iter(self._cursors)))
        return out


class ParallelIterator:
    def __init__(self, shards: List[Any], ops: List[tuple]):
        self._shards = shards
        self._ops = ops

    # ------------------------------------------------------- transformations
    def _with(self, kind: str, fn: Any) -> "ParallelIterator":
        import cloudpickle
        blob = cloudpickle.dumps(fn) if kind != "batch" else fn
        return ParallelIterator(self._shards, self._ops + [(kind, blob)])

    def for_each(self, fn: Callable[[Any], Any]) -> "ParallelIterator":
        return self._with("for_each", fn)

    def filter(self, fn: Callable[[Any], bool]) -> "ParallelIterator":
        return self._with("filter", fn)

    def flat_map(self, fn: Callable[[Any], Sequence]) -> "ParallelIterator":
        return self._with("flat_map", fn)

    def batch(self, n: int) -> "ParallelIterator":
        return ParallelIterator(self._shards, self._ops + [("batch", n)])

    def num_shards(self) -> int:
        return len(self._shards)

    # -------------------------------------------------------------- gathers
    _CHUNK = 64

    def _shard_iter(self, idx: int) -> Iterator[Any]:
        import uuid
        cursor = uuid.uuid4().hex
        start = 0
        while True:
            part = ray_tpu_torch.get(self._shards[idx].take.remote(
                self._ops, cursor, start, self._CHUNK))
            yield from part
            if len(part) < self._CHUNK:
                return
            start += self._CHUNK

    def gather_sync(self) -> Iterator[Any]:
        """Round-robin across shards, deterministic order."""
        iters = [self._shard_iter(i) for i in range(len(self._shards))]
        alive = list(iters)
        while alive:
            for it in list(alive):
                try:
                    yield next(it)
                except StopIteration:
                    alive.remove(it)

    def gather_async(self) -> Iterator[Any]:
        """Yield from whichever shard has a chunk ready first."""
        import uuid
        cursors = [uuid.uuid4().hex for _ in self._shards]
        pending = {self._shards[i].take.remote(
                       self._ops, cursors[i], 0, self._CHUNK): (i, 0)
                   for i in range(len(self._shards))}
        while pending:
            done, _ = ray_tpu_torch.wait(list(pending), num_returns=1)
            ref = done[0]
            i, start = pending.pop(ref)
            part = ray_tpu_torch.get(ref)
            yield from part
            if len(part) == self._CHUNK:
                nxt = self._shards[i].take.remote(
                    self._ops, cursors[i], start + self._CHUNK,
                    self._CHUNK)
                pending[nxt] = (i, start + self._CHUNK)

    def take(self, n: int) -> List[Any]:
        return list(itertools.islice(self.gather_sync(), n))

    def __iter__(self) -> Iterator[Any]:
        return self.gather_sync()

    def __repr__(self) -> str:
        return f"ParallelIterator(shards={len(self._shards)}, " \
               f"ops={len(self._ops)})"


def from_items(items: Sequence[Any], num_shards: int = 2) -> ParallelIterator:
    items = list(items)
    shards = []
    for i in range(num_shards):
        shards.append(_ShardActor.remote(items[i::num_shards]))
    return ParallelIterator(shards, [])


def from_range(n: int, num_shards: int = 2) -> ParallelIterator:
    return from_items(list(range(n)), num_shards)


def from_iterators(creators: Sequence[Callable[[], Sequence]]
                   ) -> ParallelIterator:
    return ParallelIterator(
        [_ShardActor.remote(list(c())) for c in creators], [])
