"""``multiprocessing.Pool``-compatible shim over ray_tpu_torch tasks.

Reference: ``python/ray/util/multiprocessing/`` (SURVEY.md §2.3) — lets
``Pool(...)``-based code scale across the cluster unchanged: apply/map/
imap/starmap (+ _async variants with AsyncResult.get/wait/ready).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional, Sequence

import ray_tpu_torch


class AsyncResult:
    def __init__(self, refs: List[Any], single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        out = ray_tpu_torch.get(self._refs, timeout=timeout)
        return out[0] if self._single else out

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                           timeout=timeout)

    def ready(self) -> bool:
        done, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                               timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        try:
            self.get(timeout=0)
            return True
        except Exception:  # noqa: BLE001
            return False


class Pool:
    """Task-backed process pool.

    ``processes`` sizes the chunking of map-style calls; execution
    concurrency is governed by the cluster scheduler (tasks queue against
    available CPUs), not by a dedicated worker set — so per-worker state
    via ``initializer`` runs once per TASK, not once per process.
    """

    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = (), ray_remote_args: Optional[dict] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self._limit = processes or int(
            ray_tpu_torch.cluster_resources().get("CPU", 4))
        self._remote_args = ray_remote_args or {}
        self._initializer = initializer
        self._initargs = initargs
        self._closed = False

    def _task(self, fn: Callable) -> Any:
        init, initargs = self._initializer, self._initargs

        def call(args, kwargs):
            if init is not None:
                init(*initargs)
            return fn(*args, **(kwargs or {}))

        return ray_tpu_torch.remote(**self._remote_args)(call) \
            if self._remote_args else ray_tpu_torch.remote(call)

    def _check_open(self):
        if self._closed:
            raise ValueError("Pool not running")

    # -- apply ---------------------------------------------------------------
    def apply(self, fn: Callable, args: Sequence = (), kwds: dict = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args: Sequence = (),
                    kwds: dict = None) -> AsyncResult:
        self._check_open()
        return AsyncResult([self._task(fn).remote(tuple(args), kwds)], True)

    # -- map -----------------------------------------------------------------
    def _submit_chunked(self, fn: Callable, iterables, chunksize, star):
        items = list(zip(*iterables)) if len(iterables) > 1 \
            else [(x,) for x in iterables[0]]
        chunksize = chunksize or max(1, len(items) // (self._limit * 4) or 1)
        task = self._task(_run_chunk)
        chunks = [items[i:i + chunksize]
                  for i in range(0, len(items), chunksize)]
        refs = [task.remote((fn, chunk, star), None) for chunk in chunks]
        return refs, [len(c) for c in chunks]

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn: Callable, iterable: Iterable,
                  chunksize: Optional[int] = None) -> "AsyncResult":
        self._check_open()
        refs, _ = self._submit_chunked(fn, [list(iterable)], chunksize, False)
        return _ChunkedResult(refs)

    def starmap(self, fn: Callable, iterable: Iterable[Sequence],
                chunksize: Optional[int] = None) -> List[Any]:
        self._check_open()
        items = list(iterable)
        refs, _ = self._submit_chunked(
            fn, [list(x) for x in zip(*items)] if items else [[]],
            chunksize, True)
        return _ChunkedResult(refs).get()

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: Optional[int] = None):
        self._check_open()
        refs, sizes = self._submit_chunked(fn, [list(iterable)], chunksize,
                                           False)
        for ref in refs:
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: Optional[int] = None):
        self._check_open()
        refs, _ = self._submit_chunked(fn, [list(iterable)], chunksize, False)
        pending = list(refs)
        while pending:
            done, pending = ray_tpu_torch.wait(pending, num_returns=1)
            yield from ray_tpu_torch.get(done[0])

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        if not self._closed:
            raise ValueError("join() before close()")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()


class _ChunkedResult(AsyncResult):
    def __init__(self, refs):
        super().__init__(refs, single=False)

    def get(self, timeout: Optional[float] = None):
        chunks = ray_tpu_torch.get(self._refs, timeout=timeout)
        return list(itertools.chain.from_iterable(chunks))


def _run_chunk(fn, chunk, star):
    return [fn(*item) if star else fn(item[0]) for item in chunk]
