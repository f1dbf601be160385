"""Dataset: lazy, distributed, block-based data.

Reference: ``python/ray/data/dataset.py`` (SURVEY.md §2.5).  A Dataset is a
plan (stage list) over source blocks; execution streams block refs through
fused map waves with backpressure (see _internal/execution.py).  Blocks are
dicts of numpy columns in the shm object store — ``iter_device_batches``
stages them onto the card through pinned buffers and a copy stream of its
own, ``prefetch`` batches ahead (the north-star ingest path, SURVEY.md
§2.4).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data._internal.execution import (
    AllToAllStage, MapStage, Stage, stream_refs)
from ray_tpu_torch.data.block import (
    Block, BlockAccessor, block_from_rows, concat_blocks)
from ray_tpu_torch.data.context import DataContext


def _batched_map_fn(fn: Callable, batch_size: Optional[int],
                    batch_format: str) -> Callable[[Block], Block]:
    # block_format is captured at DATASET-BUILD time (driver context) —
    # the closure executes in workers, whose DataContext singleton is a
    # fresh default
    blk_fmt = DataContext.get_current().block_format

    def apply(block: Block) -> Block:
        acc = BlockAccessor(block)
        rows = acc.num_rows()
        bs = batch_size or max(rows, 1)
        outs = []
        for s in range(0, max(rows, 1), bs):
            if rows == 0:
                break
            batch = BlockAccessor(acc.slice(s, min(s + bs, rows))) \
                .to_batch(batch_format)
            out = fn(batch)
            outs.append(BlockAccessor.batch_to_block(out, blk_fmt))
        return concat_blocks(outs, blk_fmt)
    return apply


def _row_map_fn(fn: Callable) -> Callable[[Block], Block]:
    blk_fmt = DataContext.get_current().block_format

    def apply(block: Block) -> Block:
        rows = [fn(r) for r in BlockAccessor(block).iter_rows()]
        return block_from_rows(rows, blk_fmt)
    return apply


def _torch_dtype(dtype: np.dtype):
    """The torch dtype of a numpy column, or None for one torch cannot
    hold (object, strings, bytes, another byte order): it stays numpy."""
    if dtype.kind not in "biufc":
        return None
    import torch
    try:
        return torch.from_numpy(np.empty(0, dtype)).dtype
    except (TypeError, ValueError):
        return None


class _HostStager:
    """``iter_device_batches`` off the card: each column copied into a
    tensor of its own (writable, never a view of the store)."""

    def __init__(self, device):
        self.device = device

    def put(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        import torch
        return {k: v if _torch_dtype(v.dtype) is None
                else torch.from_numpy(np.array(v)).to(self.device)
                for k, v in batch.items()}

    def take(self, staged: Dict[str, Any]) -> Dict[str, Any]:
        return staged


class _CudaStager:
    """``iter_device_batches`` onto a CUDA card.

    ``put`` copies a batch into ring slot ``n % (prefetch + 1)`` (pinned
    host buffers, one a column, allocated once and again only when a
    column's shape or dtype changes), after waiting on the event of the
    slot's previous copy, then issues each column's host-to-device copy
    on the copy stream and records an event there.  ``take`` makes the
    consumer's current stream wait on that event and records every
    tensor on it, so the caching allocator does not hand the memory
    (allocated on the copy stream) to another batch before the
    consumer's work on it is done.  Nothing here synchronizes the card."""

    def __init__(self, device, prefetch: int):
        import torch
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.ring: List[Dict[str, Any]] = [{} for _ in range(prefetch + 1)]
        self.events: List[Any] = [None] * (prefetch + 1)
        self.n = 0

    def put(self, batch: Dict[str, Any]) -> tuple:
        import torch
        slot = self.n % len(self.ring)
        self.n += 1
        if self.events[slot] is not None:
            self.events[slot].synchronize()    # its last copy has left it
        bufs = self.ring[slot]
        out: Dict[str, Any] = {}
        with torch.cuda.stream(self.stream):
            for k, v in batch.items():
                dtype = _torch_dtype(v.dtype)
                if dtype is None:
                    out[k] = v
                    continue
                buf = bufs.get(k)
                if buf is None or tuple(buf.shape) != v.shape \
                        or buf.dtype != dtype:
                    buf = bufs[k] = torch.empty(v.shape, dtype=dtype,
                                                pin_memory=True)
                np.copyto(buf.numpy(), v, casting="no")
                out[k] = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[slot] = event
        return out, event

    def take(self, staged: tuple) -> Dict[str, Any]:
        import torch
        out, event = staged
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        for v in out.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(consumer)
        return out


def _local_slices(batches: Iterator[Dict[str, Any]], sharding
                  ) -> Iterator[Dict[str, Any]]:
    """Each batch's columns as this rank's piece under ``sharding`` (a
    view: the stager's copy reads only it); columns torch cannot hold
    stay whole, as ``jax.device_put`` leaves them to the reference."""
    try:
        for batch in batches:
            yield {k: v if _torch_dtype(v.dtype) is None
                   else sharding.local_slice(v) for k, v in batch.items()}
    finally:
        batches.close()


def _staged(batches: Iterator[Dict[str, Any]], stager, prefetch: int
            ) -> Iterator[Dict[str, Any]]:
    """``stager.put`` of each batch on a thread of its own, ``stager.take``
    of each as the consumer gets it.  The consumer holds staged batches
    back until more than ``prefetch`` are staged (or the batches end), so
    at most ``prefetch + 1`` are staged and not yet yielded: the thread
    takes one of ``prefetch + 1`` tokens before it pulls a batch, and the
    consumer returns one as it yields.  An error of the thread is raised
    in the consumer; closing the iterator stops the thread."""
    import collections
    import queue
    import threading

    tokens = threading.Semaphore(prefetch + 1)
    ready: queue.Queue = queue.Queue()
    stop = threading.Event()

    def produce() -> None:
        try:
            while True:
                while not tokens.acquire(timeout=0.1):
                    if stop.is_set():
                        return
                if stop.is_set():
                    return
                try:
                    batch = next(batches)
                except StopIteration:
                    ready.put(("end", None))
                    return
                ready.put(("batch", stager.put(batch)))
        except BaseException as e:  # noqa: BLE001 - raised in the consumer
            ready.put(("error", e))
        finally:
            batches.close()

    thread = threading.Thread(target=produce, daemon=True,
                              name="data-device-ingest")
    thread.start()
    held: collections.deque = collections.deque()
    ended = False
    try:
        while True:
            while not ended and len(held) <= prefetch:
                kind, item = ready.get()
                if kind == "error":
                    raise item
                if kind == "end":
                    ended = True
                else:
                    held.append(item)
            if not held:
                return
            out = stager.take(held.popleft())
            tokens.release()
            yield out
    finally:
        stop.set()
        thread.join(timeout=10.0)


class Dataset:
    def __init__(self, stages: List[Stage],
                 input_refs: Optional[List[Any]] = None):
        self._stages = stages
        self._input_refs = input_refs
        self._cached_refs: Optional[List[Any]] = None

    # ------------------------------------------------------------ plumbing
    def _with_stage(self, stage: Stage) -> "Dataset":
        if self._cached_refs is not None:
            return Dataset([stage], input_refs=list(self._cached_refs))
        return Dataset(self._stages + [stage], self._input_refs)

    def _iter_refs(self) -> Iterator[Any]:
        if self._cached_refs is not None:
            yield from self._cached_refs
            return
        yield from stream_refs(self._stages, self._input_refs)

    def materialize(self) -> "Dataset":
        """Execute and pin all blocks (reference: ``Dataset.materialize``)."""
        if self._cached_refs is None:
            self._cached_refs = list(self._iter_refs())
        return self

    # --------------------------------------------------------- transforms
    def map(self, fn: Callable[[Dict], Dict]) -> "Dataset":
        return self._with_stage(MapStage(_row_map_fn(fn), "Map"))

    def map_batches(self, fn: Callable, *, batch_size: Optional[int] = None,
                    batch_format: str = "numpy",
                    num_cpus: Optional[float] = None,
                    fuse: bool = True,
                    **_compat: Any) -> "Dataset":
        """``num_cpus``/``fuse=False`` make this stage its own pipeline
        operator (its tasks overlap upstream ingest instead of fusing
        into it — reference: streaming executor operator boundaries)."""
        st = MapStage(_batched_map_fn(fn, batch_size, batch_format),
                      "MapBatches")
        if num_cpus is not None or not fuse:
            st.fusable = False
            st.remote_args = {} if num_cpus is None \
                else {"num_cpus": num_cpus}
        return self._with_stage(st)

    def flat_map(self, fn: Callable[[Dict], List[Dict]]) -> "Dataset":
        blk_fmt = DataContext.get_current().block_format

        def apply(block: Block) -> Block:
            rows: List[Dict] = []
            for r in BlockAccessor(block).iter_rows():
                rows.extend(fn(r))
            return block_from_rows(rows, blk_fmt)
        return self._with_stage(MapStage(apply, "FlatMap"))

    def filter(self, fn: Callable[[Dict], bool]) -> "Dataset":
        def apply(block: Block) -> Block:
            acc = BlockAccessor(block)
            keep = np.fromiter((bool(fn(r)) for r in acc.iter_rows()),
                               dtype=bool, count=acc.num_rows())
            return acc.take_idx(np.nonzero(keep)[0])
        return self._with_stage(MapStage(apply, "Filter"))

    def add_column(self, name: str, fn: Callable[[Dict], Any]) -> "Dataset":
        def apply(block: Block) -> Block:
            acc = BlockAccessor(block)
            vals = [fn(batch) for batch in [acc.to_batch("numpy")]]
            return acc.with_column(name, vals[0])
        return self._with_stage(MapStage(apply, "AddColumn"))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def apply(block: Block) -> Block:
            return BlockAccessor(block).drop(cols)
        return self._with_stage(MapStage(apply, "DropColumns"))

    def select_columns(self, cols: List[str]) -> "Dataset":
        def apply(block: Block) -> Block:
            return BlockAccessor(block).select(cols)
        return self._with_stage(MapStage(apply, "SelectColumns"))

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        def apply(block: Block) -> Block:
            return BlockAccessor(block).rename(mapping)
        return self._with_stage(MapStage(apply, "RenameColumns"))

    # ----------------------------------------------------------- shuffles
    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with_stage(
            AllToAllStage("repartition", num_blocks=num_blocks))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._with_stage(AllToAllStage("random_shuffle", seed=seed))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        # sample boundaries (reference: sort sampling in shuffle planner)
        self.materialize()
        samples: List[np.ndarray] = []
        for ref in self._cached_refs:
            block = ray_tpu_torch.get(ref)
            col = BlockAccessor(block).get_column(key)
            if col is not None and len(col):
                samples.append(np.random.default_rng(0).choice(
                    col, size=min(100, len(col)), replace=False)
                    if len(col) > 100 else col)
        n_out = max(1, len(self._cached_refs))
        if samples:
            allv = np.sort(np.concatenate(samples))
            qs = np.linspace(0, 1, n_out + 1)[1:-1]
            boundaries = [allv[int(q * (len(allv) - 1))] for q in qs]
        else:
            boundaries = []
        ds = self._with_stage(AllToAllStage(
            "sort", key=key, descending=descending, boundaries=boundaries,
            num_blocks=n_out))
        if descending:
            # partitions come back ascending-ordered; reverse block order
            ds.materialize()
            ds._cached_refs = list(reversed(ds._cached_refs))
        return ds

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    # -------------------------------------------------------- combination
    def union(self, *others: "Dataset") -> "Dataset":
        refs = list(self.materialize()._cached_refs)
        for o in others:
            refs.extend(o.materialize()._cached_refs)
        return Dataset([], input_refs=refs)

    def zip(self, other: "Dataset") -> "Dataset":
        left = self.materialize()._cached_refs
        right = other.materialize()._cached_refs

        @ray_tpu_torch.remote
        def _rows(b: Block) -> int:
            return BlockAccessor(b).num_rows()

        left_counts = ray_tpu_torch.get([_rows.remote(r) for r in left])
        right_counts = ray_tpu_torch.get([_rows.remote(r) for r in right])
        if sum(left_counts) != sum(right_counts):
            raise ValueError("zip requires datasets with equal row counts")

        @ray_tpu_torch.remote
        def merge(a: Block, spans, *right_blocks) -> Block:
            # spans: [(right_block_idx, lo, hi)] covering a's row range —
            # only the needed right blocks ship to this task, never the
            # whole right dataset to the driver
            pieces = [BlockAccessor(right_blocks[i]).slice(lo, hi)
                      for i, (_, lo, hi) in enumerate(spans)]
            return BlockAccessor(a).merge(concat_blocks(pieces))

        # map each left block's global row range onto right-block spans
        r_starts = np.concatenate([[0], np.cumsum(right_counts)])
        refs, pos = [], 0
        for lref, cnt in zip(left, left_counts):
            lo_g, hi_g = pos, pos + cnt
            pos = hi_g
            spans, blocks = [], []
            for j, (s, e) in enumerate(zip(r_starts[:-1], r_starts[1:])):
                if e <= lo_g or s >= hi_g:
                    continue
                spans.append((j, int(max(lo_g, s) - s), int(min(hi_g, e) - s)))
                blocks.append(right[j])
            refs.append(merge.remote(lref, spans, *blocks))
        return Dataset([], input_refs=refs)

    def limit(self, n: int) -> "Dataset":
        refs_out: List[Any] = []
        taken = 0
        for ref in self._iter_refs():
            block = ray_tpu_torch.get(ref)
            acc = BlockAccessor(block)
            rows = acc.num_rows()
            if taken + rows <= n:
                refs_out.append(ref)
                taken += rows
            else:
                refs_out.append(ray_tpu_torch.put(acc.slice(0, n - taken)))
                taken = n
            if taken >= n:
                break
        return Dataset([], input_refs=refs_out)

    # ------------------------------------------------------------- splits
    def split(self, n: int, *, equal: bool = False,
              locality_hints: Optional[List[Any]] = None) -> List["Dataset"]:
        """Reference: ``Dataset.split(n, locality_hints=workers)`` — the
        per-worker sharding primitive Train uses (SURVEY.md §3.4)."""
        self.materialize()
        refs = list(self._cached_refs)
        if not equal:
            shards = [refs[i::n] for i in range(n)]
            return [Dataset([], input_refs=s) for s in shards]
        blocks = [ray_tpu_torch.get(r) for r in refs]
        whole = concat_blocks(blocks)
        acc = BlockAccessor(whole)
        rows = acc.num_rows()
        bounds = np.linspace(0, rows, n + 1).astype(int)
        return [Dataset([], input_refs=[
            ray_tpu_torch.put(acc.slice(bounds[i], bounds[i + 1]))])
            for i in range(n)]

    def split_at_indices(self, indices: List[int]) -> List["Dataset"]:
        whole = BlockAccessor(concat_blocks(
            [ray_tpu_torch.get(r) for r in self.materialize()._cached_refs]))
        cuts = [0] + list(indices) + [whole.num_rows()]
        return [Dataset([], input_refs=[ray_tpu_torch.put(
            whole.slice(cuts[i], cuts[i + 1]))])
            for i in range(len(cuts) - 1)]

    def train_test_split(self, test_size: float, *, shuffle: bool = False,
                         seed: Optional[int] = None
                         ) -> Tuple["Dataset", "Dataset"]:
        ds = self.random_shuffle(seed=seed) if shuffle else self
        total = ds.count()
        cut = int(total * (1 - test_size))
        parts = ds.split_at_indices([cut])
        return parts[0], parts[1]

    # -------------------------------------------------------- consumption
    def count(self) -> int:
        @ray_tpu_torch.remote
        def _count(b: Block) -> int:
            return BlockAccessor(b).num_rows()
        return sum(ray_tpu_torch.get([_count.remote(r) for r in self._iter_refs()]))

    # global aggregates (reference: Dataset.sum/min/max/mean/std/unique).
    # Each block reduces to a tiny partial INSIDE its task; only O(blocks)
    # scalars (or unique sets) cross the object store, never whole columns.
    def _partials(self, on: str) -> List[Optional[tuple]]:
        """Per-block (n, mean, M2, min, max) — mean/M2 are the Welford
        moments (None for non-numeric columns), mergeable without the
        catastrophic cancellation of raw sum-of-squares."""
        @ray_tpu_torch.remote
        def _part(b: Block):
            raw = np.asarray(b[on])
            if raw.size == 0:
                return None
            if raw.dtype.kind in "fiub":
                v = raw.astype(np.float64)
                mean = float(v.mean())
                m2 = float(((v - mean) ** 2).sum())
                # integers/bools: native accumulation is exact; floats:
                # float64 (a native float16/32 sum overflows/loses bits)
                s = raw.sum() if raw.dtype.kind in "iub" else float(v.sum())
            else:
                mean = m2 = s = None  # min/max stay lexicographic
            return (int(raw.size), mean, m2, raw.min(), raw.max(), s)
        return [p for p in ray_tpu_torch.get(
            [_part.remote(r) for r in self._iter_refs()]) if p is not None]

    @staticmethod
    def _merged_moments(parts):
        """Chan et al. parallel merge of per-block (n, mean, M2)."""
        n, mean, m2 = 0, 0.0, 0.0
        for pn, pmean, pm2 in parts:
            if pmean is None:
                raise TypeError("numeric aggregate on non-numeric column")
            delta = pmean - mean
            tot = n + pn
            mean += delta * pn / tot
            m2 += pm2 + delta * delta * n * pn / tot
            n = tot
        return n, mean, m2

    def sum(self, on: str):
        parts = self._partials(on)
        if not parts:
            return None
        if parts[0][5] is None:
            raise TypeError("numeric aggregate on non-numeric column")
        return sum(p[5] for p in parts)

    def min(self, on: str):
        parts = self._partials(on)
        return min(p[3] for p in parts) if parts else None

    def max(self, on: str):
        parts = self._partials(on)
        return max(p[4] for p in parts) if parts else None

    def mean(self, on: str):
        parts = self._partials(on)
        if not parts:
            return None
        _, mean, _ = self._merged_moments([p[:3] for p in parts])
        return float(mean)

    def std(self, on: str, ddof: int = 1):
        parts = self._partials(on)
        if not parts:
            return None
        n, _, m2 = self._merged_moments([p[:3] for p in parts])
        if n <= ddof:
            return None
        return float(np.sqrt(m2 / (n - ddof)))

    def unique(self, on: str) -> List[Any]:
        @ray_tpu_torch.remote
        def _uniq(b: Block) -> np.ndarray:
            return np.unique(np.asarray(b[on]))
        parts = [p for p in ray_tpu_torch.get(
            [_uniq.remote(r) for r in self._iter_refs()]) if p.size]
        if not parts:
            return []
        return np.unique(np.concatenate(parts)).tolist()

    def random_sample(self, fraction: float, *,
                      seed: Optional[int] = None) -> "Dataset":
        """Row-wise Bernoulli sample (reference: Dataset.random_sample).

        Per-block randomness derives from (seed, block content signature)
        so equal-sized blocks draw independent masks; blocks with
        byte-identical content share a mask (deterministic by design)."""
        base = seed if seed is not None else np.random.SeedSequence().entropy

        def apply(block: Block) -> Block:
            acc = BlockAccessor(block)
            n = acc.num_rows()
            if n == 0:
                return block
            import zlib
            edge = concat_blocks([acc.slice(0, 1), acc.slice(n - 1, n)])
            sig = zlib.crc32(n.to_bytes(8, "little") + b"".join(
                np.ascontiguousarray(np.asarray(v)).tobytes()
                if getattr(np.asarray(v), "dtype", None) != object
                else repr(list(v)).encode()
                for v in BlockAccessor(edge).to_batch("numpy").values()))
            rng = np.random.default_rng([int(base) % (2 ** 63), sig])
            mask = rng.random(n) < fraction
            return acc.take_idx(np.nonzero(mask)[0])
        return self._with_stage(MapStage(apply, "RandomSample"))

    def schema(self) -> Optional[Dict[str, Any]]:
        for ref in self._iter_refs():
            block = ray_tpu_torch.get(ref)
            if BlockAccessor(block).num_rows():
                return BlockAccessor(block).schema()
        return None

    def columns(self) -> Optional[List[str]]:
        s = self.schema()
        return list(s) if s else None

    def num_blocks(self) -> int:
        return len(self.materialize()._cached_refs)

    def size_bytes(self) -> int:
        @ray_tpu_torch.remote
        def _sz(b: Block) -> int:
            return BlockAccessor(b).size_bytes()
        return sum(ray_tpu_torch.get([_sz.remote(r) for r in self._iter_refs()]))

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for ref in self._iter_refs():
            for row in BlockAccessor(ray_tpu_torch.get(ref)).iter_rows():
                out.append(row)
                if len(out) >= n:
                    return out
        return out

    def take_all(self) -> List[Dict[str, Any]]:
        return [r for ref in self._iter_refs()
                for r in BlockAccessor(ray_tpu_torch.get(ref)).iter_rows()]

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for ref in self._iter_refs():
            yield from BlockAccessor(ray_tpu_torch.get(ref)).iter_rows()

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False) -> Iterator[Any]:
        """Streams: pulls blocks lazily (backpressure reaches the executor)."""
        carry: Optional[Block] = None
        for ref in self._iter_refs():
            block = ray_tpu_torch.get(ref)
            if carry:
                block = concat_blocks([carry, block])
                carry = None
            acc = BlockAccessor(block)
            rows = acc.num_rows()
            s = 0
            while rows - s >= batch_size:
                yield BlockAccessor(acc.slice(s, s + batch_size)) \
                    .to_batch(batch_format)
                s += batch_size
            if s < rows:
                carry = acc.slice(s, rows)
        if carry and not drop_last:
            yield BlockAccessor(carry).to_batch(batch_format)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           **kw) -> Iterator[Dict[str, Any]]:
        """Batches as CPU tensors.  A column that is a view of a block
        is copied, as ``_HostStager.put`` does: a block above the inline
        size maps its store segment read-only, so an in-place op on the
        tensor would fault, and an inline block is this process's cached
        copy, which the op would change for every later read.  A column
        the batch owns (rows concatenated across blocks) stays
        zero-copy."""
        import torch
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy"):
            yield {k: torch.as_tensor(
                v if getattr(v, "flags", None) is None
                or (v.flags.writeable and v.flags.owndata)
                else np.array(v)) for k, v in batch.items()}

    def iter_device_batches(self, *, batch_size: int = 256,
                            device: Optional[Any] = None,
                            prefetch: int = 2,
                            sharding: Optional[Any] = None) -> Iterator[Any]:
        """Batches as tensors on ``device``, ``prefetch`` batches ahead of
        the consumer (the north-star ingest path, SURVEY.md §2.4).

        ``device=None`` is the card (``resolve_device``: with no card it
        raises, it never drops to the CPU); ``device="cpu"`` gives plain,
        writable CPU tensors.  On the card each column is copied once on
        the host, from the block (read-only views of the shm store) into
        one of a ring of ``prefetch + 1`` pinned buffers, then to the card
        with ``non_blocking`` on a copy stream of this iterator's own
        (``_CudaStager``).  Batches are staged on a thread of the
        iterator's own (``_staged``), so the host's copy of batch k+1
        runs while the consumer launches step k, and the card's copy
        overlaps step k's kernels.  As in the reference, a batch is
        yielded once more than ``prefetch`` are staged, and the rest
        drain at the end.  Columns torch cannot hold (object, strings,
        bytes) stay numpy.

        ``sharding``: a ``parallel.mesh.NamedSharding(mesh, spec)`` (the
        reference's ``jax.device_put(v, sharding)``): every rank iterates
        the same global stream, and only this rank's piece of each column
        (``sharding.local_slice``, e.g. its rows under
        ``mesh.batch_spec``) is copied into the ring and onto its device
        (default: the mesh's); object columns stay whole numpy."""
        from ray_tpu_torch._device import resolve_device
        batches = self.iter_batches(batch_size=batch_size,
                                    batch_format="numpy")
        if sharding is not None:
            from ray_tpu_torch.parallel.mesh import NamedSharding
            if not isinstance(sharding, NamedSharding):
                raise TypeError(f"sharding must be a parallel.mesh."
                                f"NamedSharding, not {type(sharding)!r}")
            if device is None:
                device = sharding.mesh.device
            batches = _local_slices(batches, sharding)
        dev = resolve_device(device)
        stager = _CudaStager(dev, prefetch) if dev.type == "cuda" \
            else _HostStager(dev)
        return _staged(batches, stager, prefetch)

    def to_pandas(self):
        return BlockAccessor(concat_blocks(
            [ray_tpu_torch.get(r) for r in self._iter_refs()])).to_batch("pandas")

    # ---------------------------------------------------------------- IO
    def write_parquet(self, path: str) -> None:
        self._write(path, "parquet")

    def write_csv(self, path: str) -> None:
        self._write(path, "csv")

    def write_json(self, path: str) -> None:
        self._write(path, "json")

    def _write(self, path: str, fmt: str) -> None:
        import os
        os.makedirs(path, exist_ok=True)

        @ray_tpu_torch.remote
        def _w(i: int, block: Block) -> None:
            import os

            acc = BlockAccessor(block)
            fname = os.path.join(path, f"part-{i:05d}.{fmt}")
            if fmt == "parquet":
                import pyarrow.parquet as pq
                pq.write_table(acc.to_batch("pyarrow"), fname)
            elif fmt == "csv":
                acc.to_batch("pandas").to_csv(fname, index=False)
            else:
                acc.to_batch("pandas").to_json(fname, orient="records",
                                               lines=True)
        ray_tpu_torch.get([_w.remote(i, r)
                     for i, r in enumerate(self._iter_refs())])

    def __repr__(self) -> str:
        return f"Dataset(stages={len(self._stages)})"

    # reference-compat alias
    def fully_executed(self) -> "Dataset":
        return self.materialize()


class GroupedData:
    """Reference: ``python/ray/data/grouped_data.py``."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _agg(self, specs) -> Dataset:
        return self._ds._with_stage(
            AllToAllStage("groupby", key=self._key, aggs=specs))

    def count(self) -> Dataset:
        return self._agg([("count", None, "count()")])

    def sum(self, on: str) -> Dataset:
        return self._agg([("sum", on, f"sum({on})")])

    def min(self, on: str) -> Dataset:
        return self._agg([("min", on, f"min({on})")])

    def max(self, on: str) -> Dataset:
        return self._agg([("max", on, f"max({on})")])

    def mean(self, on: str) -> Dataset:
        return self._agg([("mean", on, f"mean({on})")])

    def std(self, on: str) -> Dataset:
        return self._agg([("std", on, f"std({on})")])

    def aggregate(self, *specs) -> Dataset:
        """specs: (agg_name, on_col, out_name) triples."""
        return self._agg(list(specs))

    def map_groups(self, fn: Callable[[Dict[str, np.ndarray]], Any]) -> Dataset:
        key = self._key

        blk_fmt = DataContext.get_current().block_format

        def apply(block: Block) -> Block:
            acc = BlockAccessor(block)
            if not acc.num_rows():
                return block
            keys = acc.get_column(key)
            outs = []
            for val in dict.fromkeys(keys.tolist()):  # ordered unique
                idx = np.nonzero(keys == val)[0]
                out = fn(BlockAccessor(acc.take_idx(idx)).to_batch("numpy"))
                outs.append(BlockAccessor.batch_to_block(out, blk_fmt))
            return concat_blocks(outs)

        # hash-partition so each group lands wholly in one block, then map
        return (self._ds
                ._with_stage(AllToAllStage("groupby_raw", key=key))
                ._with_stage(MapStage(apply, "MapGroups")))
