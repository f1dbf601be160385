"""Streaming execution of dataset plans.

Reference: ``python/ray/data/_internal/execution/streaming_executor.py``
(SURVEY.md §2.5): operators pull blocks through map/shuffle stages with
backpressure.  Structure here:

- A plan is a stage list; chains of map-like stages are FUSED into one
  task per block (operator fusion — the reference does this in its
  optimizer), so a read→map→filter pipeline is one wave of tasks.
- ``stream_refs`` submits at most ``DataContext.max_tasks_in_flight``
  tasks and yields output refs as they complete: downstream consumers
  (``iter_batches``) pull lazily → bounded memory (backpressure).
- All-to-all stages (repartition / random_shuffle / sort / groupby) are
  barriers implemented as 2-phase map-reduce shuffles through the object
  store (the Exoshuffle pattern, SURVEY.md §6).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (Block, BlockAccessor, concat_blocks)
from ray_tpu_torch.data.context import DataContext


def _stable_hash(x: Any) -> int:
    """Cross-process-stable hash (Python's hash() is salted per process —
    shuffle partition tasks run in different workers)."""
    import zlib
    return zlib.crc32(repr(x).encode())


# ----------------------------------------------------------------- stages
class Stage:
    pass


class ReadStage(Stage):
    """Source: factories, each () -> Block."""

    def __init__(self, factories: Sequence[Callable[[], Block]], name="Read"):
        self.factories = list(factories)
        self.name = name


class MapStage(Stage):
    """fn: Block -> Block (fusable).  ``fusable=False`` (or custom
    ``remote_args``) makes this stage its own streaming-pipeline operator
    instead of fusing into its neighbors."""

    fusable = True
    remote_args: Optional[dict] = None

    def __init__(self, fn: Callable[[Block], Block], name="Map"):
        self.fn = fn
        self.name = name


class AllToAllStage(Stage):
    def __init__(self, kind: str, name: str = "", **kwargs):
        self.kind = kind
        self.kwargs = kwargs
        self.name = name or kind


# ------------------------------------------------------------ remote tasks
@ray_tpu_torch.remote
def _source_task(factory_blob: bytes, fns_blob: bytes) -> Block:
    import cloudpickle
    factory = cloudpickle.loads(factory_blob)
    block = factory()
    for fn in cloudpickle.loads(fns_blob):
        block = fn(block)
    return block


@ray_tpu_torch.remote
def _map_task(fns_blob: bytes, block: Block) -> Block:
    import cloudpickle
    for fn in cloudpickle.loads(fns_blob):
        block = fn(block)
    return block


@ray_tpu_torch.remote
def _partition_task(fns_blob: bytes, part_fn_blob: bytes, n: int,
                    block: Block) -> List[Block]:
    """Shuffle phase 1: apply pending fns then split into n partitions."""
    import cloudpickle
    for fn in cloudpickle.loads(fns_blob):
        block = fn(block)
    part_fn = cloudpickle.loads(part_fn_blob)
    return part_fn(block, n)


@ray_tpu_torch.remote
def _reduce_task(reduce_fn_blob: bytes, idx: int, *parts_lists) -> Block:
    """Shuffle phase 2: gather partition ``idx`` from every phase-1 output."""
    import cloudpickle
    reduce_fn = cloudpickle.loads(reduce_fn_blob)
    pieces = [pl[idx] for pl in parts_lists]
    return reduce_fn(pieces)


# ------------------------------------------------------------- scheduling
def _submit_capped(task_args: List[tuple], submit: Callable[..., Any],
                   cap: Optional[int] = None) -> Iterator[Any]:
    """Yield results refs in input order with ≤cap tasks in flight."""
    cap = cap or DataContext.get_current().max_tasks_in_flight
    refs: List[Any] = []
    idx = 0
    emitted = 0
    while emitted < len(task_args):
        while idx < len(task_args) and idx - emitted < cap:
            refs.append(submit(*task_args[idx]))
            idx += 1
        # wait for the head-of-line ref so ordering is preserved
        ray_tpu_torch.wait([refs[emitted]], num_returns=1)
        yield refs[emitted]
        emitted += 1


def _fuse(stages: List[Stage]) -> List[Stage]:
    """Merge consecutive MapStages (and into a leading ReadStage)."""
    out: List[Stage] = []
    for st in stages:
        if isinstance(st, MapStage) and out and isinstance(out[-1], MapStage) \
                and st.fusable and out[-1].fusable:
            prev = out.pop()
            fns = getattr(prev, "_fns", [prev.fn]) + \
                getattr(st, "_fns", [st.fn])
            merged = MapStage(None, name=f"{prev.name}->{st.name}")
            merged._fns = fns
            out.append(merged)
        else:
            out.append(st)
    return out


def _stage_fns(st: MapStage) -> List[Callable]:
    return getattr(st, "_fns", [st.fn] if st.fn else [])


def stream_refs(stages: List[Stage],
                input_refs: Optional[List[Any]] = None) -> Iterator[Any]:
    """Execute the plan, yielding output block refs lazily.

    Runs the operator-pipelined streaming topology (streaming.py): every
    operator is concurrently in flight with bounded per-operator budgets;
    map chains stay fused into single tasks (the wave optimizer's win is
    preserved), non-fusable stages overlap their upstream."""
    from ray_tpu_torch.data._internal.streaming import build_topology
    topo = build_topology(stages, input_refs)
    try:
        yield from topo
    finally:
        topo.stop()


def _run_wave(source: Optional[ReadStage], refs: Optional[List[Any]],
              fns_blob: bytes, ctx: DataContext) -> Iterator[Any]:
    import cloudpickle
    if source is not None:
        args = [(cloudpickle.dumps(f), fns_blob) for f in source.factories]
        yield from _submit_capped(
            args, lambda fb, mb: _source_task.remote(fb, mb),
            ctx.max_tasks_in_flight)
    else:
        args = [(fns_blob, r) for r in (refs or [])]
        yield from _submit_capped(
            args, lambda mb, r: _map_task.remote(mb, r),
            ctx.max_tasks_in_flight)


# --------------------------------------------------------------- shuffles
def _run_shuffle(st: AllToAllStage, input_refs: List[Any]) -> List[Any]:
    import cloudpickle
    from ray_tpu_torch.data.context import DataContext
    kind = st.kind
    kw = st.kwargs
    n_out = kw.get("num_blocks") or max(1, len(input_refs))
    blk_fmt = DataContext.get_current().block_format

    if kind == "repartition":
        def part_fn(block: Block, n: int) -> List[Block]:
            acc = BlockAccessor(block)
            rows = acc.num_rows()
            bounds = np.linspace(0, rows, n + 1).astype(int)
            return [acc.slice(bounds[k], bounds[k + 1]) for k in range(n)]

        def reduce_fn(pieces: List[Block], _f=blk_fmt) -> Block:
            return concat_blocks(pieces, _f)

    elif kind == "random_shuffle":
        seed = kw.get("seed")

        def part_fn(block: Block, n: int, _seed=seed) -> List[Block]:
            acc = BlockAccessor(block)
            rows = acc.num_rows()
            rng = np.random.default_rng(_seed)
            assign = rng.integers(0, n, rows)
            return [acc.take_idx(np.nonzero(assign == k)[0])
                    for k in range(n)]

        def reduce_fn(pieces: List[Block], _seed=seed, _f=blk_fmt) -> Block:
            out = concat_blocks(pieces, _f)
            acc = BlockAccessor(out)
            rng = np.random.default_rng(_seed)
            perm = rng.permutation(acc.num_rows())
            return acc.take_idx(perm)

    elif kind == "sort":
        key = kw["key"]
        descending = kw.get("descending", False)
        bounds = kw["boundaries"]  # computed by caller from samples

        def part_fn(block: Block, n: int, _b=bounds, _k=key) -> List[Block]:
            acc = BlockAccessor(block)
            col = acc.get_column(_k)
            if col is None:
                return [acc.slice(0, 0) for _ in range(n)]
            assign = np.searchsorted(np.asarray(_b), col, side="right")
            return [acc.take_idx(np.nonzero(assign == k)[0])
                    for k in range(n)]

        def reduce_fn(pieces: List[Block], _k=key, _d=descending,
                      _f=blk_fmt) -> Block:
            out = concat_blocks(pieces, _f)
            acc = BlockAccessor(out)
            if not acc.num_rows():
                return out
            order = np.argsort(acc.get_column(_k), kind="stable")
            if _d:
                order = order[::-1]
            return BlockAccessor(out).take_idx(order)

    elif kind == "groupby_raw":
        key = kw["key"]

        def part_fn(block: Block, n: int, _k=key) -> List[Block]:
            acc = BlockAccessor(block)
            col = acc.get_column(_k)
            if col is None:
                return [acc.slice(0, 0) for _ in range(n)]
            h = np.array([_stable_hash(x) % n for x in col.tolist()])
            return [acc.take_idx(np.nonzero(h == k)[0]) for k in range(n)]

        def reduce_fn(pieces: List[Block], _f=blk_fmt) -> Block:
            return concat_blocks(pieces, _f)

    elif kind == "groupby":
        key = kw["key"]
        aggs = kw["aggs"]  # list of (agg_name, on_col, out_name)

        def part_fn(block: Block, n: int, _k=key) -> List[Block]:
            acc = BlockAccessor(block)
            col = acc.get_column(_k)
            if col is None:
                return [acc.slice(0, 0) for _ in range(n)]
            h = np.array([_stable_hash(x) % n for x in col.tolist()])
            return [acc.take_idx(np.nonzero(h == k)[0]) for k in range(n)]

        def reduce_fn(pieces: List[Block], _k=key, _aggs=aggs,
                      _f=blk_fmt) -> Block:
            from ray_tpu_torch.data._internal.aggregate import apply_groupby
            return apply_groupby(concat_blocks(pieces, _f), _k, _aggs)

    else:
        raise ValueError(f"unknown shuffle kind {kind!r}")

    empty_fns = cloudpickle.dumps([])
    part_blob = cloudpickle.dumps(part_fn)
    parts_refs = [_partition_task.remote(empty_fns, part_blob, n_out, r)
                  for r in input_refs]
    red_blob = cloudpickle.dumps(reduce_fn)
    return [_reduce_task.remote(red_blob, k, *parts_refs)
            for k in range(n_out)]
