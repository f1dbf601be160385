"""The port's operator-pipelined streaming executor, held to the
reference's ``tests/test_data_streaming.py`` one to one.

Reference: ``python/ray/data/_internal/execution/streaming_executor.py``
— operators run concurrently with per-operator queues and backpressure.
The key behavioral test: a slow CPU-heavy map stage and the ingest stage
are busy AT THE SAME TIME.  Tests share one cluster (``cluster``);
functions here are pickled by value.
"""

import logging
import os
import sys
import time

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as rt
import ray_tpu_torch.data as rd
from ray_tpu_torch._private import rtlog

os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module")
def cluster():
    """One cluster for the module; the package logger is handed back as
    it was (``init`` stops its propagation)."""
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=4)
    yield
    rt.shutdown()
    for h in log.handlers[:]:
        if h not in handlers:
            log.removeHandler(h)
            h.close()
    log.propagate, log.level = propagate, level
    rtlog._stream_configured = False
    rtlog._file_handlers.clear()


def test_ingest_overlaps_slow_map(cluster):
    """read → map_batches(slow, fuse=False): stage intervals must overlap."""
    n_blocks = 6

    def make_factory(i):
        def factory():
            t0 = time.time()
            time.sleep(0.15)
            return {"i": np.array([i]), "read_start": np.array([t0]),
                    "read_end": np.array([time.time()])}
        return factory

    from ray_tpu_torch.data._internal.execution import ReadStage
    from ray_tpu_torch.data.dataset import Dataset

    @rt.remote
    def _warm():
        return 1

    rt.get([_warm.remote() for _ in range(4)])  # spawn the pool now

    ds = Dataset([ReadStage([make_factory(i) for i in range(n_blocks)],
                            "SlowRead")])

    def slow_map(batch):
        t0 = time.time()
        time.sleep(0.15)
        batch["map_start"] = np.full_like(batch["read_start"], t0)
        batch["map_end"] = np.full_like(batch["read_start"], time.time())
        return batch

    t_wall = time.time()
    rows = ds.map_batches(slow_map, fuse=False).take_all()
    wall = time.time() - t_wall
    assert len(rows) == n_blocks

    reads = [(r["read_start"], r["read_end"]) for r in rows]
    maps = [(r["map_start"], r["map_end"]) for r in rows]
    overlap = any(rs < me and ms < re
                  for rs, re in reads for ms, me in maps)
    assert overlap, (
        f"no read/map overlap: stages executed as sequential waves "
        f"(reads={reads}, maps={maps})")
    # and the overlap must actually buy wall-clock: strictly less than the
    # fully serialized sum (6*0.15 + 6*0.15 = 1.8s) even with dispatch cost.
    # Dispatch cost is CPU time; on a CONTENDED host it eats the sleep-
    # overlap margin, so the bound stretches with a FRESH host-speed probe
    # (load can arrive mid-session; the session-start probe under-reads
    # it) — but only when the probe actually detects contention (>1.3×):
    # an idle host keeps the tight bound so sequential-wave regressions
    # still trip it (the interval-overlap assertion above is the
    # structural check).
    import os as _os

    from conftest import time_scale
    scale = time_scale(fresh=True)
    # the probe can under-read lingering background load (orphaned
    # workers from earlier tests, an expiring load generator): the 1-min
    # loadavg catches what a 0.2s probe burst misses
    contended = scale > 1.3 or _os.getloadavg()[0] > 1.5
    if not contended:
        # quiet host: the strict bound is meaningful
        serial = n_blocks * 0.3
        assert wall < serial, \
            f"wall {wall:.2f}s not better than serial {serial}s"
    else:
        # contended host: dispatch CPU shares one core with the external
        # load, and the probe (one competing thread) UNDER-reads slowdown
        # for a many-process pipeline — the wall bound stops measuring
        # overlap.  The interval-overlap assertion above remains the
        # regression detector; keep only a generous sanity ceiling.
        assert wall < n_blocks * 0.3 * 8, f"wall {wall:.2f}s"


def test_fused_chain_still_one_task_per_block(cluster):
    """Fusable map chains keep the wave optimizer's win: pids show one
    task did read+map+map for a given block."""
    ds = rd.range(4, override_num_blocks=4)
    seen = []

    def tag(batch):
        import os
        batch["pid1"] = np.full(len(batch["id"]), os.getpid())
        return batch

    def tag2(batch):
        import os
        batch["pid2"] = np.full(len(batch["id"]), os.getpid())
        return batch

    rows = ds.map_batches(tag).map_batches(tag2).take_all()
    assert all(r["pid1"] == r["pid2"] for r in rows)


def test_backpressure_bounds_inflight(cluster):
    """A slow consumer must not cause the whole dataset to materialize:
    the number of blocks produced ahead of consumption stays within the
    executor budget."""
    from ray_tpu_torch.data.context import DataContext
    ctx = DataContext.get_current()
    old = ctx.max_tasks_in_flight
    ctx.max_tasks_in_flight = 2
    try:
        produced = []

        def make_factory(i):
            def factory():
                time.sleep(0.02)
                return {"i": np.array([i]), "t": np.array([time.time()])}
            return factory

        from ray_tpu_torch.data._internal.execution import ReadStage
        from ray_tpu_torch.data.dataset import Dataset
        ds = Dataset([ReadStage([make_factory(i) for i in range(12)],
                                "Read")])
        it = ds._iter_refs()
        first = rt.get(next(it))
        stall_end = time.time() + 1.5
        time.sleep(1.5)  # consumer stalls; producer must throttle
        # blocks produced while the consumer stalled: bounded by the
        # executor budget (inflight + output queue), NOT all 12 — the
        # essential claim is that the dataset did not fully materialize
        stamped = [first] + [rt.get(r) for r in it]
        assert len(stamped) == 12
        early = [b for b in stamped if float(b["t"][0]) < stall_end]
        late = [b for b in stamped if float(b["t"][0]) >= stall_end]
        assert late, (
            f"no backpressure: all 12 blocks were produced while the "
            f"consumer stalled (early={len(early)})")
    finally:
        ctx.max_tasks_in_flight = old


def test_error_in_stage_propagates(cluster):
    ds = rd.range(4, override_num_blocks=2)

    def boom(batch):
        raise ValueError("stage error")

    with pytest.raises(Exception):
        ds.map_batches(boom, fuse=False).take_all()


def test_shuffle_barrier_inside_pipeline(cluster):
    """read → shuffle → slow map: the barrier collects, then its outputs
    stream through the downstream operator."""
    ds = rd.range(40, override_num_blocks=4).random_shuffle(seed=7)

    def inc(batch):
        batch["id"] = batch["id"] + 1
        return batch

    rows = ds.map_batches(inc, fuse=False).take_all()
    assert sorted(r["id"] for r in rows) == list(range(1, 41))
