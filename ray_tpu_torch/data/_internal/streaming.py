"""Operator-pipelined streaming executor.

Reference: ``python/ray/data/_internal/execution/streaming_executor.py``
(SURVEY.md §2.5): a running topology of operators with per-operator input
queues and bounded budgets; blocks flow operator-to-operator as they are
produced, so a fast ingest stage and a slow CPU-heavy stage are busy
CONCURRENTLY instead of executing as sequential waves.

Design (the driver is the control loop, workers do the work — no
dedicated supervisor actors):

- The logical plan keeps the map-chain FUSION optimizer (a read→map→map
  chain is still one task per block); only genuinely distinct operators
  (different compute shape, or separated by an all-to-all) become
  pipeline stages.
- One background scheduler thread drives the whole topology: it submits
  tasks for any operator whose input queue is non-empty and whose budget
  allows, harvests completions with ``ray_tpu_torch.wait``, and moves outputs
  to the downstream queue IN SUBMISSION ORDER (deterministic output
  order, out-of-order completion internally).
- Backpressure: each operator may have at most ``DataContext.
  max_tasks_in_flight`` blocks in (inflight + downstream-queue); the
  sink's output queue is bounded the same way, so a slow consumer stalls
  the topology source-first instead of buffering the dataset.
- All-to-all stages are barrier operators: they collect their whole
  input, then run the existing 2-phase shuffle and stream its outputs.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.data.context import DataContext


class _Op:
    """One pipeline stage: submits one task per input item."""

    def __init__(self, name: str, submit: Callable[[Any], Any],
                 budget: int):
        self.name = name
        self.submit = submit           # input item -> output ref
        self.budget = budget
        self.inq: deque = deque()      # ready input items
        self.inflight: dict = {}       # ref -> seq
        self.results: dict = {}        # seq -> output ref
        self.next_seq = 0              # next submission sequence number
        self.emit_seq = 0              # next sequence to emit downstream
        self.upstream_done = False
        self.emitted = 0

    def done(self) -> bool:
        return (self.upstream_done and not self.inq and not self.inflight
                and not self.results)


class _BarrierOp(_Op):
    """All-to-all: collects ALL inputs, then materializes its outputs via
    the wave shuffle (inherently a barrier in any executor)."""

    def __init__(self, name: str, run: Callable[[List[Any]], List[Any]],
                 budget: int):
        super().__init__(name, submit=None, budget=budget)
        self.run = run
        self.collected: List[Any] = []
        self.ran = False


class StreamingTopology:
    def __init__(self, ops: List[_Op]):
        self.ops = ops
        self.out: deque = deque()      # sink output refs, ordered
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        # set ONLY by the scheduler thread, whose view is consistent —
        # the consumer must never compute done-ness itself (it could
        # observe the instant between inq.popleft() and inflight
        # registration and conclude the topology is empty)
        self._finished = threading.Event()
        self._wake = threading.Event()
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="data-streaming-exec")
        self._thread.start()

    # ------------------------------------------------------------- driving
    def _downstream(self, i: int) -> Optional[_Op]:
        return self.ops[i + 1] if i + 1 < len(self.ops) else None

    def _room_downstream(self, i: int) -> bool:
        nxt = self._downstream(i)
        if nxt is not None:
            return len(nxt.inq) < nxt.budget
        return len(self.out) < self.ops[i].budget

    def _loop(self) -> None:
        import time as _time
        try:
            while not self._stop.is_set():
                progress = False
                # sink-first: draining downstream frees upstream budget
                for i in range(len(self.ops) - 1, -1, -1):
                    op = self.ops[i]
                    # barrier op: run once its whole input has arrived
                    if isinstance(op, _BarrierOp):
                        op.collected.extend(op.inq)
                        op.inq.clear()
                        if op.upstream_done and not op.ran:
                            # resolve to concrete refs first: the shuffle
                            # fans every input into every reducer
                            outs = op.run(op.collected)
                            op.ran = True
                            for r in outs:
                                op.results[op.next_seq] = r
                                op.next_seq += 1
                            progress = True
                    else:
                        # submit while input + budget allow; completed-but-
                        # unemitted results count against the budget too,
                        # or a stalled consumer lets the op materialize
                        # its whole input into `results`
                        while op.inq and \
                                len(op.inflight) + len(op.results) \
                                < op.budget:
                            item = op.inq.popleft()
                            ref = op.submit(item)
                            op.inflight[ref] = op.next_seq
                            op.next_seq += 1
                            progress = True
                    # emit completed outputs downstream, in order
                    while op.emit_seq in op.results and \
                            self._room_downstream(i):
                        ref = op.results.pop(op.emit_seq)
                        op.emit_seq += 1
                        op.emitted += 1
                        nxt = self._downstream(i)
                        if nxt is not None:
                            nxt.inq.append(ref)
                        else:
                            with self._lock:
                                self.out.append(ref)
                            self._wake.set()
                        progress = True
                    # propagate completion
                    nxt = self._downstream(i)
                    if nxt is not None and not nxt.upstream_done and \
                            op.done():
                        nxt.upstream_done = True
                        progress = True
                if self._all_done():
                    self._finished.set()
                    self._wake.set()
                    return
                if progress:
                    continue
                # harvest: wait on every in-flight ref across ops
                inflight = [r for op in self.ops for r in op.inflight]
                if not inflight:
                    # nothing running and no progress: topology is stalled
                    # on the consumer (sink queue full) — wait for a pull
                    _time.sleep(0.002)
                    continue
                done, _ = ray_tpu_torch.wait(inflight, num_returns=1,
                                       timeout=0.2)
                for ref in done:
                    for op in self.ops:
                        seq = op.inflight.pop(ref, None)
                        if seq is not None:
                            op.results[seq] = ref
                            break
        except BaseException as e:  # noqa: BLE001 - surfaced to consumer
            self.error = e
            self._finished.set()
            self._wake.set()

    def _all_done(self) -> bool:
        return all(op.done() for op in self.ops)

    # ------------------------------------------------------------ consuming
    def __iter__(self) -> Iterator[Any]:
        while True:
            with self._lock:
                ref = self.out.popleft() if self.out else None
            if ref is not None:
                yield ref
                continue
            if self.error is not None:
                raise self.error
            if self._finished.is_set():
                with self._lock:
                    if not self.out:
                        return
                continue
            self._wake.wait(0.05)
            self._wake.clear()

    def stop(self) -> None:
        self._stop.set()


def build_topology(stages, input_refs=None) -> StreamingTopology:
    """Compile fused logical stages into a running streaming topology."""
    import cloudpickle

    from ray_tpu_torch.data._internal import execution as ex

    ctx = DataContext.get_current()
    budget = max(2, ctx.max_tasks_in_flight)
    ops: List[_Op] = []
    stages = ex._fuse(list(stages))

    def seed(op: _Op) -> _Op:
        """First op consumes the explicit input refs (if any)."""
        if not ops:
            op.inq.extend(input_refs or [])
            op.upstream_done = True
        return op

    i = 0
    while i < len(stages):
        st = stages[i]
        if isinstance(st, ex.ReadStage):
            fns: List[Callable] = []
            i += 1
            while i < len(stages) and isinstance(stages[i], ex.MapStage) \
                    and stages[i].fusable:
                fns.extend(ex._stage_fns(stages[i]))
                i += 1
            fns_blob = cloudpickle.dumps(fns)

            def submit(item, _fb=fns_blob):
                return ex._source_task.remote(item, _fb)
            op = _Op(st.name + ("+Map" if fns else ""), submit, budget)
            op.inq.extend(cloudpickle.dumps(f) for f in st.factories)
            op.upstream_done = True
            ops.append(op)
        elif isinstance(st, ex.MapStage):
            if st.fusable:
                fns = []
                name = "Map"
                while i < len(stages) and \
                        isinstance(stages[i], ex.MapStage) and \
                        stages[i].fusable:
                    fns.extend(ex._stage_fns(stages[i]))
                    name = stages[i].name
                    i += 1
                remote_args = None
            else:
                fns = ex._stage_fns(st)
                name = st.name
                remote_args = st.remote_args
                i += 1
            fns_blob = cloudpickle.dumps(fns)
            task = ex._map_task.options(**remote_args) if remote_args \
                else ex._map_task

            def submit(item, _t=task, _fb=fns_blob):
                return _t.remote(_fb, item)
            ops.append(seed(_Op(name, submit, budget)))
        elif isinstance(st, ex.AllToAllStage):
            i += 1

            def run(collected, _st=st):
                return ex._run_shuffle(_st, list(collected))
            ops.append(seed(_BarrierOp(st.name, run, budget)))
        else:
            raise TypeError(f"unknown stage {st!r}")
    if not ops:
        # empty plan over explicit refs: passthrough barrier
        bop = _BarrierOp("Identity", lambda c: list(c), budget)
        bop.inq.extend(input_refs or [])
        bop.upstream_done = True
        return StreamingTopology([bop])
    return StreamingTopology(ops)
