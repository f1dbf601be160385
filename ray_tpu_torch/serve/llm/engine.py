"""LLMEngine: the continuous-batching loop over the paged KV cache
(port of ``ray_tpu/serve/llm/engine.py``).

One engine = one model on one device.  Requests enter through
``submit()`` (thread-safe, returns a token stream); a dedicated engine
thread runs ``step()`` forever: drain new requests, plan the iteration
(``scheduler.py``), execute a prefill or a bucketed decode batch
(``model_runner.py``), write the new K/V into the device block pool
(``kv_cache.py``), push sampled tokens to the per-request streams.

With ``EngineConfig.share_weights`` (the reference's default) the params
come through the shared-memory weights plane (``weights.py``): the first
engine on the node publishes them and later ones attach; every engine
reaps dead publishers' segments at boot and releases its own at
shutdown.

Metrics and tracing are the reference's, over the port's
``util/metrics_catalog`` and ``util/tracing`` and behind
``GLOBAL_CONFIG.metrics_enabled``: ``rtt_llm_tokens_total`` (prefill =
prompt tokens, decode = tokens of decode iterations), the sequence, KV
block and occupancy gauges after every step, TTFT and TPOT histograms,
the preemption counter, and the spans ``llm.prefill``,
``llm.decode_step`` and ``llm.preempt`` parented to the submitter's span.
None of them reads the device: every value is a host count or a host
clock, so a step gains no synchronisation.

Not in this slice: disaggregated prefill/decode over the data plane
(``prefill_remote``, ``attach``, the KV export plane and the KV pool's
shm segment; the pool lives on the device) and the flight recorder's
engine records.
"""

from __future__ import annotations

import queue
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch._private import rtlog
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.serve.llm.config import EngineConfig, SamplingParams
from ray_tpu_torch.serve.llm.kv_cache import NoFreeBlocks, PagedKVCache
from ray_tpu_torch.serve.llm.model_runner import ModelRunner
from ray_tpu_torch.serve.llm.scheduler import (FAILED, FINISHED,
                                               IterationScheduler, Plan,
                                               Sequence)
from ray_tpu_torch.serve.llm import weights
from ray_tpu_torch.util import metrics_catalog as mcat
from ray_tpu_torch.util import tracing

logger = rtlog.get("serve.llm.engine")

_DONE = "__llm_done__"
_ERR = "__llm_err__"


class RequestStream:
    """Iterator over one request's generated token ids."""

    def __init__(self, seq_id: str, q: "queue.Queue", engine=None):
        self.seq_id = seq_id
        self._q = q
        self._engine = engine
        self.finish_reason: Optional[str] = None

    def __iter__(self):
        while True:
            item = self._q.get()
            if isinstance(item, tuple):
                kind, payload = item
                if kind == _DONE:
                    self.finish_reason = payload
                    return
                raise RuntimeError(f"llm request failed: {payload}")
            yield item

    def poll(self, max_items: int = 16,
             timeout: float = 0.2) -> tuple:
        """Non-blocking-ish drain: wait up to ``timeout`` for the FIRST
        available token, then take whatever else is already queued (cap
        ``max_items``).  Returns (tokens, done) — the serve streaming
        path's bounded-occupancy pull."""
        out: List[int] = []
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            return out, False
        while True:
            if isinstance(item, tuple):
                kind, payload = item
                if kind == _DONE:
                    self.finish_reason = payload
                    return out, True
                if out:
                    # deliver the tokens drained BEFORE the failure
                    # (parity with __iter__); the error marker goes
                    # back for the next poll — nothing follows it
                    self._q.put(item)
                    return out, False
                raise RuntimeError(f"llm request failed: {payload}")
            out.append(item)
            if len(out) >= max_items:
                return out, False
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return out, False

    def cancel(self) -> None:
        """Abandon the request: the engine frees its KV blocks and
        drops it from the batch at the next iteration."""
        if self._engine is not None:
            self._engine.cancel(self.seq_id)

    def tokens(self) -> List[int]:
        return list(self)


class LLMEngine:
    """``device`` defaults to ``cuda`` (raises with no card);
    ``model_cfg`` overrides the preset's model config."""

    def __init__(self, cfg: EngineConfig, params=None, *,
                 start: bool = True, device: DeviceLike = None,
                 model_cfg=None):
        if cfg.prefill_len_buckets[-1] < cfg.max_model_len:
            raise ValueError(
                "largest prefill bucket must cover max_model_len "
                "(preempted sequences re-prefill their full context)")
        if cfg.decode_batch_buckets[-1] < cfg.max_num_seqs:
            raise ValueError(
                f"largest decode batch bucket "
                f"{cfg.decode_batch_buckets[-1]} < max_num_seqs "
                f"{cfg.max_num_seqs}: a full batch would have no bucket")
        weights.reap_orphans()
        self.cfg = cfg
        self.runner = ModelRunner(cfg, params, device=device,
                                  model_cfg=model_cfg)
        self.cache = PagedKVCache(
            cfg.num_blocks, self.runner.n_layer, cfg.block_size,
            self.runner.n_kv, self.runner.head_dim,
            device=self.runner.device)
        self.sched = IterationScheduler(cfg.max_num_seqs,
                                        cfg.max_prefill_tokens,
                                        cfg.max_model_len)
        self._lock = threading.Lock()
        self._inbox: deque = deque()                 # guarded by: _lock
        self._streams: Dict[str, queue.Queue] = {}   # guarded by: _lock
        self._cancels: set = set()                   # guarded by: _lock
        self._wake = threading.Event()
        self._stop = threading.Event()
        # step-loop-owned counters (read-only elsewhere)
        self.prefill_steps = 0
        self.decode_steps = 0
        self.preemptions = 0
        self.tokens_out = 0
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name=f"llm-engine-{self.cfg.model_key()}",
            daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        with self._lock:
            streams = list(self._streams.values())
            self._streams.clear()
        for q in streams:           # unblock any readers
            q.put((_ERR, "engine shut down"))
        if self.runner.weights_key:
            weights.release(self.runner.weights_key)
        self.cache.close()

    # ------------------------------------------------------------ submission
    def submit(self, prompt: List[int],
               sampling: Optional[SamplingParams] = None) -> RequestStream:
        sampling = sampling or SamplingParams()
        seq = Sequence(seq_id=uuid.uuid4().hex[:12],
                       prompt=[int(t) for t in prompt], sampling=sampling)
        # request tracing: the submitter's span (serve replica method /
        # driver trace) parents every engine span for this sequence —
        # captured HERE because the engine loop thread has no context
        span = tracing.current_span()
        if span is not None and span.sampled:
            seq.trace = span
        q: queue.Queue = queue.Queue()
        with self._lock:
            # checked under the same lock shutdown() drains streams
            # under: no reader can block on a never-serviced queue
            if self._stop.is_set():
                raise RuntimeError("engine shut down")
            self._streams[seq.seq_id] = q
            self._inbox.append(seq)
        self._wake.set()
        return RequestStream(seq.seq_id, q, self)

    def generate(self, prompt: List[int],
                 sampling: Optional[SamplingParams] = None) -> List[int]:
        return self.submit(prompt, sampling).tokens()

    def cancel(self, seq_id: str) -> None:
        """Request abandonment (thread-safe; applied at the next step)."""
        with self._lock:
            self._cancels.add(seq_id)
        self._wake.set()

    # ------------------------------------------------------------ engine loop
    def _loop(self) -> None:
        while not self._stop.is_set():
            if not self._work_pending():
                self._wake.wait(timeout=0.2)
                self._wake.clear()
                continue
            try:
                if not self.step():
                    # work exists but nothing runnable this iteration:
                    # don't busy-spin the core
                    self._wake.wait(timeout=0.02)
                    self._wake.clear()
            except Exception:  # noqa: BLE001 - engine must survive a step
                logger.exception("engine step failed")
                time.sleep(0.05)

    def _work_pending(self) -> bool:
        with self._lock:
            backlog = bool(self._inbox)
        return backlog or self.sched.has_work()

    def step(self) -> bool:
        """One iteration: admit, (maybe) prefill, decode, publish.
        Returns False when nothing was runnable (loop backs off)."""
        self._drain_cancels()
        with self._lock:
            while self._inbox:
                seq = self._inbox.popleft()
                try:
                    self.sched.add(seq)
                except ValueError as e:
                    self._finish_locked(seq, FAILED, str(e))
        # a prompt whose blocks can NEVER fit (even with every other
        # sequence evicted) must fail now, not starve the waiting line
        while self.sched.waiting:
            head = self.sched.waiting[0]
            if self.cache.blocks_needed(head.ctx_len) + 1 \
                    <= self.cache.num_blocks:
                break
            self.sched.waiting.popleft()
            self._finish(head, FAILED,
                         f"prompt needs more KV blocks than the pool "
                         f"holds ({self.cache.num_blocks})")
        plan = self.sched.plan(self.cache.free_block_count(),
                               self.cache.blocks_needed)
        if plan.prefill is not None:
            self._do_prefill(plan.prefill)
        elif plan.decode:
            self._do_decode(plan.decode)
        self._publish_metrics(plan)
        return plan.prefill is not None or bool(plan.decode)

    # ---------------------------------------------------------------- prefill
    def _do_prefill(self, seq: Sequence) -> None:
        try:
            self.cache.alloc_seq(seq.seq_id, seq.ctx_len)
        except NoFreeBlocks:
            # plan() checked free blocks, but be safe: requeue
            self.sched.waiting.appendleft(seq)
            return
        t0 = time.time()
        try:
            logits, ks, vs = self.runner.prefill(seq.prompt)
        except Exception as e:  # noqa: BLE001 - surface to the caller
            self.cache.free_seq(seq.seq_id)
            self._finish(seq, FAILED, f"prefill failed: {e!r}")
            return
        self.prefill_steps += 1
        self.cache.scatter_prefill(seq.seq_id, ks, vs, len(seq.prompt))
        # sampling step = tokens generated so far RELATIVE TO THE
        # ORIGINAL prompt, so a preemption re-prefill draws the same rng
        # stream position as the pressure-free run
        tok = self.runner.sample(logits, seq.sampling, step=seq.generated)
        if seq.trace is not None:
            # per-sequence prefill span (explicit parent: the engine
            # loop thread never holds the request's context variable)
            tracing.emit_span("llm.prefill", seq.trace, t0,
                              time.time() - t0, cat="llm",
                              seq_id=seq.seq_id, tokens=len(seq.prompt),
                              model=self.cfg.model)
        self.sched.start_running(seq)
        self._emit(seq, tok)
        self._count_tokens(len(seq.prompt), phase="prefill")
        self._maybe_finish(seq)

    # ----------------------------------------------------------------- decode
    def _do_decode(self, seqs: List[Sequence]) -> None:
        slots = {}
        batch = list(seqs)
        for seq in list(batch):
            while True:
                if seq not in self.sched.running:
                    break        # preempted while making room for others
                try:
                    slots[seq.seq_id] = self.cache.append_slot(seq.seq_id)
                    break
                except NoFreeBlocks:
                    if not self._preempt_one(slots):
                        # unreachable: sched.running contains at least
                        # `seq` itself, so victim() always finds one
                        raise RuntimeError(
                            "no preemption victim with a growing "
                            "sequence running")
            # preemption may have evicted members of THIS batch
            batch = [s for s in batch if s in self.sched.running]
        if not batch:
            return
        maxb = self.cfg.max_blocks_per_seq
        tables = np.zeros((len(batch), maxb), np.int32)
        toks = np.zeros(len(batch), np.int32)
        poss = np.zeros(len(batch), np.int32)
        lens = np.zeros(len(batch), np.int32)
        for i, s in enumerate(batch):
            t = self.cache.table(s.seq_id)
            tables[i, :len(t)] = t
            # the token being processed is the last SAMPLED one — its KV
            # is not in the pool yet (this step writes it); both its
            # position and the valid pool length are ctx_len - 1
            toks[i] = s.output[-1] if s.output else s.prompt[-1]
            poss[i] = s.ctx_len - 1
            lens[i] = s.ctx_len - 1
        t0 = time.time()
        try:
            logits, ks, vs = self.runner.decode(toks, poss,
                                                self.cache.pool, tables,
                                                lens)
        except BaseException:
            # return every slot reserved for THIS step, or every later
            # append_slot is off by one and the cache silently corrupts
            for s in batch:
                ent = slots.get(s.seq_id)
                if ent is not None:
                    self.cache.rollback_slot(s.seq_id, ent[2])
            raise
        self.decode_steps += 1
        blks = [slots[s.seq_id][0] for s in batch]
        offs = [slots[s.seq_id][1] for s in batch]
        self.cache.write_token(blks, offs, ks, vs)
        for i, s in enumerate(batch):
            tok = self.runner.sample(logits[i], s.sampling,
                                     step=s.generated)
            self._emit(s, tok)
            self._maybe_finish(s)
        traced = next((s for s in batch if s.trace is not None), None)
        if traced is not None:
            # one span per decode ITERATION (the batch is the unit of
            # execution), parented to the first traced sequence in it
            tracing.emit_span("llm.decode_step", traced.trace, t0,
                              time.time() - t0, cat="llm",
                              batch=len(batch), seq_id=traced.seq_id,
                              model=self.cfg.model)
        self._count_tokens(len(batch), phase="decode")

    def _preempt_one(self, slots: Dict) -> bool:
        """Evict the scheduler's victim (latest arrival — possibly one
        that already reserved a slot this iteration, or even the
        sequence being grown); its entry in ``slots`` is invalidated so
        the caller's batch bookkeeping stays consistent."""
        victim = self.sched.victim()
        if victim is None:
            return False
        logger.info("preempting %s under cache pressure (ctx=%d)",
                    victim.seq_id, victim.ctx_len)
        if victim.trace is not None:
            tracing.emit_span("llm.preempt", victim.trace, time.time(),
                              0.0, cat="llm", seq_id=victim.seq_id,
                              ctx=victim.ctx_len)
        self.cache.free_seq(victim.seq_id)
        slots.pop(victim.seq_id, None)
        self.sched.preempt(victim)
        self.preemptions += 1
        if GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_llm_preemptions_total").inc(
                tags={"model": self.cfg.model})
        return True

    def _drain_cancels(self) -> None:
        with self._lock:
            if not self._cancels:
                return
            cancelled = self._cancels
            self._cancels = set()
            for sid in cancelled:
                self._streams.pop(sid, None)    # nobody is reading
            self._inbox = deque(s for s in self._inbox
                                if s.seq_id not in cancelled)
        for seq in [s for s in self.sched.running
                    if s.seq_id in cancelled]:
            self.cache.free_seq(seq.seq_id)
            self.sched.finish(seq, FINISHED)
        for seq in [s for s in list(self.sched.waiting)
                    if s.seq_id in cancelled]:
            self.sched.drop_waiting(seq)

    # ------------------------------------------------------------- completion
    def _emit(self, seq: Sequence, tok: int) -> None:
        now = time.monotonic()
        if seq.first_token_at is None:
            seq.first_token_at = now
            if GLOBAL_CONFIG.metrics_enabled:
                mcat.get("rtt_llm_ttft_seconds").observe(
                    now - seq.arrival, tags={"model": self.cfg.model})
        seq.output.append(int(tok))
        self.tokens_out += 1
        with self._lock:
            q = self._streams.get(seq.seq_id)
        if q is not None:
            q.put(int(tok))

    def _maybe_finish(self, seq: Sequence) -> None:
        reason = seq.finish_reason()
        if reason is None:
            return
        self.cache.free_seq(seq.seq_id)
        self.sched.finish(seq, FINISHED)
        if GLOBAL_CONFIG.metrics_enabled and len(seq.output) > 1 and \
                seq.first_token_at is not None:
            tpot = (seq.finished_at - seq.first_token_at) / \
                (len(seq.output) - 1)
            mcat.get("rtt_llm_tpot_seconds").observe(
                tpot, tags={"model": self.cfg.model})
        with self._lock:
            q = self._streams.pop(seq.seq_id, None)
        if q is not None:
            q.put((_DONE, reason))

    def _finish(self, seq: Sequence, state: str, err: str) -> None:
        with self._lock:
            self._finish_locked(seq, state, err)

    def _finish_locked(self, seq: Sequence, state: str, err: str) -> None:
        seq.state = state
        seq.error = err
        seq.finished_at = time.monotonic()
        q = self._streams.pop(seq.seq_id, None)
        if q is not None:
            q.put((_ERR, err))

    def max_num_seqs_room(self) -> int:
        """Sequences the running batch can still take (what the Serve
        deployment's admission reads)."""
        return self.cfg.max_num_seqs - len(self.sched.running)

    # ---------------------------------------------------------------- metrics
    def _count_tokens(self, n: int, phase: str) -> None:
        if GLOBAL_CONFIG.metrics_enabled:
            mcat.get("rtt_llm_tokens_total").inc(
                n, tags={"model": self.cfg.model, "phase": phase})

    def _publish_metrics(self, plan: Plan) -> None:
        if not GLOBAL_CONFIG.metrics_enabled:
            return
        tags = {"model": self.cfg.model}
        running = len(self.sched.running)
        mcat.get("rtt_llm_sequences").set(
            running, tags={**tags, "state": "running"})
        mcat.get("rtt_llm_sequences").set(
            len(self.sched.waiting), tags={**tags, "state": "waiting"})
        free = self.cache.free_block_count()
        mcat.get("rtt_llm_kv_blocks").set(
            self.cfg.num_blocks - free, tags={**tags, "state": "used"})
        mcat.get("rtt_llm_kv_blocks").set(free,
                                          tags={**tags, "state": "free"})
        mcat.get("rtt_llm_batch_occupancy").set(
            running / max(1, self.cfg.max_num_seqs), tags=tags)

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        return dict(prefill_steps=self.prefill_steps,
                    decode_steps=self.decode_steps,
                    preemptions=self.preemptions,
                    tokens_out=self.tokens_out,
                    running=len(self.sched.running),
                    waiting=len(self.sched.waiting),
                    blocks_free=self.cache.free_block_count(),
                    compiles=self.runner.compiles)
