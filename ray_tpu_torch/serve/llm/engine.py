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
clock, so a step gains no synchronisation.  With the flight recorder
installed, each step that runs work and each preemption leave a record.

Disaggregated prefill/decode rides the runtime's data plane, as in the
reference: ``prefill_remote()`` prefills on the caller's thread and
copies the sequence's filled KV blocks from the device pool (one gather,
one device-to-host copy) into an export spool, ``rtt_llm_export_<pid>_*``
in the port's shm directory (``RTT_SHM_DIR``), which the engine's
``DataPlaneServer`` serves; it returns a manifest.  ``attach()`` on
another engine pulls the blocks with pooled ``DataPlanePool`` pulls,
copies each into a freshly allocated block of its own pool, and queues
the sequence with its first token: it decodes WITHOUT re-running
prefill (``prefill_steps`` is the no-recompute oracle).  The
``llm.prefill_remote`` span travels in the manifest and parents
``llm.attach``, which parents the sequence's decode spans.  Both calls
share the device's default stream with the engine loop, so a block is
read only after its prefill's writes.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch._private import flight_recorder, rtlog, shm_store
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.serve.llm.config import EngineConfig, SamplingParams
from ray_tpu_torch.serve.llm.kv_cache import (EXPORT_SPOOL_PREFIX,
                                              NoFreeBlocks, PagedKVCache,
                                              reap_orphan_export_spools)
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
_EXPORT_WINDOW = 64           # exported manifests kept for late attachers


def _spool_base() -> Optional[str]:
    """Where export spools live: the port's shm directory, read at call
    time (``shm_store._SHM_DIR``, ``RTT_SHM_DIR``)."""
    base = shm_store._SHM_DIR
    return str(base) if os.path.isdir(base) else None


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
        reap_orphan_export_spools(_spool_base())
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
        self._attached: deque = deque()              # guarded by: _lock
        self._streams: Dict[str, queue.Queue] = {}   # guarded by: _lock
        self._cancels: set = set()                   # guarded by: _lock
        self._wake = threading.Event()
        self._stop = threading.Event()
        # decode_steps/preemptions/tokens_out are step-loop-owned
        # (read-only elsewhere).  prefill_steps has a second writer,
        # prefill_remote() on the caller's thread, so every += runs
        # under _lock.
        self.prefill_steps = 0                       # guarded by: _lock
        self.decode_steps = 0
        self.preemptions = 0
        self.tokens_out = 0
        self._export_server = None
        self._export_spool: Optional[str] = None
        self._exports: deque = deque()               # guarded by: _lock
        self._pull_pool = None
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
        if self._export_server is not None:
            self._export_server.stop()
            self._export_server = None
        if self._pull_pool is not None:
            self._pull_pool.close_all()
            self._pull_pool = None
        if self._export_spool:
            shutil.rmtree(self._export_spool, ignore_errors=True)
            self._export_spool = None
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
            backlog = bool(self._inbox or self._attached)
        return backlog or self.sched.has_work()

    def step(self) -> bool:
        """One iteration: admit, (maybe) prefill, decode, publish.
        Returns False when nothing was runnable (loop backs off)."""
        self._drain_cancels()
        self._drain_attached()
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
        if flight_recorder.enabled() and \
                (plan.prefill is not None or plan.decode):
            flight_recorder.record(
                "llm_step",
                f"prefill={'1' if plan.prefill is not None else '0'} "
                f"decode={len(plan.decode)} "
                f"free={self.cache.free_block_count()}")
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
        with self._lock:
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
        if flight_recorder.enabled():
            flight_recorder.record(
                "llm_preempt", f"{victim.seq_id} ctx={victim.ctx_len}")
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

    # --------------------------------------------------- prefill/decode split
    def _ensure_export_plane(self):
        from ray_tpu_torch._private.data_plane import DataPlaneServer
        with self._lock:
            if self._export_server is not None:
                return self._export_server
        # built OUTSIDE the lock: the orphan sweep, mkdtemp and the
        # listener's bind are I/O, and _lock is a leaf guarding handoff
        # state that is never held across blocking work
        base = _spool_base()
        reap_orphan_export_spools(base)
        # the pid in the name makes a SIGKILLed publisher's spool
        # reapable by the next engine on the host
        spool = tempfile.mkdtemp(
            prefix=f"{EXPORT_SPOOL_PREFIX}{os.getpid()}_", dir=base)
        server = DataPlaneServer(spool, host="127.0.0.1",
                                 advertise_host="127.0.0.1")
        with self._lock:                # prefill_remote races are legal
            if self._export_server is None:
                self._export_spool = spool
                self._export_server = server
                return server
            winner = self._export_server
        server.stop()                   # lost the race: tear ours down
        shutil.rmtree(spool, ignore_errors=True)
        return winner

    def prefill_remote(self, prompt: List[int],
                       sampling: Optional[SamplingParams] = None) -> dict:
        """Run prefill here; publish the filled KV blocks on the data
        plane and return the manifest a decode engine ``attach()``es.

        Runs on the caller's thread (the engine loop keeps decoding its
        own batch meanwhile; cache alloc/free are thread-safe).  The
        blocks are read back after the prefill's writes on the same
        stream, in one device-to-host copy."""
        from ray_tpu_torch._private.data_plane import write_spool
        sampling = sampling or SamplingParams()
        if self._stop.is_set():
            raise RuntimeError("engine shut down")
        seq_id = "pf_" + uuid.uuid4().hex[:12]
        prompt = [int(t) for t in prompt]
        span = tracing.current_span()   # caller's thread context
        if span is not None and not span.sampled:
            span = None
        t0 = time.time()
        self.cache.alloc_seq(seq_id, len(prompt))
        try:
            logits, ks, vs = self.runner.prefill(prompt)
            with self._lock:
                self.prefill_steps += 1
            self.cache.scatter_prefill(seq_id, ks, vs, len(prompt))
            first = self.runner.sample(logits, sampling, step=0)
            srv = self._ensure_export_plane()
            table = self.cache.table(seq_id)
            oids = []
            for b, raw in zip(table, self.cache.blocks_bytes(table)):
                oid = f"llmkv_{seq_id}_{b}"
                write_spool(self._export_spool, oid, raw)
                oids.append(oid)
            # bounded retention: an exported manifest is consumed once by
            # the attaching decode engine; keep a window for late
            # attachers and evict beyond it, so a long-lived prefill
            # engine cannot grow the spool without limit
            evict: List[str] = []
            with self._lock:
                self._exports.append(list(oids))
                while len(self._exports) > _EXPORT_WINDOW:
                    evict.extend(self._exports.popleft())
            for old in evict:
                srv.delete_local(old)
            self._count_tokens(len(prompt), phase="prefill")
            # the manifest carries the prefill side's span (compact wire
            # form): attach() on the decode engine parents its tree to
            # it, the link between the two engines
            ctx = tracing.emit_span(
                "llm.prefill_remote", span, t0, time.time() - t0,
                cat="llm", tokens=len(prompt), blocks=len(oids),
                model=self.cfg.model) if span is not None else None
            return dict(addr=srv.advertise_addr, blocks=oids,
                        block_nbytes=self.cache.block_nbytes,
                        tokens=prompt, first_token=int(first),
                        model=self.cfg.model,
                        block_size=self.cfg.block_size,
                        trace=ctx.to_wire() if ctx is not None else None)
        except BaseException:
            if self._stop.is_set():
                # a shutdown racing this call closed the cache or the
                # export plane under it: surface the contract error, not
                # the incidental failure
                raise RuntimeError("engine shut down") from None
            raise
        finally:
            self.cache.free_seq(seq_id)

    def attach(self, manifest: dict,
               sampling: Optional[SamplingParams] = None) -> RequestStream:
        """Adopt a remotely prefilled sequence: pull its KV blocks over
        the data plane into blocks of this engine's pool and continue
        decoding, with no re-prefill."""
        from ray_tpu_torch._private.data_plane import DataPlanePool
        if manifest["model"] != self.cfg.model:
            raise ValueError(f"manifest model {manifest['model']!r} != "
                             f"engine model {self.cfg.model!r}")
        if manifest["block_nbytes"] != self.cache.block_nbytes or \
                manifest["block_size"] != self.cfg.block_size:
            raise ValueError("KV block geometry mismatch")
        sampling = sampling or SamplingParams()
        # the admission contract submit() gets through
        # IterationScheduler.add: an attached sequence must not outgrow
        # the block-table width every decode step is padded to
        if len(manifest["tokens"]) + sampling.max_tokens > \
                self.cfg.max_model_len:
            raise ValueError(
                f"manifest context {len(manifest['tokens'])} + "
                f"max_tokens {sampling.max_tokens} exceeds "
                f"max_model_len={self.cfg.max_model_len}")
        with self._lock:          # concurrent attach() races are legal
            if self._pull_pool is None:
                self._pull_pool = DataPlanePool()
            pool = self._pull_pool
        prompt = [int(t) for t in manifest["tokens"]]
        seq = Sequence(seq_id=uuid.uuid4().hex[:12], prompt=prompt,
                       sampling=sampling)
        # link the decode side's tree to the prefill side's: the
        # manifest's span parents the attach span, which parents this
        # sequence's decode spans; an untraced manifest falls back to
        # the caller's own span
        parent = tracing.SpanContext.from_wire(manifest.get("trace"),
                                               name="llm.prefill_remote")
        if parent is None:
            cur = tracing.current_span()
            parent = cur if cur is not None and cur.sampled else None
        t0 = time.time()
        self.cache.alloc_seq(seq.seq_id, len(prompt))
        tok = tracing.adopt(parent) if parent is not None else None
        try:
            # with the manifest's span adopted, the block pulls' data.pull
            # spans (and the holder's serve spans) land in the same tree
            table = self.cache.table(seq.seq_id)
            for b, oid in zip(table, manifest["blocks"]):
                raw = pool.pull(manifest["addr"], oid,
                                size=manifest["block_nbytes"])
                self.cache.load_block(b, raw)
        except BaseException:
            self.cache.free_seq(seq.seq_id)
            if self._stop.is_set():
                raise RuntimeError("engine shut down") from None
            raise
        finally:
            if tok is not None:
                tracing.restore(tok)
        if parent is not None:
            seq.trace = tracing.emit_span(
                "llm.attach", parent, t0, time.time() - t0, cat="llm",
                seq_id=seq.seq_id, blocks=len(manifest["blocks"]),
                tokens=len(prompt), model=self.cfg.model)
        q: queue.Queue = queue.Queue()
        released = False
        with self._lock:
            # the post-shutdown race submit() closes: a stream registered
            # after the drain would never be serviced
            if self._stop.is_set():
                released = True
            else:
                self._streams[seq.seq_id] = q
                self._attached.append((seq, manifest["first_token"]))
        if released:
            self.cache.free_seq(seq.seq_id)
            raise RuntimeError("engine shut down")
        self._wake.set()
        return RequestStream(seq.seq_id, q, self)

    def _drain_attached(self) -> None:
        # the max_num_seqs gate plan() applies to prefill admission:
        # adopting more sequences than the largest decode batch bucket
        # would leave a later decode step without a bucket
        room = self.max_num_seqs_room()
        if room <= 0:
            return
        items = []
        with self._lock:
            while self._attached and len(items) < room:
                items.append(self._attached.popleft())
        for seq, first in items:
            self.sched.start_running(seq)
            self._emit(seq, int(first))
            self._maybe_finish(seq)

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
            dropped = [it[0] for it in self._attached
                       if it[0].seq_id in cancelled]
            self._attached = deque(it for it in self._attached
                                   if it[0].seq_id not in cancelled)
        for seq in dropped:     # blocks freed OUTSIDE _lock: leaf locks
            self.cache.free_seq(seq.seq_id)    # never nest
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
