"""Replica actor: hosts one copy of a deployment's user class.

Reference: ``python/ray/serve/_private/replica.py`` (SURVEY.md §3.6) — the
replica wraps the user callable, runs requests with bounded concurrency
(the actor's ``max_concurrency`` = the deployment's
``max_ongoing_requests``; excess calls queue at the actor mailbox), and
owns an asyncio loop so async user methods and ``@serve.batch`` work.

Port of ``ray_tpu/serve/_replica.py``.  Model construction (the CUDA
context, the weights on the card, the kernels' first load) happens in
``__init__`` — the controller only marks a replica ready once ``__init__``
returned, so traffic never hits a cold replica (SURVEY.md §7.3).
"""

from __future__ import annotations

import asyncio
import inspect
import threading
from typing import Any, Dict, Tuple


class HandleMarker:
    """Placeholder in init args for a bound sub-deployment (composition)."""

    def __init__(self, dep_key: str):
        self.dep_key = dep_key

    def __repr__(self):
        return f"HandleMarker({self.dep_key})"


def _resolve_markers(obj: Any) -> Any:
    from ray_tpu_torch.serve.handle import DeploymentHandle
    if isinstance(obj, HandleMarker):
        return DeploymentHandle(obj.dep_key)
    if isinstance(obj, list):
        return [_resolve_markers(o) for o in obj]
    if isinstance(obj, tuple):
        return tuple(_resolve_markers(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _resolve_markers(v) for k, v in obj.items()}
    return obj


class Replica:
    def __init__(self, dep_key: str, replica_tag: str, user_cls: type,
                 init_args: Tuple, init_kwargs: Dict):
        self._dep_key = dep_key
        self._replica_tag = replica_tag
        self._loop = asyncio.new_event_loop()
        threading.Thread(target=self._loop.run_forever,
                         name="replica-asyncio", daemon=True).start()
        init_args = _resolve_markers(tuple(init_args))
        init_kwargs = _resolve_markers(dict(init_kwargs))
        self._streams: Dict[str, Tuple[Any, float]] = {}
        self._streams_lock = threading.Lock()
        self._ongoing = 0
        self._ongoing_lock = threading.Lock()
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch.util import metrics_catalog as mcat
        if GLOBAL_CONFIG.metrics_enabled:
            # group-label convention (metrics_catalog.py): this process
            # hosts exactly one replica of one deployment, so the LLM
            # engine's rtt_llm_* series — emitted deep inside the
            # engine, where no dep_key is in scope — inherit the
            # deployment key as ``group`` via process-level default tags
            # (stamped BEFORE user __init__ constructs the engine).
            for _name in ("rtt_llm_sequences", "rtt_llm_kv_blocks",
                          "rtt_llm_batch_occupancy",
                          "rtt_llm_preemptions_total",
                          "rtt_llm_ttft_seconds",
                          "rtt_llm_tpot_seconds",
                          "rtt_llm_tokens_total"):
                mcat.get(_name).set_default_tags({"group": dep_key})
        self._instance = user_cls(*init_args, **init_kwargs)

    def _track_ongoing(self, delta: int) -> None:
        """rtt_serve_ongoing_requests: requests executing inside THIS
        replica right now (reference: ``serve_replica_processing_queries``).
        The replica process's background publisher ships it — the
        controller's autoscaler signal stays handle-reported and
        unchanged."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch.util import metrics_catalog as mcat
        with self._ongoing_lock:
            # gauge set INSIDE the lock: counter update and publication
            # must be atomic, or a delayed set() from a finished request
            # can overwrite a newer value and stick the gauge wrong until
            # the next request
            self._ongoing += delta
            if GLOBAL_CONFIG.metrics_enabled:
                mcat.get("rtt_serve_ongoing_requests").set(
                    self._ongoing, tags={"deployment": self._dep_key,
                                         "replica": self._replica_tag,
                                         "group": self._dep_key})

    def handle_request(self, method: str, args: Tuple, kwargs: Dict):
        self._track_ongoing(1)
        try:
            return self._handle_request(method, args, kwargs)
        finally:
            self._track_ongoing(-1)

    def _handle_request(self, method: str, args: Tuple, kwargs: Dict):
        import ray_tpu_torch
        from ray_tpu_torch._private.object_ref import ObjectRef

        # Chained DeploymentResponses arrive as ObjectRefs inside the args
        # tuple — possibly nested in containers (the worker only
        # auto-resolves TOP-level task args); resolve them all here so
        # composed deployments see values, not refs.
        def resolve(o):
            if isinstance(o, ObjectRef):
                return ray_tpu_torch.get(o)
            if isinstance(o, list):
                return [resolve(x) for x in o]
            if isinstance(o, tuple):
                return tuple(resolve(x) for x in o)
            if isinstance(o, dict):
                return {k: resolve(v) for k, v in o.items()}
            return o

        args = tuple(resolve(a) for a in args)
        kwargs = {k: resolve(v) for k, v in kwargs.items()}
        # multiplex routing metadata rides a reserved kwarg; expose it to
        # the user method via serve.get_multiplexed_model_id()
        model_id = kwargs.pop("__serve_model_id__", "")
        from ray_tpu_torch.serve import multiplex as _mux
        m = getattr(self._instance, method)
        if inspect.iscoroutinefunction(m):
            from ray_tpu_torch.util import tracing
            span = tracing.current_span()

            # contextvars do not cross run_coroutine_threadsafe into the
            # loop thread; set the id inside the task's own context, and
            # the request's span too, so what the method submits (an LLM
            # engine's sequences) is parented to the request
            async def _run():
                tok = _mux._set_model_id(model_id)
                span_tok = tracing.adopt(span)
                try:
                    return await m(*args, **kwargs)
                finally:
                    tracing.restore(span_tok)
                    _mux._current_model_id.reset(tok)

            fut = asyncio.run_coroutine_threadsafe(_run(), self._loop)
            result = fut.result()
        else:
            token = _mux._set_model_id(model_id)
            try:
                result = m(*args, **kwargs)
            finally:
                _mux._current_model_id.reset(token)
        return self._maybe_register_stream(result, model_id)

    # ------------------------------------------------------------ streaming
    def _maybe_register_stream(self, result: Any, model_id: str = ""):
        """Generators / StreamingResponse stay replica-side; the caller
        gets a marker and pulls chunks via ``stream_next`` (the router
        pins continuations to THIS replica).  ``model_id`` is remembered
        with the stream: a generator body executes during stream_next
        pulls (arbitrary actor threads), so get_multiplexed_model_id()
        must be re-established around each pull, not around the call
        that merely CREATED the generator."""
        from ray_tpu_torch.serve.http_util import StreamingResponse
        status, ctype, it, pull = 200, "text/plain", None, 16
        if isinstance(result, StreamingResponse):
            status, ctype = result.status_code, result.content_type
            pull = result.pull_chunks
            it = (self._drive_asyncgen(result.content, model_id)
                  if inspect.isasyncgen(result.content)
                  else iter(result.content))
        elif inspect.isgenerator(result):
            it = result
        elif inspect.isasyncgen(result):
            it = self._drive_asyncgen(result, model_id)
        if it is None:
            return result
        import time as _time
        import uuid
        self._reap_abandoned_streams()
        sid = uuid.uuid4().hex
        with self._streams_lock:
            self._streams[sid] = (it, _time.time(), model_id)
        # a live stream IS an ongoing request: the generator body runs
        # during later stream_next pulls, after handle_request's finally
        # already decremented — re-count it until the stream completes
        # (stream_next done / cancel / abandoned-reap)
        self._track_ongoing(1)
        return {"__serve_stream__": sid, "status": status,
                "content_type": ctype, "pull": pull}

    def _reap_abandoned_streams(self, max_age_s: float = 600.0) -> None:
        """Drop streams whose client vanished without draining or
        cancelling — pop under the lock, close OUTSIDE it (a generator
        finally can block; it must not stall every concurrent stream on
        the replica).  Runs on every new stream registration AND from the
        controller's periodic check_health, so an idle replica's
        ongoing-request gauge cannot stay stuck on a phantom stream."""
        import time as _time
        with self._streams_lock:
            now = _time.time()
            reaped = [self._streams.pop(s) for s, entry in
                      list(self._streams.items())
                      if now - entry[1] > max_age_s]
        if reaped:
            self._track_ongoing(-len(reaped))
        for entry in reaped:
            close = getattr(entry[0], "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 - user finally raised
                    pass

    def _drive_asyncgen(self, agen, model_id: str = ""):
        from ray_tpu_torch.serve import multiplex as _mux

        async def _next():
            # async-gen body runs on the LOOP thread: establish the
            # multiplexed model id in that task's context per pull
            tok = _mux._set_model_id(model_id)
            try:
                return await agen.__anext__()
            finally:
                _mux._current_model_id.reset(tok)

        try:
            while True:
                fut = asyncio.run_coroutine_threadsafe(_next(), self._loop)
                try:
                    yield fut.result()
                except StopAsyncIteration:
                    return
        finally:
            # closing this sync wrapper (stream_cancel / abandoned-stream
            # reap) must also close the UNDERLYING async generator so
            # ``finally`` blocks in the deployment body run now — aclose
            # has to execute on the loop thread that owns the agen
            try:
                asyncio.run_coroutine_threadsafe(
                    agen.aclose(), self._loop).result(timeout=5)
            except Exception:  # noqa: BLE001 - already closed / loop gone
                pass

    def stream_next(self, sid: str, max_chunks: int = 16):
        """Pull up to ``max_chunks`` items; returns (chunks, done).

        If the stream object implements ``__serve_poll__(max_chunks)``
        — returning (ready_chunks, done) without blocking until
        ``max_chunks`` items EXIST — it is preferred over ``next()``:
        a latency-bound producer (serve.llm decode loop) then occupies
        this actor thread only until the first chunk (bounded wait),
        not for ``max_chunks`` production steps, and an idle stream
        returns ``([], False)`` so hundreds of pending streams cannot
        starve the replica's thread pool out of serving new requests."""
        import time as _time

        from ray_tpu_torch.serve import multiplex as _mux
        with self._streams_lock:
            entry = self._streams.get(sid)
        if entry is None:
            return [], True
        it, _, model_id = entry
        chunks, done = [], False
        token = _mux._set_model_id(model_id)
        try:
            try:
                poll = getattr(it, "__serve_poll__", None)
                if poll is not None:
                    chunks, done = poll(max_chunks)
                    chunks = list(chunks)
                else:
                    for _ in range(max_chunks):
                        try:
                            chunks.append(next(it))
                        except StopIteration:
                            done = True
                            break
            except BaseException:
                # a producer failure (e.g. the llm engine failing the
                # request) ends the stream NOW: deregister and release
                # the ongoing-request slot instead of pinning both
                # until the 600s abandoned-stream reap
                with self._streams_lock:
                    popped = self._streams.pop(sid, None)
                if popped is not None:
                    self._track_ongoing(-1)
                    close = getattr(popped[0], "close", None)
                    if close is not None:
                        try:
                            close()
                        except Exception:  # noqa: BLE001 - already dead
                            pass
                raise
        finally:
            _mux._current_model_id.reset(token)
        popped = None
        with self._streams_lock:
            if done:
                popped = self._streams.pop(sid, None)
            elif sid in self._streams:
                self._streams[sid] = (it, _time.time(), model_id)
        if popped is not None:
            self._track_ongoing(-1)  # stream drained: no longer ongoing
        return chunks, done

    def stream_cancel(self, sid: str) -> bool:
        """Drop a stream's generator without draining it (e.g. the unary
        gRPC ingress rejecting a streaming result); closes the generator
        so ``finally`` blocks in the deployment body run now, not at the
        600s abandoned-stream reap."""
        with self._streams_lock:
            entry = self._streams.pop(sid, None)
        if entry is None:
            return False
        self._track_ongoing(-1)  # cancelled stream: no longer ongoing
        it = entry[0]
        close = getattr(it, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001 - user finally raised
                pass
        return True

    def check_health(self) -> bool:
        self._reap_abandoned_streams()  # periodic gauge/stream hygiene
        chk = getattr(self._instance, "check_health", None)
        if chk is not None:
            chk()
        return True

    def prepare_shutdown(self) -> bool:
        """Graceful drain hook: user ``__del__``-style cleanup before kill."""
        hook = getattr(self._instance, "shutdown", None)
        if callable(hook):
            try:
                hook()
            except Exception:  # noqa: BLE001 - best-effort drain
                pass
        return True
