"""Actor-side method server.

Reference: the actor path of ``CoreWorker`` task receiving
(``ActorTaskSubmitter`` peer; SURVEY.md §3.3): callers connect directly to
the actor's worker, calls execute in arrival order (single-threaded by
default; ``max_concurrency>1`` → thread pool; async methods run on a
dedicated event loop), results go back on the caller connection (fast path)
and are sealed with the GCS (authoritative path) so any process can get them.
"""

from __future__ import annotations

import asyncio
import inspect
import os
import queue
import threading
import time
from typing import Any, List, Optional

from ray_tpu_torch._private import protocol, rtlog
from ray_tpu_torch.util import metrics_catalog as mcat
from ray_tpu_torch.util import tracing
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.serialization import serialize_to_bytes
from ray_tpu_torch import exceptions as exc

logger = rtlog.get("actor")


class ActorExit(SystemExit):
    """Raised by exit_actor() inside a method to terminate gracefully."""


class ActorServer:
    def __init__(self, worker, spec: dict, instance: Any):
        self.worker = worker
        self.spec = spec
        self.instance = instance
        self.actor_id = spec["actor_id"]
        self.max_concurrency = int(spec.get("max_concurrency") or 1)
        if worker.session is None:
            # remote-agent host: no shared session dir, and a unix socket
            # would be unreachable from other hosts — listen on an
            # ephemeral TCP port and advertise this host's address
            # (RTT_ADVERTISE_HOST, set by the NodeAgent)
            self._listener = protocol.make_tcp_actor_listener()
            host = os.environ.get("RTT_ADVERTISE_HOST", "127.0.0.1")
            self.addr = f"tcp://{host}:{self._listener.address[1]}"
        else:
            sock_name = f"a_{self.actor_id[:12]}_{os.getpid()}.sock"
            self.addr = worker.session.socket_path(sock_name)
            self._listener = protocol.make_listener(self.addr)
        try:
            self._queue: "queue.Queue" = queue.Queue()
            self._send_lock = threading.Lock()  # replies come from executor
            # threads AND the asyncio loop; Connection.send isn't
            # thread-safe.
            # Serial actors (max_concurrency=1) execute calls directly on
            # the connection-reader thread under _exec_lock instead of
            # hopping through the queue to the executor thread: one fewer
            # thread handoff per call (~2 GIL wakeups) on the serial-RT
            # hot path.  The lock preserves the one-call-at-a-time
            # contract across multiple caller connections exactly as the
            # single executor thread did.
            self._exec_lock = threading.Lock()
            self._direct_exec = self.max_concurrency == 1
            self._stopped = threading.Event()
            self._loop: Optional[asyncio.AbstractEventLoop] = None
            if any(inspect.iscoroutinefunction(
                    getattr(type(instance), m, None))
                   for m in dir(type(instance))):
                self._loop = asyncio.new_event_loop()
                threading.Thread(target=self._loop.run_forever,
                                 name="actor-asyncio", daemon=True).start()
            threading.Thread(target=self._accept_loop, name="actor-accept",
                             daemon=True).start()
        except BaseException:
            # a failed boot returns no server: the caller cannot close
            # the listener it never received (an actor-creation retry
            # would otherwise leak one bound port/socket per attempt)
            self._listener.close()
            raise

    # ------------------------------------------------------------- transport
    def _accept_loop(self) -> None:
        # TCP listeners are internet-facing on remote-agent hosts, so
        # half-open probes and port scans hit this accept path routinely.
        protocol.serve_accept_loop(self._listener, self._stopped.is_set,
                                   self._conn_reader, "actor-conn-reader")

    def _conn_reader(self, conn) -> None:
        try:
            while not self._stopped.is_set():
                try:
                    # rtlint: blocks-ok(parks between a caller's method
                    # invocations; caller death EOFs the conn — peer
                    # liveness is the deadline, per-conn thread)
                    msg = conn.recv()
                except (EOFError, OSError):
                    return
                if not self._direct_exec:
                    self._queue.put((conn, msg))
                    continue
                try:
                    with self._exec_lock:
                        self._handle_call(conn, msg)
                except ActorExit:
                    self._shutdown()
                    return
                except Exception:  # noqa: BLE001
                    # _handle_call replies its own errors, so reaching
                    # here means the REPLY machinery failed and the
                    # conn's framing state is unknown: tear it down so
                    # the caller sees EOF (→ actor-error/resubmit path),
                    # never an infinite hang on a swallowed dispatch
                    logger.exception("actor call handling failed")
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def serve_forever(self) -> None:
        if self.max_concurrency > 1:
            threads = [threading.Thread(target=self._exec_loop, daemon=True,
                                        name=f"actor-exec-{i}")
                       for i in range(self.max_concurrency - 1)]
            for t in threads:
                t.start()
        self._exec_loop()

    def _exec_loop(self) -> None:
        while not self._stopped.is_set():
            # rtlint: blocks-ok(parks until work arrives; _shutdown
            # enqueues a None sentinel per exec thread, so stop always
            # wakes the get — the sentinel is the deadline)
            item = self._queue.get()
            if item is None:
                return
            conn, msg = item
            try:
                self._handle_call(conn, msg)
            except ActorExit:
                self._shutdown()
                return
            except Exception:  # noqa: BLE001
                # reply machinery failed (handlers reply their own
                # errors): EOF the caller instead of stranding it
                logger.exception("actor call handling failed")
                try:
                    conn.close()
                except OSError:
                    pass

    # -------------------------------------------------------------- execution
    def _run_method(self, method_name: str, args: list, kwargs: dict) -> Any:
        if method_name == "__ray_terminate__":
            raise ActorExit(0)
        if method_name == "__ray_ready__":
            return True
        if method_name == "__ray_apply__":
            # Run an arbitrary function against the actor instance (reference:
            # ``__ray_call__``): fn(instance, *args, **kwargs).  Used by the
            # collective layer and Train's WorkerGroup to execute code inside
            # an existing actor without the user declaring a method for it.
            fn, *rest = args
            return fn(self.instance, *rest, **kwargs)
        method = getattr(self.instance, method_name)
        if inspect.iscoroutinefunction(method):
            if self._loop is None:
                return asyncio.run(method(*args, **kwargs))
            # handled by _handle_call's async fast path; reaching here means
            # a coroutine method was invoked via __ray_apply__ — block, as
            # there is no conn to reply on later
            fut = asyncio.run_coroutine_threadsafe(
                method(*args, **kwargs), self._loop)
            return fut.result()
        return method(*args, **kwargs)

    async def _run_async_call(self, method, args, kwargs, conn, msg) -> None:
        """Body of an async method call: only the await runs ON the event
        loop (no executor thread parked while the coroutine waits); result
        serialization, sealing, and the reply — all blocking I/O — are
        handed back to a thread so parked coroutines never stall behind
        them.  BaseException (incl. ActorExit) must be caught here: an
        unobserved exception in the loop future would hang the caller."""
        value = err = None
        try:
            value = await method(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001
            err = e
        asyncio.get_running_loop().run_in_executor(
            None, self._complete_async_call, conn, msg, value, err)

    def _observe_call(self, msg: dict, t0: Optional[float]) -> None:
        """Actor methods feed the same exec histogram as plain tasks,
        tagged ``Class.method`` — one series family for 'where did the
        worker's time go' across both execution paths.  Control-plane
        methods (``__ray_ready__``, ``__ray_terminate__``, ...) are
        excluded: their durations measure bring-up/teardown round-trips,
        not user work, and would add a control series per class."""
        method = msg.get("method", "?")
        if t0 is None or method.startswith("__ray_") \
                or not GLOBAL_CONFIG.metrics_enabled:
            return
        mcat.get("rtt_task_exec_seconds").observe(
            time.monotonic() - t0,
            tags={"name": f"{self.spec.get('class_name', 'Actor')}."
                          f"{method}"})

    def _complete_async_call(self, conn, msg, value, err) -> None:
        return_ids: List[str] = msg["return_ids"]
        w = self.worker
        try:
            try:
                self._observe_call(msg, msg.pop("_exec_t0", None))
                actx = msg.pop("_span_ctx", None)
                at0 = msg.pop("_span_t0", None)
                if actx is not None and at0 is not None:
                    tracing.emit_ctx_span(
                        actx,
                        f"{self.spec.get('class_name', 'Actor')}."
                        f"{msg.get('method', '?')}",
                        at0, time.time() - at0, cat="actor_task")
                if err is None:
                    try:
                        results = w._store_results(return_ids, value,
                                                   msg["num_returns"])
                        ok = True
                    except Exception as store_err:  # noqa: BLE001 - e.g.
                        # unpicklable result: the caller must still get a
                        # reply
                        err = store_err
                if err is not None:
                    if isinstance(err, ActorExit):
                        wrapped: BaseException = exc.RayActorError(
                            self.actor_id, "actor exited")
                    else:
                        wrapped = exc.RayTaskError.from_exception(
                            f"{self.spec.get('class_name', 'Actor')}."
                            f"{msg['method']}", err)
                    err_res = {"loc": "error",
                               "data": serialize_to_bytes(wrapped)[0]}
                    results = [err_res for _ in return_ids]
                    ok = False
                self._seal_and_reply(conn, msg, results, ok)
            except Exception:  # noqa: BLE001 - reply machinery failed.
                # This runs as a loop-submitted executor job: an escaping
                # exception lands in an unobserved Future — the caller
                # would hang forever.  EOF it instead.
                logger.exception("async actor call completion failed")
                try:
                    conn.close()
                except OSError:
                    pass
        finally:
            if isinstance(err, ActorExit):
                self._shutdown()

    def _handle_call(self, conn, msg: dict) -> None:
        return_ids: List[str] = msg["return_ids"]
        num_returns = msg["num_returns"]
        w = self.worker
        if msg.get("_resubmitted") and return_ids:
            # A resubmitted call may have COMPLETED on the previous
            # incarnation (results seal with the GCS before the inline
            # reply; death can race the reply).  The caller's own dedup
            # can miss seal events still in flight at disconnect time —
            # by the time the restarted actor executes, the GCS has
            # drained them, so this check is authoritative.  Prevents
            # re-executing finished methods on stateful actors.
            try:
                metas = w.rpc("peek_meta",
                              object_ids=return_ids).get("metas", {})
                if all(m and m.get("state") in ("ready", "error")
                       for m in metas.values()):
                    with self._send_lock:
                        conn.send({"call_id": msg["call_id"],
                                   "return_ids": return_ids,
                                   "inline_results": [None] * len(return_ids),
                                   "ok": True})
                    return
            except (OSError, EOFError):
                pass  # control plane hiccup: at-least-once fallback
        t_exec = time.monotonic()
        from ray_tpu_torch._private import flight_recorder
        if flight_recorder.enabled():
            flight_recorder.record(
                "actor_call",
                f"{self.spec.get('class_name', 'Actor')}."
                f"{msg.get('method', '?')}")
        try:
            args, kwargs = w._unpack_args(msg)
            method_name = msg["method"]
            if self._loop is not None and method_name not in (
                    "__ray_terminate__", "__ray_ready__", "__ray_apply__"):
                method = getattr(self.instance, method_name, None)
                if method is not None and inspect.iscoroutinefunction(method):
                    msg["_exec_t0"] = t_exec
                    # span context flows into the coroutine: adopt the
                    # child span on THIS thread — run_coroutine_threadsafe
                    # captures the caller's contextvars — and stash it on
                    # the msg so _complete_async_call emits the event
                    aspan = tracing.SpanContext.from_dict(
                        msg.get("trace_ctx"))
                    tok = None
                    if aspan is not None:
                        ctx = tracing.child_span(aspan, method_name)
                        msg["_span_ctx"] = ctx
                        msg["_span_t0"] = time.time()
                        tok = tracing.adopt(ctx)
                    try:
                        asyncio.run_coroutine_threadsafe(
                            self._run_async_call(method, args, kwargs,
                                                 conn, msg),
                            self._loop)
                    finally:
                        if tok is not None:
                            tracing.restore(tok)
                    # executor thread freed; the reply obligation moves to
                    # the event loop (_run_async_call → _complete_async_call
                    # replies or tears the conn down on every path)
                    # rtlint: reply-missing-ok(deferred reply via event loop)
                    return
            span = tracing.SpanContext.from_dict(msg.get("trace_ctx"))
            if span is not None:
                # child span per method call; timeline events link back to
                # the caller's span (reference: ray.util.tracing).  The
                # event carries the SAME span id the method body saw, so
                # spans opened inside (engine submits, nested calls)
                # parent correctly; rows use the stable per-thread tid +
                # thread_name metadata (emit_ctx_span).
                t0 = time.time()
                tracing._set_span(tracing.child_span(span, method_name))
            try:
                value = self._run_method(method_name, args, kwargs)
            finally:
                if span is not None:
                    tracing.emit_ctx_span(
                        tracing.current_span(),
                        f"{self.spec.get('class_name', 'Actor')}."
                        f"{method_name}",
                        t0, time.time() - t0, cat="actor_task")
                    tracing._set_span(None)
            results = w._store_results(return_ids, value, num_returns)
            ok = True
        except ActorExit:
            err_res = {"loc": "error",
                       "data": serialize_to_bytes(
                           exc.RayActorError(self.actor_id, "actor exited"))[0]}
            results = [err_res for _ in return_ids]
            ok = False
            self._seal_and_reply(conn, msg, results, ok)
            raise
        except Exception as e:  # noqa: BLE001
            err = exc.RayTaskError.from_exception(
                f"{self.spec.get('class_name', 'Actor')}.{msg['method']}", e)
            err_res = {"loc": "error", "data": serialize_to_bytes(err)[0]}
            results = [err_res for _ in return_ids]
            ok = False
        self._observe_call(msg, t_exec)
        self._seal_and_reply(conn, msg, results, ok)

    def _seal_and_reply(self, conn, msg: dict, results: List[dict],
                        ok: bool) -> None:  # rtlint: replies
        w = self.worker
        # authoritative: seal with GCS (one-way on the worker's task channel)
        w._send_event({"kind": "actor_result", "return_ids": msg["return_ids"],
                       "results": results})
        # release the caller's in-flight arg pins
        if msg.get("arg_ledger"):
            w.rpc_oneway("release_all", ledger=msg["arg_ledger"])
        # fast path: inline values straight back to the caller (errors go via
        # the GCS so the caller's local cache never masks a raise)
        inline = [r.get("data") if r["loc"] == "inline" else None
                  for r in results]
        try:
            with self._send_lock:
                conn.send({"call_id": msg["call_id"],
                           "return_ids": msg["return_ids"],
                           "inline_results": inline, "ok": ok})
        except (OSError, ValueError):
            pass  # caller went away; results are in the GCS regardless

    def stop_serving(self) -> None:
        """Stop the server WITHOUT declaring an intentional exit: the
        ray_tpu_torch.kill path for proc-less (remote/raylet) actor workers —
        the control plane already recorded its own death reason and
        restart policy, and an actor_exit event here would wrongly
        suppress a no_restart=False restart."""
        self._stopped.set()
        try:
            self._listener.close()
        except OSError:
            pass
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        # unblock sibling exec threads
        for _ in range(self.max_concurrency):
            self._queue.put(None)

    def _shutdown(self) -> None:
        # tell the control plane this exit is intentional → no restart
        self.worker._send_event({"kind": "actor_exit", "actor_id": self.actor_id})
        self.stop_serving()


def exit_actor() -> None:
    """Terminate the current actor gracefully (reference: ray.actor.exit_actor)."""
    raise ActorExit(0)
