"""gRPC proxy actor: binary ingress beside the HTTP proxy.

Reference: ``python/ray/serve/_private/grpc_util.py`` + the Serve 2.x
gRPC proxy — a second ingress for latency-sensitive callers (binary
framing, HTTP/2 multiplexing, no JSON coercion).  The reference requires
user-compiled protobuf servicers; this proxy instead registers a
GENERIC handler that accepts ANY unary-unary method, so callers need no
proto toolchain:

- the request payload is raw bytes, handed to the deployment as-is
  (codec=``bytes``) or unpickled first (metadata ``serve-codec:
  pickle``).  The pickle codec executes arbitrary code on load, so it
  is DISABLED unless the server opts in with
  ``gRPCOptions(allow_pickle=True)`` — only for trusted callers;
- the target application is named by the ``application`` metadata key
  (reference contract) — absent, the method path's service name is
  tried as an app name, then the lone app wins;
- the called deployment method is the final path segment (``/Pkg.Svc/
  Predict`` → ``Predict``) when the ingress class defines it, else
  ``__call__``;
- ``multiplexed_model_id`` metadata routes model-affine (multiplex.py).

Start it with ``serve.start(grpc_options=gRPCOptions(port=...))`` or by
passing ``grpc_options`` to ``serve.run``.
"""

from __future__ import annotations

import pickle
import threading
import time
from concurrent import futures
from typing import Optional

import ray_tpu_torch
from ray_tpu_torch._private import rtlog
from ray_tpu_torch.serve.handle import DeploymentHandle, get_controller

logger = rtlog.get("serve.grpc")


class GrpcProxyActor:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 request_timeout_s: float = 120.0, max_workers: int = 32,
                 allow_pickle: bool = False):
        import grpc

        self._controller = get_controller()
        self._timeout = request_timeout_s
        self._allow_pickle = allow_pickle
        # 1s-TTL caches (same pattern as the HTTP proxy's route table):
        # the hot path must not pay a controller RPC per request
        self._apps: dict = {}
        self._apps_ts = 0.0
        self._methods: dict = {}      # (dep_key, version, name) -> bool
        self._cache_lock = threading.Lock()
        proxy = self

        class _Generic(grpc.GenericRpcHandler):
            def service(self, call_details):
                method = call_details.method
                meta = {k: v for k, v in
                        (call_details.invocation_metadata or ())}

                def unary(request: bytes, context):
                    return proxy._handle(method, meta, request, context)

                return grpc.unary_unary_rpc_method_handler(
                    unary,
                    request_deserializer=None,    # raw bytes in
                    response_serializer=None)     # raw bytes out

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        self._server.add_generic_rpc_handlers((_Generic(),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self.host = host
        self._server.start()
        ray_tpu_torch.get(self._controller.set_grpc_address.remote(
            self.host, self.port))
        logger.info("grpc proxy listening on %s:%d", host, self.port)

    def address(self) -> tuple:
        return (self.host, self.port)

    def get_allow_pickle(self) -> bool:
        return self._allow_pickle

    # ---------------------------------------------------------------- routing
    def _apps_cached(self) -> dict:
        if time.monotonic() - self._apps_ts > 1.0:
            # cold start (empty map) blocks ALL callers on the first
            # fetch — a non-blocking loser returning {} would abort a
            # deployed app's request with a spurious NOT_FOUND; once
            # warm, losers serve the stale map without waiting
            if self._cache_lock.acquire(blocking=not self._apps):
                try:
                    self._apps = ray_tpu_torch.get(
                        self._controller.list_app_ingress.remote(),
                        timeout=10)
                    self._apps_ts = time.monotonic()
                except Exception:  # noqa: BLE001 - keep the stale map
                    pass
                finally:
                    self._cache_lock.release()
            elif not self._apps:
                # lost the cold-start race: wait for the winner's fetch
                with self._cache_lock:
                    pass
        return self._apps

    def _resolve(self, method: str, meta: dict) -> Optional[str]:
        """(method path, metadata) → ingress dep_key."""
        apps = self._apps_cached()
        if not apps:
            return None
        app = meta.get("application")
        if app is None and "/" in method:
            svc = method.rsplit("/", 2)[-2]        # "Pkg.Svc"
            tail = svc.rsplit(".", 1)[-1]
            if tail in apps:
                app = tail
        if app is None and len(apps) == 1:
            app = next(iter(apps))
        dep = apps.get(app or "")
        return f"{app}#{dep}" if dep else None

    def _handle(self, method: str, meta: dict, request: bytes, context):
        import grpc
        dep_key = self._resolve(method, meta)
        if dep_key is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"no application for {method!r} "
                          f"(set 'application' metadata)")
        codec = meta.get("serve-codec", "bytes")
        if codec == "pickle" and not self._allow_pickle:
            # pickle.loads on caller-supplied bytes is code execution;
            # require the server-side opt-in (gRPCOptions.allow_pickle)
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "the pickle codec is disabled on this proxy; start serve "
                "with gRPCOptions(allow_pickle=True) to enable it for "
                "trusted callers")
        try:
            payload = pickle.loads(request) if codec == "pickle" else request
        except Exception as e:  # noqa: BLE001
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"bad {codec} payload: {e}")
        call = method.rsplit("/", 1)[-1] or "__call__"
        handle = DeploymentHandle(dep_key)
        router = handle._router()
        target = call if self._dep_has_method(router, call) else "__call__"
        try:
            # request_timeout_s bounds BOTH phases (replica assignment +
            # result wait), matching the HTTP proxy's contract
            start = time.monotonic()
            resp = router.assign(
                target, (payload,), {}, timeout_s=self._timeout,
                multiplexed_model_id=meta.get("multiplexed_model_id", ""))
            remaining = max(0.1, self._timeout -
                            (time.monotonic() - start))
            # raw value, NOT resp.result(): result() turns a stream
            # marker into a live generator, which a unary response
            # cannot carry — we need the marker to reject + cancel
            result = ray_tpu_torch.get(resp._to_object_ref(),
                                 timeout=remaining)
        except ray_tpu_torch.exceptions.RayServeError as e:
            context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        except Exception as e:  # noqa: BLE001 - user code raised
            context.abort(grpc.StatusCode.INTERNAL, str(e)[:500])
        if isinstance(result, dict) and "__serve_stream__" in result:
            # streaming deployments need a pull loop against the owning
            # replica; unary gRPC has nowhere to put it — reject cleanly
            # (and free the replica-side generator entry) instead of
            # leaking the stream until the idle reap
            handle = None
            with router._lock:
                handle = router._replicas.get(resp._replica_tag)
            if handle is not None:
                try:
                    handle.stream_cancel.remote(result["__serve_stream__"])
                except Exception:  # noqa: BLE001 - replica may be gone
                    pass
            context.abort(
                grpc.StatusCode.UNIMPLEMENTED,
                "streaming deployments are not supported over the unary "
                "gRPC ingress; use the HTTP proxy or a handle")
        if codec == "pickle":
            try:
                return pickle.dumps(result)
            except Exception as e:  # noqa: BLE001 - unpicklable result
                context.abort(
                    grpc.StatusCode.INTERNAL,
                    f"result of type {type(result).__name__} is not "
                    f"picklable: {str(e)[:200]}")
        if isinstance(result, (bytes, bytearray, memoryview)):
            return bytes(result)
        if isinstance(result, str):
            return result.encode()
        # structured result over the bytes codec: JSON, matching the
        # HTTP proxy's coercion (numpy results need the pickle codec)
        import json
        try:
            return json.dumps(result).encode()
        except TypeError as e:
            context.abort(
                grpc.StatusCode.INTERNAL,
                f"result of type {type(result).__name__} is not JSON-"
                f"serializable over the bytes codec ({e}); use metadata "
                f"serve-codec=pickle or return bytes/str")

    def _dep_has_method(self, router, name: str) -> bool:
        if name in ("", "__call__"):
            return False
        # keyed by the router's deployment VERSION so a redeploy that
        # adds/removes the method is picked up (the router refreshes its
        # version from the controller every report interval)
        key = (router.dep_key, router._version, name)
        with self._cache_lock:
            if key in self._methods:
                return self._methods[key]
        has = bool(ray_tpu_torch.get(
            self._controller.ingress_has_method.remote(router.dep_key,
                                                       name)))
        with self._cache_lock:
            if len(self._methods) > 4096:
                self._methods.clear()
            self._methods[key] = has
        return has

    def shutdown(self) -> bool:
        self._server.stop(grace=0.5)
        return True
