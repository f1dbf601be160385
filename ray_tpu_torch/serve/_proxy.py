"""HTTP proxy actor: socket in, deployment handle out.

Reference: ``python/ray/serve/_private/proxy.py`` (SURVEY.md §3.6) — the
proxy owns the HTTP listener, resolves the route prefix to an app's ingress
deployment, and forwards the request through a ``DeploymentHandle`` (whose
router does power-of-two-choices replica selection).  The reference runs
uvicorn/Starlette; here a stdlib ``ThreadingHTTPServer`` serves the same
role with zero dependencies — each connection thread blocks on the handle
result, giving natural per-connection backpressure.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ray_tpu_torch._private import rtlog
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.serve.handle import DeploymentHandle, get_controller
from ray_tpu_torch.serve.http_util import Request, coerce_response, match_route
from ray_tpu_torch.util import metrics_catalog as mcat

import ray_tpu_torch

logger = rtlog.get("serve.proxy")


def _observe_request(dep_key: str, status: int, t0: float) -> None:
    """Per-deployment data-plane series (reference: Serve's
    ``serve_deployment_request_counter`` / ``_processing_latency_ms``):
    recorded at the proxy so every HTTP outcome — success, timeout,
    no-replica 503, user 500 — lands in the same histogram."""
    if not GLOBAL_CONFIG.metrics_enabled:
        return
    # ``group`` is the cross-layer cohort label (same convention as the
    # train plane's rtt_train_step_seconds): serve/LLM series stamp the
    # deployment key so one selector ({group="X"}) follows a deployment
    # across proxy, handle, replica, and engine series.
    mcat.get("rtt_serve_request_latency_seconds").observe(
        time.monotonic() - t0,
        tags={"deployment": dep_key, "group": dep_key})
    mcat.get("rtt_serve_requests_total").inc(
        tags={"deployment": dep_key, "code": str(status),
              "group": dep_key})
    if status >= 500:
        mcat.get("rtt_serve_errors_total").inc(
            tags={"deployment": dep_key, "group": dep_key})


class ProxyActor:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 request_timeout_s: float = 120.0):
        self._controller = get_controller()
        self._routes: Dict[str, str] = {}
        self._routes_ts = 0.0
        self._refresh_lock = threading.Lock()
        self._timeout = request_timeout_s
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # noqa: A003
                logger.debug("http: " + fmt % args)

            def _dispatch(self):
                self.serve_response_started = False
                try:
                    proxy._handle(self)
                except BrokenPipeError:
                    self.close_connection = True
                except Exception as e:  # noqa: BLE001
                    if self.serve_response_started:
                        # Headers already on the wire: a second response
                        # would corrupt HTTP/1.1 framing — drop the conn.
                        self.close_connection = True
                        return
                    try:
                        body = f"internal error: {e}".encode()
                        self.send_response(500)
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    except OSError:
                        self.close_connection = True

            do_GET = do_POST = do_PUT = do_DELETE = do_PATCH = _dispatch

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        threading.Thread(target=self._server.serve_forever,
                         name="serve-http", daemon=True).start()
        ray_tpu_torch.get(self._controller.set_http_address.remote(
            self.host, self.port))
        logger.info("proxy listening on %s:%d", self.host, self.port)

    def address(self) -> tuple:
        return (self.host, self.port)

    # ---------------------------------------------------------------- routing
    def _get_routes(self) -> Dict[str, str]:
        # Serve the cached dict; at most ONE thread refreshes a stale cache
        # (non-blocking acquire) so a slow controller never stalls the
        # whole HTTP data plane behind a lock held across an RPC.
        if time.monotonic() - self._routes_ts > 1.0 and \
                self._refresh_lock.acquire(blocking=False):
            try:
                self._routes = ray_tpu_torch.get(
                    self._controller.get_routes.remote(), timeout=10)
                self._routes_ts = time.monotonic()
            except Exception:  # noqa: BLE001 - keep serving the stale map
                pass
            finally:
                self._refresh_lock.release()
        return self._routes

    def _match(self, path: str) -> Optional[tuple]:
        return match_route(path, self._get_routes())

    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        path = req.path.split("?")[0]
        if path == "/-/healthz":
            self._respond(req, 200, b"success", "text/plain")
            return
        if path == "/-/routes":
            body = json.dumps(self._get_routes()).encode()
            self._respond(req, 200, body, "application/json")
            return
        match = self._match(path)
        if match is None:
            self._respond(req, 404, b"no route matched", "text/plain")
            return
        prefix, dep_key = match
        # one HTTP request = one candidate trace root, sampled head-based
        # at trace_sample_rate; when sampled, the span context rides the
        # actor call to the replica (router → handle_request) and on into
        # the engine, so the whole proxy→router→replica→engine path is
        # ONE tree.  Streaming requests keep the span open until the last
        # chunk (the latency metric below still records TTFB).
        from ray_tpu_torch.util import tracing
        with tracing.request_trace(f"serve.{dep_key}", http_path=path,
                                   method=req.command):
            self._handle_routed(req, path, prefix, dep_key)

    def _handle_routed(self, req: BaseHTTPRequestHandler, path: str,
                       prefix: str, dep_key: str) -> None:
        length = int(req.headers.get("Content-Length") or 0)
        body = req.rfile.read(length) if length else b""
        request = Request.from_parts(req.command, req.path,
                                     dict(req.headers), body, prefix)
        handle = DeploymentHandle(dep_key)
        # reference header contract: serve_multiplexed_model_id routes to
        # a replica already holding that model (multiplex.py)
        model_id = req.headers.get("serve_multiplexed_model_id", "")
        start = time.monotonic()
        try:
            # The configured request timeout bounds BOTH phases: waiting
            # for a replica (assign) and waiting for the result.
            resp_f = handle._router().assign(
                "__call__", (request,), {}, timeout_s=self._timeout,
                multiplexed_model_id=model_id)
            remaining = max(0.1, self._timeout - (time.monotonic() - start))
            # raw result: a stream MARKER must reach the chunked-encoding
            # path below, not result()'s generator conversion
            result = ray_tpu_torch.get(resp_f._to_object_ref(),
                                 timeout=remaining)
        except ray_tpu_torch.exceptions.GetTimeoutError:
            _observe_request(dep_key, 408, start)
            self._respond(req, 408, b"request timed out", "text/plain")
            return
        except ray_tpu_torch.exceptions.RayServeError as e:
            _observe_request(dep_key, 503, start)
            self._respond(req, 503, str(e).encode(), "text/plain")
            return
        except Exception as e:  # noqa: BLE001 - user code raised
            _observe_request(dep_key, 500, start)
            self._respond(req, 500, str(e).encode(), "text/plain")
            return
        if isinstance(result, dict) and "__serve_stream__" in result:
            # streaming: the latency series records time-to-first-byte
            _observe_request(dep_key, result.get("status", 200), start)
            self._respond_stream(req, result, resp_f)
            return
        resp = coerce_response(result)
        _observe_request(dep_key, resp.status_code, start)
        self._respond(req, resp.status_code, resp.body, resp.content_type)

    @staticmethod
    def _respond_stream(req, marker: dict, resp_f) -> None:
        """Chunked transfer encoding fed by replica-side generator pulls
        (reference: Serve StreamingResponse over ASGI)."""
        from ray_tpu_torch.serve.http_util import encode_chunk
        req.serve_response_started = True
        req.send_response(marker.get("status", 200))
        req.send_header("Content-Type",
                        marker.get("content_type", "text/plain"))
        req.send_header("Transfer-Encoding", "chunked")
        req.end_headers()
        try:
            for chunk in resp_f._stream_chunks(marker["__serve_stream__"],
                                               marker.get("pull", 16)):
                b = encode_chunk(chunk)
                if not b:
                    continue  # empty chunk would terminate the encoding
                req.wfile.write(f"{len(b):x}\r\n".encode() + b + b"\r\n")
                req.wfile.flush()
            req.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away; replica reaper collects the stream

    @staticmethod
    def _respond(req, status: int, body: bytes, content_type: str) -> None:
        req.serve_response_started = True
        req.send_response(status)
        req.send_header("Content-Type", content_type)
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    def shutdown(self) -> bool:
        self._server.shutdown()
        return True
