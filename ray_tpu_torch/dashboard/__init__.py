"""Dashboard-lite: a JSON/Prometheus HTTP endpoint over cluster state.

Reference: ``python/ray/dashboard/`` (SURVEY.md §2.3) — aiohttp server +
React UI.  This build keeps the API surface (REST endpoints over live
cluster state, Prometheus metrics) and serves a single-file vanilla-JS
UI (``_index.py``) instead of a TypeScript build; everything is stdlib
``http.server`` on a thread.

Endpoints:
  GET /                    — live UI (summary tiles + tabbed tables)
  GET /api/cluster_summary — nodes/resources/tasks/actors/objects rollup
  GET /api/nodes|actors|tasks|objects|workers|placement_groups
  GET /api/timeline        — Chrome trace JSON
  GET /metrics             — Prometheus exposition (cluster-merged)
  GET /metrics/history     — head-TSDB range query (?series=<expr>
                             [&window=600][&step=10]; DESIGN.md §4k) —
                             history + the UI's sparkline feed
  GET /profile/flame       — continuous-profiling flamegraph SVG
                             (?window=5m[&proc=ROLE:PID]; DESIGN.md §4o)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_server: Optional[ThreadingHTTPServer] = None


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj) -> None:
        self._send(200, json.dumps(obj, indent=2, default=str).encode(),
                   "application/json")

    def do_GET(self):  # noqa: N802 - http.server API
        from ray_tpu_torch.util import metrics, state
        try:
            if self.path == "/metrics":
                text = metrics.prometheus_text(metrics.collect_cluster())
                self._send(200, text.encode(), "text/plain; version=0.0.4")
            elif self.path.startswith("/metrics/history"):
                # TSDB range query (DESIGN.md §4k): the UI's sparkline
                # feed.  ?series=<expr>[&window=600][&step=10] — the
                # expression is instant-evaluated at each step over the
                # trailing window.
                import time as _time
                from urllib.parse import parse_qs, urlparse
                qs = parse_qs(urlparse(self.path).query)
                expr = (qs.get("series") or qs.get("expr") or [None])[0]
                if not expr:
                    self._send(400, b"missing ?series=<expr>",
                               "text/plain")
                    return
                try:
                    window = float((qs.get("window") or ["600"])[0])
                    step = float((qs.get("step") or [str(max(
                        window / 60.0, 1.0))])[0])
                except ValueError:
                    self._send(400, b"window/step must be numbers",
                               "text/plain")
                    return
                end = _time.time()
                from ray_tpu_torch.util.tsdb import QueryError
                try:
                    rows = state.metrics_history(
                        expr, start=end - window, end=end, step=step)
                except QueryError as e:
                    # only a malformed expression is the CLIENT's fault;
                    # RPC/head failures fall to the outer 500 handler
                    self._send(400, f"bad expression: {e}".encode(),
                               "text/plain")
                    return
                self._json({"expr": expr, "window_s": window,
                            "step_s": step, "results": rows})
            elif self.path.startswith("/profile/flame"):
                # continuous-profiling flamegraph (DESIGN.md §4o):
                # ?window=<dur>[&proc=ROLE:PID] → inline SVG over the
                # head ProfileStore's trailing window.
                from urllib.parse import parse_qs, urlparse
                from ray_tpu_torch.util import profiler as profiler_mod
                from ray_tpu_torch.util.tsdb import QueryError
                qs = parse_qs(urlparse(self.path).query)
                try:
                    window = profiler_mod.parse_duration(
                        (qs.get("window") or ["5m"])[0])
                    resp = state.profile(
                        window_s=window,
                        proc=(qs.get("proc") or [None])[0])
                except QueryError as e:
                    self._send(400, f"bad query: {e}".encode(),
                               "text/plain")
                    return
                if resp.get("disabled"):
                    self._send(404, b"profiler disabled on head",
                               "text/plain")
                    return
                svg = profiler_mod.render_flame_svg(
                    resp.get("stacks", {}),
                    title=f"ray_tpu_torch flame — {window:.0f}s window, "
                          f"{resp.get('samples', 0)} samples")
                self._send(200, svg.encode(), "image/svg+xml")
            elif self.path == "/api/cluster_summary":
                self._json(state.cluster_summary())
            elif self.path == "/api/nodes":
                self._json(state.list_nodes())
            elif self.path == "/api/actors":
                self._json(state.list_actors())
            elif self.path == "/api/tasks":
                self._json(state.list_tasks())
            elif self.path == "/api/objects":
                self._json(state.list_objects())
            elif self.path == "/api/workers":
                self._json(state.list_workers())
            elif self.path == "/api/placement_groups":
                self._json(state.list_placement_groups())
            elif self.path == "/api/timeline":
                import ray_tpu_torch
                self._json(ray_tpu_torch.timeline())
            elif self.path == "/api/logs":
                self._json(_list_logs())
            elif self.path.startswith("/api/logs/"):
                from urllib.parse import parse_qs, urlparse
                u = urlparse(self.path)
                name = u.path[len("/api/logs/"):]
                try:
                    tail = int(parse_qs(u.query).get("tail", ["200"])[0])
                except ValueError:
                    self._send(400, b"tail must be an integer",
                               "text/plain")
                    return
                text = _read_log(name, tail)
                if text is None:
                    self._send(404, b"no such log", "text/plain")
                else:
                    self._send(200, text.encode("utf-8", "replace"),
                               "text/plain")
            elif self.path == "/":
                from ray_tpu_torch.dashboard._index import INDEX_HTML
                self._send(200, INDEX_HTML.encode(), "text/html")
            else:
                self._send(404, b"not found", "text/plain")
        except Exception as e:  # noqa: BLE001
            self._send(500, str(e).encode(), "text/plain")


def _logs_dir():
    from ray_tpu_torch._private import worker as worker_mod
    w = worker_mod.try_global_worker()
    if w is None or w.session is None:
        return None
    return w.session.path / "logs"


def _list_logs():
    """Reference: the dashboard's per-node log listing (SURVEY.md §5.5)."""
    d = _logs_dir()
    if d is None or not d.is_dir():
        return []
    out = []
    for p in sorted(d.glob("*.log")):
        try:
            out.append({"name": p.name, "bytes": p.stat().st_size})
        except OSError:
            pass
    return out


def _read_log(name: str, tail: int):
    """Tail one session log file.  The name must resolve INSIDE the logs
    dir — a traversal path (../gcs_state/...) must 404, not read."""
    d = _logs_dir()
    if d is None:
        return None
    p = (d / name).resolve()
    if not str(p).startswith(str(d.resolve()) + "/") or not p.is_file():
        return None
    tail = max(1, min(tail, 10000))
    # bounded read: a multi-GB log must not be loaded whole to serve a
    # 200-line tail — seek back a generous per-line budget instead
    budget = tail * 4096
    with open(p, "rb") as f:
        f.seek(0, 2)
        size = f.tell()
        f.seek(max(0, size - budget))
        data = f.read()
    lines = data.decode("utf-8", "replace").splitlines()
    if size > budget and lines:
        lines = lines[1:]  # first line is likely a partial
    return "\n".join(lines[-tail:]) + "\n"


def start_dashboard(host: str = "127.0.0.1",
                    port: int = 8265) -> ThreadingHTTPServer:
    """Start the dashboard HTTP server (daemon thread); returns the server."""
    global _server
    srv = ThreadingHTTPServer((host, port), _Handler)
    threading.Thread(target=srv.serve_forever, name="dashboard",
                     daemon=True).start()
    _server = srv
    return srv


def stop_dashboard() -> None:
    global _server
    if _server is not None:
        _server.shutdown()
        _server = None
