"""HTTP request/response types handed to Serve ingress deployments.

Reference: Ray Serve hands Starlette ``Request`` objects to ingress
replicas (``python/ray/serve/_private/http_util.py``).  This framework has
no ASGI dependency; the proxy parses HTTP itself and passes this small
picklable ``Request`` to the ingress replica over the actor plane.
"""

from __future__ import annotations

import dataclasses
import json as _json
from typing import Dict, Optional
from urllib.parse import parse_qsl, urlsplit


@dataclasses.dataclass
class Request:
    method: str
    path: str                       # path with the route prefix stripped
    raw_path: str                   # full path as received
    query_params: Dict[str, str]
    headers: Dict[str, str]
    body: bytes = b""

    def json(self):
        return _json.loads(self.body or b"null")

    def text(self) -> str:
        return (self.body or b"").decode("utf-8", errors="replace")

    @classmethod
    def from_parts(cls, method: str, target: str, headers: Dict[str, str],
                   body: bytes, route_prefix: str) -> "Request":
        parts = urlsplit(target)
        path = parts.path
        stripped = path[len(route_prefix):] if (
            route_prefix != "/" and path.startswith(route_prefix)) else path
        if not stripped.startswith("/"):
            stripped = "/" + stripped
        return cls(method=method.upper(), path=stripped, raw_path=path,
                   query_params=dict(parse_qsl(parts.query)),
                   headers={k.lower(): v for k, v in headers.items()},
                   body=body)


def match_route(path: str, routes: Dict[str, object]):
    """Longest-prefix route match → (prefix, value) or None.

    Shared by the HTTP proxy's route table and DAGDriver so prefix
    semantics (exact match, or prefix + "/" boundary, "/" catches all)
    can never diverge between the two dispatchers."""
    best = None
    for prefix, value in routes.items():
        if prefix == "/" or path == prefix or path.startswith(
                prefix if prefix.endswith("/") else prefix + "/"):
            if best is None or len(prefix) > len(best[0]):
                best = (prefix, value)
    return best


@dataclasses.dataclass
class Response:
    """Explicit response; any other return value is coerced (see coerce)."""

    body: object = b""
    status_code: int = 200
    content_type: Optional[str] = None

    def encode(self) -> "Response":
        if isinstance(self.body, bytes):
            ct = self.content_type or "application/octet-stream"
            return Response(self.body, self.status_code, ct)
        if isinstance(self.body, str):
            ct = self.content_type or "text/plain; charset=utf-8"
            return Response(self.body.encode(), self.status_code, ct)
        return Response(_json.dumps(self.body).encode(), self.status_code,
                        self.content_type or "application/json")


class StreamingResponse:
    """Incremental response (reference: ``StreamingResponse``): ``content``
    is any iterable/generator; chunks reach the client as produced —
    HTTP clients via chunked transfer encoding, handle callers as a
    generator from ``DeploymentResponse.result()``.

    ``pull_chunks`` caps the chunks one continuation pull returns.  For
    plain iterators each pull blocks until that many chunks (or the
    end), so 16 amortizes round trips for bulk streams.  Producer-paced
    streams should implement ``__serve_poll__(max_chunks)`` on the
    content object instead (see ``Replica.stream_next``): a poll
    returns whatever is READY — first chunk the moment it exists,
    never parking a replica thread until ``pull_chunks`` items have
    been produced — and ``pull_chunks`` only bounds the drain."""

    def __init__(self, content, content_type: str = "text/plain",
                 status_code: int = 200, pull_chunks: int = 16):
        self.content = content
        self.content_type = content_type
        self.status_code = status_code
        self.pull_chunks = max(1, int(pull_chunks))


def encode_chunk(chunk: object) -> bytes:
    if isinstance(chunk, bytes):
        return chunk
    if isinstance(chunk, str):
        return chunk.encode()
    return _json.dumps(chunk).encode()


def coerce_response(value: object) -> Response:
    if isinstance(value, Response):
        return value.encode()
    return Response(value).encode()
