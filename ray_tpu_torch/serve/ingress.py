"""FastAPI-style ingress routing (``@serve.ingress``).

Reference: ``python/ray/serve/api.py::ingress`` — the reference mounts a
FastAPI/ASGI app inside the ingress replica so HTTP routes map to
decorated METHODS of the deployment class instead of one ``__call__``.
This image ships no FastAPI/Starlette, so the same surface is provided
ASGI-free:

- :class:`HTTPApp` — a minimal router with ``@app.get/post/put/delete``
  decorators and ``{param}`` path captures (the subset of FastAPI's
  decorator API the reference pattern uses);
- :func:`ingress` — the class decorator wiring the router in: it
  installs a ``__call__(request)`` that dispatches on (method, path)
  against the proxy's :class:`~ray_tpu_torch.serve.http_util.Request`.

A genuine FastAPI app object also works if the library is present —
dispatch duck-types ``app.routes`` (``path``/``methods``/``endpoint``),
though sync endpoints only (no ASGI loop in the replica).

Usage::

    app = serve.HTTPApp()

    @serve.deployment
    @serve.ingress(app)
    class Api:
        @app.get("/items/{item_id}")
        def get_item(self, item_id: str):
            return {"id": item_id}

        @app.post("/items")
        def create(self, request):
            return {"made": request.json()}
"""

from __future__ import annotations

import inspect
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.serve.http_util import Request, Response

_PARAM_RE = re.compile(r"\{([a-zA-Z_][a-zA-Z0-9_]*)\}")


class _Route:
    def __init__(self, method: str, path: str, fn: Callable):
        self.method = method.upper()
        self.path = path
        self.fn = fn
        # literal segments are ESCAPED ("/metrics.json" must not match
        # "/metricsXjson"); only {param} tokens become capture groups
        norm = path.rstrip("/") or "/"
        parts, pos = [], 0
        for m in _PARAM_RE.finditer(norm):
            parts.append(re.escape(norm[pos:m.start()]))
            parts.append(f"(?P<{m.group(1)}>[^/]+)")
            pos = m.end()
        parts.append(re.escape(norm[pos:]))
        self._re = re.compile(f"^{''.join(parts)}/?$")

    def match(self, method: str, path: str) -> Optional[Dict[str, str]]:
        if method != self.method:
            return None
        m = self._re.match(path or "/")
        if m is None:
            return None
        # percent-decode captures: query params arrive decoded (parse_qsl
        # in Request.from_parts), path params must match — and FastAPI,
        # which this API mirrors, decodes them too
        from urllib.parse import unquote
        return {k: unquote(v) for k, v in m.groupdict().items()}


class HTTPApp:
    """Decorator-style route table (the FastAPI surface ``ingress``
    consumes, minus ASGI)."""

    def __init__(self):
        self.routes: List[_Route] = []

    def route(self, path: str, methods: Tuple[str, ...] = ("GET",)):
        def deco(fn: Callable) -> Callable:
            for m in methods:
                self.routes.append(_Route(m, path, fn))
            return fn
        return deco

    def get(self, path: str):
        return self.route(path, ("GET",))

    def post(self, path: str):
        return self.route(path, ("POST",))

    def put(self, path: str):
        return self.route(path, ("PUT",))

    def delete(self, path: str):
        return self.route(path, ("DELETE",))


def _iter_routes(app: Any):
    """Normalize HTTPApp and FastAPI-like apps to (method, path, fn)."""
    if isinstance(app, HTTPApp):
        for r in app.routes:
            yield r
        return
    for r in getattr(app, "routes", ()):   # duck-typed FastAPI/Starlette
        path = getattr(r, "path", None)
        fn = getattr(r, "endpoint", None)
        if path is None or fn is None:
            continue
        for m in (getattr(r, "methods", None) or ("GET",)):
            yield _Route(m, path, fn)


def _call_handler(fn: Callable, instance: Any, request: Request,
                  path_params: Dict[str, str]) -> Any:
    """Bind path params / query params / the request object by NAME, the
    FastAPI convention (sans pydantic coercion: values arrive as str)."""
    sig = inspect.signature(fn)
    kwargs: Dict[str, Any] = {}
    for name, p in sig.parameters.items():
        if name == "self":
            continue
        if name in path_params:
            kwargs[name] = path_params[name]
        elif name == "request":
            kwargs[name] = request
        elif name in request.query_params:
            kwargs[name] = request.query_params[name]
        elif p.default is not inspect.Parameter.empty:
            continue
        elif p.kind in (inspect.Parameter.VAR_KEYWORD,
                        inspect.Parameter.VAR_POSITIONAL):
            continue
        else:
            raise TypeError(
                f"route handler {fn.__name__}: required parameter "
                f"{name!r} not found in path or query")
    out = fn(instance, **kwargs)
    if inspect.iscoroutine(out):
        # async handlers: the ingress __call__ is sync (the replica
        # dispatches on the METHOD being a coroutine function, and
        # __call__ isn't one) — drive the coroutine here, blocking this
        # executor thread exactly like a sync handler would
        import asyncio
        return asyncio.run(out)
    return out


def ingress(app: Any) -> Callable[[type], type]:
    """Class decorator: route HTTP requests to ``app``-decorated methods.

    The proxy invokes the ingress deployment's ``__call__(request)``;
    this installs one that dispatches on (method, path) and 404s
    unmatched routes.  Methods remain directly callable through handles
    and the gRPC proxy (they are plain methods; only HTTP routing is
    added)."""

    def wrap(cls: type) -> type:
        if not inspect.isclass(cls):
            raise TypeError("@serve.ingress decorates a class (put it "
                            "UNDER @serve.deployment)")
        # snapshot here, NOT in ingress(): decorator EXPRESSIONS evaluate
        # before the class body runs, so the @app.get registrations only
        # exist once wrap() is applied to the finished class
        routes = list(_iter_routes(app))

        def __call__(self, request):
            if not isinstance(request, Request):
                raise TypeError(
                    "ingress deployments take HTTP requests; call methods "
                    "directly via a handle for non-HTTP use")
            for r in routes:
                params = r.match(request.method, request.path)
                if params is not None:
                    return _call_handler(r.fn, self, request, params)
            return Response(
                body={"error": f"no route for "
                               f"{request.method} {request.path}"},
                status_code=404, content_type="application/json")

        cls.__call__ = __call__
        cls.__serve_http_app__ = app
        return cls

    return wrap
