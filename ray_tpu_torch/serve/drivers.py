"""DAGDriver: multi-route HTTP dispatch over a deployment graph.

Reference: ``python/ray/serve/drivers.py::DAGDriver`` (the Serve 2.x
graph-build API's ingress node): one driver deployment fronts several
bound sub-graphs, routing by path prefix —

    serve.run(DAGDriver.bind({"/a": ModelA.bind(), "/b": ModelB.bind()}))

Each value is an ordinary bound Application node, so the whole dict is
one composed graph (the controller deploys every referenced deployment;
the driver holds child handles).  HTTP requests dispatch to the child
whose route prefix matches the longest; non-HTTP callers can use
``predict(route, *args)`` through a handle, matching the reference's
``DAGDriver.predict`` contract.
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.serve.deployment import Deployment
from ray_tpu_torch.serve.http_util import Request, Response, match_route

# HTTP dispatch bound: matches the proxy's request_timeout_s default so
# a hung child cannot pin a driver replica slot forever
_CHILD_TIMEOUT_S = 120.0


def _norm_prefix(prefix: str) -> str:
    if not prefix.startswith("/"):
        prefix = "/" + prefix
    return prefix.rstrip("/") or "/"


def _validate_route_table(route_table: Any) -> None:
    """Raises at BIND time (driver side) — a replica-side failure would
    only surface as an opaque not-ready deploy timeout."""
    if not isinstance(route_table, dict) or not route_table:
        raise TypeError(
            "DAGDriver.bind takes {route_prefix: bound_app} (a "
            "non-empty dict)")
    seen: Dict[str, str] = {}
    for p in route_table:
        norm = _norm_prefix(p)
        if norm in seen:
            # silent last-wins would deploy the earlier sub-graph but
            # leave it unroutable — fail loudly instead
            raise ValueError(
                f"DAGDriver route prefixes collide after normalization: "
                f"{seen[norm]!r} and {p!r} -> {norm!r}")
        seen[norm] = p


class _DAGDriverImpl:
    """Route-table ingress over child deployment handles."""

    def __init__(self, route_table: Dict[str, Any]):
        _validate_route_table(route_table)  # defense in depth
        # init args arrive with Application nodes already resolved to
        # DeploymentHandles (HandleMarker resolution in the replica)
        self._routes = {_norm_prefix(p): h
                        for p, h in route_table.items()}

    def _match(self, path: str):
        return match_route(path, self._routes)

    def __call__(self, request):
        if not isinstance(request, Request):
            raise TypeError(
                "DAGDriver routes HTTP requests; use .predict(route, *args)"
                " for handle calls")
        m = self._match(request.path)
        if m is None:
            return Response(
                body={"error": f"no DAG route for {request.path}"},
                status_code=404, content_type="application/json")
        prefix, handle = m
        # strip the matched prefix so children see their own sub-path
        sub = request.path[len(prefix):] if prefix != "/" else request.path
        child_req = Request(
            method=request.method, path=sub or "/",
            raw_path=request.raw_path, query_params=request.query_params,
            headers=request.headers, body=request.body)
        return handle.remote(child_req).result(timeout_s=_CHILD_TIMEOUT_S)

    def predict(self, route: str, *args: Any, **kwargs: Any) -> Any:
        """Reference contract: invoke the sub-graph registered at
        ``route`` with raw arguments (non-HTTP path)."""
        m = self._routes.get(_norm_prefix(route))
        if m is None:
            raise KeyError(f"no DAG route {route!r} "
                           f"(have {sorted(self._routes)})")
        return m.remote(*args, **kwargs).result(timeout_s=_CHILD_TIMEOUT_S)


class _DAGDriverDeployment(Deployment):
    """Bind-time validation wrapper: route-table mistakes surface as an
    immediate ValueError/TypeError at ``DAGDriver.bind(...)`` instead of
    a replica-crash → opaque not-ready deploy timeout."""

    def bind(self, *args: Any, **kwargs: Any):
        table = args[0] if args else kwargs.get("route_table")
        _validate_route_table(table)
        return super().bind(*args, **kwargs)


DAGDriver = _DAGDriverDeployment(_DAGDriverImpl, name="DAGDriver")
