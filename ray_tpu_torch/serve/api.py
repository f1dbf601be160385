"""Serve public API: start / run / status / shutdown / handles.

Reference: ``python/ray/serve/api.py`` (SURVEY.md §3.6).  ``serve.run``
deploys a bound application graph onto the running ray_tpu_torch cluster; the
controller and HTTP proxy are detached named actors, so applications
outlive the deploying driver until ``serve.shutdown()``.

Port of ``ray_tpu/serve/api.py``.  ``serve.run`` raises at once when the
controller marks a deployment failed (a resource the cluster lacks, more
GPU replicas than GPU worker processes, or replicas that keep failing in
``__init__``), with the controller's message; a replica is placed on the
card only through ``ray_actor_options={"num_gpus": ...}``.
"""

from __future__ import annotations

import time
from typing import Optional

import ray_tpu_torch
from ray_tpu_torch.serve._proxy import ProxyActor
from ray_tpu_torch.serve.config import HTTPOptions, gRPCOptions
from ray_tpu_torch.serve.controller import ServeController
from ray_tpu_torch.serve.deployment import Application
from ray_tpu_torch.serve.handle import (CONTROLLER_NAME, DeploymentHandle,
                                        Router, get_controller)

PROXY_NAME = "SERVE_PROXY"
GRPC_PROXY_NAME = "SERVE_GRPC_PROXY"


def start(http_options: Optional[HTTPOptions] = None, *,
          proxy: bool = True,
          grpc_options: Optional[gRPCOptions] = None):
    """Idempotently start the Serve system actors; returns the controller."""
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    requested = http_options
    http_options = http_options or HTTPOptions(port=0)
    controller = ray_tpu_torch.remote(ServeController).options(
        name=CONTROLLER_NAME, lifetime="detached", num_cpus=0,
        max_concurrency=8, get_if_exists=True).remote()
    ray_tpu_torch.get(controller.__ray_ready__.remote())
    if proxy:
        p = ray_tpu_torch.remote(ProxyActor).options(
            name=PROXY_NAME, lifetime="detached", num_cpus=0,
            max_concurrency=32, get_if_exists=True,
        ).remote(http_options.host, http_options.port,
                 http_options.request_timeout_s)
        ray_tpu_torch.get(p.__ray_ready__.remote())
        if requested is not None:
            actual = ray_tpu_torch.get(controller.get_http_address.remote())
            if actual is not None and requested.port not in (0, actual[1]):
                from ray_tpu_torch._private import rtlog
                rtlog.get("serve").warning(
                    "Serve proxy already running on %s:%d; requested "
                    "http_options (port=%d) ignored — call serve.shutdown() "
                    "first to change HTTP options", actual[0], actual[1],
                    requested.port)
    if grpc_options is not None:
        import importlib.util
        if importlib.util.find_spec("grpc") is None:
            # the proxy imports grpc inside its actor; fail here, by name,
            # instead of as a proxy actor that never becomes ready
            raise ImportError(
                "serve.start(grpc_options=...) needs the grpcio package "
                "(import name grpc), which is not installed")
        from ray_tpu_torch.serve._grpc_proxy import GrpcProxyActor
        g = ray_tpu_torch.remote(GrpcProxyActor).options(
            name=GRPC_PROXY_NAME, lifetime="detached", num_cpus=0,
            max_concurrency=32, get_if_exists=True,
        ).remote(grpc_options.host, grpc_options.port,
                 grpc_options.request_timeout_s,
                 allow_pickle=getattr(grpc_options, "allow_pickle", False))
        ray_tpu_torch.get(g.__ray_ready__.remote())
        actual = ray_tpu_torch.get(controller.get_grpc_address.remote())
        if actual is not None and grpc_options.port not in (0, actual[1]):
            from ray_tpu_torch._private import rtlog
            rtlog.get("serve").warning(
                "Serve gRPC proxy already running on %s:%d; requested "
                "grpc_options (port=%d) ignored — call serve.shutdown() "
                "first to change gRPC options", actual[0], actual[1],
                grpc_options.port)
        # get_if_exists can hand back a proxy started with a DIFFERENT
        # pickle posture — __init__ options don't re-apply.  A silent
        # mismatch in either direction is a security surprise; warn.
        requested_ap = getattr(grpc_options, "allow_pickle", False)
        try:
            actual_ap = ray_tpu_torch.get(g.get_allow_pickle.remote(), timeout=10)
        except Exception:  # noqa: BLE001 - pre-upgrade proxy lacks the RPC
            actual_ap = None
        if actual_ap is not None and actual_ap != requested_ap:
            from ray_tpu_torch._private import rtlog
            rtlog.get("serve").warning(
                "Serve gRPC proxy already running with allow_pickle=%s; "
                "requested allow_pickle=%s ignored — call serve.shutdown() "
                "first to change the pickle codec posture",
                actual_ap, requested_ap)
    return controller


def run(target: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/", blocking: bool = False,
        http_options: Optional[HTTPOptions] = None,
        grpc_options: Optional[gRPCOptions] = None,
        _wait_timeout_s: float = 120.0) -> DeploymentHandle:
    if not isinstance(target, Application):
        raise TypeError("serve.run expects a bound Application "
                        "(use MyDeployment.bind(...))")
    controller = start(http_options=http_options, grpc_options=grpc_options)
    nodes: dict = {}
    target._collect(nodes)
    payload = []
    for dep_name, node in nodes.items():
        args, kwargs = node._marked_args(name)
        payload.append(dict(
            name=dep_name, user_cls=node._deployment.user_class,
            init_args=args, init_kwargs=kwargs,
            config=node._deployment.to_config()))
    ingress = target._deployment.name
    ray_tpu_torch.get(controller.deploy_application.remote(
        name, route_prefix, payload, ingress))
    _wait_ready(controller, [f"{name}#{d}" for d in nodes], _wait_timeout_s)
    handle = DeploymentHandle(f"{name}#{ingress}")
    if blocking:
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
    return handle


def _wait_ready(controller, keys, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        status = ray_tpu_torch.get(controller.status.remote())
        pending = [k for k in keys
                   if status.get(k, {}).get("ready", 0) <
                   status.get(k, {}).get("target", 1)]
        bad = [k for k in keys if k not in status]
        failed = [f"{k}: {status[k]['message']}" for k in keys
                  if status.get(k, {}).get("failed")]
        if failed:
            raise ray_tpu_torch.exceptions.RayServeError(
                "deployment failed: " + "; ".join(failed))
        if not pending and not bad:
            return
        time.sleep(0.1)
    raise ray_tpu_torch.exceptions.RayServeError(
        f"application not ready within {timeout_s}s: {status}")


def status() -> dict:
    return ray_tpu_torch.get(get_controller().status.remote())


def get_http_address() -> Optional[tuple]:
    return ray_tpu_torch.get(get_controller().get_http_address.remote())


def get_grpc_address() -> Optional[tuple]:
    return ray_tpu_torch.get(get_controller().get_grpc_address.remote())


def get_app_handle(name: str = "default") -> DeploymentHandle:
    key = ray_tpu_torch.get(get_controller().get_app_ingress.remote(name))
    if key is None:
        raise ray_tpu_torch.exceptions.RayServeError(f"no application {name!r}")
    return DeploymentHandle(key)


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(f"{app_name}#{deployment_name}")


def delete(name: str) -> None:
    ray_tpu_torch.get(get_controller().delete_application.remote(name))


def shutdown() -> None:
    """Tear down all applications and the Serve system actors."""
    Router.reset_all()
    try:
        controller = get_controller()
    except Exception:  # noqa: BLE001 - serve never started
        return
    try:
        ray_tpu_torch.get(controller.shutdown_all.remote(), timeout=10)
    except Exception:  # noqa: BLE001
        pass
    for proxy_name in (PROXY_NAME, GRPC_PROXY_NAME):
        try:
            proxy = ray_tpu_torch.get_actor(proxy_name)
            ray_tpu_torch.get(proxy.shutdown.remote(), timeout=5)
            ray_tpu_torch.kill(proxy)
        except Exception:  # noqa: BLE001
            pass
    try:
        ray_tpu_torch.kill(controller)
    except Exception:  # noqa: BLE001
        pass
    _wait_released((CONTROLLER_NAME, PROXY_NAME, GRPC_PROXY_NAME))


def _wait_released(names, timeout_s: float = 10.0) -> None:
    """``kill`` returns before the runtime has marked the actor dead, and
    until then its name still resolves: a ``serve.start`` right after
    ``shutdown`` would get the dying controller back through
    ``get_if_exists``.  Wait for each name to be free."""
    deadline = time.monotonic() + timeout_s
    for name in names:
        while time.monotonic() < deadline:
            try:
                ray_tpu_torch.get_actor(name)
            except Exception:  # noqa: BLE001 - no such actor: released
                break
            time.sleep(0.05)
