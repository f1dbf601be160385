"""Serve configuration types (port of ``ray_tpu/serve/config.py``).

Reference: ``python/ray/serve/config.py`` (SURVEY.md §2.5, §3.6) —
``AutoscalingConfig`` (min/max replicas, target ongoing requests per
replica, up/downscale delays), HTTP options, deployment options.

Replica start on the card: a ``num_gpus`` replica is a fresh GPU worker
process, so its start pays the CUDA context, the copy of its weights to
the device and the lazy load of the kernels' module at the first call
(``_build.lib``).  The autoscaler defaults stay sticky (long downscale
delay), and replicas build and warm their model in ``__init__`` so a
replica is only marked ready once it can serve.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class AutoscalingConfig:
    """Replica autoscaling policy for one deployment.

    ``target_ongoing_requests`` is the per-replica load the autoscaler
    steers toward: desired = ceil(total_ongoing / target).
    """

    min_replicas: int = 1
    max_replicas: int = 1
    target_ongoing_requests: float = 2.0
    initial_replicas: Optional[int] = None
    upscale_delay_s: float = 30.0
    downscale_delay_s: float = 600.0
    metrics_interval_s: float = 1.0

    def __post_init__(self):
        if self.min_replicas < 0 or self.max_replicas < max(1, self.min_replicas):
            raise ValueError("need 0 <= min_replicas <= max_replicas (>=1)")
        if self.target_ongoing_requests <= 0:
            raise ValueError("target_ongoing_requests must be > 0")


@dataclasses.dataclass
class HTTPOptions:
    host: str = "127.0.0.1"
    port: int = 8000
    request_timeout_s: float = 120.0


@dataclasses.dataclass
class gRPCOptions:  # noqa: N801 - reference-parity name
    """Binary ingress options (reference: ``serve.config.gRPCOptions``).

    The reference takes ``grpc_servicer_functions`` (compiled proto
    servicers); this proxy serves a GENERIC unary-unary handler instead
    (any method path, raw-bytes payloads, app selection via
    ``application`` metadata) so no proto toolchain is required — see
    ``_grpc_proxy.py``."""

    host: str = "127.0.0.1"
    port: int = 0
    request_timeout_s: float = 120.0
    # The ``serve-codec: pickle`` metadata deserializes attacker-supplied
    # bytes with pickle — arbitrary code execution for anyone who can reach
    # the port.  It therefore requires an explicit server-side opt-in; only
    # enable it when every possible caller is trusted (e.g. in-cluster
    # callers on a private network).
    allow_pickle: bool = False


@dataclasses.dataclass
class DeploymentConfig:
    """Resolved per-deployment options stored by the controller."""

    num_replicas: int = 1
    max_ongoing_requests: int = 8
    autoscaling_config: Optional[AutoscalingConfig] = None
    ray_actor_options: Optional[dict] = None
    graceful_shutdown_wait_s: float = 2.0
    health_check_period_s: float = 5.0

    def initial_target(self) -> int:
        ac = self.autoscaling_config
        if ac is None:
            return self.num_replicas
        if ac.initial_replicas is not None:
            return ac.initial_replicas
        return max(1, ac.min_replicas)
