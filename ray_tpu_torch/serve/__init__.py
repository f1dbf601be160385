"""ray_tpu_torch.serve — online model serving on GPU actors (port of
``ray_tpu/serve``).

Reference: ``python/ray/serve/`` (SURVEY.md §2.5, §3.6): controller actor
(deployment FSM + autoscaler), HTTP proxy, power-of-two-choices routing,
replica actors with bounded ongoing requests, deployment handles for model
composition, ``@serve.batch`` for request batching.

On the card:
- a replica is placed on the card only through
  ``ray_actor_options={"num_gpus": ...}``: it runs in a GPU worker process
  of its own (``init(_system_config={"gpu_workers_per_node": N})`` lets N
  of them share one card, each with a fraction of its ``"GPU"``); a
  replica without it runs in a plain worker that sees no card, where a
  model built for ``cuda`` raises and the deployment reports it;
- replicas build and warm their model in ``__init__`` (CUDA context,
  weights on the device, the kernels' first load) and are only routed to
  once ready;
- ``@serve.batch`` turns request streams into batches for the tensor
  cores;
- the autoscaler's downscale delay is sticky by default, because a
  replica's start pays all of the above (SURVEY.md §7.3).

Usage::

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    rt.init(num_cpus=8, _system_config={"gpu_workers_per_node": 4})
    handle = serve.run(Bert.options(
        ray_actor_options={"num_gpus": 0.25}).bind(), route_prefix="/bert")
    handle.remote(ids).result()
"""

from ray_tpu_torch.serve.api import (  # noqa: F401
    delete, get_app_handle, get_deployment_handle, get_grpc_address,
    get_http_address, run, shutdown, start, status,
)
from ray_tpu_torch.serve.batching import batch  # noqa: F401
from ray_tpu_torch.serve.config import (  # noqa: F401
    AutoscalingConfig, HTTPOptions, gRPCOptions,
)
from ray_tpu_torch.serve.multiplex import (  # noqa: F401
    get_multiplexed_model_id, multiplexed,
)
from ray_tpu_torch.serve.deployment import (  # noqa: F401
    Application, Deployment, deployment,
)
from ray_tpu_torch.serve.drivers import DAGDriver  # noqa: F401
from ray_tpu_torch.serve.ingress import HTTPApp, ingress  # noqa: F401
from ray_tpu_torch.serve.handle import (  # noqa: F401
    DeploymentHandle, DeploymentResponse,
)
from ray_tpu_torch.serve.http_util import (  # noqa: F401
    Request, Response, StreamingResponse,
)

__all__ = [
    "deployment", "run", "start", "shutdown", "status", "delete",
    "get_app_handle", "get_deployment_handle", "get_http_address",
    "get_grpc_address", "batch", "AutoscalingConfig", "HTTPOptions",
    "gRPCOptions", "Application", "StreamingResponse",
    "multiplexed", "get_multiplexed_model_id",
    "Deployment", "DeploymentHandle", "DeploymentResponse",
    "Request", "Response",
]
