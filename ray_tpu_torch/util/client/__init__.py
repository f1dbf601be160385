"""Ray-Client-equivalent remote driver mode.

Reference: ``python/ray/util/client/`` (SURVEY.md §2.3) — a gRPC proxy at
``ray://host:10001``; the client process runs a thin API facade and the
server translates to real core calls.  Here the proxy is a TCP tunnel
(``server.ClientProxyServer``): a connecting client names a target ("gcs"
or an actor socket path) and the proxy pipes messages to the cluster-local
unix socket — so the normal control-plane *and* direct actor-call protocols
work remotely unchanged.  The data plane differs by necessity: a remote
client cannot mmap the cluster's shm directory, so client ``put`` always
inlines through the control plane and ``get`` fetches object bytes via the
``fetch_object`` RPC (the reference's client server proxies object
transport the same way).  The same port is the one a ``NodeAgent`` joins
through (``python -m ray_tpu_torch._private.node_agent --address``).
"""

from ray_tpu_torch.util.client.server import ClientProxyServer  # noqa: F401
