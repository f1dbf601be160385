"""ray_tpu_torch — the PyTorch / CUDA port of ray_tpu for NVIDIA Hopper.

The JAX package ``ray_tpu`` stays beside it as the reference; this
package imports nothing from it.  Plain tensor code is PyTorch, and every
Pallas kernel of the reference on a ported path is a CUDA C++ kernel
written by hand for ``sm_90a`` (``csrc/``, built at first use by
``_build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``::

    from ray_tpu_torch.serve import llm
    eng = llm.LLMEngine(llm.EngineConfig(model="gpt2:gpt2-124m",
                                         share_weights=False))
    tokens = eng.generate([1, 2, 3], llm.SamplingParams(max_tokens=16))

The runtime on one host (``init``, ``remote``, ``get``, ``put``,
``wait``, ``kill``, ``cancel``, ``get_actor``, ``shutdown``) is the
reference's core API with ``num_gpus`` / ``"GPU"`` for the accelerator.
Everything it puts on a host carries the port's own names: ``RTT_*``
environment variables, ``rtt_*`` shared-memory segments and sessions
under ``/tmp/rtt_sessions``.  Importing the package does not import
torch: spawned workers import it, and a plain worker never touches a
tensor.
"""

from __future__ import annotations

import atexit
import os
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import rtlog
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.session import Session
from ray_tpu_torch._private.gpus import detect_gpus as _detect_gpus
from ray_tpu_torch._private import protocol as _protocol
from ray_tpu_torch._private import worker as _worker_mod
from ray_tpu_torch.actor import ActorClass, ActorHandle, get_actor
from ray_tpu_torch.remote_function import RemoteFunction

__version__ = "0.1.0"

__all__ = [
    "init", "shutdown", "remote", "get", "put", "wait", "kill", "cancel",
    "get_actor", "is_initialized", "nodes", "cluster_resources",
    "available_resources", "ObjectRef", "ActorHandle", "exceptions",
    "method", "timeline", "get_runtime_context", "__version__",
    "resolve_device",
]


def __getattr__(name: str):
    # resolve_device imports torch; only callers that ask for it pay that
    if name == "resolve_device":
        from ray_tpu_torch._device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


_init_lock = threading.Lock()
_head = None  # GcsServer when this process started the cluster


def init(address: Optional[str] = None, *,
         num_cpus: Optional[int] = None, num_gpus: Optional[float] = None,
         resources: Optional[dict] = None, namespace: str = "default",
         log_to_driver: bool = True, _system_config: Optional[dict] = None,
         ignore_reinit_error: bool = False,
         _session_dir: Optional[str] = None, **_compat: Any):
    """Start (or connect to) a ray_tpu_torch cluster. Reference: ``ray.init``.

    With no address, boots a head node in-process: control plane (GCS),
    object store, and an on-demand worker pool (SURVEY.md §3.1).
    """
    global _head
    with _init_lock:
        if _worker_mod.try_global_worker() is not None:
            if ignore_reinit_error:
                return _ctx()
            raise RuntimeError("ray_tpu_torch.init() called twice "
                               "(pass ignore_reinit_error=True to allow)")
        GLOBAL_CONFIG.apply_system_config(_system_config)
        from ray_tpu_torch._private.gcs import GcsServer

        if address is None or address == "local":
            if _session_dir:
                # head restart over an existing session dir: GcsServer
                # restores the durable snapshot (GCS fault tolerance) and
                # surviving workers/actors reattach
                root, name = os.path.split(os.path.abspath(_session_dir))
                session = Session(root=root, name=name)
            else:
                session = Session()
            _protocol.set_authkey(session.auth_key())
            rtlog.setup("driver", session.log_dir)
            head_res = dict(resources or {})
            head_res["CPU"] = float(num_cpus if num_cpus is not None
                                    else (os.cpu_count() or 4))
            gpus = num_gpus if num_gpus is not None else _detect_gpus()
            if gpus:
                head_res["GPU"] = float(gpus)
            _head = GcsServer(session, head_res)
            session.write_descriptor({"gcs": _head.rpc_path})
        elif address.startswith("ray://"):
            # remote-client mode through the TCP proxy (reference:
            # ray.init("ray://host:10001") — Ray Client)
            hostport = address[len("ray://"):]
            host, _, port = hostport.partition(":")
            key_hex = os.environ.get("RTT_AUTH_KEY")
            if key_hex:
                _protocol.set_authkey(bytes.fromhex(key_hex))
            rtlog.setup("client", None)
            w = _worker_mod.Worker(None, role="driver",
                                   proxy_addr=(host, int(port or 10001)))
            w.namespace = namespace
            _worker_mod.set_global_worker(w)
            atexit.register(shutdown)
            return {"session_dir": None, "node_id": w.node_id,
                    "client": True}
        elif address == "auto":
            # attach to the latest session on this machine (reference:
            # ray.init(address="auto"))
            session = Session.latest()
            desc_pid = session.read_descriptor().get("head_pid") \
                or session.read_descriptor().get("pid")
            alive = False
            if desc_pid:
                try:
                    os.kill(desc_pid, 0)
                    alive = True
                except (ProcessLookupError, PermissionError):
                    pass
            if not alive:
                raise ConnectionError(
                    f"no running ray_tpu_torch cluster (latest session "
                    f"{session.path} has no live head process)")
            _protocol.set_authkey(session.auth_key())
            rtlog.setup("driver", session.log_dir)
        else:
            # attach to an existing session (same machine)
            root, name = os.path.split(address)
            session = Session(root=root, name=name)
            _protocol.set_authkey(session.auth_key())
            rtlog.setup("driver", session.log_dir)

        w = _worker_mod.Worker(session, role="driver")
        w.namespace = namespace
        _worker_mod.set_global_worker(w)
        if _head is not None and log_to_driver and GLOBAL_CONFIG.log_to_driver:
            _head.log_sink = print
        atexit.register(shutdown)
        return _ctx()


def _ctx() -> dict:
    w = _worker_mod.global_worker()
    return {"session_dir": str(w.session.path), "node_id": w.node_id}


def shutdown() -> None:
    global _head
    with _init_lock:
        w = _worker_mod.try_global_worker()
        if w is None:
            return
        try:
            w.shutdown()
        finally:
            _worker_mod.set_global_worker(None)
        if _head is not None:
            _head.shutdown()
            _head = None
        try:
            atexit.unregister(shutdown)
        except Exception:  # noqa: BLE001
            pass


def is_initialized() -> bool:
    return _worker_mod.try_global_worker() is not None


# ----------------------------------------------------------------- decorator
def remote(*args: Any, **options: Any):
    """``@ray_tpu_torch.remote`` for functions and classes (reference:
    ``ray.remote``); ``num_gpus`` asks for CUDA cards."""
    def wrap(obj):
        if isinstance(obj, type):
            return ActorClass(obj).options(**options)
        return RemoteFunction(obj).options(**options)

    if len(args) == 1 and callable(args[0]) and not options:
        return wrap(args[0])
    if args:
        raise TypeError("@remote takes keyword options only")
    return wrap


def method(num_returns: int = 1):
    """Decorator to declare actor-method return arity (reference: ray.method)."""
    def deco(fn):
        fn.__ray_num_returns__ = num_returns
        return fn
    return deco


# ------------------------------------------------------------------ core ops
def put(value: Any) -> ObjectRef:
    return _worker_mod.global_worker().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None) -> Any:
    w = _worker_mod.global_worker()
    if hasattr(refs, "__ray_get__"):  # pg.ready() duck-typing
        return refs.__ray_get__(timeout)
    if isinstance(refs, ObjectRef):
        return w.get([refs], timeout=timeout)[0]
    return w.get(list(refs), timeout=timeout)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None,
         fetch_local: bool = True) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    if isinstance(refs, ObjectRef):
        raise TypeError("ray_tpu_torch.wait() expects a list of ObjectRefs")
    return _worker_mod.global_worker().wait(list(refs), num_returns, timeout)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    _worker_mod.global_worker().kill_actor(actor._actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    _worker_mod.global_worker().rpc(
        "cancel_task", task_id=_task_of(ref), force=force)


def _task_of(ref: ObjectRef) -> str:
    # return ids are minted per task; GCS keeps the mapping via lineage/running
    w = _worker_mod.global_worker()
    resp = w.rpc("find_task_of_object", object_id=str(ref.id))
    return resp["task_id"]


# --------------------------------------------------------------- state views
def nodes() -> List[dict]:
    return _worker_mod.global_worker().rpc("list_nodes")["nodes"]


def cluster_resources() -> dict:
    return _worker_mod.global_worker().rpc("cluster_resources")["total"]


def available_resources() -> dict:
    return _worker_mod.global_worker().rpc("cluster_resources")["available"]


def timeline(filename: Optional[str] = None,
             trace_id: Optional[str] = None) -> List[dict]:
    """Chrome-trace events (reference: ``ray timeline``, SURVEY.md §5.1).

    With ``trace_id``, returns only that request's causal tree — host
    spans across every process plus the device rows captured under it
    (``util/trace_assembly.py``; CLI: ``ray_tpu_torch trace <trace_id>``)."""
    events = _worker_mod.global_worker().rpc("timeline")["events"]
    if trace_id is not None:
        from ray_tpu_torch.util import trace_assembly
        events = trace_assembly.trace_events(events, trace_id)
    if filename:
        import json
        with open(filename, "w") as f:
            json.dump(events, f)
    return events


class _RuntimeContext:
    @property
    def node_id(self) -> str:
        return _worker_mod.global_worker().node_id

    @property
    def worker_id(self) -> str:
        return _worker_mod.global_worker().worker_id

    @property
    def task_id(self) -> Optional[str]:
        return _worker_mod.global_worker().ctx.task_id

    def get_node_id(self) -> str:
        return self.node_id


def get_runtime_context() -> _RuntimeContext:
    return _RuntimeContext()
