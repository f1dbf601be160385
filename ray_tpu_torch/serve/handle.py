"""DeploymentHandle + Router: request assignment to replicas.

Reference: ``python/ray/serve/handle.py`` + the power-of-two-choices
``ReplicaScheduler`` (SURVEY.md §3.6).  The router keeps a local
ongoing-request count per replica, picks the less-loaded of two random
replicas, and periodically (a) reaps completed requests, (b) refreshes the
replica set from the controller, and (c) pushes per-deployment ongoing
counts to the controller — the autoscaler's input signal (as in Ray 2.x,
where handles report metrics rather than replicas).
"""

from __future__ import annotations

import os
import random
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private import rtlog

logger = rtlog.get("serve.router")

CONTROLLER_NAME = "SERVE_CONTROLLER"
_REPORT_INTERVAL_S = float(os.environ.get("RTT_SERVE_REPORT_S", "0.5"))
# Max distinct multiplexed model ids tracked for replica affinity; LRU
# beyond this (each entry is ≤4 replica tags — a few thousand ids is KBs).
_AFFINITY_MAX_IDS = int(os.environ.get("RTT_SERVE_AFFINITY_MAX_IDS", "4096"))


def get_controller():
    return ray_tpu_torch.get_actor(CONTROLLER_NAME)


class DeploymentResponse:
    """Future for one assigned request (reference: ``DeploymentResponse``)."""

    def __init__(self, ref, router: "Router", replica_tag: str):
        self._ref = ref
        self._router = router
        self._replica_tag = replica_tag

    def result(self, timeout_s: Optional[float] = None) -> Any:
        out = ray_tpu_torch.get(self._ref, timeout=timeout_s)
        if isinstance(out, dict) and "__serve_stream__" in out:
            # streaming method: hand back a generator that pulls chunks
            # from the replica that owns the generator state
            return self._stream_chunks(out["__serve_stream__"],
                                       out.get("pull", 16))
        return out

    def _stream_chunks(self, sid: str, pull: int = 16):
        # Re-look-up the replica on every pull: generator state lives on
        # the replica, so a replica that dies (or is scaled away) mid-stream
        # must surface as RayServeError, not a raw actor error.
        while True:
            with self._router._lock:
                handle = self._router._replicas.get(self._replica_tag)
            if handle is None:
                raise ray_tpu_torch.exceptions.RayServeError(
                    "streaming replica went away mid-stream")
            try:
                chunks, done = ray_tpu_torch.get(
                    handle.stream_next.remote(sid, pull))
            except ray_tpu_torch.exceptions.RayActorError as e:
                raise ray_tpu_torch.exceptions.RayServeError(
                    "streaming replica died mid-stream") from e
            yield from chunks
            if done:
                return
            if not chunks:
                # producer-paced stream (__serve_poll__) with nothing
                # ready: back off briefly instead of hammering the
                # replica mailbox
                time.sleep(0.05)

    def _to_object_ref(self):
        return self._ref


def _strip_responses(obj: Any) -> Any:
    if isinstance(obj, DeploymentResponse):
        return obj._to_object_ref()
    if isinstance(obj, list):
        return [_strip_responses(o) for o in obj]
    if isinstance(obj, tuple):
        return tuple(_strip_responses(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _strip_responses(v) for k, v in obj.items()}
    return obj


class Router:
    _instances: Dict[str, "Router"] = {}
    _instances_lock = threading.Lock()

    @classmethod
    def for_deployment(cls, dep_key: str) -> "Router":
        with cls._instances_lock:
            r = cls._instances.get(dep_key)
            if r is None:
                r = cls._instances[dep_key] = Router(dep_key)
            return r

    @classmethod
    def reset_all(cls) -> None:
        with cls._instances_lock:
            for r in cls._instances.values():
                r._stop.set()
            cls._instances.clear()

    def __init__(self, dep_key: str):
        self.dep_key = dep_key
        self.router_id = uuid.uuid4().hex[:12]
        self._controller = None
        self._replicas: Dict[str, Any] = {}      # tag -> ActorHandle
        self._counts: Dict[str, int] = {}        # tag -> my ongoing
        self._outstanding: Dict[str, str] = {}   # ref id -> tag
        self._out_refs: Dict[str, Any] = {}      # ref id -> ObjectRef
        # model-multiplex affinity: model_id -> replica tags that have
        # served it (most recent last); the router prefers these so a
        # loaded model (its weights on the card) stays resident.  Bounded
        # LRU over model ids — a long-lived router seeing an unbounded id
        # stream must not grow without limit.
        self._model_affinity: "OrderedDict[str, List[str]]" = OrderedDict()
        self._pending = 0        # waiting in assign() — autoscale signal too
        self._max_ongoing = 0    # 0 = unknown/unbounded
        self._deployment_gone = False  # controller no longer knows the key
        self._version = -1
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._last_refresh = 0.0
        threading.Thread(target=self._background_loop,
                         name=f"serve-router-{dep_key}", daemon=True).start()

    # ---------------------------------------------------------------- routing
    def assign(self, method: str, args: tuple, kwargs: dict,
               timeout_s: float = 60.0,
               multiplexed_model_id: str = "") -> DeploymentResponse:
        # DeploymentResponses anywhere in the args become ObjectRefs (they
        # hold live threads/locks and must never be pickled); the replica
        # resolves refs — nested ones included — back to values.
        args = tuple(_strip_responses(a) for a in args)
        kwargs = {k: _strip_responses(v) for k, v in kwargs.items()}
        deadline = time.monotonic() + timeout_s
        with self._lock:
            self._pending += 1
        try:
            while True:
                with self._lock:
                    tags = list(self._replicas)
                    if tags:
                        tag = self._pick(tags, multiplexed_model_id)
                        # Enforce max_ongoing_requests at the router: hold
                        # the request here (counted in _pending → autoscale
                        # signal) instead of queueing it at a full replica.
                        if not self._max_ongoing or \
                                self._counts.get(tag, 0) < self._max_ongoing:
                            handle = self._replicas[tag]
                            self._counts[tag] = self._counts.get(tag, 0) + 1
                            break
                if time.monotonic() > deadline:
                    raise ray_tpu_torch.exceptions.RayServeError(
                        f"no replica of {self.dep_key!r} became available "
                        f"within {timeout_s}s")
                self._refresh(force=True)
                self._reap()
                time.sleep(0.05)
        finally:
            with self._lock:
                self._pending -= 1
        if multiplexed_model_id:
            kwargs = dict(kwargs)
            kwargs["__serve_model_id__"] = multiplexed_model_id
            with self._lock:
                aff = self._model_affinity.setdefault(
                    multiplexed_model_id, [])
                if tag in aff:
                    aff.remove(tag)
                aff.append(tag)
                del aff[:-4]             # keep the few most recent holders
                self._model_affinity.move_to_end(multiplexed_model_id)
                while len(self._model_affinity) > _AFFINITY_MAX_IDS:
                    self._model_affinity.popitem(last=False)
        ref = handle.handle_request.remote(method, args, kwargs)
        with self._lock:
            self._outstanding[str(ref.id)] = tag
            self._out_refs[str(ref.id)] = ref
        return DeploymentResponse(ref, self, tag)

    def _pick(self, tags: List[str], model_id: str = "") -> str:
        if model_id:
            # prefer the most recent non-saturated replica known to hold
            # this model (reference: multiplex-aware replica scheduler)
            for tag in reversed(self._model_affinity.get(model_id, [])):
                if tag in self._replicas and (
                        not self._max_ongoing
                        or self._counts.get(tag, 0) < self._max_ongoing):
                    return tag
        if len(tags) == 1:
            return tags[0]
        a, b = random.sample(tags, 2)
        ca, cb = self._counts.get(a, 0), self._counts.get(b, 0)
        return a if ca <= cb else b

    # ------------------------------------------------------------- background
    def _background_loop(self) -> None:
        while not self._stop.wait(_REPORT_INTERVAL_S):
            try:
                self._reap()
                self._refresh()
                self._report()
            except Exception:  # noqa: BLE001 - cluster may be shutting down
                if ray_tpu_torch.is_initialized():
                    logger.exception("router background loop error")
                else:
                    return

    def _reap(self) -> None:
        with self._lock:
            refs = list(self._out_refs.values())
        if not refs:
            return
        ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0)
        if not ready:
            return
        with self._lock:
            for r in ready:
                tag = self._outstanding.pop(str(r.id), None)
                self._out_refs.pop(str(r.id), None)
                if tag is not None and tag in self._counts:
                    self._counts[tag] = max(0, self._counts[tag] - 1)

    def _refresh(self, force: bool = False) -> None:
        now = time.monotonic()
        min_gap = 0.2 if force else 2 * _REPORT_INTERVAL_S
        if now - self._last_refresh < min_gap:
            return
        self._last_refresh = now
        if self._controller is None:
            self._controller = get_controller()
        info = ray_tpu_torch.get(
            self._controller.get_deployment_targets.remote(self.dep_key))
        if info is None:
            # deployment deleted: stop republishing its last queue depth
            # (the flag keeps _report from resurrecting the series on the
            # very next tick)
            self._deployment_gone = True
            from ray_tpu_torch.util import metrics_catalog as mcat
            mcat.get("rtt_serve_replica_queue_depth").remove_series(
                tags={"deployment": self.dep_key, "group": self.dep_key})
            return
        self._deployment_gone = False  # (re)deployed
        with self._lock:
            self._max_ongoing = info.get("max_ongoing") or 0
            if info["version"] == self._version and not force:
                return
            self._version = info["version"]
            new = {}
            for tag, actor_name in info["replicas"].items():
                if tag in self._replicas:
                    new[tag] = self._replicas[tag]
                else:
                    try:
                        new[tag] = ray_tpu_torch.get_actor(actor_name)
                    except Exception:  # noqa: BLE001 - not registered yet
                        continue
            self._replicas = new
            self._counts = {t: self._counts.get(t, 0) for t in new}
            # drop affinity tags for replicas that no longer exist (and
            # the id entirely once no live replica holds it)
            for mid in list(self._model_affinity):
                live = [t for t in self._model_affinity[mid] if t in new]
                if live:
                    self._model_affinity[mid] = live
                else:
                    del self._model_affinity[mid]

    def _report(self) -> None:
        if self._controller is None or self._deployment_gone:
            return
        with self._lock:
            # Waiting-to-be-assigned requests count toward load, otherwise
            # scale-from-zero (min_replicas=0) could never trigger.
            total = len(self._outstanding) + self._pending
            pending = self._pending
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        if GLOBAL_CONFIG.metrics_enabled:
            # queue depth = requests held in assign() by the
            # max_ongoing_requests gate; the backpressure signal operators
            # watch to see a saturated deployment before latency blows up
            from ray_tpu_torch.util import metrics_catalog as mcat
            mcat.get("rtt_serve_replica_queue_depth").set(
                pending,
                tags={"deployment": self.dep_key, "group": self.dep_key})
        self._controller.report_handle_stats.remote(
            self.router_id, self.dep_key, total)


class _MethodCaller:
    def __init__(self, handle: "DeploymentHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args: Any, **kwargs: Any) -> DeploymentResponse:
        return self._handle._router().assign(
            self._method, args, kwargs,
            multiplexed_model_id=self._handle._model_id)


_warned_handle_options: set = set()


class DeploymentHandle:
    """Callable reference to a deployment; picklable across processes."""

    def __init__(self, dep_key: str, multiplexed_model_id: str = ""):
        self._dep_key = dep_key
        self._model_id = multiplexed_model_id

    def options(self, *, multiplexed_model_id: str = "",
                **_compat: Any) -> "DeploymentHandle":
        """Per-request routing options (reference:
        ``handle.options(multiplexed_model_id=...)``).

        Unrecognized reference options (``method_name``, ``stream``, …)
        are NOT silently honored here — warn so callers porting reference
        code see the behavior difference instead of a silent no-op."""
        if _compat:
            unknown = tuple(sorted(_compat))
            if unknown not in _warned_handle_options:   # once per shape,
                _warned_handle_options.add(unknown)     # not per request
                logger.warning(
                    "DeploymentHandle.options(): unsupported option(s) %s "
                    "ignored — only multiplexed_model_id is honored "
                    "(call methods as handle.method.remote(...) instead of "
                    "method_name=...)", list(unknown))
        return DeploymentHandle(self._dep_key, multiplexed_model_id)

    def _router(self) -> Router:
        return Router.for_deployment(self._dep_key)

    def remote(self, *args: Any, **kwargs: Any) -> DeploymentResponse:
        return self._router().assign("__call__", args, kwargs,
                                     multiplexed_model_id=self._model_id)

    def __getattr__(self, name: str) -> _MethodCaller:
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodCaller(self, name)

    def __reduce__(self):
        return (DeploymentHandle, (self._dep_key, self._model_id))

    def __repr__(self):
        return f"DeploymentHandle({self._dep_key!r})"
