"""Public exception types.

Behavioral parity with the reference's ``python/ray/exceptions.py``
(SURVEY.md §3.2/§5.3): task errors propagate to ``get()`` wrapped in
``RayTaskError``; dead actors raise ``RayActorError``; a lost object whose
owner died raises ``OwnerDiedError`` (ownership is deliberately not re-homed —
SURVEY.md §5.3 notes this contract is load-bearing for refcount simplicity).
"""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class for all ray_tpu_torch errors."""


class RayTaskError(RayTpuError):
    """A task raised an exception; re-raised at ``get()`` on the caller.

    Carries the remote traceback text so the driver sees where the failure
    happened inside the worker (reference: ``RayTaskError.as_instanceof_cause``).
    """

    def __init__(self, function_name: str, traceback_str: str,
                 cause: Optional[BaseException] = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(f"task {function_name} failed:\n{traceback_str}")

    @classmethod
    def from_exception(cls, function_name: str, exc: BaseException) -> "RayTaskError":
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        return cls(function_name, tb, cause=exc)

    def __reduce__(self):
        # cause travels when picklable; degraded to None otherwise
        try:
            import pickle
            pickle.dumps(self.cause)
            cause = self.cause
        except Exception:  # noqa: BLE001
            cause = None
        return (RayTaskError, (self.function_name, self.traceback_str, cause))


class RayActorError(RayTpuError):
    """The actor died before or while executing the method."""

    def __init__(self, actor_id: str = "", reason: str = "actor died"):
        self.actor_id = actor_id
        self.reason = reason
        super().__init__(f"actor {actor_id or '?'}: {reason}")

    def __reduce__(self):
        return (type(self), (self.actor_id, self.reason))


class ActorDiedError(RayActorError):
    pass


class ObjectLostError(RayTpuError):
    """Object can no longer be retrieved and could not be reconstructed."""

    def __init__(self, object_id: str = "", reason: str = "object lost"):
        self.object_id = object_id
        self.reason = reason
        super().__init__(f"object {object_id or '?'}: {reason}")

    def __reduce__(self):
        return (type(self), (self.object_id, self.reason))


class OwnerDiedError(ObjectLostError):
    """The process that owned this object died; borrowers cannot recover it."""


class ObjectStoreFullError(RayTpuError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class WorkerCrashedError(RayTpuError):
    """A worker process died (e.g. SIGKILL) while running a task."""


class TaskCancelledError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class PlacementGroupSchedulingError(RayTpuError):
    """Placement group bundles cannot be satisfied by the cluster."""


class OutOfMemoryError(RayTpuError):
    """Task killed by the memory monitor under node memory pressure
    (reference: ray.exceptions.OutOfMemoryError)."""


class RaySystemError(RayTpuError):
    """Internal control-plane failure."""


class RayServeError(RayTpuError):
    """Serve-level failure (no replicas available, bad deployment, ...).

    Reference: ``ray.serve.exceptions.RayServeException``."""


# Reference-compatible alias.
RayServeException = RayServeError
