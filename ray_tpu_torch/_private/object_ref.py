"""ObjectRef: the distributed future handle.

Reference: ``ObjectID``/``ObjectRef`` in ``python/ray/_raylet.pyx``
(SURVEY.md §2.2/§3.2).  Semantics preserved:

- the ref is a future; ``ray_tpu_torch.get(ref)`` blocks for the value;
- refs are first-class values — passing one to a task defers to its value,
  putting one inside a container keeps it a ref (borrowing tracked at
  serialization time, see ``serialization._RefCollector``);
- dropping the last Python reference releases the distributed refcount
  (``__del__`` → worker.release()).

The *owner* worker id is embedded in the id (``ids.ObjectID``), so borrower
processes know who to report borrows to without a directory hop.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private.ids import ObjectID


class ObjectRef:
    __slots__ = ("id", "_worker", "_skip_release", "__weakref__")

    def __init__(self, object_id: str, worker: Optional[object] = None,
                 skip_release: bool = False):
        self.id = ObjectID(object_id)
        self._worker = worker
        self._skip_release = skip_release

    # -- identity ------------------------------------------------------------
    def hex(self) -> str:
        return str(self.id)

    @property
    def owner_id(self) -> str:
        return self.id.owner

    def __repr__(self) -> str:
        return f"ObjectRef({self.id})"

    def __hash__(self) -> int:
        return hash(self.id)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ObjectRef) and other.id == self.id

    # -- future sugar ---------------------------------------------------------
    def __await__(self):
        from ray_tpu_torch._private import worker as _w
        # Async actors / serve: run the blocking get in the default executor.
        import asyncio
        loop = asyncio.get_event_loop()
        fut = loop.run_in_executor(None, _w.global_worker().get_one, self)
        return fut.__await__()

    # -- refcount lifecycle ---------------------------------------------------
    @staticmethod
    def _deserialize(object_id: str) -> "ObjectRef":
        return _deserialize_object_ref(object_id)

    def __reduce__(self):
        # Plain-pickle path (refs inside values shipped via cloudpickle
        # outside the framework serializer, e.g. Dataset shards handed to
        # train workers).  The framework serializer's reducer_override
        # additionally records the borrow; here the sender must keep the
        # ref alive (the driver does, via the owning Dataset).
        return (_deserialize_object_ref, (str(self.id),))

    def __del__(self):
        w = self._worker
        if w is not None and not self._skip_release:
            try:
                w.release(str(self.id))
            except Exception:
                pass  # interpreter shutdown / closed control socket


def _deserialize_object_ref(object_id: str) -> ObjectRef:
    """Reconstructs a ref popping out of a pickled value (borrow protocol).

    Module-level so the pickle reduce tuple references a plain importable
    function (bound classmethods don't pickle under protocol-5 reducers).
    """
    from ray_tpu_torch._private import worker as _w
    w = _w.try_global_worker()
    if w is not None:
        w.notify_borrow(object_id)
    return ObjectRef(object_id, worker=w)


# Alias matching the reference's old name.
ObjectRefType = ObjectRef
