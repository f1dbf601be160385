"""ID types for objects, tasks, actors, jobs, nodes, placement groups.

Reference: ``src/ray/common/id.h`` (SURVEY.md §2.1) — Ray ObjectIDs embed the
owner (task) id plus a return/put index so ownership is derivable from the id
alone.  We keep that property: an ``ObjectID`` is
``<owner_worker_hex16><kind:1><counter_hex10>`` so any process can read the
owner straight off the id without a directory lookup.
"""

from __future__ import annotations

import os
import threading
import uuid


# 16-char ID generation is on the task-submission hot path (one TaskID
# per `.remote()`), and uuid4/urandom cost 20-30µs per call on small
# hosts (one getrandom syscall each).  Instead: one 40-bit urandom
# prefix per process plus a 24-bit counter — unique within a process by
# the counter, across processes by the prefix (birthday risk over 1k
# processes ≈ 5e-7), re-seeded on counter rollover and after fork
# (os.getpid check) so forked children never continue the parent's
# sequence.  Short ids (worker/job — rare, per-process not per-task)
# keep full per-call entropy.
_seed_lock = threading.Lock()
_seed = ["", 0, 0]  # [prefix_hex10, counter, pid]


def _rand_hex(n: int) -> str:
    if n < 16:
        return uuid.uuid4().hex[:n]
    with _seed_lock:
        pid = os.getpid()
        if _seed[2] != pid or _seed[1] >= 0xFFFFFF:
            _seed[0] = os.urandom(5).hex()
            _seed[1] = 0
            _seed[2] = pid
        _seed[1] += 1
        h = f"{_seed[0]}{_seed[1]:06x}"
    return h if n == 16 else h + uuid.uuid4().hex[:n - 16]


class _Counter:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def next(self) -> int:
        with self._lock:
            self._n += 1
            return self._n


class WorkerID(str):
    @classmethod
    def new(cls) -> "WorkerID":
        # pid folded in for human debuggability of logs/ids.
        return cls(f"{os.getpid():08x}{_rand_hex(8)}")


class JobID(str):
    @classmethod
    def new(cls) -> "JobID":
        return cls(_rand_hex(8))


class NodeID(str):
    @classmethod
    def new(cls) -> "NodeID":
        return cls(_rand_hex(16))


class TaskID(str):
    @classmethod
    def new(cls) -> "TaskID":
        return cls(_rand_hex(16))


class ActorID(str):
    @classmethod
    def new(cls) -> "ActorID":
        return cls(_rand_hex(16))


class PlacementGroupID(str):
    @classmethod
    def new(cls) -> "PlacementGroupID":
        return cls(_rand_hex(16))


KIND_PUT = "p"
KIND_RETURN = "r"


class ObjectID(str):
    """``<owner16><kind1><counter10>`` — owner-embedding object id."""

    @classmethod
    def make(cls, owner: str, kind: str, counter: int) -> "ObjectID":
        assert kind in (KIND_PUT, KIND_RETURN)
        return cls(f"{owner[:16]:>16s}{kind}{counter:010x}")

    @property
    def owner(self) -> str:
        return self[:16]

    @property
    def is_put(self) -> bool:
        return self[16] == KIND_PUT
