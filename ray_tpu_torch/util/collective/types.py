"""Collective op/backend types.

Reference: ``python/ray/util/collective/types.py`` — ``ReduceOp`` and
backend identifiers.  The port has one backend, the object-plane ``shm``
group; the reference's ``gloo`` name is an alias of it, and ``nccl`` (the
device group) waits for the multi-GPU slice (ROADMAP queue A, item 8).
"""

from __future__ import annotations

import enum


class ReduceOp(enum.Enum):
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"

    @staticmethod
    def coerce(op: "ReduceOp | str") -> "ReduceOp":
        return op if isinstance(op, ReduceOp) else ReduceOp(str(op).lower())


class Backend(str, enum.Enum):
    """Collective transport.

    SHM — object-plane backend: tensors move through the shared-memory
    object store, rendezvous via GCS KV.  Works for any set of actors or
    processes (the GLOO analog).
    NCCL — the device group; not ported yet.
    """

    SHM = "shm"
    GLOO = "gloo"
    NCCL = "nccl"

    @staticmethod
    def coerce(b: "Backend | str") -> "Backend":
        b = Backend(str(b).lower()) if not isinstance(b, Backend) else b
        return Backend.SHM if b == Backend.GLOO else b
