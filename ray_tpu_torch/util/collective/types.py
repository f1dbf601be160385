"""Collective op/backend types.

Reference: ``python/ray/util/collective/types.py`` — ``ReduceOp`` and
backend identifiers.  The port has two backends: the object-plane ``shm``
group (the reference's ``gloo`` name is an alias of it) and the device
group over a ``torch.distributed`` domain (``device``; the JAX package's
``xla`` name is an alias of it, and ``nccl`` is the device group with
the NCCL transport forced).
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
    DEVICE — the device group: the ranks of a ``torch.distributed``
    domain, each tensor on its rank's device, the transport chosen by
    placement (``collective_group/device_group.py``).
    NCCL — the device group with the NCCL transport (ranks that share a
    card raise).
    """

    SHM = "shm"
    DEVICE = "device"
    GLOO = "gloo"
    XLA = "xla"
    NCCL = "nccl"

    @staticmethod
    def coerce(b: "Backend | str") -> "Backend":
        b = Backend(str(b).lower()) if not isinstance(b, Backend) else b
        if b == Backend.GLOO:
            return Backend.SHM
        return Backend.DEVICE if b == Backend.XLA else b
