"""A node's CUDA cards: how many it has, and which ones its GPU workers
see.  Shared by the head (``init``, ``GcsServer._spawn_worker``) and the
``NodeAgent``, so a head and an agent on the same kind of host declare
and hand out their cards alike.  torch is imported only to count cards,
and only when ``RTT_NUM_GPUS`` does not say."""

from __future__ import annotations

import math
import os


def detect_gpus() -> float:
    """The host's CUDA cards: ``RTT_NUM_GPUS`` when set, else
    ``torch.cuda.device_count()``."""
    override = os.environ.get("RTT_NUM_GPUS")
    if override is not None:
        return float(override)
    import torch
    return float(torch.cuda.device_count())


def cuda_visible_devices(num_gpus: float) -> str:
    """``CUDA_VISIBLE_DEVICES`` for a GPU worker of a node that declares
    ``num_gpus`` cards: the first ``ceil(num_gpus)`` entries of this
    process's own list when it has one, else ``0..n-1``."""
    n = math.ceil(num_gpus)
    parent = os.environ.get("CUDA_VISIBLE_DEVICES")
    if parent:
        return ",".join(parent.split(",")[:n]) if n else parent
    return ",".join(str(i) for i in range(n))
