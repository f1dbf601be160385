"""Public collective API.

Reference: ``python/ray/util/collective/collective.py`` —
``init_collective_group`` / ``create_collective_group`` / ``allreduce`` /
``allgather`` / ``reducescatter`` / ``broadcast`` / ``reduce`` / ``barrier``
/ ``send`` / ``recv`` / ``destroy_collective_group`` / ``get_rank`` /
``get_collective_group_size``.

Backends (types.Backend): ``shm`` — object-plane collectives among
arbitrary actors/processes (the GLOO analog; ``gloo`` is its alias); and
``device`` (``nccl`` forces its NCCL transport) — the device group over
the ranks of this process's ``torch.distributed`` domain
(``parallel.multihost``), each tensor on its rank's device, the
transport chosen by placement (``collective_group/device_group.py``).

The shm group's rendezvous is through the GCS KV (namespace
"collective"): each rank registers ``<group>/meta/<rank>`` and init
blocks until all ranks are present, mirroring the reference's
named-actor NCCL-uid rendezvous.  The device group's is the domain's.
"""

from __future__ import annotations

import pickle
import time
from typing import Any, Dict, List, Optional, Sequence

from ray_tpu_torch.util.collective.collective_group.device_group import (
    DeviceCollectiveGroup,
)
from ray_tpu_torch.util.collective.collective_group.shm_group import (
    ShmCollectiveGroup, _POLL_MAX, _POLL_MIN,
)
from ray_tpu_torch.util.collective.types import Backend, ReduceOp

_groups: Dict[str, Any] = {}


def _register_alias(alias: str, group_name: str) -> None:
    """Process-local alias → existing group (used by Train so user code can
    say "train_default" while the KV keys use a per-run unique name)."""
    _groups[alias] = _groups[group_name]


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _groups


def get_rank(group_name: str = "default") -> int:
    g = _groups.get(group_name)
    return g.rank if g else -1


def get_collective_group_size(group_name: str = "default") -> int:
    g = _groups.get(group_name)
    return g.world_size if g else -1


def init_collective_group(world_size: int, rank: int,
                          backend: str = "shm",
                          group_name: str = "default") -> None:
    """Register this process as ``rank`` of ``group_name`` and block until
    all ``world_size`` ranks have registered.  ``device`` / ``nccl``: the
    ranks of this process's ``torch.distributed`` domain, which must be
    ``world_size`` ranks with this one at ``rank`` (``nccl`` forces that
    transport)."""
    if group_name in _groups:
        raise RuntimeError(f"collective group {group_name!r} already "
                           "initialized in this process")
    b = Backend.coerce(backend)
    if b in (Backend.DEVICE, Backend.NCCL):
        from ray_tpu_torch.parallel import multihost
        if multihost.is_distributed() and (
                multihost.process_count(), multihost.process_index()) \
                != (world_size, rank):
            raise ValueError(
                f"group {group_name!r}: rank {rank} of {world_size}, but "
                f"this process is rank {multihost.process_index()} of a "
                f"domain of {multihost.process_count()}")
        _groups[group_name] = DeviceCollectiveGroup.over_domain(
            group_name, "nccl" if b == Backend.NCCL else None)
        return
    g = ShmCollectiveGroup(world_size, rank, group_name)
    meta = pickle.dumps({"world_size": world_size, "backend": b.value})
    g._kv_put(f"{group_name}/meta/{rank}", meta)
    # Block until the whole group is present (reference init semantics).
    deadline = time.monotonic() + 120.0
    poll = _POLL_MIN
    while True:
        keys = g._kv_count(f"{group_name}/meta/")
        if len(keys) >= world_size:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"group {group_name}: only {len(keys)}/{world_size} ranks "
                "registered")
        time.sleep(poll)
        poll = min(poll * 2, _POLL_MAX)
    _groups[group_name] = g


def _init_in_actor(_instance, world_size: int, rank: int, backend: str,
                   group_name: str) -> None:
    init_collective_group(world_size, rank, backend, group_name)


def create_collective_group(actors: Sequence[Any], world_size: Optional[int] = None,
                            ranks: Optional[Sequence[int]] = None,
                            backend: str = "shm",
                            group_name: str = "default") -> None:
    """Driver-side: install a collective group across ``actors``.

    Each actor becomes one rank (``ranks`` defaults to positional order).
    Reference: ``create_collective_group`` declared the group and the NCCL
    communicator was lazily built; here init runs eagerly in every actor via
    ``__ray_apply__`` and this call blocks until rendezvous completes.
    """
    import ray_tpu_torch
    world_size = world_size or len(actors)
    ranks = list(ranks) if ranks is not None else list(range(len(actors)))
    if len(actors) != len(ranks):
        raise ValueError("actors and ranks length mismatch")
    refs = [a.__ray_apply__.remote(_init_in_actor, world_size, r, backend,
                                   group_name)
            for a, r in zip(actors, ranks)]
    ray_tpu_torch.get(refs)


def destroy_collective_group(group_name: str = "default") -> None:
    """Tear down THIS rank's state only (reference semantics) — deleting
    other ranks' keys would break peers mid-collective."""
    g = _groups.pop(group_name, None)
    if g is None:
        return
    # drop aliases pointing at the same group
    for k, v in list(_groups.items()):
        if v is g:
            del _groups[k]
    if isinstance(g, DeviceCollectiveGroup):
        g.destroy()
        return
    import re
    # exactly this rank's phase keys (<group>/<seq>/<phase>/<rank>), its
    # meta key, and p2p keys it SENT (<group>/p2p/<rank>-<dst>/<seq>) —
    # never keys whose trailing seq number merely equals the rank
    pat = re.compile(
        rf"^{re.escape(g.group_name)}/(\d+/[a-z]+/{g.rank}"
        rf"|meta/{g.rank}|p2p/{g.rank}-\d+/\d+)$")
    for k in g._kv_count(f"{g.group_name}/"):
        if pat.match(k):
            g._kv_del(k)
    g.destroy()


def _group(group_name: str) -> Any:
    g = _groups.get(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group {group_name!r} is not initialized in this "
            "process (call init_collective_group / create_collective_group)")
    return g


# ------------------------------------------------------------------ ops API
def allreduce(tensor: Any, group_name: str = "default",
              op: ReduceOp = ReduceOp.SUM) -> Any:
    return _group(group_name).allreduce(tensor, ReduceOp.coerce(op))


def reduce(tensor: Any, dst_rank: int = 0, group_name: str = "default",
           op: ReduceOp = ReduceOp.SUM) -> Any:
    return _group(group_name).reduce(tensor, dst_rank, ReduceOp.coerce(op))


def broadcast(tensor: Any, src_rank: int = 0,
              group_name: str = "default") -> Any:
    return _group(group_name).broadcast(tensor, src_rank)


def allgather(tensor: Any, group_name: str = "default") -> List[Any]:
    return _group(group_name).allgather(tensor)


def reducescatter(tensor_list: Sequence[Any], group_name: str = "default",
                  op: ReduceOp = ReduceOp.SUM) -> Any:
    return _group(group_name).reducescatter(tensor_list, ReduceOp.coerce(op))


def alltoall(tensor_list: Sequence[Any],
             group_name: str = "default") -> List[Any]:
    return _group(group_name).alltoall(tensor_list)


def barrier(group_name: str = "default") -> None:
    _group(group_name).barrier()


def send(tensor: Any, dst_rank: int, group_name: str = "default") -> None:
    _group(group_name).send(tensor, dst_rank)


def recv(src_rank: int, group_name: str = "default") -> Any:
    return _group(group_name).recv(src_rank)
