"""Multi-process program domains over ``torch.distributed`` (port of
``ray_tpu/parallel/multihost.py``).

The reference joins every worker process to one multi-controller JAX
domain (``jax.distributed.initialize``), after which one program spans
the processes and XLA inserts the collectives.  The port's counterpart
is a ``torch.distributed`` process group over the gloo backend: the
processes exchange host (CPU) tensors, so any number of ranks may share
one card.  NCCL refuses two ranks on one device, and meshes, shardings
and device collectives are the multi-GPU slice's (ROADMAP queue A,
item 8).  This is the part the elastic worker loop needs:

- ``initialize()`` / ``shutdown()`` — join and leave the domain
  (``init_method="tcp://<coordinator>"``; rank 0 hosts the rendezvous);
  leaving is idempotent, so a process can join a domain of another size
  later (the re-mesh).
- ``gather_to_host()`` / ``put_global()`` — checkpoint plumbing: a tree
  whose leaves are replicated, or this rank's shards along one axis, is
  gathered to plain numpy holding the GLOBAL value on every rank, and a
  host tree is placed back as this rank's tensors on an explicit device.
- ``broadcast_one_to_all()`` — rank 0's value on every rank;
  ``allreduce()`` — a tree summed (or averaged) over the ranks, in one
  host buffer.

Outside a domain (one process) every call is the single-process
identity, as in the reference.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Any, Optional

import numpy as np
import torch

from ray_tpu_torch.parallel import transforms as tx

__all__ = [
    "initialize", "shutdown", "is_distributed", "process_index",
    "process_count", "gather_to_host", "put_global",
    "broadcast_one_to_all", "allreduce",
]

_LOOPBACK = ("127.0.0.1", "localhost", "::1")


def _dist():
    import torch.distributed as dist
    return dist


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *,
               init_timeout_s: Optional[float] = None) -> None:
    """Join this process to a gloo domain of ``num_processes`` ranks whose
    rendezvous rank 0 hosts at ``coordinator_address`` (``host:port``).
    A domain of one process is no domain (nothing to join).  A rank that
    cannot form the domain within ``init_timeout_s`` raises."""
    if num_processes <= 1:
        return
    dist = _dist()
    if dist.is_initialized():
        raise RuntimeError(
            "this process is in a domain already: shutdown() first")
    host = coordinator_address.rsplit(":", 1)[0].strip("[]")
    if host in _LOOPBACK and not os.environ.get("GLOO_SOCKET_IFNAME"):
        # every rank is on this host: gloo's pairs bind the loopback
        # interface, not whatever the host name resolves to
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    kw = {}
    if init_timeout_s is not None:
        kw["timeout"] = timedelta(seconds=float(init_timeout_s))
    dist.init_process_group(backend="gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id), **kw)


def shutdown() -> None:
    """Leave the domain (idempotent); the all-reduce's host buffer goes."""
    _pinned.clear()
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_distributed() -> bool:
    return process_count() > 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def _to_numpy(t: torch.Tensor) -> Any:
    """A host copy: numpy, or a CPU tensor for bfloat16 (numpy has none)."""
    h = t.detach().to("cpu", copy=True)
    return h if h.dtype == torch.bfloat16 else h.numpy()


def _from_host(h: Any) -> torch.Tensor:
    """A tensor over the host array, never written: ``put_global`` copies
    it (a state pulled from the object plane is a read-only view of the
    store's segment)."""
    if isinstance(h, torch.Tensor):
        return h
    import warnings
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(np.ascontiguousarray(h))


def _map(fn, tree: Any) -> Any:
    """``fn`` over the leaves of dicts, lists and tuples (an optimizer
    state nests tuples, which ``transforms.tree_map`` leaves alone);
    non-tensor leaves of a host tree are mapped too."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [_map(fn, v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree)


def gather_to_host(tree: Any, axis: Optional[int] = None) -> Any:
    """Tree of tensors → numpy tree of GLOBAL values, the same on every
    rank.  ``axis`` None: every leaf is replicated over the ranks, and this
    rank's copy is that value.  An int: every leaf is this rank's shard
    along ``axis``, in rank order, and the shards are all-gathered (equal
    shard shapes, the ``put_global`` layout)."""
    if axis is None or not is_distributed():
        return _map(_to_numpy, tree)
    dist = _dist()
    world = process_count()

    def gather(t: torch.Tensor):
        host = t.detach().cpu().contiguous()
        parts = [torch.empty_like(host) for _ in range(world)]
        dist.all_gather(parts, host)
        return _to_numpy(torch.cat(parts, dim=axis))

    return _map(gather, tree)


def put_global(tree: Any, device: Any, axis: Optional[int] = None) -> Any:
    """Host tree (every rank holding the same values, the
    ``gather_to_host`` contract) → this rank's tensors on ``device``:
    each leaf whole (``axis`` None) or its ``process_index()``-th of
    ``process_count()`` equal chunks along ``axis``."""
    dev = torch.device(device)
    rank, world = process_index(), process_count()

    def put(h):
        t = _from_host(h)
        if axis is not None and world > 1:
            if t.shape[axis] % world:
                raise ValueError(f"a leaf of shape {tuple(t.shape)} does "
                                 f"not split {world} ways along {axis}")
            t = t.chunk(world, dim=axis)[rank]
        return t.to(dev, copy=True).contiguous()

    return _map(put, tree)


def broadcast_one_to_all(x: Any) -> Any:
    """Rank 0's ``x`` (a number or numpy array) on every rank."""
    if not is_distributed():
        return x
    arr = np.array(x)                  # a copy the broadcast writes into
    _dist().broadcast(torch.from_numpy(arr), src=0)
    return arr if isinstance(x, np.ndarray) else arr.item()


def _host_buffer(n: int, dtype: torch.dtype, pinned: bool) -> torch.Tensor:
    """The all-reduce's host buffer: page-locked, and kept for the next
    call of the same size, when the leaves live on a card (its copies then
    run at the link's rate); a fresh one otherwise."""
    if not pinned:
        return torch.empty(n, dtype=dtype)
    buf = _pinned.get((n, dtype))
    if buf is None:
        _pinned.clear()
        buf = _pinned[(n, dtype)] = torch.empty(n, dtype=dtype,
                                                pin_memory=True)
    return buf


_pinned: dict = {}
# the last all-reduce's seconds: "to_host" (device-to-host copies),
# "reduce" (gloo), "to_device" (host-to-device copies)
last_allreduce: dict = {}


def allreduce(tree: Any, op: str = "mean",
              dtype: torch.dtype = torch.float32) -> Any:
    """Tree of tensors summed (``op="sum"``) or averaged (``"mean"``) over
    the ranks: every leaf rides one host buffer of ``dtype`` through one
    gloo all-reduce, and comes back on its device in its dtype.  One
    process: the tree itself."""
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
    if not is_distributed():
        return tree
    import time
    leaves = tx.tree_leaves(tree)
    cuda = any(t.is_cuda for t in leaves)
    t0 = time.perf_counter()
    flat = _host_buffer(sum(t.numel() for t in leaves), dtype, cuda)
    at = 0
    for t in leaves:
        flat[at:at + t.numel()].copy_(t.detach().reshape(-1),
                                      non_blocking=cuda)
        at += t.numel()
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    _dist().all_reduce(flat)
    if op == "mean":
        flat /= process_count()
    t2 = time.perf_counter()
    out, at = [], 0
    for t in leaves:
        n = t.numel()
        out.append(flat[at:at + n].view(t.shape).to(
            t.device, t.dtype, non_blocking=cuda, copy=True))
        at += n
    if cuda:
        torch.cuda.synchronize()    # the buffer is free for the next call
    last_allreduce.update(to_host=t1 - t0, reduce=t2 - t1,
                          to_device=time.perf_counter() - t2)
    it = iter(out)
    return tx.tree_map(lambda _: next(it), tree)
