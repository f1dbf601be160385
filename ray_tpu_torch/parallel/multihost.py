"""Multi-process program domains over ``torch.distributed`` (port of
``ray_tpu/parallel/multihost.py``).

The reference joins every worker process to one multi-controller JAX
domain (``jax.distributed.initialize``), after which one program spans
the processes and XLA inserts the collectives.  The port's counterpart
is a ``torch.distributed`` process group over the gloo backend: the
processes exchange host (CPU) tensors, so any number of ranks may share
one card (NCCL refuses two ranks on one device).  Meshes over the
domain's ranks are ``parallel/mesh.py``; their device collectives ride
the transport ``util/collective/collective_group/device_group.py``
chooses by placement (NCCL, or this domain's gloo through pinned host
buffers where ranks share a card).

- ``initialize()`` / ``shutdown()`` — join and leave the domain
  (``init_method="tcp://<coordinator>"``; rank 0 hosts the rendezvous);
  leaving is idempotent, so a process can join a domain of another size
  later (the re-mesh).  ``device=`` gives the rank its device
  (``device()``): the card when the worker holds a GPU share, the CPU
  only when the caller asks.
- ``gather_to_host()`` / ``put_global()`` — checkpoint plumbing: a tree
  whose leaves are replicated, or this rank's shards along one axis, is
  gathered to plain numpy holding the GLOBAL value on every rank, and a
  host tree is placed back as this rank's tensors on an explicit device
  (whole, split along one axis, or sliced by sharding specs over a
  mesh: ZeRO-3's ``fsdp`` pieces and the ``expert`` slices included,
  so a sharded train state checkpoints in the one-rank state's layout).
- ``broadcast_one_to_all()`` — rank 0's value on every rank;
  ``allreduce()`` — a tree summed (or averaged) over the ranks, in one
  flat buffer, through the domain's device group (``domain_group()``).

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
    "initialize", "shutdown", "is_distributed", "process_index", "device",
    "process_count", "gather_to_host", "put_global",
    "broadcast_one_to_all", "allreduce", "domain_group",
]

_LOOPBACK = ("127.0.0.1", "localhost", "::1")


def _dist():
    import torch.distributed as dist
    return dist


_device: list = []


def device() -> torch.device:
    """This rank's device: the one ``initialize`` was given, else the card
    (``resolve_device(None)``: no card raises)."""
    from ray_tpu_torch._device import resolve_device
    return _device[0] if _device else resolve_device(None)


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *,
               init_timeout_s: Optional[float] = None,
               device: Any = None, store: Any = None) -> None:
    """Join this process to a gloo domain of ``num_processes`` ranks whose
    rendezvous rank 0 hosts at ``coordinator_address`` (``host:port``),
    or, with ``store``, through that ``torch.distributed`` store (a
    ``TCPStore`` another process hosts, e.g. on port 0).  A domain of one
    process is no domain (nothing to join).  A rank that cannot form the
    domain within ``init_timeout_s`` raises.  ``device`` (None: the card)
    is the rank's device for meshes and device groups."""
    _device.clear()
    if device is not None:
        from ray_tpu_torch._device import resolve_device
        _device.append(resolve_device(device))
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
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = f"tcp://{coordinator_address}"
    dist.init_process_group(backend="gloo", world_size=int(num_processes),
                            rank=int(process_id), **kw)


def shutdown() -> None:
    """Leave the domain (idempotent); its device groups go with it."""
    _domain.clear()
    _device.clear()
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


def _gather_spec(t: torch.Tensor, spec: Any, mesh: Any) -> torch.Tensor:
    """A leaf's global value from the ranks' slices under ``spec``: each
    split dim gathered over its axes, the innermost first (a short last
    piece padded for the gather and cut after it)."""
    from ray_tpu_torch.parallel.mesh import entry_axes
    for d, entry in enumerate(spec):
        for a in reversed(entry_axes(entry)):
            if mesh.shape[a] == 1:
                continue
            g = mesh.group(a)
            n = torch.tensor([t.shape[d]], device=t.device)
            sizes = [int(x) for x in g.all_gather(n)]
            pad = max(sizes) - t.shape[d]
            if pad:
                shape = list(t.shape)
                shape[d] = pad
                t = torch.cat([t, t.new_zeros(shape)], dim=d)
            t = torch.cat([p.narrow(d, 0, s) for p, s in
                           zip(g.all_gather(t), sizes)], dim=d)
    return t


def _map_specs(fn, specs: Any) -> None:
    """``fn`` over a spec tree's ``PartitionSpec`` leaves in ``_map``'s
    order."""
    from ray_tpu_torch.parallel.mesh import PartitionSpec
    if isinstance(specs, dict):
        for k in sorted(specs):
            _map_specs(fn, specs[k])
    elif isinstance(specs, (list, tuple)) \
            and not isinstance(specs, PartitionSpec):
        for v in specs:
            _map_specs(fn, v)
    else:
        fn(specs)


def gather_to_host(tree: Any, axis: Optional[int] = None,
                   specs: Any = None, mesh: Any = None) -> Any:
    """Tree of tensors → numpy tree of GLOBAL values, the same on every
    rank.  ``axis`` None: every leaf is replicated over the ranks, and this
    rank's copy is that value.  An int: every leaf is this rank's shard
    along ``axis``, in rank order, and the shards are all-gathered (equal
    shard shapes, the ``put_global`` layout).  ``specs`` (a tree of
    sharding specs shaped as ``tree``, e.g. ``spmd.state_specs``) with the
    ``mesh``: every leaf is this rank's slice under its spec."""
    if specs is not None:
        if mesh is None:
            raise ValueError("gather_to_host(specs=...) needs the mesh")
        leaves = []
        _map(leaves.append, tree)
        flat_specs = []
        _map_specs(flat_specs.append, specs)
        it = iter([_to_numpy(_gather_spec(t, s, mesh))
                   for t, s in zip(leaves, flat_specs)])
        return _map(lambda _: next(it), tree)
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


def put_global(tree: Any, device: Any, axis: Optional[int] = None,
               specs: Any = None, mesh: Any = None) -> Any:
    """Host tree (every rank holding the same values, the
    ``gather_to_host`` contract) → this rank's tensors on ``device``:
    each leaf whole (``axis`` None), its ``process_index()``-th of
    ``process_count()`` equal chunks along ``axis``, or, with ``specs``
    (a tree of sharding specs, ``mesh.param_specs``) and a ``mesh``, the
    slice its mesh coordinates select (``mesh.local_slice``)."""
    dev = torch.device(device)
    rank, world = process_index(), process_count()
    if specs is not None:
        from ray_tpu_torch.parallel.mesh import local_slice
        if mesh is None:
            raise ValueError("put_global(specs=...) needs the mesh")
        flat_specs = []
        _map_specs(flat_specs.append, specs)
        it = iter(flat_specs)
        return _map(lambda h: local_slice(_from_host(h), next(it), mesh).to(
            dev, copy=True).contiguous(), tree)

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


_domain: dict = {}
# the last all-reduce's seconds, by the domain group's legs: "to_host"
# (device-to-host copies), "wire" (gloo), "to_device" (host-to-device
# copies)
last_allreduce: dict = {}


def domain_group(dev: torch.device):
    """The device group of every rank of the domain on ``dev``
    (``util/collective/collective_group/device_group.py``: its transport
    by the ranks' placement), made at the first call for ``dev``; every
    rank makes it at the same point of its program."""
    group = _domain.get(dev)
    if group is None:
        from ray_tpu_torch.util.collective.collective_group.device_group \
            import DeviceCollectiveGroup, choose_transport
        group = _domain[dev] = DeviceCollectiveGroup.new(
            range(process_count()), dev, choose_transport(dev),
            f"domain-{dev}")
    return group


def allreduce(tree: Any, op: str = "mean",
              dtype: torch.dtype = torch.float32) -> Any:
    """Tree of tensors summed (``op="sum"``) or averaged (``"mean"``) over
    the ranks: every leaf rides one flat buffer of ``dtype`` through one
    all-reduce of the domain's device group on the leaves' device, and
    comes back on its device in its dtype.  One process: the tree
    itself."""
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
    if not is_distributed():
        return tree
    from ray_tpu_torch.util.collective.collective_group import device_group
    leaves = tx.tree_leaves(tree)
    group = domain_group(leaves[0].device)
    before = dict(group.seconds)
    flat = group.all_reduce(device_group.flatten(leaves, dtype))
    if op == "mean":
        flat /= process_count()
    out = device_group.unflatten(flat, leaves)
    last_allreduce.update({k: v - before[k]
                           for k, v in group.seconds.items()})
    it = iter(out)
    return tx.tree_map(lambda _: next(it), tree)
