"""Device collective group: a group of ranks, each holding its tensor on
its own device (counterpart of ``ray_tpu/util/collective/collective_group/
xla_group.py``).

The reference's group is ONE process owning N devices, each op a compiled
``shard_map`` collective over them.  The port's is the PyTorch idiom: one
process a rank, a ``torch.distributed`` (sub-)group of the ranks, each op
called by every rank with the tensor on its device and returning a tensor
on that device.  Rank r's tensor plays row r of the reference's stacked
input.

The transport is chosen by placement and recorded on the group
(``transport``):

- ``"nccl"``: every rank has a card of its own — an NCCL group, device
  tensors straight to the library.  A failed NCCL init raises; the group
  never switches transport.  (Unverified: every card machine this port
  has run on held one card; ROADMAP queue A, item 8b.)
- ``"staged"``: ranks share a card (NCCL refuses two ranks on one
  device) — each op copies the tensor into a page-locked host buffer,
  runs the gloo collective on it, and copies the result back.
- ``"gloo"``: CPU tensors, straight to gloo.

``seconds`` accumulates the time of the three legs (``to_host``,
``wire``, ``to_device``); only ``"staged"`` has the copies.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ray_tpu_torch.util.collective.types import ReduceOp

TRANSPORTS = ("nccl", "staged", "gloo")
NCCL_SHARED = ("NCCL refuses two ranks on one card: ranks {} share {}; "
               "use the staged transport (pinned host buffers over gloo)")

_REDUCE = {ReduceOp.SUM: "SUM", ReduceOp.PRODUCT: "PRODUCT",
           ReduceOp.MIN: "MIN", ReduceOp.MAX: "MAX"}


def _dist():
    import torch.distributed as dist
    return dist


def placement(device: torch.device) -> Tuple[str, str]:
    """(host, card) of this rank: the card by its UUID, so two processes
    sharing one card see the same string."""
    import socket
    if device.type != "cuda":
        return socket.gethostname(), "cpu"
    props = torch.cuda.get_device_properties(device)
    return socket.gethostname(), str(getattr(props, "uuid", device.index))


def choose_transport(device: torch.device,
                     requested: Optional[str] = None) -> str:
    """The transport for ranks placed as the domain's are (a collective
    over the default group: every rank calls it)."""
    if requested is not None and requested not in TRANSPORTS:
        raise ValueError(f"unknown transport {requested!r} (expected one "
                         f"of {TRANSPORTS})")
    dist = _dist()
    places: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(places, placement(device))
    return transport_for(places, device.type, requested)


def transport_for(places: Sequence[Tuple[str, str]], device_type: str,
                  requested: Optional[str] = None) -> str:
    """The rule: every rank's (host, card) → the transport.  ``requested``
    forces one; NCCL over a shared card, and a card's tensors over plain
    gloo, raise instead of switching."""
    if device_type != "cuda":
        if requested not in (None, "gloo"):
            raise ValueError(f"transport {requested!r} needs a card; this "
                             f"rank's device is {device_type}")
        return "gloo"
    if requested == "gloo":
        raise ValueError("gloo takes host tensors: a rank on a card uses "
                         "'staged' or 'nccl'")
    if any(p[1] == "cpu" for p in places):
        raise ValueError(f"ranks on cards and on the CPU in one group: "
                         f"{list(places)}")
    places = [tuple(p) for p in places]
    shared = sorted({p for p in places if places.count(p) > 1})
    if requested == "nccl" and shared:
        ranks = [r for r, p in enumerate(places) if p in shared]
        raise RuntimeError(NCCL_SHARED.format(ranks, shared[0][1]))
    return requested or ("staged" if shared else "nccl")


def flatten(leaves: Sequence[torch.Tensor],
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The leaves as one flat tensor of ``dtype`` on the first leaf's
    device: one collective for a tree (``unflatten`` undoes it)."""
    dev = leaves[0].device
    return torch.cat([t.detach().reshape(-1).to(dev, dtype)
                      for t in leaves])


def unflatten(flat: torch.Tensor, like: Sequence[torch.Tensor]
              ) -> List[torch.Tensor]:
    """``flat`` cut into the leaves of ``like``, each in its shape,
    dtype and device."""
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view(t.shape).to(
            t.device, t.dtype))
        at += t.numel()
    return out


class _Pending:
    """An issued permutation: ``wait()`` gives the received tensor on the
    group's device (zeros where no rank sends to this one)."""

    def __init__(self, group: "DeviceCollectiveGroup", works, buf, like):
        self.group, self.works, self.buf, self.like = group, works, buf, like

    def wait(self) -> torch.Tensor:
        t0 = time.perf_counter()
        for w in self.works:
            w.wait()
        g = self.group
        g.seconds["wire"] += time.perf_counter() - t0
        if self.buf is None:
            return torch.zeros_like(self.like)
        return g._from_wire(self.buf, self.like)


class DeviceCollectiveGroup:
    """Ranks ``ranks`` (global ranks, in group order) of the domain, this
    one at ``rank``, collectives over ``transport``."""

    def __init__(self, pg, ranks: Sequence[int], device: torch.device,
                 transport: str, name: str = "default"):
        dist = _dist()
        self.pg = pg
        self.ranks = list(ranks)
        self.global_rank = dist.get_rank()
        self.rank = self.ranks.index(self.global_rank) \
            if self.global_rank in self.ranks else -1
        self.world_size = len(self.ranks)
        self.device = torch.device(device)
        self.transport = transport
        self.group_name = name
        self.seconds: Dict[str, float] = {"to_host": 0.0, "wire": 0.0,
                                          "to_device": 0.0}
        self._pinned: Dict[Tuple[int, torch.dtype, str], torch.Tensor] = {}

    @classmethod
    def new(cls, ranks: Sequence[int], device: torch.device, transport: str,
            name: str = "default") -> "DeviceCollectiveGroup":
        """Make the sub-group of ``ranks``: every rank of the domain calls
        this for every sub-group, in the same order."""
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}")
        backend = "nccl" if transport == "nccl" else "gloo"
        pg = _dist().new_group(list(ranks), backend=backend)
        return cls(pg, ranks, device, transport, name)

    @classmethod
    def over_domain(cls, name: str = "default",
                    transport: Optional[str] = None
                    ) -> "DeviceCollectiveGroup":
        """The group of every rank of the domain (``multihost``), on each
        rank's device; ``transport`` forces one."""
        from ray_tpu_torch.parallel import multihost
        if not multihost.is_distributed():
            raise RuntimeError(
                "a device group needs a torch.distributed domain "
                "(parallel.multihost.initialize, or TorchConfig("
                "use_distributed=True) in Train)")
        dev = multihost.device()
        chosen = choose_transport(dev, transport)
        return cls.new(range(multihost.process_count()), dev, chosen, name)

    # ------------------------------------------------------------ staging
    @property
    def staged(self) -> bool:
        return self.transport == "staged"

    def _host(self, like: torch.Tensor, slot: str) -> torch.Tensor:
        key = (like.numel(), like.dtype, slot)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(
                like.numel(), dtype=like.dtype, pin_memory=True)
        return buf.view(like.shape)

    def _to_wire(self, t: torch.Tensor, slot: str = "send") -> torch.Tensor:
        """The tensor the wire reads: a host copy when staged (the copy
        waits for the kernels that make ``t``), else ``t`` itself."""
        t = t.detach()
        if not self.staged:
            return t.contiguous()
        t0 = time.perf_counter()
        h = self._host(t, slot)
        h.copy_(t)
        self.seconds["to_host"] += time.perf_counter() - t0
        return h

    def _wire_buffer(self, like: torch.Tensor, slot: str = "recv"
                     ) -> torch.Tensor:
        if self.staged:
            return self._host(like, slot)
        return torch.empty(like.shape, dtype=like.dtype, device=like.device)

    def _from_wire(self, h: torch.Tensor, like: torch.Tensor
                   ) -> torch.Tensor:
        if not self.staged:
            return h
        t0 = time.perf_counter()
        out = h.to(self.device, copy=True)
        self.seconds["to_device"] += time.perf_counter() - t0
        return out.view(like.shape)

    def _timed(self, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, group=self.pg, **kw)
        self.seconds["wire"] += time.perf_counter() - t0
        return out

    # -------------------------------------------------------- primitives
    def all_reduce(self, t: torch.Tensor, op: ReduceOp = ReduceOp.SUM
                   ) -> torch.Tensor:
        """The elementwise reduction of every rank's ``t``."""
        if self.world_size == 1:
            return t.detach().clone()
        dist = _dist()
        h = self._to_wire(t).clone() if not self.staged else self._to_wire(t)
        self._timed(dist.all_reduce, h,
                    op=getattr(dist.ReduceOp, _REDUCE[ReduceOp.coerce(op)]))
        return self._from_wire(h, t)

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t``, in rank order."""
        if self.world_size == 1:
            return [t.detach().clone()]
        h = self._to_wire(t)
        parts = [self._wire_buffer(t, f"gather{i}")
                 for i in range(self.world_size)]
        self._timed(_dist().all_gather, parts, h)
        return [self._from_wire(p, t) for p in parts]

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (world, ...): row j goes to rank j; row j of the result
        came from rank j."""
        if self.world_size == 1:
            return t.detach().clone()
        if t.shape[0] != self.world_size:
            raise ValueError(f"leading axis {t.shape[0]} != group size "
                             f"{self.world_size}")
        h = self._to_wire(t)
        out = self._wire_buffer(t, "a2a")
        self._timed(_dist().all_to_all_single, out, h)
        return self._from_wire(out, t)

    def reduce_scatter(self, t: torch.Tensor, op: ReduceOp = ReduceOp.SUM
                       ) -> torch.Tensor:
        """``t`` (world, ...): the reduction over ranks of row ``rank``
        (an all-to-all, then the reduction of the rows that came in)."""
        rows = self.all_to_all(t)
        op = ReduceOp.coerce(op)
        if op == ReduceOp.SUM:
            return rows.sum(0, dtype=t.dtype)
        if op == ReduceOp.PRODUCT:
            return rows.prod(0, dtype=t.dtype)
        return rows.amax(0) if op == ReduceOp.MAX else rows.amin(0)

    def permute_start(self, t: torch.Tensor,
                      pairs: Sequence[Tuple[int, int]]) -> _Pending:
        """Issue a permutation (``(src, dst)`` group ranks; no rank twice
        as a source or as a destination): this rank's ``t`` goes to its
        destination, and ``wait()`` on the result gives its source's."""
        dist = _dist()
        me = self.rank
        dst = [d for s, d in pairs if s == me]
        src = [s for s, d in pairs if d == me]
        if dst == [me] and src == [me]:
            return _Pending(self, [], self._to_wire(t, "self").clone()
                            if self.staged else t.detach().clone(), t)
        ops = []
        if dst:
            ops.append(dist.P2POp(dist.isend, self._to_wire(t, "send"),
                                  self.ranks[dst[0]], self.pg))
        buf = None
        if src:
            buf = self._wire_buffer(t, "recv")
            ops.append(dist.P2POp(dist.irecv, buf, self.ranks[src[0]],
                                  self.pg))
        t0 = time.perf_counter()
        works = dist.batch_isend_irecv(ops) if ops else []
        self.seconds["wire"] += time.perf_counter() - t0
        return _Pending(self, works, buf, t)

    # ------------------------------------------- util.collective's ops
    def allreduce(self, tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM
                  ) -> torch.Tensor:
        return self.all_reduce(tensor, op)

    def allgather(self, tensor: torch.Tensor) -> torch.Tensor:
        """(world, ...): row r is rank r's tensor."""
        return torch.stack(self.all_gather(tensor))

    def reducescatter(self, tensor: torch.Tensor,
                      op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
        """``tensor`` (world, ...), row i this rank's contribution to rank
        i; returns the sum over ranks of their row ``rank``."""
        return self.reduce_scatter(tensor, op)

    def alltoall(self, tensor: torch.Tensor) -> torch.Tensor:
        """``tensor`` (world, ...); out[j] = rank j's row ``rank``."""
        return self.all_to_all(tensor)

    def broadcast(self, tensor: torch.Tensor, src_rank: int = 0
                  ) -> torch.Tensor:
        h = self._to_wire(tensor).clone() if not self.staged \
            else self._to_wire(tensor)
        self._timed(_dist().broadcast, h, src=self.ranks[src_rank])
        return self._from_wire(h, tensor)

    def reduce(self, tensor: torch.Tensor, dst_rank: int = 0,
               op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
        out = self.all_reduce(tensor, op)
        return out if self.rank == dst_rank else tensor

    def send(self, tensor: torch.Tensor, dst_rank: int) -> None:
        """``tensor`` to group rank ``dst_rank``: its shape and dtype
        first, then its data."""
        dist = _dist()
        dist.send_object_list([(tuple(tensor.shape), tensor.dtype)],
                              dst=self.ranks[dst_rank], group=self.pg)
        self._timed(dist.send, self._to_wire(tensor),
                    dst=self.ranks[dst_rank])

    def recv(self, src_rank: int) -> torch.Tensor:
        """The tensor group rank ``src_rank`` sent, on this rank's
        device."""
        dist = _dist()
        meta: List[Any] = [None]
        dist.recv_object_list(meta, src=self.ranks[src_rank], group=self.pg)
        shape, dtype = meta[0]
        like = torch.empty(shape, dtype=dtype, device=self.device)
        buf = self._wire_buffer(like, "recv")
        self._timed(dist.recv, buf, src=self.ranks[src_rank])
        return self._from_wire(buf, like)

    def barrier(self) -> None:
        self._timed(_dist().barrier)

    def destroy(self) -> None:
        """Free the pinned buffers and this rank's handle on the group.
        Every rank of the group calls it: a barrier first, so no rank
        drops the group while a peer still sets it up or uses it."""
        self._pinned.clear()
        dist = _dist()
        if self.pg is not None and dist.is_initialized() \
                and self.pg is not dist.group.WORLD:
            dist.barrier(group=self.pg)
            dist.destroy_process_group(self.pg)
        self.pg = None

    def __repr__(self) -> str:
        return (f"DeviceCollectiveGroup({self.group_name!r}, ranks="
                f"{self.ranks}, rank={self.rank}, device={self.device}, "
                f"transport={self.transport})")
