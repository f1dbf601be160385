"""Object-plane collective backend (the GLOO analog).

Reference: ``python/ray/util/collective/collective_group/gloo_collective_group.py``
— CPU collectives among arbitrary actors/processes.  Here tensors move
through the shared-memory object store (zero-copy segments) and rendezvous
rides the GCS KV (the reference's rendezvous is a named actor storing NCCL
unique ids).

Synchronization model: every rank calls the same sequence of collectives in
the same order (the standard NCCL/GLOO contract).  Each call gets a
monotonically increasing sequence number; rank r publishes its contribution
under ``<group>/<seq>/<phase>/<r>`` and polls for the others.  Keys and
tensor objects from seq s-2 are reclaimed on entering seq s — safe because
entering seq s requires every rank to have *published* at s-1, which
requires every rank to have fully *read* s-2.

Small payloads (≤ ``INLINE_LIMIT``) are inlined into KV values; large
tensors go through the object store and only the object id travels via KV.

Tensors: numpy arrays and torch tensors.  A torch tensor leaves through
``.detach().cpu().numpy()`` (bfloat16, which numpy lacks, as float32: the
reduction then sums in float32 and rounds once), and a result comes back
as a tensor of the template's dtype on the template's device — a CUDA
tensor in gives a CUDA tensor out.
"""

from __future__ import annotations

import copy
import pickle
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ray_tpu_torch._private import worker as _worker_mod
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch.experimental import internal_kv
from ray_tpu_torch.util.collective.types import ReduceOp

NAMESPACE = "collective"
INLINE_LIMIT = 64 * 1024
_POLL_MIN, _POLL_MAX = 0.0002, 0.005


def _reduce_arrays(arrays: List[np.ndarray], op: ReduceOp) -> np.ndarray:
    out = np.array(arrays[0], copy=True)
    for a in arrays[1:]:
        if op == ReduceOp.SUM:
            out += a
        elif op == ReduceOp.PRODUCT:
            out *= a
        elif op == ReduceOp.MIN:
            np.minimum(out, a, out=out)
        else:
            np.maximum(out, a, out=out)
    return out


def _is_torch(x: Any) -> bool:
    return type(x).__module__.startswith("torch")


def _to_numpy(tensor: Any) -> np.ndarray:
    if _is_torch(tensor):
        import torch
        t = tensor.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(tensor)


def _like(result: np.ndarray, template: Any) -> Any:
    """Return ``result`` in the array namespace of ``template``: a torch
    template gives a tensor of its dtype on its device."""
    if _is_torch(template):
        import torch
        return torch.tensor(np.asarray(result)).to(
            device=template.device, dtype=template.dtype)
    return result


class ShmCollectiveGroup:
    def __init__(self, world_size: int, rank: int, group_name: str):
        if not (0 <= rank < world_size):
            raise ValueError(f"rank {rank} outside world of {world_size}")
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self._seq = 0
        self._p2p_send: Dict[int, int] = {}
        self._p2p_recv: Dict[int, int] = {}
        # refs published at seq s, released at s+2 (see module docstring)
        self._pinned: Dict[int, List[ObjectRef]] = {}
        # p2p refs can't use the epoch rule (recv timing is unknown); a
        # send's ref stays pinned until the matching recv deletes its key.
        self._p2p_pinned: List[tuple] = []  # (key, ref)

    # ------------------------------------------------------------------ kv
    @property
    def _w(self):
        return _worker_mod.global_worker()

    def _key(self, seq: int, phase: str, rank: int) -> str:
        return f"{self.group_name}/{seq}/{phase}/{rank}"

    def _kv_put(self, key: str, value: bytes) -> None:
        internal_kv._internal_kv_put(key, value, namespace=NAMESPACE)

    def _kv_get(self, key: str) -> Optional[bytes]:
        return internal_kv._internal_kv_get(key, namespace=NAMESPACE)

    def _kv_del(self, key: str) -> None:
        internal_kv._internal_kv_del(key, namespace=NAMESPACE)

    def _kv_count(self, prefix: str) -> List[str]:
        return internal_kv._internal_kv_list(prefix, namespace=NAMESPACE)

    # -------------------------------------------------------------- framing
    def _publish(self, seq: int, phase: str, tensor: Any) -> None:
        payload = pickle.dumps(tensor, protocol=5)
        if len(payload) <= INLINE_LIMIT:
            blob = b"I" + payload
        else:
            ref = self._w.put(tensor)
            self._pinned.setdefault(seq, []).append(ref)
            blob = b"R" + ref.hex().encode()
        self._kv_put(self._key(seq, phase, self.rank), blob)

    def _fetch(self, blob: bytes, timeout: float) -> Any:
        if blob[:1] == b"I":
            return pickle.loads(blob[1:])
        ref = ObjectRef(blob[1:].decode(), self._w, skip_release=True)
        # a copy: the value reads back as views onto the store, and the
        # sender frees the object once the protocol says it was read
        return copy.deepcopy(self._w.get_one(ref, timeout=timeout))

    def _await_keys(self, seq: int, phase: str, ranks: Sequence[int],
                    timeout: float) -> Dict[int, bytes]:
        want = {self._key(seq, phase, r): r for r in ranks}
        prefix = f"{self.group_name}/{seq}/{phase}/"
        deadline = time.monotonic() + timeout
        poll = _POLL_MIN
        while True:
            have = set(self._kv_count(prefix))
            if all(k in have for k in want):
                return {r: self._kv_get(k) for k, r in want.items()}
            if time.monotonic() > deadline:
                missing = [r for k, r in want.items() if k not in have]
                raise TimeoutError(
                    f"collective {self.group_name} seq={seq} phase={phase}: "
                    f"rank {self.rank} timed out waiting for ranks {missing}")
            time.sleep(poll)
            poll = min(poll * 2, _POLL_MAX)

    def _collect(self, seq: int, phase: str, ranks: Sequence[int],
                 timeout: float) -> Dict[int, Any]:
        blobs = self._await_keys(seq, phase, ranks, timeout)
        return {r: self._fetch(b, timeout) for r, b in blobs.items()}

    def _next_seq(self) -> int:
        self._seq += 1
        stale = self._seq - 2
        if stale in self._pinned:
            del self._pinned[stale]
        if stale >= 0:
            for phase in ("t", "b"):
                self._kv_del(self._key(stale, phase, self.rank))
        return self._seq

    # ---------------------------------------------------------------- ops
    def _ranks(self) -> List[int]:
        return list(range(self.world_size))

    def barrier(self, timeout: float = 60.0) -> None:
        seq = self._next_seq()
        self._kv_put(self._key(seq, "b", self.rank), b"")
        self._await_keys(seq, "b", self._ranks(), timeout)

    # Above this size the ring algorithm wins: the naive all-gather moves
    # N·S bytes per rank (every rank reads every contribution) while the
    # ring moves 2·S·(N-1)/N ≈ 2·S — the NCCL bus-bandwidth shape
    # (reference: nccl_collective_group ring semantics).
    # Below it, the 2(N-1) sequential KV hops cost more than the traffic.
    RING_THRESHOLD = 4 * 1024 * 1024

    def allreduce(self, tensor: Any, op: ReduceOp = ReduceOp.SUM,
                  timeout: float = 60.0) -> Any:
        arr = _to_numpy(tensor)
        if arr.nbytes >= self.RING_THRESHOLD and self.world_size > 2:
            return _like(self._allreduce_ring(arr, op, timeout), tensor)
        seq = self._next_seq()
        self._publish(seq, "t", arr)
        parts = self._collect(seq, "t", self._ranks(), timeout)
        out = _reduce_arrays([parts[r] for r in self._ranks()], op)
        return _like(out, tensor)

    def _allreduce_ring(self, arr: np.ndarray, op: ReduceOp,
                        timeout: float) -> np.ndarray:
        """Chunked ring allreduce: reduce-scatter then all-gather, each
        N-1 p2p hops of S/N-byte chunks through the object plane (chunks
        ride the slab/shm segments; only ids travel via KV).  Per-rank
        traffic is ~2·S instead of the naive N·S, so bus bandwidth holds
        flat as S grows instead of collapsing."""
        N, r = self.world_size, self.rank
        flat = np.ascontiguousarray(arr).reshape(-1)
        chunks = np.array_split(flat, N)
        acc: List[np.ndarray] = [np.array(c, copy=True) for c in chunks]
        right = (r + 1) % N
        left = (r - 1) % N
        # reduce-scatter: after N-1 hops, rank r holds the full reduction
        # of chunk (r+1) % N
        idx = r
        for _ in range(N - 1):
            self.send(acc[idx], right, timeout)
            idx = (idx - 1) % N
            incoming = self.recv(left, timeout)
            if op == ReduceOp.SUM:
                acc[idx] += incoming
            elif op == ReduceOp.PRODUCT:
                acc[idx] *= incoming
            elif op == ReduceOp.MIN:
                np.minimum(acc[idx], incoming, out=acc[idx])
            else:
                np.maximum(acc[idx], incoming, out=acc[idx])
        # all-gather: circulate the reduced chunks N-1 hops
        idx = (r + 1) % N
        for _ in range(N - 1):
            self.send(acc[idx], right, timeout)
            idx = (idx - 1) % N
            acc[idx] = self.recv(left, timeout)
        out = np.concatenate(acc)
        return out.reshape(arr.shape).astype(arr.dtype, copy=False)

    def _ack_barrier(self, seq: int, timeout: float) -> None:
        """Full all-rank ack: entering seq s+2 (which reclaims seq-s keys)
        then provably implies every rank finished seq s.  Required for ops
        where the main phase does not already collect from all ranks
        (broadcast, reduce) — see module docstring invariant."""
        self._kv_put(self._key(seq, "b", self.rank), b"")
        self._await_keys(seq, "b", self._ranks(), timeout)

    def reduce(self, tensor: Any, dst_rank: int = 0,
               op: ReduceOp = ReduceOp.SUM, timeout: float = 60.0) -> Any:
        seq = self._next_seq()
        self._publish(seq, "t", _to_numpy(tensor))
        out = tensor
        if self.rank == dst_rank:
            parts = self._collect(seq, "t", self._ranks(), timeout)
            out = _like(_reduce_arrays([parts[r] for r in self._ranks()], op),
                        tensor)
        self._ack_barrier(seq, timeout)
        return out

    def broadcast(self, tensor: Any, src_rank: int = 0,
                  timeout: float = 60.0) -> Any:
        seq = self._next_seq()
        if self.rank == src_rank:
            self._publish(seq, "t", _to_numpy(tensor))
            out = tensor
        else:
            parts = self._collect(seq, "t", [src_rank], timeout)
            out = _like(parts[src_rank], tensor)
        self._ack_barrier(seq, timeout)
        return out

    def allgather(self, tensor: Any, timeout: float = 60.0) -> List[Any]:
        seq = self._next_seq()
        self._publish(seq, "t", _to_numpy(tensor))
        parts = self._collect(seq, "t", self._ranks(), timeout)
        return [_like(parts[r], tensor) for r in self._ranks()]

    def reducescatter(self, tensor_list: Sequence[Any],
                      op: ReduceOp = ReduceOp.SUM,
                      timeout: float = 60.0) -> Any:
        if len(tensor_list) != self.world_size:
            raise ValueError("reducescatter needs world_size input tensors")
        seq = self._next_seq()
        self._publish(seq, "t", [_to_numpy(t) for t in tensor_list])
        parts = self._collect(seq, "t", self._ranks(), timeout)
        mine = [parts[r][self.rank] for r in self._ranks()]
        return _like(_reduce_arrays(mine, op), tensor_list[self.rank])

    def alltoall(self, tensor_list: Sequence[Any],
                 timeout: float = 60.0) -> List[Any]:
        """Rank r receives tensor_list[r] from every rank (Ulysses building
        block over the object plane; the in-mesh path is compiled)."""
        if len(tensor_list) != self.world_size:
            raise ValueError("alltoall needs world_size input tensors")
        seq = self._next_seq()
        self._publish(seq, "t", [_to_numpy(t) for t in tensor_list])
        parts = self._collect(seq, "t", self._ranks(), timeout)
        return [_like(parts[r][self.rank], tensor_list[0])
                for r in self._ranks()]

    def send(self, tensor: Any, dst_rank: int, timeout: float = 60.0) -> None:
        seq = self._p2p_send.get(dst_rank, 0) + 1
        self._p2p_send[dst_rank] = seq
        key = f"{self.group_name}/p2p/{self.rank}-{dst_rank}/{seq}"
        payload = pickle.dumps(_to_numpy(tensor), protocol=5)
        if len(payload) <= INLINE_LIMIT:
            self._kv_put(key, b"I" + payload)
        else:
            ref = self._w.put(_to_numpy(tensor))
            # lazily unpin completed sends (recv deletes the key on read)
            self._p2p_pinned = [
                (k, r) for k, r in self._p2p_pinned
                if self._kv_get(k) is not None]
            self._p2p_pinned.append((key, ref))
            self._kv_put(key, b"R" + ref.hex().encode())

    def recv(self, src_rank: int, timeout: float = 60.0) -> Any:
        seq = self._p2p_recv.get(src_rank, 0) + 1
        self._p2p_recv[src_rank] = seq
        key = f"{self.group_name}/p2p/{src_rank}-{self.rank}/{seq}"
        deadline = time.monotonic() + timeout
        poll = _POLL_MIN
        while True:
            blob = self._kv_get(key)
            if blob is not None:
                # read before the key goes: the sender keeps the object
                # pinned only while the key exists, and frees it on its
                # next send once the key is gone
                out = self._fetch(blob, max(deadline - time.monotonic(),
                                            0.0))
                self._kv_del(key)
                return out
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"recv from rank {src_rank} timed out ({key})")
            time.sleep(poll)
            poll = min(poll * 2, _POLL_MAX)

    def destroy(self) -> None:
        self._pinned.clear()
        self._p2p_pinned.clear()
