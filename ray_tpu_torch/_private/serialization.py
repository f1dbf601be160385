"""Serialization: cloudpickle + pickle-5 out-of-band buffers.

Reference: ``python/ray/_private/serialization.py`` + vendored cloudpickle
(SURVEY.md §2.3) — closures serialized by value; large contiguous buffers
(numpy arrays and torch tensors) travel out-of-band so reads are zero-copy
views onto shared memory; ``ObjectRef``s found inside values are surfaced
so the control plane can track borrowed references.

A torch tensor (or ``nn.Parameter``) ships its bytes out of band with its
dtype, device and ``requires_grad`` (a bfloat16 tensor as a 2-byte
integer view: numpy has no bfloat16).  A CPU tensor reads back as a
tensor over the stored buffer — read-only memory, as the reference's
numpy views are, so clone it before writing in place.  A CUDA tensor
reads back on the same ``cuda:<index>`` (GPU workers see the node's
cards in the driver's order); in a process that sees no card (a plain
worker), or fewer cards than the index, that raises instead of landing
on the CPU.  A Parameter reads back as a Parameter, a tensor with
``requires_grad`` as a leaf that requires grad.  Each tensor ships its
own bytes: views of one storage read back as separate tensors, as numpy
views do, and other tensor subclasses pickle in band.

Wire layout of a stored object::

    [8B magic+version][8B pickle_len][8B nbuf]
    [nbuf * 16B (offset,len) table]
    [pickle bytes][padding to 64][buf0 .. bufN  each 64-aligned]

64-byte alignment keeps numpy views cache-line aligned (and XLA host-buffer
friendly for the dlpack staging path).
"""

from __future__ import annotations

import io
import pickle
import struct
import sys
import warnings
from typing import Any, Callable, Dict, List, Tuple, Type

import cloudpickle

_MAGIC = b"RTPUOBJ1"
_ALIGN = 64
_HDR = struct.Struct("<8sQQ")
_ENT = struct.Struct("<QQ")


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class _RefCollector:
    """Pickler hook that records ObjectRefs serialized inside a value."""

    def __init__(self) -> None:
        self.refs: List[Any] = []

    def __call__(self, ref: Any) -> None:
        self.refs.append(ref)


# The custom-serializer registry (ray.util.register_serializer parity).
_CUSTOM: Dict[Type, Tuple[Callable, Callable]] = {}


def _reduce_tensor(t: Any) -> Tuple[Callable, tuple]:
    torch = sys.modules["torch"]
    host = t.detach().to("cpu").contiguous()
    if host.dtype == torch.bfloat16:
        arr = host.view(torch.int16).numpy()
    else:
        arr = host.numpy()
    return _rebuild_tensor, (arr, str(t.dtype).rpartition(".")[2],
                             str(t.device), t.requires_grad,
                             isinstance(t, torch.nn.Parameter))


def _rebuild_tensor(arr: Any, dtype: str, device: str,
                    requires_grad: bool = False,
                    parameter: bool = False) -> Any:
    import torch
    with warnings.catch_warnings():
        # a store read is a read-only view (see the module docstring)
        warnings.filterwarnings("ignore", message=".*not writable.*")
        t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    dev = torch.device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have == 0:
            raise RuntimeError(
                "a CUDA tensor was read in a process that sees no CUDA "
                "device; read it in a task or actor declared with num_gpus "
                "(plain workers see no card)")
        if (dev.index or 0) >= have:
            raise RuntimeError(
                f"a tensor of {device} was read in a process that sees "
                f"{have} CUDA device(s); declare num_gpus to cover it")
        t = t.to(dev)
    elif dev.type != "cpu":
        t = t.to(dev)
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad)


def register_serializer(cls: Type, *, serializer: Callable, deserializer: Callable) -> None:
    _CUSTOM[cls] = (serializer, deserializer)


def deregister_serializer(cls: Type) -> None:
    _CUSTOM.pop(cls, None)


class _Pickler(cloudpickle.Pickler):
    def __init__(self, file, protocol, buffer_callback, ref_collector):
        super().__init__(file, protocol=protocol, buffer_callback=buffer_callback)
        self._ref_collector = ref_collector

    def persistent_id(self, obj):  # noqa: D401 - pickle hook
        return None

    def reducer_override(self, obj):
        from ray_tpu_torch._private.object_ref import ObjectRef, _deserialize_object_ref
        if isinstance(obj, ObjectRef):
            if self._ref_collector is not None:
                self._ref_collector(obj)
            return (_deserialize_object_ref, (str(obj.id),))
        ser = _CUSTOM.get(type(obj))
        if ser is not None:
            serializer, deserializer = ser
            return (deserializer, (serializer(obj),))
        torch = sys.modules.get("torch")   # no tensor exists without it
        if torch is not None and type(obj) in (torch.Tensor,
                                               torch.nn.Parameter) \
                and obj.layout == torch.strided:
            return _reduce_tensor(obj)
        # Delegate to cloudpickle's reducer_override — that is where its
        # by-value class/function pickling lives; returning NotImplemented
        # here would skip it and local classes would fail to pickle.
        return super().reducer_override(obj)


_NONE_PICKLE: bytes = pickle.dumps(None, protocol=5)


def serialize(value: Any) -> Tuple[bytes, List[pickle.PickleBuffer], List[Any]]:
    """Returns (pickle_bytes, oob_buffers, contained_object_refs)."""
    if value is None:
        # the single most common task result (side-effect tasks): its
        # pickle is a constant — skip the pickler machinery entirely
        return _NONE_PICKLE, [], []
    buffers: List[pickle.PickleBuffer] = []
    collector = _RefCollector()
    f = io.BytesIO()
    p = _Pickler(f, protocol=5, buffer_callback=buffers.append,
                 ref_collector=collector)
    p.dump(value)
    return f.getvalue(), buffers, collector.refs


def serialized_size(pickled: bytes, buffers: List[pickle.PickleBuffer]) -> int:
    n = _HDR.size + _ENT.size * len(buffers)
    n = _align(n + len(pickled))
    for b in buffers:
        n = _align(n + _raw_view(b).nbytes)
    return n


def _raw_view(b: pickle.PickleBuffer) -> memoryview:
    """Physical-order byte view of an out-of-band buffer.

    ``raw()`` handles F-contiguous arrays (plain ``cast('B')`` is restricted
    to C-contiguous views); unpickling rebuilds from the same physical order.
    """
    try:
        return b.raw()
    except BufferError:
        v = memoryview(b)
        return v if (v.ndim == 1 and v.format == "B") else memoryview(bytes(v))


def write_to(buf: memoryview, pickled: bytes, buffers: List[pickle.PickleBuffer]) -> int:
    """Write the wire layout into ``buf``; returns bytes written."""
    views = [_raw_view(b) for b in buffers]
    off = _HDR.size + _ENT.size * len(views)
    pickle_off = off
    off = _align(off + len(pickled))
    entries = []
    for v in views:
        entries.append((off, v.nbytes))
        off = _align(off + v.nbytes)
    _HDR.pack_into(buf, 0, _MAGIC, len(pickled), len(views))
    pos = _HDR.size
    for e in entries:
        _ENT.pack_into(buf, pos, *e)
        pos += _ENT.size
    buf[pickle_off:pickle_off + len(pickled)] = pickled
    for (boff, blen), v in zip(entries, views):
        buf[boff:boff + blen] = v
    return off


def to_wire_bytes(pickled: bytes,
                  buffers: List[pickle.PickleBuffer]) -> bytearray:
    """Assemble the wire layout in memory (for inline/slab objects)."""
    out = bytearray(serialized_size(pickled, buffers))
    write_to(memoryview(out), pickled, buffers)
    return out


def serialize_to_bytes(value: Any) -> Tuple[bytearray, List[Any]]:
    """One-shot: full wire-format bytes (for inline objects / socket
    transport).  Returns a bytearray — callers only need a bytes-like;
    an extra ``bytes()`` copy would double the cost of every large
    transfer."""
    pickled, buffers, refs = serialize(value)
    return to_wire_bytes(pickled, buffers), refs


def write_value_to_fd(fd: int, pickled: bytes,
                      buffers: List[pickle.PickleBuffer]) -> int:
    """Stream the wire layout straight to ``fd`` with writev — for the
    tmpfs segment plane, where write() beats mmap-and-memcpy ~2x (fresh
    pages fault once in the kernel instead of once per user-space touch).
    Returns bytes written.  One data copy total: buffers → page cache."""
    import os
    views = [_raw_view(b) for b in buffers]
    head_len = _HDR.size + _ENT.size * len(views)
    off = _align(head_len + len(pickled))
    entries = []
    for v in views:
        entries.append((off, v.nbytes))
        off = _align(off + v.nbytes)
    head = bytearray(_align(head_len + len(pickled)))
    _HDR.pack_into(head, 0, _MAGIC, len(pickled), len(views))
    pos = _HDR.size
    for e in entries:
        _ENT.pack_into(head, pos, *e)
        pos += _ENT.size
    head[head_len:head_len + len(pickled)] = pickled

    iov: List[memoryview] = [memoryview(head)]
    cursor = len(head)
    for (boff, blen), v in zip(entries, views):
        if boff > cursor:                     # alignment gap
            iov.append(memoryview(bytes(boff - cursor)))
            cursor = boff
        iov.append(v)
        cursor += blen
    if off > cursor:
        iov.append(memoryview(bytes(off - cursor)))

    total = 0
    while iov:
        n = os.writev(fd, iov[:1024])
        total += n
        # drop fully-written segments; re-slice a partial one
        while iov and n >= iov[0].nbytes:
            n -= iov[0].nbytes
            iov.pop(0)
        if iov and n:
            iov[0] = iov[0][n:]
    return total


def deserialize_from(buf: memoryview) -> Any:
    """Zero-copy deserialize: numpy arrays view ``buf`` directly.

    Caller must keep the backing mmap alive while views are alive (handled by
    ``ObjectRef`` pinning its ``MappedObject``).
    """
    magic, plen, nbuf = _HDR.unpack_from(buf, 0)
    if magic != _MAGIC:
        raise ValueError("corrupt ray_tpu_torch object header")
    pos = _HDR.size
    entries = []
    for _ in range(nbuf):
        entries.append(_ENT.unpack_from(buf, pos))
        pos += _ENT.size
    pickled = bytes(buf[pos:pos + plen])
    oob = [pickle.PickleBuffer(buf[o:o + l]) for o, l in entries]
    return pickle.loads(pickled, buffers=oob)


def dumps_call(obj: Any) -> bytes:
    """Plain cloudpickle (functions, task specs over the control socket)."""
    return cloudpickle.dumps(obj, protocol=5)


def loads_call(data: bytes) -> Any:
    return pickle.loads(data)
