"""Experimental: shared-memory channels + compiled actor DAGs.

Reference: ``python/ray/experimental/channel`` + compiled graphs (aDAG)
— newer-vintage upstream features (SURVEY.md §2.6): a ``Channel`` is a
pre-allocated single-producer/single-consumer transport that bypasses
the control plane entirely, and a compiled graph pre-wires channels
through a static DAG of actor methods so repeated executions pay zero
per-call scheduling.

These channels cover the HOST side — e.g. feeding an inference actor
chain at high rate without per-call control-plane messages.  A tensor
goes over a channel as ``pickle`` sends it; where it lands is the
runtime's rule: a CUDA tensor arrives on ``cuda`` in a process that sees
the card, and a stage whose process cannot decode it (a ``num_gpus=0``
actor) forwards the decode error, so the caller's ``result()`` raises it.

``Channel``: a ring buffer (mmap) in the runtime's shm directory (the
store's ``RTT_SHM_DIR``, where the run's other segments live) with
head/tail counters and spin-then-sleep waits; payloads are pickled
objects.  Its name carries the creating process's pid, as an object
segment's does, so a head that boots after that process's session died
reaps it (``session.reap_orphan_segments``).  Same-host only — exactly the reference's primary
(shared-memory) channel; cross-host channels fall back to the normal
actor-call path when compiled.

``compile_chain``: the aDAG-lite — a linear pipeline of actor methods.
Each hop gets a channel; each actor runs a pump thread reading its
input channel, applying the bound method, writing its output channel.
``execute()`` writes the input channel and reads the final output —
no task submission, no GCS traffic, per-hop latency is a shm write +
wakeup.  All chain actors must live on the driver's host (the channel
re-attach fails with a clear error otherwise); cross-host stages should
use the normal actor-call path.
"""

from __future__ import annotations

import mmap
import os
import pickle
import struct
import time
import uuid
from typing import Any, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private import shm_store

_HDR = struct.Struct("<QQ")          # head (write cursor), tail (read cursor)
_LEN = struct.Struct("<I")


class Channel:
    """SPSC ring buffer over a segment in the runtime's shm directory.

    One writer process, one reader process; ``put`` blocks while full,
    ``get`` blocks while empty (spin briefly, then sleep-poll — the
    reference channel uses the same wait shape)."""

    def __init__(self, capacity_bytes: int = 4 * 1024 * 1024,
                 name: Optional[str] = None, create: bool = True):
        self.name = name or \
            f"rtt_chan_{os.getpid():08x}_{uuid.uuid4().hex[:12]}"
        self.capacity = capacity_bytes
        # the store's directory as this process resolved it; the GCS hands
        # the same one to every worker it spawns
        self.dir = str(shm_store._SHM_DIR)
        path = self.path
        if create:
            fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
            try:
                os.ftruncate(fd, _HDR.size + capacity_bytes)
            finally:
                os.close(fd)
        self._attach()

    @property
    def path(self) -> str:
        return os.path.join(self.dir, self.name)

    def _attach(self) -> None:
        path = self.path
        try:
            fd = os.open(path, os.O_RDWR)
        except FileNotFoundError:
            raise RuntimeError(
                f"channel segment {path} not found: shm channels are "
                f"same-host only — this process is not on the creating "
                f"host (use normal actor calls for cross-host stages)")
        try:
            size = os.fstat(fd).st_size
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self.capacity = len(self._mm) - _HDR.size

    # channels pickle by name: the receiving process re-attaches
    def __getstate__(self):
        return {"name": self.name, "capacity": self.capacity,
                "dir": self.dir}

    def __setstate__(self, st):
        self.name = st["name"]
        self.capacity = st["capacity"]
        self.dir = st["dir"]
        self._attach()

    # ------------------------------------------------------------------ ring
    def _cursors(self):
        return _HDR.unpack_from(self._mm, 0)

    def _set_head(self, v: int) -> None:
        struct.pack_into("<Q", self._mm, 0, v)

    def _set_tail(self, v: int) -> None:
        struct.pack_into("<Q", self._mm, 8, v)

    def _write_bytes(self, off: int, data: bytes) -> None:
        base = _HDR.size
        pos = off % self.capacity
        first = min(len(data), self.capacity - pos)
        self._mm[base + pos:base + pos + first] = data[:first]
        if first < len(data):
            self._mm[base:base + len(data) - first] = data[first:]

    def _read_bytes(self, off: int, n: int) -> bytes:
        base = _HDR.size
        pos = off % self.capacity
        first = min(n, self.capacity - pos)
        out = bytes(self._mm[base + pos:base + pos + first])
        if first < n:
            out += bytes(self._mm[base:base + n - first])
        return out

    def _wait(self, cond, timeout: Optional[float]):
        deadline = None if timeout is None else time.monotonic() + timeout
        spins = 0
        while True:
            v = cond()
            if v is not None:
                return v
            spins += 1
            if spins < 200:      # ~burst latency: pure spin
                continue
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"channel {self.name} wait timed out")
            time.sleep(0.0002)

    # ------------------------------------------------------------------- api
    def put(self, value: Any, timeout: Optional[float] = None) -> None:
        data = pickle.dumps(value, protocol=5)
        need = _LEN.size + len(data)
        if need > self.capacity:
            raise ValueError(f"object of {len(data)}B exceeds channel "
                             f"capacity {self.capacity}B")

        def has_room():
            head, tail = self._cursors()
            return head if self.capacity - (head - tail) >= need else None

        head = self._wait(has_room, timeout)
        self._write_bytes(head, _LEN.pack(len(data)))
        self._write_bytes(head + _LEN.size, data)
        self._set_head(head + need)   # publish after the payload is in

    def get(self, timeout: Optional[float] = None) -> Any:
        def has_item():
            head, tail = self._cursors()
            return tail if head - tail >= _LEN.size else None

        tail = self._wait(has_item, timeout)
        (n,) = _LEN.unpack(self._read_bytes(tail, _LEN.size))

        def full_item():
            head, _ = self._cursors()
            return tail if head - tail >= _LEN.size + n else None

        self._wait(full_item, timeout)
        data = self._read_bytes(tail + _LEN.size, n)
        # consumed before it is decoded: a payload this process cannot
        # decode raises once, and the next get reads the next item
        self._set_tail(tail + _LEN.size + n)
        return pickle.loads(data)

    def close(self) -> None:
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass

    def destroy(self) -> None:
        self.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass


def _pump(instance, method_name: str, in_chan: Channel, out_chan: Channel,
          stop_flag: dict) -> None:
    method = getattr(instance, method_name)

    def put_checked(item) -> bool:
        """Bounded put that honors the stop flag while the ring is full
        (an unbounded put would strand this thread forever if the
        downstream consumer died)."""
        while not stop_flag.get("stop"):
            try:
                out_chan.put(item, timeout=0.5)
                return True
            except TimeoutError:
                continue
        return False

    while not stop_flag.get("stop"):
        try:
            item = in_chan.get(timeout=0.5)
        except TimeoutError:
            continue
        except Exception as e:  # noqa: BLE001 - surfaced to the caller
            # a payload this process cannot decode (a CUDA tensor in a
            # process without the card): the ring has moved past it, so
            # forward the error in its place — a dead pump would wedge
            # the chain with only a bare timeout at the caller
            put_checked(_Err(RuntimeError(
                f"stage {method_name} could not decode its input: {e!r}")))
            continue
        if isinstance(item, _Stop):
            put_checked(item)
            return
        if isinstance(item, _Err):
            put_checked(item)   # forward the ORIGINAL upstream error —
            continue            # feeding it to this stage would mask it
        try:
            out = method(item)
        except Exception as e:  # noqa: BLE001 - surfaced to the caller
            try:
                put_checked(_Err(e))
            except Exception:   # noqa: BLE001 - unpicklable exception:
                # a crashed pump would wedge the chain with no diagnosis
                put_checked(_Err(RuntimeError(
                    f"stage {method_name} error (unpicklable): {e!r}")))
            continue
        try:
            put_checked(out)
        except Exception as e:  # noqa: BLE001 - unpicklable/oversized
            # RESULT: forward a descriptive error instead of dying (a
            # dead pump wedges the chain with only a bare timeout)
            put_checked(_Err(RuntimeError(
                f"stage {method_name} result not transportable: {e!r}")))


class _Stop:
    pass


class _Err:
    def __init__(self, e: BaseException):
        self.e = e


class CompiledChain:
    """A pre-wired pipeline: input channel → actor method → ... → output.

    ``execute`` is synchronous; ``execute_async``/``result`` overlap
    pipeline stages across consecutive inputs (each hop has its own
    channel, so N in-flight items occupy N stages concurrently)."""

    def __init__(self, actors: List[Any], methods: List[str],
                 capacity_bytes: int = 4 * 1024 * 1024):
        assert len(actors) == len(methods) and actors
        self._chain_id = uuid.uuid4().hex[:12]
        self._chans = [Channel(capacity_bytes)
                       for _ in range(len(actors) + 1)]
        self._actors = actors
        self._inflight = 0
        # start a pump thread inside every actor (same-host shm channels)
        refs = []
        try:
            for i, (a, m) in enumerate(zip(actors, methods)):
                refs.append(a.rtt_channel_pump_start.remote(
                    m, self._chans[i], self._chans[i + 1], self._chain_id))
            ray_tpu_torch.get(refs)  # pumps running before first execute
        except BaseException:
            # partial start (e.g. a dead actor): stop the pumps that DID
            # start and free the segments, or they leak forever
            for a in actors:
                try:
                    a.rtt_channel_pump_stop.remote(self._chain_id)
                except Exception:  # noqa: BLE001
                    pass
            for c in self._chans:
                c.destroy()
            raise

    def execute(self, value: Any, timeout: Optional[float] = 60.0) -> Any:
        self.execute_async(value, timeout=timeout)
        return self.result(timeout=timeout)

    def execute_async(self, value: Any,
                      timeout: Optional[float] = 60.0) -> None:
        # bounded: a dead/stalled first stage must surface as a
        # TimeoutError here, not an unkillable spin in the ring wait
        self._chans[0].put(value, timeout=timeout)
        self._inflight += 1

    def result(self, timeout: Optional[float] = 60.0) -> Any:
        if self._inflight <= 0:
            raise RuntimeError("no execution in flight")
        out = self._chans[-1].get(timeout=timeout)
        self._inflight -= 1
        if isinstance(out, _Err):
            raise out.e
        return out

    def teardown(self) -> None:
        try:
            self._chans[0].put(_Stop(), timeout=1.0)
            self._chans[-1].get(timeout=5.0)  # drained through every stage
        except (TimeoutError, OSError):
            pass
        # belt and braces: raise every pump's stop flag too — if the
        # _Stop could not flow (full ring, dead stage) the threads exit
        # at their next 0.5s poll instead of leaking forever
        try:
            ray_tpu_torch.get(
                [a.rtt_channel_pump_stop.remote(self._chain_id)
                 for a in self._actors], timeout=10)
        except Exception:  # noqa: BLE001 - actor may already be dead
            pass
        for c in self._chans:
            c.destroy()


def enable_channels(actor_cls):
    """Class decorator: adds the channel-pump entry point to an actor.

    (The reference injects its accelerated-DAG machinery into every
    actor; here opting in is explicit.)"""
    def rtt_channel_pump_start(self, method, in_chan, out_chan,
                                chain_id="default"):
        import threading
        flag = {}
        t = threading.Thread(target=_pump,
                             args=(self, method, in_chan, out_chan, flag),
                             daemon=True, name="channel-pump")
        t.start()
        if not hasattr(self, "_rtt_pump_flags"):
            self._rtt_pump_flags = {}
        # scoped per chain: tearing one chain down must not kill the
        # pumps another live chain runs on this same actor
        self._rtt_pump_flags.setdefault(chain_id, []).append(flag)
        return True

    def rtt_channel_pump_stop(self, chain_id=None):
        """Stop one chain's pumps, or ALL pumps when called with no
        chain id (the orphan-recovery escape hatch)."""
        flags = getattr(self, "_rtt_pump_flags", {})
        for cid in ([chain_id] if chain_id is not None else list(flags)):
            for flag in flags.pop(cid, []):
                flag["stop"] = True
        return True

    actor_cls.rtt_channel_pump_start = rtt_channel_pump_start
    actor_cls.rtt_channel_pump_stop = rtt_channel_pump_stop
    return actor_cls


def compile_chain(bindings: List[tuple],
                  capacity_bytes: int = 4 * 1024 * 1024) -> CompiledChain:
    """``bindings``: [(actor_handle, "method"), ...] — a linear DAG.
    Actor classes must be decorated with ``@enable_channels`` (below
    ``@ray_tpu_torch.remote``)."""
    actors = [a for a, _ in bindings]
    methods = [m for _, m in bindings]
    return CompiledChain(actors, methods, capacity_bytes)
