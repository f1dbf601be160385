"""Shared-memory object store (plasma-equivalent data plane).

Reference: ``src/ray/object_manager/plasma/`` (SURVEY.md §2.1) — a per-node
shared-memory immutable object store with create→seal→get semantics, zero-copy
mmap reads, and eviction/spill when full.

TPU-native design choice: instead of one big mmap'd slab with a custom
allocator, each object is a file under ``/dev/shm`` (tmpfs) mapped on demand.
The kernel's page cache *is* the slab allocator; creation is O(1), reads are
zero-copy ``mmap``, and cross-process attach is by name — which sidesteps
CPython's ``multiprocessing.shared_memory`` resource-tracker unlink hazards
entirely.  A C++ slab store (``native/plasma_store.cc``) is used for
allocation bookkeeping when built; this module is the portable path and the
Python API for both.

Capacity accounting + LRU spill-to-disk live here; *refcounts* live in the
control plane (GCS), which calls ``delete_object`` when counts hit zero.
"""

from __future__ import annotations

import mmap
import os
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Optional, Tuple

from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.exceptions import ObjectStoreFullError

_SHM_DIR = Path(os.environ.get("RTT_SHM_DIR", "/dev/shm"))
_PREFIX = "rtt_"


def _seg_path(object_id: str) -> Path:
    return _SHM_DIR / f"{_PREFIX}{object_id}"


class MappedObject:
    """A sealed object mapped read-only; keeps the mmap alive for zero-copy views."""

    __slots__ = ("object_id", "_mm", "_fileobj", "buf")

    def __init__(self, object_id: str, path: Path):
        self.object_id = object_id
        fd = os.open(str(path), os.O_RDONLY)
        try:
            size = os.fstat(fd).st_size
            self._mm = mmap.mmap(fd, size, prot=mmap.PROT_READ)
        finally:
            os.close(fd)
        self.buf = memoryview(self._mm)

    def close(self) -> None:
        try:
            self.buf.release()
            self._mm.close()
        except (BufferError, ValueError):
            pass  # still-live numpy views pin the map; GC will retry via __del__

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass


def _move_file(src: str, dst: str) -> None:
    """rename, or copy+unlink across filesystems (spill dirs usually live
    on disk while segments live on tmpfs — os.replace alone raises EXDEV)."""
    try:
        os.replace(src, dst)
    except OSError as e:
        import errno
        import shutil
        if e.errno != errno.EXDEV:
            raise
        tmp = dst + ".mv"
        try:
            shutil.copyfile(src, tmp)
            os.replace(tmp, dst)
        except BaseException:
            # a half-written temp (e.g. ENOSPC mid-spill) would eat the
            # very disk space spilling needs — clean it before re-raising
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        os.unlink(src)


class ShmObjectStore:
    """Node-local store daemon side: create/seal/evict/delete + accounting."""

    def __init__(self, capacity_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None):
        self.capacity = capacity_bytes or GLOBAL_CONFIG.object_store_memory_mb * 1024 * 1024
        self.spill_dir = Path(spill_dir) if spill_dir else None
        self._lock = threading.Lock()
        # object_id -> size, LRU order (oldest first); only *sealed* objects.
        self._sealed: "OrderedDict[str, int]" = OrderedDict()   # guarded by: _lock
        self._unsealed: Dict[str, int] = {}                     # guarded by: _lock
        self._spilled: Dict[str, int] = {}                      # guarded by: _lock
        self._used = 0                                          # guarded by: _lock

    # -- creation (writer side) ---------------------------------------------
    def create(self, object_id: str, size: int) -> Tuple[memoryview, object]:
        """Allocate a writable buffer; returns (view, handle). Call seal() after."""
        with self._lock:
            if self._used + size > self.capacity:
                self._evict_locked(self._used + size - self.capacity)
            if self._used + size > self.capacity:
                raise ObjectStoreFullError(
                    f"object of {size} bytes does not fit "
                    f"(used {self._used}/{self.capacity})")
            self._used += size
            self._unsealed[object_id] = size
        path = _seg_path(object_id)
        try:
            fd = os.open(str(path), os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
            try:
                try:
                    os.ftruncate(fd, max(size, 1))
                    mm = mmap.mmap(fd, max(size, 1),
                                   prot=mmap.PROT_READ | mmap.PROT_WRITE)
                finally:
                    os.close(fd)
            except BaseException:
                # only after a successful O_EXCL open: the segment is
                # OURS to remove (unlinking on an open failure could
                # delete a pre-existing segment of the same name)
                try:
                    os.unlink(str(path))
                except OSError:
                    pass
                raise
        except BaseException:
            # roll back the reservation: a failed create (ENOSPC on a
            # full tmpfs, EEXIST, mmap failure) must not leave _used
            # inflated and a phantom _unsealed entry pinned forever
            with self._lock:
                if self._unsealed.pop(object_id, None) is not None:
                    self._used -= size
            raise
        return memoryview(mm)[:size], mm

    def adopt(self, object_id: str, size: int) -> None:
        """Account for a sealed object another process wrote directly to shm.

        Workers create+seal result objects in /dev/shm themselves (the data
        plane needs no daemon round-trip); the control plane adopts them into
        capacity/LRU accounting when the result metadata arrives.
        """
        with self._lock:
            if object_id in self._sealed or object_id in self._spilled:
                return
            if self._used + size > self.capacity:
                self._evict_locked(self._used + size - self.capacity)
            self._used += size
            self._sealed[object_id] = size

    def seal(self, object_id: str, handle: object) -> None:
        handle.flush() if hasattr(handle, "flush") else None
        with self._lock:
            size = self._unsealed.pop(object_id)
            self._sealed[object_id] = size

    # -- reads (any process; staticmethod: data plane needs no daemon) -------
    @staticmethod
    def map_readonly(object_id: str) -> MappedObject:
        return MappedObject(object_id, _seg_path(object_id))

    @staticmethod
    def exists_in_shm(object_id: str) -> bool:
        return _seg_path(object_id).exists()

    def touch(self, object_id: str) -> None:
        """LRU bump on access."""
        with self._lock:
            if object_id in self._sealed:
                self._sealed.move_to_end(object_id)

    # -- spill / restore -----------------------------------------------------
    def _spill_path(self, object_id: str) -> Path:
        assert self.spill_dir is not None
        return self.spill_dir / f"{_PREFIX}{object_id}"

    def _evict_locked(self, need_bytes: int) -> None:
        if not GLOBAL_CONFIG.object_store_eviction or self.spill_dir is None:
            return
        freed = 0
        victims = []
        for oid, size in self._sealed.items():
            victims.append((oid, size))
            freed += size
            if freed >= need_bytes:
                break
        for oid, size in victims:
            src = _seg_path(oid)
            self.spill_dir.mkdir(parents=True, exist_ok=True)
            _move_file(str(src), str(self._spill_path(oid)))
            del self._sealed[oid]
            self._spilled[oid] = size
            self._used -= size

    def restore(self, object_id: str) -> bool:
        """Bring a spilled object back into shm. True if restored or present."""
        with self._lock:
            if object_id in self._sealed:
                return True
            if object_id not in self._spilled:
                return False
            size = self._spilled[object_id]
            if self._used + size > self.capacity:
                self._evict_locked(self._used + size - self.capacity)
            _move_file(str(self._spill_path(object_id)), str(_seg_path(object_id)))
            del self._spilled[object_id]
            self._sealed[object_id] = size
            self._used += size
            return True

    def location(self, object_id: str) -> str:
        with self._lock:
            if object_id in self._sealed or object_id in self._unsealed:
                return "shm"
            if object_id in self._spilled:
                return "spilled"
            return "missing"

    # -- deletion ------------------------------------------------------------
    def delete_object(self, object_id: str) -> None:
        with self._lock:
            size = self._sealed.pop(object_id, None)
            if size is None:
                size = self._unsealed.pop(object_id, None)
            if size is not None:
                self._used -= size
                try:
                    os.unlink(str(_seg_path(object_id)))
                except FileNotFoundError:
                    pass
                return
            if self._spilled.pop(object_id, None) is not None:
                try:
                    os.unlink(str(self._spill_path(object_id)))
                except FileNotFoundError:
                    pass

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "capacity": self.capacity,
                "used": self._used,
                "num_sealed": len(self._sealed),
                "num_spilled": len(self._spilled),
            }

    def shutdown(self) -> None:
        with self._lock:
            ids = list(self._sealed) + list(self._unsealed) + list(self._spilled)
        for oid in ids:
            self.delete_object(oid)
