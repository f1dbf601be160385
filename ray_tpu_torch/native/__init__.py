"""Native (C++) components, loaded via ctypes.

The reference ships its runtime as C++ (raylet, plasma, core worker —
SURVEY.md §2.1); here the native layer is built per-component and loaded
through ``ctypes`` (no pybind11 in this environment).  Components:

- ``slab_store.cc`` — shared-memory slab object store (plasma-equivalent
  small-object data plane; see the .cc header comment for the design).

Build strategy: compile on first import with ``g++ -O2 -shared -fPIC`` into
``ray_tpu_torch/_build/native/`` and cache by source mtime.  If no compiler is
available the callers fall back to pure-Python paths; nothing in the
framework *requires* the native layer, it is the fast path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_SRC_DIR = Path(__file__).parent / "src"
# under the package's (git-ignored) build directory, beside the CUDA
# kernels' library
_BUILD_DIR = Path(__file__).parent.parent / "_build" / "native"

_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _compile(src: Path, out: Path, *, cmd_prefix: Optional[list] = None
             ) -> bool:
    """Compile src → out (atomic replace; concurrent builders race
    benignly).  Default toolchain is the C++ shared-lib build;
    ``cmd_prefix`` overrides everything before the ``-o tmp src`` tail
    (used by the CPython-extension build)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(out.parent))
    os.close(fd)
    prefix = cmd_prefix or ["g++", "-O2", "-g", "-shared", "-fPIC",
                            "-std=c++17"]
    cmd = [*prefix, "-o", tmp, str(src)]
    if cmd_prefix is None:
        cmd.append("-lpthread")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        os.unlink(tmp)
        return False
    if proc.returncode != 0:
        os.unlink(tmp)
        import logging
        logging.getLogger(__name__).warning(
            "native build failed:\n%s", proc.stderr[-2000:])
        return False
    os.replace(tmp, out)  # atomic: concurrent builders race benignly
    return True


def _ensure_built(name: str) -> Optional[Path]:
    """Caller must hold _build_lock."""
    src = _SRC_DIR / f"{name}.cc"
    out = _BUILD_DIR / f"lib{name}.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    return out if _compile(src, out) else None


_wirecodec = None
_wirecodec_tried = False


def load_wirecodec():
    """Build + import the C rtmsg codec (``src/wirecodec.c``, a CPython
    extension); None if no toolchain.  wire.py prefers it over the
    pure-Python encoder — same language-neutral format, ~10x the speed,
    which lets v2 frames ride rtmsg even on the µs-critical hot kinds."""
    global _wirecodec, _wirecodec_tried
    if _wirecodec is not None or _wirecodec_tried:
        return _wirecodec
    with _build_lock:
        if _wirecodec is not None or _wirecodec_tried:
            return _wirecodec
        _wirecodec_tried = True
        if os.environ.get("RTT_NO_NATIVE"):
            return None
        import sysconfig
        src = _SRC_DIR / "wirecodec.c"
        out = _BUILD_DIR / "wirecodec.so"
        if not (out.exists()
                and out.stat().st_mtime >= src.stat().st_mtime):
            if not _compile(src, out, cmd_prefix=[
                    "gcc", "-O2", "-shared", "-fPIC",
                    "-I", sysconfig.get_path("include")]):
                return None
        try:
            import importlib.util
            # NOTE: the name's last component must be "wirecodec" — the
            # extension's init symbol is PyInit_wirecodec
            spec = importlib.util.spec_from_file_location(
                "wirecodec", str(out))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except (ImportError, OSError):
            return None
        _wirecodec = mod
        return _wirecodec


def load_slab_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the slab-store library; None if unavailable."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    with _build_lock:
        # everything below happens under the lock so a concurrent caller
        # never observes _lib_tried before _lib is assigned
        if _lib is not None or _lib_tried:
            return _lib
        return _load_slab_lib_locked()


def _load_slab_lib_locked() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if os.environ.get("RTT_NO_NATIVE"):
        _lib_tried = True
        return None
    path = _ensure_built("slab_store")
    if path is None:
        _lib_tried = True
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        # stale/incompatible cached build (e.g. sanitizer .so) → rebuild once
        try:
            path.unlink()
        except OSError:
            path = None
        path = _ensure_built("slab_store") if path is not None else None
        lib = None
        if path is not None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:
                lib = None
        if lib is None:
            _lib_tried = True
            return None
    lib.rtt_store_open.restype = ctypes.c_void_p
    lib.rtt_store_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                    ctypes.c_uint32, ctypes.c_int]
    lib.rtt_store_close.argtypes = [ctypes.c_void_p]
    lib.rtt_store_unlink.argtypes = [ctypes.c_char_p]
    lib.rtt_put.restype = ctypes.c_int64
    lib.rtt_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_char_p, ctypes.c_uint64]
    lib.rtt_get.restype = ctypes.c_int64
    lib.rtt_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_void_p, ctypes.c_uint64]
    lib.rtt_size.restype = ctypes.c_int64
    lib.rtt_size.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtt_exists.restype = ctypes.c_int
    lib.rtt_exists.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtt_delete.restype = ctypes.c_int
    lib.rtt_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtt_create.restype = ctypes.c_int64
    lib.rtt_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.rtt_seal.restype = ctypes.c_int
    lib.rtt_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtt_lookup_pin.restype = ctypes.c_int64
    lib.rtt_lookup_pin.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_uint64)]
    lib.rtt_unpin.restype = ctypes.c_int
    lib.rtt_unpin.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtt_base.restype = ctypes.c_void_p
    lib.rtt_base.argtypes = [ctypes.c_void_p]
    lib.rtt_store_stats.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_uint64)]
    lib.rtt_lru_victims.restype = ctypes.c_int64
    lib.rtt_lru_victims.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                     ctypes.c_char_p, ctypes.c_uint64]
    lib.rtt_reap_dead.restype = ctypes.c_int64
    lib.rtt_reap_dead.argtypes = [ctypes.c_void_p]
    _lib = lib
    _lib_tried = True
    return _lib


class SlabStore:
    """Python handle on the shared-memory slab store.

    One process creates (the GCS daemon); all others attach by path.  All
    methods are safe to call from multiple threads (the shm mutex is the
    only serialization point).
    """

    def __init__(self, path: str, handle: int, lib: ctypes.CDLL,
                 owner: bool):
        self.path = path
        self._h = handle
        self._lib = lib
        self._owner = owner
        self._closed = False
        # Serializes close() against in-flight ops from other threads (the
        # handle is freed by rtt_store_close; calling into a freed handle
        # is a use-after-free).  The shm mutex serializes cross-process.
        self._oplock = threading.Lock()

    # -- constructors --------------------------------------------------------
    @classmethod
    def create(cls, path: str, capacity_bytes: int,
               max_objects: int = 65536) -> Optional["SlabStore"]:
        lib = load_slab_lib()
        if lib is None:
            return None
        h = lib.rtt_store_open(path.encode(), capacity_bytes, max_objects, 1)
        return cls(path, h, lib, owner=True) if h else None

    @classmethod
    def attach(cls, path: str) -> Optional["SlabStore"]:
        lib = load_slab_lib()
        if lib is None or not os.path.exists(path):
            return None
        h = lib.rtt_store_open(path.encode(), 0, 0, 0)
        return cls(path, h, lib, owner=False) if h else None

    # Payloads above this copy OUTSIDE the shm mutex (create→memmove→seal on
    # write, lookup_pin→string_at→unpin on read) so a 1MB memcpy doesn't
    # convoy every other process behind the single cross-process lock.
    _COPY_UNDER_LOCK_MAX = 65536

    # -- object ops ----------------------------------------------------------
    def put(self, object_id: str, data) -> bool:
        """Store bytes-like. False if full/exists/out of slots."""
        enc = object_id.encode()
        if isinstance(data, (bytearray, memoryview)):
            # ctypes c_char_p args need bytes; slab objects are small
            data = bytes(data)
        with self._oplock:
            if self._closed:
                return False
            if len(data) <= self._COPY_UNDER_LOCK_MAX:
                return self._lib.rtt_put(self._h, enc, data, len(data)) == 0
            off = self._lib.rtt_create(self._h, enc, len(data))
            if off < 0:
                return False
            base = self._lib.rtt_base(self._h)
            ctypes.memmove(base + off, data, len(data))
            return self._lib.rtt_seal(self._h, enc) == 0

    def get(self, object_id: str) -> Optional[bytes]:
        enc = object_id.encode()
        with self._oplock:
            if self._closed:
                return None
            cap = self._COPY_UNDER_LOCK_MAX
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.rtt_get(self._h, enc, buf, cap)
            if n >= 0:
                return buf.raw[:n]
            if n != -5:  # miss
                return None
            # large object: pin, copy outside the shm mutex, unpin
            size = ctypes.c_uint64()
            off = self._lib.rtt_lookup_pin(self._h, enc, ctypes.byref(size))
            if off < 0:
                return None
            try:
                base = self._lib.rtt_base(self._h)
                return ctypes.string_at(base + off, size.value)
            finally:
                self._lib.rtt_unpin(self._h, enc)

    def exists(self, object_id: str) -> bool:
        with self._oplock:
            if self._closed:
                return False
            return bool(self._lib.rtt_exists(self._h, object_id.encode()))

    def delete(self, object_id: str) -> bool:
        with self._oplock:
            if self._closed:
                return False
            return self._lib.rtt_delete(self._h, object_id.encode()) == 0

    def stats(self) -> dict:
        keys = ("used", "heap_size", "num_objects", "max_objects",
                "hits", "misses", "allocs", "fails")
        with self._oplock:
            if self._closed:
                return dict.fromkeys(keys, 0)
            arr = (ctypes.c_uint64 * 8)()
            self._lib.rtt_store_stats(self._h, arr)
            return dict(zip(keys, (int(v) for v in arr)))

    def reap_dead(self) -> int:
        """Free unsealed objects whose creator process has died."""
        with self._oplock:
            if self._closed:
                return 0
            return max(0, int(self._lib.rtt_reap_dead(self._h)))

    def lru_victims(self, need_bytes: int, cap: int = 1 << 16) -> list:
        with self._oplock:
            if self._closed:
                return []
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.rtt_lru_victims(self._h, need_bytes, buf, cap)
            if n <= 0:
                return []
            ids = buf.raw.split(b"\x00")
            return [i.decode() for i in ids[:n]]

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        with self._oplock:
            if self._closed:
                return
            self._closed = True
            self._lib.rtt_store_close(self._h)
        if self._owner:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass
