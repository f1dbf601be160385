"""Opt-in runtime resource-leak sanitizer (DESIGN.md §4f).

``RTT_RESOURCE_SANITIZER=1`` is the dynamic half of rtlint's
static resource pass (``tools/rtlint/resources.py``), the same pairing
as ``RTT_LOCK_WATCHDOG=1`` / the lock-order pass: the static pass
proves discharge-on-every-path over the AST; this module measures NET
leaked resources in a live process and names the acquisition stack of
every survivor.

Mechanism: :func:`install` patches the process-wide acquisition points

- ``socket.socket`` (tracked subclass — ``accept``/``dup``/
  ``socketpair``/``create_connection`` all construct through the
  module global, so they are covered too),
- ``mmap.mmap`` (tracked subclass),
- ``os.open`` / ``os.dup`` (raw-fd registry; ``os.close`` discharges),
- ``threading.Thread.start`` (non-daemon threads only — daemon threads
  are strandable by declared policy, enforced by rtlint's thread pass),
- ``multiprocessing.connection.Connection.__init__`` (every protocol
  dial and every accepted peer lands here),

recording a ``traceback.format_stack()`` per acquisition in a global
:class:`ResourceRegistry`.  Nothing hooks ``close()``: each entry
holds a weakref plus a *liveness predicate* (``sock.fileno() == -1``,
``f.closed``, ``conn.closed``, ``not thread.is_alive()``, fstat on raw
fds) evaluated at assert time, so any discharge path — ``close``,
``detach``, ``with``, GC finalizer — counts without instrumenting it.

:func:`assert_clean` (wired into ``GcsServer.shutdown``, the worker
main-loop exit, and the leak-hammer in
``tests/test_resource_sanitizer.py``) garbage-collects, polls until a
grace deadline for in-flight teardown on daemon threads, and raises
:class:`ResourceLeakError` listing every survivor with the stack that
acquired it.

Known imprecision (documented so nobody trusts it for what it cannot
do): a raw fd closed by a wrapper OTHER than ``os.close`` (e.g.
``os.fdopen(fd).close()``) stays registered until the fstat probe sees
EBADF — and if the fd number was reused by an untracked open, the
probe reports the REUSED resource as leaked.  Baseline resources
acquired before :func:`install` are never tracked.
"""

from __future__ import annotations

import gc
import os
import threading
import time
import traceback
import weakref
from typing import Callable, Dict, List, Optional, Tuple

_ENV = "RTT_RESOURCE_SANITIZER"


def sanitizer_enabled() -> bool:
    return os.environ.get(_ENV) == "1"


class ResourceLeakError(RuntimeError):
    """Net resources survived a clean shutdown; message carries the
    acquisition stack of each survivor."""


class _Entry:
    __slots__ = ("kind", "desc", "stack", "created", "ref", "probe")

    def __init__(self, kind: str, desc: str, stack: List[str],
                 ref, probe: Optional[Callable[[], bool]]):
        self.kind = kind
        self.desc = desc
        self.stack = stack
        self.created = time.time()
        self.ref = ref          # weakref/strong ref/raw fd int, or None
        self.probe = probe      # () -> still-leaked?


class ResourceRegistry:
    """Stack-recording registry of live leakable resources."""

    def __init__(self, capture_stacks: bool = True):
        self._mu = threading.Lock()
        self._entries: Dict[int, _Entry] = {}   # key -> entry
        self._next_key = 0
        self._capture = capture_stacks
        # reentrancy guard: capturing a stack may itself acquire
        # resources (linecache file reads) — never re-enter
        self._tls = threading.local()
        self.acquired: Dict[str, int] = {}      # kind -> total ever seen

    # ------------------------------------------------------------ recording
    def _stack(self) -> List[str]:
        if not self._capture:
            return []
        stack = traceback.format_stack()
        while stack and __file__ in stack[-1]:
            stack.pop()
        return stack

    def register(self, kind: str, desc: str,
                 probe: Callable[[], bool]) -> Optional[int]:
        if getattr(self._tls, "busy", False):
            return None
        self._tls.busy = True
        try:
            stack = self._stack()
            with self._mu:
                key = self._next_key
                self._next_key += 1
                self._entries[key] = _Entry(kind, desc, stack, None, probe)
                self.acquired[kind] = self.acquired.get(kind, 0) + 1
            return key
        finally:
            self._tls.busy = False

    def register_obj(self, kind: str, obj, desc: str,
                     probe: Callable[[object], bool]) -> Optional[int]:
        """Track ``obj`` via weakref: a collected object is discharged
        (CPython refcounting runs its finalizer, which closes it);
        a live one is probed.  Objects that refuse weakrefs are held
        strongly — the probe alone decides."""
        try:
            ref = weakref.ref(obj)
        except TypeError:
            ref = lambda o=obj: o  # noqa: E731 - strong-ref fallback

        def _probe() -> bool:
            o = ref()
            return o is not None and probe(o)
        return self.register(kind, desc, _probe)

    def unregister(self, key: Optional[int]) -> None:
        if key is None:
            return
        with self._mu:
            self._entries.pop(key, None)

    # ------------------------------------------------------------ reporting
    def live(self) -> List[_Entry]:
        """Entries whose probe still reports the resource as leaked
        (probe errors count as leaked: an undiagnosable resource is a
        finding, not a pass)."""
        with self._mu:
            entries = list(self._entries.items())
        out = []
        dead = []
        for key, e in entries:
            try:
                leaked = e.probe()
            except Exception:  # noqa: BLE001 - treat as leaked
                leaked = True
            if leaked:
                out.append(e)
            else:
                dead.append(key)
        if dead:
            with self._mu:
                for k in dead:
                    self._entries.pop(k, None)
        return out

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.live():
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def report(self, entries: Optional[List[_Entry]] = None,
               limit: int = 20) -> str:
        entries = self.live() if entries is None else entries
        lines = [f"{len(entries)} leaked resource(s):"]
        for e in entries[:limit]:
            lines.append(f"--- {e.kind} {e.desc} (acquired "
                         f"{time.time() - e.created:.1f}s ago) ---")
            lines.append("".join(e.stack) or "  <no stack recorded>")
        if len(entries) > limit:
            lines.append(f"... and {len(entries) - limit} more")
        return "\n".join(lines)

    def assert_clean(self, tag: str = "", grace_s: float = 2.0) -> None:
        """Raise :class:`ResourceLeakError` when net resources remain
        after ``grace_s`` (daemon serve threads may still be mid-
        teardown when shutdown returns — poll, don't guess)."""
        deadline = time.monotonic() + grace_s
        while True:
            gc.collect()
            entries = self.live()
            if not entries:
                return
            if time.monotonic() >= deadline:
                break
            time.sleep(0.05)
        raise ResourceLeakError(
            f"resource sanitizer [{tag}]: {self.report(entries)}")


# ---------------------------------------------------------------- patching
_REGISTRY: Optional[ResourceRegistry] = None
_ORIG: Dict[str, object] = {}


def get_registry() -> Optional[ResourceRegistry]:
    return _REGISTRY


def _fd_probe(fd: int) -> Callable[[], bool]:
    def probe() -> bool:
        try:
            os.fstat(fd)
        except OSError:
            return False  # EBADF: closed by some other path
        return True
    return probe


def install() -> ResourceRegistry:
    """Patch the acquisition points; idempotent.  Process-global, so
    only the sanitizer entry points (``maybe_install``) and tests call
    this directly."""
    global _REGISTRY
    if _REGISTRY is not None:
        return _REGISTRY
    reg = ResourceRegistry()

    import mmap as mmap_mod
    import multiprocessing.connection as mpc
    import socket as socket_mod

    _ORIG["socket"] = socket_mod.socket
    _ORIG["mmap"] = mmap_mod.mmap
    _ORIG["os.open"] = os.open
    _ORIG["os.dup"] = os.dup
    _ORIG["os.close"] = os.close
    _ORIG["thread.start"] = threading.Thread.start
    _ORIG["conn.init"] = mpc.Connection.__init__

    class _TrackedSocket(socket_mod.socket):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            reg.register_obj("socket", self,
                             f"fd={self.fileno()}",
                             lambda s: s.fileno() != -1)

    class _TrackedMmap(mmap_mod.mmap):
        def __new__(cls, *a, **kw):
            m = super().__new__(cls, *a, **kw)
            reg.register_obj("mmap", m, f"len={len(m)}",
                             lambda o: not o.closed)
            return m

    fd_keys: Dict[int, int] = {}
    fd_mu = threading.Lock()

    def _track_fd(fd: int, desc: str) -> int:
        key = reg.register("fd", desc, _fd_probe(fd))
        if key is not None:
            with fd_mu:
                old = fd_keys.pop(fd, None)
                if old is not None:
                    # the number was reused without an os.close we saw
                    # (fdopen-style discharge): the old entry is dead
                    reg.unregister(old)
                fd_keys[fd] = key
        return fd

    orig_open, orig_dup, orig_close = os.open, os.dup, os.close

    def _os_open(path, flags, mode=0o777, *, dir_fd=None):
        return _track_fd(orig_open(path, flags, mode, dir_fd=dir_fd),
                         f"os.open({path!r})")

    def _os_dup(fd):
        return _track_fd(orig_dup(fd), f"os.dup({fd})")

    def _os_close(fd):
        # pop BEFORE the kernel close: the moment orig_close returns,
        # the fd number is free for a concurrent open to reuse —
        # popping after would untrack that new resource (false-negative
        # leak).  A failed close (EBADF) still drops the entry: the
        # registration was stale.
        with fd_mu:
            key = fd_keys.pop(fd, None)
        try:
            orig_close(fd)
        finally:
            reg.unregister(key)

    orig_start = threading.Thread.start

    def _start(self):
        if not self.daemon:
            # rtlint's thread pass forces the daemon= decision to be
            # explicit; the sanitizer holds non-daemon threads to the
            # join/transfer contract the static pass checks
            reg.register_obj("thread", self, self.name or "<unnamed>",
                             lambda t: t.is_alive())
        return orig_start(self)

    orig_conn_init = mpc.Connection.__init__

    def _conn_init(self, *a, **kw):
        orig_conn_init(self, *a, **kw)
        reg.register_obj("conn", self, repr(self),
                         lambda c: not c.closed)

    socket_mod.socket = _TrackedSocket
    mmap_mod.mmap = _TrackedMmap
    os.open = _os_open
    os.dup = _os_dup
    os.close = _os_close
    threading.Thread.start = _start
    mpc.Connection.__init__ = _conn_init
    _REGISTRY = reg
    return reg


def uninstall() -> None:
    """Restore the original acquisition points (tests only)."""
    global _REGISTRY
    if _REGISTRY is None:
        return
    import mmap as mmap_mod
    import multiprocessing.connection as mpc
    import socket as socket_mod
    socket_mod.socket = _ORIG.pop("socket")
    mmap_mod.mmap = _ORIG.pop("mmap")
    os.open = _ORIG.pop("os.open")
    os.dup = _ORIG.pop("os.dup")
    os.close = _ORIG.pop("os.close")
    threading.Thread.start = _ORIG.pop("thread.start")
    mpc.Connection.__init__ = _ORIG.pop("conn.init")
    _REGISTRY = None


def maybe_install() -> Optional[ResourceRegistry]:
    """Entry-point hook: install iff ``RTT_RESOURCE_SANITIZER=1``.
    Called from ``GcsServer.__init__`` and the spawned-worker main —
    the env var rides ``Popen`` inheritance to every worker."""
    if sanitizer_enabled():
        return install()
    return None


def assert_clean_at_shutdown(tag: str) -> None:
    """Shutdown hook: no-op unless the sanitizer is installed."""
    if _REGISTRY is not None and sanitizer_enabled():
        _REGISTRY.assert_clean(tag=tag)
