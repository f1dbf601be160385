"""Always-on per-process flight recorder: a crash-surviving ring buffer.

Black-box recorder in the spirit of the reference's event-stats /
state-dump debugging aids, but built to survive the process: every
ray_tpu_torch process (GCS, workers, driver) appends fixed-size records —
recent wire frames, scheduler dispatch decisions, lock-watchdog waits,
data-plane requests, LLM engine iterations — into a **shared-mmap ring
file in the session directory** (``<session>/flight/<role>_<pid>.ring``).

Because the ring is a ``MAP_SHARED`` file, "dump on crash" needs no
signal handler: a SIGKILLed or OOM-killed process leaves its last
``flight_recorder_slots`` records on disk, exactly as written.  A live
process's ring is equally readable (readers see writes through the page
cache), so ``ray_tpu_torch debug dump`` (GCS op ``debug_dump``) returns the
recent history of every process of the session — dead ones included —
without cooperating with any of them.

Write path (the hot-path budget is a couple of µs):

- ``record(kind, detail)`` takes NO lock: a global ``itertools.count``
  hands out the slot sequence (``next()`` is atomic under the GIL) and
  each record writes only its own slot.  After wrap-around two racing
  writers can theoretically lap each other onto one slot; readers
  detect the torn slot (length bounds / utf-8) and skip it.
- Records are ``[u64 seq][f64 wall-ts][u16 len][utf-8 "kind detail"]``
  in a fixed ``_SLOT_BYTES`` slot; longer details truncate.

Config: ``flight_recorder_enabled`` (default on),
``flight_recorder_slots`` (ring capacity).  DESIGN.md §4h documents the
overwrite semantics.
"""

from __future__ import annotations

import itertools
import os
import struct
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

_MAGIC = b"RTFR1\n\x00\x00"
_HDR = struct.Struct("<8sII Q d")       # magic, slot_size, nslots, pid, t0
_HDR_BYTES = 64
_SLOT = struct.Struct("<Q d H")         # seq, wall ts, payload len
_SLOT_BYTES = 224
_PAY_MAX = _SLOT_BYTES - _SLOT.size

FLIGHT_DIR = "flight"


class FlightRecorder:
    """One process's ring.  Owns the mmap; ``close()`` discharges it
    (the ring FILE stays behind — it is the crash artifact)."""

    def __init__(self, path: str, nslots: int):  # rtlint: owns(path)
        import mmap
        self.path = str(path)
        self.nslots = max(64, int(nslots))
        size = _HDR_BYTES + self.nslots * _SLOT_BYTES
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, size)
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)  # the mapping keeps the inode; fd not needed
        _HDR.pack_into(self._mm, 0, _MAGIC, _SLOT_BYTES, self.nslots,
                       os.getpid(), time.time())
        self._seq = itertools.count(1)
        self._closed = False

    def record(self, kind: str, detail: str = "") -> None:
        if self._closed:
            return
        seq = next(self._seq)                 # GIL-atomic slot claim
        off = _HDR_BYTES + ((seq - 1) % self.nslots) * _SLOT_BYTES
        pay = (kind + " " + detail if detail else kind).encode(
            "utf-8", "replace")[:_PAY_MAX]
        try:
            _SLOT.pack_into(self._mm, off, seq, time.time(), len(pay))
            self._mm[off + _SLOT.size:off + _SLOT.size + len(pay)] = pay
        except (ValueError, IndexError):
            return  # closed under us / torn geometry: recorder never raises
        if seq % 64 == 0:
            # amortized counter (a per-record tagged inc would put a
            # metric lock on the GCS frame hot path)
            from ray_tpu_torch._private.config import GLOBAL_CONFIG
            if GLOBAL_CONFIG.metrics_enabled:
                from ray_tpu_torch.util import metrics_catalog as mcat
                try:
                    mcat.get("rtt_trace_flight_records_total").inc(64)
                except Exception:  # noqa: BLE001 - telemetry best-effort
                    pass

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass


_RECORDER: Optional[FlightRecorder] = None
_install_lock = threading.Lock()

# Rings live on tmpfs, NOT in the (disk-backed) session dir: a
# disk-backed shared mapping is subject to writeback, after which the
# next slot write pays a write-protect fault — a host round trip on
# virtualized kernels, ~100µs/record (measured; the recorder's whole
# budget is a couple of µs).  tmpfs pages stay dirty-resident, and
# SIGKILL survival is identical — the file outlives the process either
# way.  One dir per session under the base, in the object store's shm
# directory (``RTT_SHM_DIR``), reaped by the next cluster's install once
# the owning session's processes are all dead.
def _shm_base() -> Path:
    from ray_tpu_torch._private.shm_store import _SHM_DIR
    return _SHM_DIR / "rtt_flight"


def flight_dir_for(session_path) -> Path:
    """Where a session's ring files live (tmpfs; session-dir fallback
    for hosts without one)."""
    if _shm_base().parent.is_dir():
        return _shm_base() / Path(session_path).name
    return Path(session_path) / FLIGHT_DIR


def _reap_orphan_dirs(keep: Path) -> None:
    """Remove other sessions' ring dirs once every recorded pid is dead
    — tier-1 alone creates hundreds of sessions; without this, tmpfs
    grows ~0.5MB per dead process forever."""
    import shutil
    try:
        siblings = list(_shm_base().iterdir())
    except OSError:
        return
    for d in siblings:
        if d == keep or not d.is_dir():
            continue
        alive = False
        try:
            for ring in d.glob("*.ring"):
                if _pid_alive(ring_pid(ring)):
                    alive = True
                    break
        except OSError:
            continue
        if not alive:
            shutil.rmtree(d, ignore_errors=True)


def maybe_install(session_path, role: str) -> Optional[FlightRecorder]:
    """Install the process-wide recorder (idempotent; first caller wins
    within one session — head==driver processes install once as 'gcs').
    Returns the active recorder, or None when disabled / no session."""
    global _RECORDER
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    if session_path is None or not GLOBAL_CONFIG.flight_recorder_enabled:
        return _RECORDER
    flight_dir = flight_dir_for(session_path)
    with _install_lock:
        if _RECORDER is not None and not _RECORDER._closed:
            if Path(_RECORDER.path).parent == flight_dir:
                return _RECORDER
            _RECORDER.close()   # re-init against a NEW session (tests)
        try:
            flight_dir.mkdir(parents=True, exist_ok=True)
            if role == "gcs":   # one sweep per cluster, not per worker
                _reap_orphan_dirs(flight_dir)
            _RECORDER = FlightRecorder(
                str(flight_dir / f"{role}_{os.getpid()}.ring"),
                GLOBAL_CONFIG.flight_recorder_slots)
        except OSError:
            _RECORDER = None    # recording is best-effort, never fatal
        return _RECORDER


def record(kind: str, detail: str = "") -> None:
    fr = _RECORDER
    if fr is not None:
        fr.record(kind, detail)


def enabled() -> bool:
    return _RECORDER is not None


def close() -> None:
    """Discharge the mmap on clean shutdown (the resource sanitizer
    tracks it); the ring file itself is left behind on purpose."""
    global _RECORDER
    with _install_lock:
        if _RECORDER is not None:
            _RECORDER.close()
            _RECORDER = None


# ------------------------------------------------------------- readers
def read_ring(path) -> List[dict]:
    """Decode one ring file → records in seq order (oldest first).
    Torn/empty slots are skipped; never raises on a malformed ring."""
    try:
        raw = Path(path).read_bytes()
    except OSError:
        return []
    if len(raw) < _HDR_BYTES:
        return []
    try:
        magic, slot_size, nslots, pid, t0 = _HDR.unpack_from(raw, 0)
    except struct.error:
        return []
    if magic != _MAGIC or slot_size <= _SLOT.size or nslots <= 0:
        return []
    out = []
    for i in range(nslots):
        off = _HDR_BYTES + i * slot_size
        if off + _SLOT.size > len(raw):
            break
        try:
            seq, ts, ln = _SLOT.unpack_from(raw, off)
        except struct.error:
            continue
        if seq == 0 or ln > slot_size - _SLOT.size:
            continue  # empty or torn slot
        pay = raw[off + _SLOT.size:off + _SLOT.size + ln]
        text = pay.decode("utf-8", "replace")
        kind, _, detail = text.partition(" ")
        out.append({"seq": seq, "ts": ts, "kind": kind, "detail": detail})
    out.sort(key=lambda r: r["seq"])
    return out


def ring_pid(path) -> Optional[int]:
    try:
        with open(path, "rb") as f:
            hdr = f.read(_HDR_BYTES)
        magic, _, _, pid, _ = _HDR.unpack_from(hdr, 0)
    except (OSError, struct.error):
        return None
    return int(pid) if magic == _MAGIC else None


def collect(session_path, tail: int = 200) -> Dict[str, dict]:
    """Every ring of a session → {ring_name: {pid, alive, records}} with
    the newest ``tail`` records per process.  Dead processes' rings read
    exactly like live ones — that is the point of the recorder."""
    out: Dict[str, dict] = {}
    flight_dir = flight_dir_for(session_path)
    try:
        paths = sorted(flight_dir.glob("*.ring"))
    except OSError:
        return out
    for p in paths:
        recs = read_ring(p)
        pid = ring_pid(p)
        out[p.stem] = {"pid": pid, "alive": _pid_alive(pid),
                       "records": recs[-max(1, int(tail)):]}
    return out


def _pid_alive(pid: Optional[int]) -> bool:
    """EPERM means the pid EXISTS (another user's process) — on a
    shared host that must count as alive, or one user's reap/dump
    would destroy/mislabel another's live session."""
    if not pid:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True
