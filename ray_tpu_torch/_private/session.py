"""Session directory management.

Mirrors the reference's ``/tmp/ray/session_*`` layout (reference:
``python/ray/_private/node.py``; SURVEY.md §2.3): every ``init()`` creates a
timestamped session dir holding logs, unix sockets, the object-store spill
area, and a ``session.json`` descriptor that late-joining processes read to
find the control plane.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import socket
import time
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional, Set

from ray_tpu_torch._private.config import GLOBAL_CONFIG


class Session:
    def __init__(self, root: Optional[str] = None, name: Optional[str] = None):
        root_dir = Path(root or GLOBAL_CONFIG.session_dir_root)
        if name is None:
            stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
            name = f"session_{stamp}_{os.getpid()}_{uuid.uuid4().hex[:6]}"
        self.name = name
        self.path = root_dir / name
        (self.path / "logs").mkdir(parents=True, exist_ok=True)
        (self.path / "sockets").mkdir(parents=True, exist_ok=True)
        (self.path / "spill").mkdir(parents=True, exist_ok=True)
        latest = root_dir / "session_latest"
        try:
            if latest.is_symlink() or latest.exists():
                latest.unlink()
            latest.symlink_to(self.path)
        except OSError:
            pass  # concurrent sessions racing on the symlink is fine

    @property
    def log_dir(self) -> Path:
        return self.path / "logs"

    @property
    def socket_dir(self) -> Path:
        return self.path / "sockets"

    @property
    def spill_dir(self) -> Path:
        spill = GLOBAL_CONFIG.object_spill_dir
        return Path(spill) if spill else self.path / "spill"

    def socket_path(self, name: str) -> str:
        # Unix socket paths are limited to ~107 bytes; keep names short.
        return str(self.socket_dir / name)

    def auth_key(self) -> bytes:
        """Per-session control-plane secret (HMAC key for every socket).

        Created once by the first accessor (the head), mode 0600; every
        process of the session reads it from the session dir.  Remote
        clients must receive it out-of-band (RTT_AUTH_KEY) — the
        multiprocessing handshake then provides real authentication
        instead of a publicly-known constant."""
        p = self.path / "auth.key"
        try:
            return bytes.fromhex(p.read_text().strip())
        except FileNotFoundError:
            pass
        key = os.urandom(32)
        # write-then-link so a concurrent reader never sees a partial file
        # (which would become its HMAC key and fail every handshake).
        # O_TRUNC (not O_EXCL): a stale tmp from a killed pid is overwritten
        # rather than crashing startup forever.
        tmp = p.with_name(f".auth.key.{os.getpid()}")
        try:
            fd = os.open(str(tmp), os.O_CREAT | os.O_TRUNC | os.O_WRONLY,
                         0o600)
            with os.fdopen(fd, "w") as f:
                f.write(key.hex())
            os.link(str(tmp), str(p))  # fails if a racer published first
            return key
        except FileExistsError:
            return bytes.fromhex(p.read_text().strip())
        finally:
            try:
                os.unlink(str(tmp))
            except FileNotFoundError:
                pass

    @property
    def tag(self) -> str:
        """The session's short name in the shm directory (its slab's and
        its registry entry's)."""
        return hashlib.md5(self.name.encode()).hexdigest()[:12]

    def slab_path(self) -> str:
        """Path of the session's native slab store segment (C++ small-object
        data plane; ray_tpu_torch/native/src/slab_store.cc). Derived from the
        session name so late-joining workers find it without a descriptor;
        it lives beside the object segments, in the store's shm directory
        (``RTT_SHM_DIR``)."""
        from ray_tpu_torch._private.shm_store import _SHM_DIR
        return str(_SHM_DIR / f"rtt_slab_{self.tag}")

    def register_process(self) -> None:
        """Records this process (head, driver or worker) as one of the
        session's, in the registry beside the segments: before a process
        makes a segment, so a head that boots later can tell this
        session's segments from a dead one's (``reap_orphan_segments``).
        Best effort: a process that cannot write it only loses the
        protection from a later reap, never its own start."""
        d = _registry_dir() / self.tag
        try:
            d.mkdir(parents=True, exist_ok=True)
            (d / str(os.getpid())).touch()
        except OSError:
            pass

    def unregister(self) -> None:
        """A clean head shutdown: the session's registry entry goes with
        its slab and segments."""
        shutil.rmtree(_registry_dir() / self.tag, ignore_errors=True)

    def write_descriptor(self, info: Dict[str, Any]) -> None:
        desc = dict(info)
        desc["session_name"] = self.name
        desc["hostname"] = socket.gethostname()
        desc["pid"] = os.getpid()
        (self.path / "session.json").write_text(json.dumps(desc, indent=2))

    def read_descriptor(self) -> Dict[str, Any]:
        return json.loads((self.path / "session.json").read_text())

    @classmethod
    def latest(cls, root: Optional[str] = None) -> "Session":
        root_dir = Path(root or GLOBAL_CONFIG.session_dir_root)
        target = (root_dir / "session_latest").resolve()
        if not target.exists():
            raise FileNotFoundError("no ray_tpu_torch session found")
        return cls(root=str(root_dir), name=target.name)


# An object segment: ``rtt_`` + an ObjectID, ``<owner worker id: its pid
# in 8 hex digits, 8 more><kind p|r><counter in 10 hex digits>``.
_OBJECT_SEGMENT = re.compile(r"^rtt_([0-9a-f]{8})[0-9a-f]{8}[pr][0-9a-f]{10}$")
# A channel's ring (``experimental.channels``): ``rtt_chan_<creator's pid
# in 8 hex digits>_<12 hex digits>``.
_CHANNEL_SEGMENT = re.compile(r"^rtt_chan_([0-9a-f]{8})_[0-9a-f]{12}$")


def _registry_dir() -> Path:
    """``rtt_sessions/<session tag>/<pid>``: every process of every
    session on this shm directory, one empty file each."""
    from ray_tpu_torch._private.shm_store import _SHM_DIR
    return _SHM_DIR / "rtt_sessions"


def _pid_alive(pid: int) -> bool:
    """A process that exists and is not a zombie (a killed worker whose
    parent is gone may wait unreaped)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return True


def reap_orphan_segments() -> List[str]:
    """Unlinks the slabs and object segments that dead sessions left in
    the shm directory (a head killed by a signal cannot unlink its own;
    the slab alone is ``slab_memory_mb`` of tmpfs).  Called by a booting
    head once its own process is registered.

    Only what the registry proves dead goes.  A session is dead once its
    registry entry lists processes and every one of them is dead; its
    slab goes, then its entry.  An object segment goes when the process
    that owns it (the pid its ObjectID carries) is listed in a dead
    entry and in no live one: a live session keeps the segments of its
    dead workers, which its GCS may still serve.  A channel's ring goes
    by the same rule, by the pid of the process that made it.  A slab or segment that
    no entry accounts for (a session that never registered, a client,
    a process of another host) is left alone.  The directory is listed
    before the registry is read and every process registers before it
    makes a segment, so a segment made by a session starting meanwhile
    is never taken for an orphan.  Returns the names unlinked."""
    from ray_tpu_torch._private.shm_store import _SHM_DIR
    try:
        names = os.listdir(_SHM_DIR)
    except OSError:
        return []
    try:
        entries = list(_registry_dir().iterdir())
    except OSError:
        entries = []
    dead: Dict[str, Set[int]] = {}
    live_pids: Set[int] = set()
    for entry in entries:
        try:
            pids = {int(n) for n in os.listdir(entry) if n.isdigit()}
        except OSError:
            continue
        if any(map(_pid_alive, pids)):
            live_pids |= pids
        elif pids:
            dead[entry.name] = pids
    dead_pids = set().union(*dead.values()) - live_pids
    reaped = []
    for name in names:
        if name.startswith("rtt_slab_"):
            orphan = name[len("rtt_slab_"):] in dead
        else:
            m = _OBJECT_SEGMENT.match(name) or _CHANNEL_SEGMENT.match(name)
            orphan = m is not None and int(m.group(1), 16) in dead_pids
        if not orphan:
            continue
        try:
            os.unlink(_SHM_DIR / name)
            reaped.append(name)
        except OSError:
            pass
    for tag in dead:
        shutil.rmtree(_registry_dir() / tag, ignore_errors=True)
    return reaped
