"""Session directory management.

Mirrors the reference's ``/tmp/ray/session_*`` layout (reference:
``python/ray/_private/node.py``; SURVEY.md §2.3): every ``init()`` creates a
timestamped session dir holding logs, unix sockets, the object-store spill
area, and a ``session.json`` descriptor that late-joining processes read to
find the control plane.
"""

from __future__ import annotations

import json
import os
import socket
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Optional

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

    def slab_path(self) -> str:
        """Path of the session's native slab store segment (C++ small-object
        data plane; ray_tpu_torch/native/src/slab_store.cc). Derived from the
        session name so late-joining workers find it without a descriptor;
        it lives beside the object segments, in the store's shm directory
        (``RTT_SHM_DIR``)."""
        import hashlib
        from ray_tpu_torch._private.shm_store import _SHM_DIR
        tag = hashlib.md5(self.name.encode()).hexdigest()[:12]
        return str(_SHM_DIR / f"rtt_slab_{tag}")

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
