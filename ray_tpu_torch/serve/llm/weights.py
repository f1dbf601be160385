"""Model-weight sharing across same-node replicas through shared memory
(port of ``ray_tpu/serve/llm/weights.py``).

Every LLM replica on a node needs the same parameters.  The first replica
to arrive publishes them, flattened to float32, into one segment under
``RTT_SHM_DIR`` (default ``/dev/shm``); later replicas attach to it and
copy each leaf onto their own device, with no init of their own.

The port's files carry the port's prefix (``rtt_llmw_``), never the
reference's own: the two packages draw other values and write other
headers, so neither may attach to, or reap, the other's.

Publication protocol (crash-safe, single-writer), as the reference's:

- segment ``rtt_llmw_<key>.<publisher_pid>`` holds an 8-byte header
  length, a JSON header (each leaf's key path, shape, dtype, offset and
  size, in a fixed key order) and the raw leaf bytes; the pid in the name
  makes a SIGKILLed publisher's segment recognizably orphaned;
- writers race on an O_EXCL ``.lock`` sentinel; the loser polls for a
  live publisher's ``.ready`` sentinel.  A writer that dies mid-publish
  leaves no ``.ready``; a stale lock (dead pid) is broken by rename
  (single winner); dead publishers' segments are reaped by
  :func:`reap_orphans` at every engine boot.

``init_fn(device)`` builds the params on ``device``.  On attach it is
called on the ``meta`` device, which draws nothing, to rebuild the tree's
keys and shapes (the reference's ``jax.eval_shape``); the published
leaves must match them.  On any shm failure the caller falls back to a
private ``init_fn(device)``, with a warning, as the reference does.
"""

from __future__ import annotations

import json
import logging
import mmap
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger("ray_tpu_torch.serve.llm.weights")

_HDR_LEN_BYTES = 8
Params = Dict[str, Any]
InitFn = Callable[[torch.device], Params]


def _shm_dir() -> Path:
    return Path(os.environ.get("RTT_SHM_DIR", "/dev/shm"))


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _lock_path(key: str) -> str:
    return str(_shm_dir() / f"rtt_llmw_{key}.lock")


def _seg_path(key: str, pid: int) -> str:
    return str(_shm_dir() / f"rtt_llmw_{key}.{pid}")


def _parse_pid(name: str) -> Optional[int]:
    core = name[:-len(".ready")] if name.endswith(".ready") else name
    if core.endswith(".lock") or ".stale." in core:
        return None
    try:
        return int(core.rsplit(".", 1)[1])
    except (IndexError, ValueError):
        return None


def _live_segment(key: str) -> Optional[str]:
    """A live publisher's segment base for ``key`` (reaping dead ones)."""
    prefix = f"rtt_llmw_{key}."
    shm = _shm_dir()
    try:
        names = os.listdir(shm)
    except OSError:
        return None
    for name in names:
        if not (name.startswith(prefix) and name.endswith(".ready")):
            continue
        pid = _parse_pid(name)
        if pid is None:
            continue
        base = str(shm / name[:-len(".ready")])
        if _pid_alive(pid):
            return base
        for p in (str(shm / name), base):
            try:
                os.unlink(p)
            except OSError:
                pass
    return None


def reap_orphans() -> int:
    """Unlink weight segments whose publisher pid is dead (engine boot
    sweep: a SIGKILLed replica cannot release() its own)."""
    n = 0
    shm = _shm_dir()
    try:
        names = os.listdir(shm)
    except OSError:
        return n
    for name in names:
        if not name.startswith("rtt_llmw_"):
            continue
        pid = _parse_pid(name)
        if pid is None or pid == os.getpid() or _pid_alive(pid):
            continue
        try:
            os.unlink(shm / name)
            n += 1
        except OSError:
            pass
    if n:
        logger.info("reaped %d orphaned weight segment file(s)", n)
    return n


def _flatten(params: Params, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs of a nested dict, keys sorted at every level
    (the reference's pytree order)."""
    if isinstance(params, dict):
        return [kv for k in sorted(params)
                for kv in _flatten(params[k], f"{prefix}{k}/")]
    return [(prefix[:-1], params)]


def _unflatten(pairs: List[Tuple[str, Any]]) -> Params:
    out: Params = {}
    for path, leaf in pairs:
        *parents, last = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def release(key: str) -> None:
    """Unlink the published segment for ``key`` (engine shutdown).

    Safe at any time: attachers copy the leaves onto their device and
    close their mapping before returning, so nothing references the file
    after publish_or_attach returns.  Unlinks only THIS process's
    segment; segments of SIGKILLed publishers are swept by
    :func:`reap_orphans`."""
    base = _seg_path(key, os.getpid())
    for p in (base + ".ready", base):
        try:
            os.unlink(p)
        except OSError:
            pass


def publish_or_attach(key: str, init_fn: InitFn, device: torch.device,
                      timeout_s: float = 120.0) -> Params:
    """The params for ``key`` on ``device``, shared through shared memory.

    The first caller on the node runs ``init_fn(device)`` and publishes;
    every other caller attaches to the published bytes.  On any shm
    failure the caller falls back to a private ``init_fn(device)``."""
    lock = _lock_path(key)
    deadline = time.monotonic() + timeout_s
    while True:
        live = _live_segment(key)
        if live is not None:
            try:
                return _attach(live, init_fn, device)
            except Exception:  # noqa: BLE001 - corrupt/raced segment
                logger.warning("attach to %s failed; loading privately",
                               live, exc_info=True)
                return init_fn(device)
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o600)
        except FileExistsError:
            # A peer is publishing; break a dead publisher's stale lock by
            # RENAME, not unlink: rename succeeds for exactly one racer, so
            # two waiters can never both break it and publish concurrently.
            if _lock_stale(lock):
                stale = f"{lock}.stale.{os.getpid()}"
                try:
                    os.rename(lock, stale)
                    os.unlink(stale)
                except OSError:
                    pass
                continue
            if time.monotonic() > deadline:
                logger.warning("weights publish wait timed out for %s; "
                               "loading privately", key)
                return init_fn(device)
            time.sleep(0.05)
            continue
        try:
            os.write(fd, str(os.getpid()).encode())
        finally:
            os.close(fd)
        params = None
        base = _seg_path(key, os.getpid())
        try:
            params = init_fn(device)
            _publish(base, base + ".ready", params)
        except Exception:  # noqa: BLE001 - publish is best-effort
            if params is None:
                raise      # the model load itself failed: surface it
            logger.warning("weights publish for %s failed; continuing "
                           "with private params", key, exc_info=True)
            try:
                os.unlink(base)
            except OSError:
                pass
        finally:
            try:
                os.unlink(lock)
            except OSError:
                pass
        return params


def _lock_stale(lock: str) -> bool:
    try:
        with open(lock, "rb") as f:
            pid = int(f.read().decode() or "0")
    except (OSError, ValueError):
        return False
    return pid > 0 and not _pid_alive(pid)


def _publish(base: str, ready: str, params: Params) -> None:
    pairs = _flatten(params)
    metas, off = [], 0
    for path, t in pairs:
        n = t.numel() * 4                  # float32 on the shm plane
        metas.append(dict(path=path, shape=list(t.shape), dtype="float32",
                          offset=off, nbytes=n))
        off += n
    hdr = json.dumps(metas).encode()
    # pid-unique temp: even if lock-breaking ever admitted two publishers,
    # they cannot tear each other's bytes; os.replace promotes whichever
    # finished last, atomically
    tmp = f"{base}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(len(hdr).to_bytes(_HDR_LEN_BYTES, "little"))
            f.write(hdr)
            for _, t in pairs:
                a = t.detach().to("cpu", torch.float32).contiguous().numpy()
                f.write(np.ascontiguousarray(a).data)
        os.replace(tmp, base)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    with open(ready, "wb") as f:
        f.write(b"1")
    logger.info("published %d weight leaves (%.1f MB) to %s",
                len(pairs), off / 1e6, base)


def _attach(base: str, init_fn: InitFn, device: torch.device) -> Params:
    """Map the published segment and rebuild the tree from
    ``init_fn`` on the ``meta`` device (keys and shapes only), copying
    each leaf onto ``device`` in the meta tree's dtype."""
    fd = os.open(base, os.O_RDONLY)
    try:
        size = os.fstat(fd).st_size
        # copy-on-write: a writable view for torch.frombuffer whose writes
        # (there are none) could never reach the shared file
        mm = mmap.mmap(fd, size, access=mmap.ACCESS_COPY)
    finally:
        os.close(fd)
    try:
        hdr_len = int.from_bytes(mm[:_HDR_LEN_BYTES], "little")
        metas = json.loads(mm[_HDR_LEN_BYTES:_HDR_LEN_BYTES + hdr_len])
        body = _HDR_LEN_BYTES + hdr_len
        like = _flatten(init_fn(torch.device("meta")))
        if [(p, list(t.shape)) for p, t in like] != \
                [(m["path"], m["shape"]) for m in metas]:
            raise ValueError(f"published leaves of {base} do not match the "
                             f"model's keys and shapes")
        pairs = []
        for (path, t), m in zip(like, metas):
            view = torch.frombuffer(mm, dtype=torch.float32,
                                    count=m["nbytes"] // 4,
                                    offset=body + m["offset"])
            pairs.append((path, view.view(m["shape"]).to(
                device=device, dtype=t.dtype, copy=True)))
            del view
    finally:
        mm.close()
    logger.info("attached %d weight leaves from %s", len(pairs), base)
    return _unflatten(pairs)
