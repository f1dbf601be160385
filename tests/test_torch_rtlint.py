"""rtlint's passes over the port's runtime, with the port's own lock DAGs.

``tools/rtlint`` scans the JAX package (``tests/test_rtlint.py``); its
pass functions take any file and any DAG, so here they run on the
port's files with the tables of ``ray_tpu_torch/_private/lock_watchdog.py``:
lock order and no blocking under leaf locks (``lockorder``), every
``# guarded by:`` field written only under its lock (``guarded``), named
daemon-explicit threads (``threads``), and no leaked socket, fd, file,
mmap, thread or connection (``resources``).  The interprocedural passes
(``replies``, ``blocking``, ``protostate``, ``wire``) read the reference's
own declaration tables, so they stay with ``tests/test_rtlint.py``.

Each case asserts no finding, or exactly the waived ones, each named.
A waiver is a ``# rtlint: <rule>-ok(reason)`` comment in the port's
source, filtered as the driver filters it.
"""

from pathlib import Path

import pytest

from tools.rtlint import REPO_ROOT, load
from tools.rtlint.__main__ import filter_waived
from tools.rtlint.guarded import check_guarded
from tools.rtlint.lockorder import LockSpec, check_locks
from tools.rtlint.resources import check_resources
from tools.rtlint.threads import check_threads

from ray_tpu_torch._private import lock_watchdog as lw

PORT = REPO_ROOT / "ray_tpu_torch"
PRIV = PORT / "_private"
LLM = PORT / "serve" / "llm"


def _spec(prefix, cross=frozenset()):
    noblock = getattr(lw, f"{prefix}_NOBLOCK_LOCKS", set())
    return LockSpec(getattr(lw, f"{prefix}_LOCK_DAG"), noblock,
                    getattr(lw, f"{prefix}_CV_ALIASES"), set(cross))


# (file, the port's DAG prefix, cross-object methods) — the files the
# driver's ``locks`` and ``guarded`` passes check in the reference, where
# the port has them
LOCK_FILES = {
    "gcs": (PRIV / "gcs.py", "GCS", {"push", "push_ctl"}),
    "worker": (PRIV / "worker.py", "WORKER", ()),
    "raylet": (PRIV / "raylet.py", "RAYLET", {"push", "push_ctl"}),
    "replication": (PRIV / "replication.py", "REPL", ()),
    "tsdb": (PORT / "util" / "tsdb.py", "TSDB", ()),
    "profiler": (PORT / "util" / "profiler.py", "PROFILER", ()),
}
GUARDED_FILES = {
    "gcs": (PRIV / "gcs.py", "GCS"),
    "worker": (PRIV / "worker.py", "WORKER"),
    "data_plane": (PRIV / "data_plane.py", "DATA_PLANE"),
    "shm_store": (PRIV / "shm_store.py", "SHM_STORE"),
    "raylet": (PRIV / "raylet.py", "RAYLET"),
    "kv_cache": (LLM / "kv_cache.py", "LLM_KV"),
    "engine": (LLM / "engine.py", "LLM_ENGINE"),
    "tsdb": (PORT / "util" / "tsdb.py", "TSDB"),
    "replication": (PRIV / "replication.py", "REPL"),
    "profiler": (PORT / "util" / "profiler.py", "PROFILER"),
}
RESOURCE_FILES = [PRIV / n for n in (
    "data_plane.py", "gcs.py", "worker.py", "protocol.py", "shm_store.py",
    "actor_server.py", "resource_sanitizer.py", "raylet.py",
    "replication.py")] + [PORT / "util" / "profiler.py"]

# findings a waiver in the port's source silences, by (pass, file): the
# data plane's socket handed to the serving thread (copied from the
# reference with its waiver)
WAIVED: dict = {("resources", "*"): [("resource-leak", "data_plane.py")]}


def _active(findings):
    active, waived = filter_waived(findings)
    return ([(f.rule, Path(f.path).name, f.line) for f in active],
            sorted({(f.rule, Path(f.path).name) for f in waived}))


@pytest.mark.parametrize("name", sorted(LOCK_FILES))
def test_lock_order_of_the_port(name):
    path, prefix, cross = LOCK_FILES[name]
    active, waived = _active(check_locks(load(path), _spec(prefix, cross)))
    assert active == []
    assert waived == WAIVED.get(("locks", name), [])


@pytest.mark.parametrize("name", sorted(GUARDED_FILES))
def test_guarded_fields_of_the_port(name):
    path, prefix = GUARDED_FILES[name]
    active, waived = _active(check_guarded(
        load(path), set(getattr(lw, f"{prefix}_LOCK_DAG")),
        getattr(lw, f"{prefix}_CV_ALIASES")))
    assert active == []
    assert waived == WAIVED.get(("guarded", name), [])


def test_cancel_lock_is_a_declared_leaf():
    """C8's cancel lock guards ``_in_user_fn`` and ``_cancel_pending``;
    the port's worker DAG declares it, as a leaf."""
    assert lw.WORKER_LOCK_DAG["_cancel_lock"] == set()
    assert not any("_cancel_lock" in after
                   for after in lw.WORKER_LOCK_DAG.values())


def test_threads_of_the_port():
    active, waived = _active(check_threads(sorted(PORT.rglob("*.py"))))
    assert active == []
    assert waived == WAIVED.get(("threads", "*"), [])


def test_resources_of_the_port():
    files = [load(p) for p in RESOURCE_FILES]
    assert all(p.exists() for p in RESOURCE_FILES)
    active, waived = _active(check_resources(files))
    assert active == []
    assert waived == WAIVED.get(("resources", "*"), [])
