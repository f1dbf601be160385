"""Helpers shared by the port's runtime tests: a short session root per
test and the package logger handed back as it was.

``init`` stops the ``ray_tpu_torch`` logger's propagation, so a module
that inits in the pytest process restores it (``restore_logger``), or a
later module's caplog sees nothing.  A session root under pytest's
``tmp_path`` is too long for the unix sockets beneath it (107 bytes), so
each test gets a fresh short directory instead (``short_tmpdir``).
"""

import atexit
import contextlib
import logging
import os
import shutil
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def short_tmpdir() -> str:
    """A fresh directory whose session sockets fit a unix socket path."""
    base = tempfile.gettempdir()
    return tempfile.mkdtemp(prefix="rtt_t",
                            dir=base if len(base) <= 40 else "/tmp")


@contextlib.contextmanager
def session_root(monkeypatch):
    """``RTT_SESSION_DIR_ROOT`` set to a short directory of the caller's
    own for the block, removed after it."""
    d = short_tmpdir()
    monkeypatch.setenv("RTT_SESSION_DIR_ROOT", d)
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)
        # a worker still exiting, or the head's last snapshot, may write
        # there after the shutdown returned: sweep again at exit
        atexit.register(shutil.rmtree, d, ignore_errors=True)


@contextlib.contextmanager
def restore_logger():
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import rtlog
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    try:
        yield
    finally:
        if rt.is_initialized():
            rt.shutdown()
        for h in log.handlers[:]:
            if h not in handlers:
                log.removeHandler(h)
                h.close()
        log.propagate, log.level = propagate, level
        rtlog._stream_configured = False
        rtlog._file_handlers.clear()
