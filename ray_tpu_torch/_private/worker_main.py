"""Entry point for spawned worker processes.

Reference: the worker-process half of ``python/ray/_private/workers`` startup
(``default_worker.py``): connect to the node's control plane, register, then
serve the task loop until stopped.
"""

from __future__ import annotations

import io
import os
import sys


class _LogShipper(io.TextIOBase):
    """Tee worker stdout/stderr to the driver via the control plane."""

    def __init__(self, worker, stream_name: str, orig):
        self.worker = worker
        self.stream_name = stream_name
        self.orig = orig
        self._buf = ""

    def write(self, s: str) -> int:
        self.orig.write(s)
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            if line.strip():
                task = self.worker._current_spec or {}
                prefix = task.get("name") or task.get("class_name") or "worker"
                self.worker._send_event({
                    "kind": "log",
                    "line": f"({prefix} pid={os.getpid()}) {line}"})
        return len(s)

    def flush(self) -> None:
        self.orig.flush()


def main() -> None:
    from ray_tpu_torch._private import resource_sanitizer, rtlog
    from ray_tpu_torch._private.session import Session
    from ray_tpu_torch._private.worker import Worker, set_global_worker
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    # leak oracle (env rides Popen inheritance from the head): every
    # acquisition from here on must be discharged by the clean-stop
    # path below
    resource_sanitizer.maybe_install()
    if os.environ.get("RTT_GPU_WORKER") == "1":
        # a GPU worker is kept warm (the head forks it before GPU work
        # asks): it imports torch before it registers, so the actor it
        # will host finds it imported (no CUDA context yet)
        import torch  # noqa: F401

    node_id = os.environ["RTT_NODE_ID"]
    proxy = os.environ.get("RTT_PROXY_ADDR")
    if proxy:
        # remote-node worker (spawned by a NodeAgent on another host):
        # RPCs tunnel to the head; no local session/data plane.  On a
        # raylet node (RTT_RAYLET_SOCK set) the task/ctl channels and
        # release oneways instead attach to the LOCAL per-node scheduler
        # (Worker reads the env; see _dial_task_endpoint / §4i).
        from ray_tpu_torch._private import protocol
        protocol.set_authkey_from_env()
        host, _, port = proxy.partition(":")
        rtlog.setup("worker", None)
        session = None
        worker = Worker(None, role="worker", node_id=node_id,
                        proxy_addr=(host, int(port)))
    else:
        session_dir = os.environ["RTT_SESSION_DIR"]
        root, name = os.path.split(session_dir)
        session = Session(root=root, name=name)
        from ray_tpu_torch._private import protocol
        protocol.set_authkey(session.auth_key())
        rtlog.setup("worker", session.log_dir)
        worker = Worker(session, role="worker", node_id=node_id)
    set_global_worker(worker)
    if GLOBAL_CONFIG.log_to_driver:
        sys.stdout = _LogShipper(worker, "stdout", sys.stdout)
        sys.stderr = _LogShipper(worker, "stderr", sys.stderr)
    worker.run_worker_loop()
    # only a CLEAN stop reaches here (stop_worker / head-gone exit);
    # SIGTERM/SIGKILL teardown never does — the oracle asserts exactly
    # the paths the static pass models
    if resource_sanitizer.sanitizer_enabled():
        worker.shutdown()
        resource_sanitizer.assert_clean_at_shutdown("worker-exit")


if __name__ == "__main__":
    main()
