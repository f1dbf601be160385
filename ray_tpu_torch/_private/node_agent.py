"""NodeAgent: join this host to a remote head as a worker node.

Reference analog: the raylet's process-management half (SURVEY.md §2.1).
The agent dials the head's client-proxy port (per-session HMAC auth via
RTT_AUTH_KEY), registers a node with this host's resources, and
maintains a pool of worker processes: one plain worker per CPU, which
sees no card (``CUDA_VISIBLE_DEVICES=""``), and, on a host with cards
(detected, or declared with ``--num-gpus``), the head's
``gpu_workers_per_node`` GPU workers (``RTT_GPU_WORKER=1``) that see
them all — the head's own rule for its GPU workers.  Against a head that
speaks ``wire.PROTO_RAYLET`` it promotes itself into a **raylet**
(``_private/raylet.py``, DESIGN.md §4i): a per-node local scheduler that
claims worker leases in bulk, dispatches intra-node tasks without a head
round-trip, nets owner-local refcount releases, and uses ONE keepalive
channel (the lease channel's heartbeat) for node liveness.  Against an
older head — or with ``raylet_enabled=0`` — it falls back byte-identical
to the legacy mode: workers attach their task conns straight to the GCS
through the tunnel and a dedicated ``agent_attach`` conn carries
liveness.  Actors in both modes listen on ephemeral TCP ports and
advertise ``tcp://<this-host>:<port>`` addresses; callers dial them
directly, or relay through the head's client proxy when sibling hosts
aren't mutually reachable.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private import protocol, rtlog
from ray_tpu_torch._private.gpus import cuda_visible_devices, detect_gpus

logger = rtlog.get("node-agent")


class NodeAgent:
    def __init__(self, head_host: str, head_port: int, *,
                 num_cpus: Optional[int] = None,
                 num_gpus: float = 0,
                 labels: Optional[Dict[str, str]] = None,
                 resources: Optional[Dict[str, float]] = None):
        self.head = (head_host, head_port)
        self.num_workers = int(num_cpus or os.cpu_count() or 1)
        self.num_gpus = float(num_gpus or 0)
        res = dict(resources or {})
        res["CPU"] = float(self.num_workers)
        if self.num_gpus:
            # this host's cards: served by the device-holding workers
            # (as many as the head's gpu_workers_per_node, below)
            res["GPU"] = self.num_gpus
        all_labels = {"agent": "1", **(labels or {})}
        self._conn = protocol.tunnel_connect(*self.head, "gcs")
        try:
            self._chan = protocol.RpcChannel(self._conn, negotiate=True)
            # P2P object plane (reference: ObjectManager node↔node
            # transfer): large objects produced on this host spool
            # locally and are served directly to sibling hosts; the head
            # is only the fallback relay.
            import tempfile
            from ray_tpu_torch._private import wire
            from ray_tpu_torch._private.data_plane import DataPlaneServer
            self._spool_dir = tempfile.mkdtemp(prefix="rtt_spool_")
            self._data_plane = DataPlaneServer(
                self._spool_dir, advertise_host=self._advertise_host())
            # data_proto advertises this host's data-plane wire ceiling
            # so the head's pooled pull/delete conns skip the per-conn
            # hello (an old head ignores the extra field)
            node_info = dict(resources=res, labels=all_labels, remote=True,
                             data_addr=self._data_plane.advertise_addr,
                             data_proto=wire.DATA_PROTO_MAX)
            resp = self._chan.call("add_node", **node_info)
            self.node_id = resp["node_id"]
            from ray_tpu_torch._private.config import GLOBAL_CONFIG
            # GPU slots: the head's cap on a node's GPU workers (its
            # fractional leases need one worker each), else our own
            self._gpu_slots = int(
                resp.get("gpu_workers_per_node")
                or GLOBAL_CONFIG.gpu_workers_per_node) \
                if self.num_gpus else 0
            self._procs: List[subprocess.Popen] = []
            self._extra_procs: List[subprocess.Popen] = []
            self._stop = threading.Event()
            self._draining = False
            self.raylet = None
            if GLOBAL_CONFIG.raylet_enabled \
                    and self._chan.version >= wire.PROTO_RAYLET:
                # Promote to a raylet (DESIGN.md §4i): the add_node conn
                # becomes the lease channel — grants down, batched
                # results/refcount reconciliation/heartbeats up.  It is
                # ALSO the node's one liveness path (keepalive dedup:
                # no separate agent_attach conn, no _liveness_watch).
                from ray_tpu_torch._private import flight_recorder, raylet
                sess = resp.get("session")
                if sess:
                    # same-host rings land in the head session's tmpfs
                    # dir (flight_dir_for keys on the path NAME) so
                    # the head's debug dump collects them; the no-/dev/shm
                    # fallback then writes under OUR spool dir, not "/"
                    flight_recorder.maybe_install(
                        os.path.join(self._spool_dir, str(sess)),
                        "raylet")
                from ray_tpu_torch.util import profiler as profiler_mod
                profiler_mod.maybe_install("raylet")
                self.raylet = raylet.Raylet(
                    self.head, self.node_id, node_info,
                    sock_dir=self._spool_dir,
                    spawn_cb=self._spawn_extra,
                    on_lost=self.stop,
                    upstream_conn=self._conn,
                    upstream_version=self._chan.version)
            else:
                # legacy path (old head / raylets disabled): dedicate
                # this connection to liveness — the head removes the
                # node when it drops (kill -9 / host crash / partition)
                self._chan.send_oneway("agent_attach", node_id=self.node_id)
                # watch the liveness conn from OUR side too: a dropped
                # TCP conn makes the head remove the node; without this
                # the agent would keep an orphaned pool running
                threading.Thread(target=self._liveness_watch, daemon=True,
                                 name="agent-liveness").start()
            # per-node OOM killer (reference: MemoryMonitor runs inside
            # each raylet): THIS host's pressure, THIS host's pids.
            # Victim policy stays with the head (pick_oom_victim RPC)
            # which pre-marks the task so the death surfaces as a
            # retriable OutOfMemoryError.
            threading.Thread(target=self._memory_watch, daemon=True,
                             name="agent-memory-monitor").start()
        except BaseException:
            # a failed join (version fence, head rejecting add_node,
            # agent_attach send failing) returns no agent: close the
            # dialed conn, stop the already-listening data plane, and
            # drop the spool dir — a retry loop around NodeAgent() must
            # not accrete a listener + tempdir per attempt
            try:
                self._conn.close()
            except OSError:
                pass
            dp = getattr(self, "_data_plane", None)
            if dp is not None:
                dp.stop()
            sd = getattr(self, "_spool_dir", None)
            if sd is not None:
                import shutil
                shutil.rmtree(sd, ignore_errors=True)
            raise
        logger.info("joined head %s:%s as node %s (%d workers)",
                    head_host, head_port, self.node_id[:8], self.num_workers)

    def _memory_watch(self) -> None:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch._private.memory_monitor import node_memory_usage
        while not self._stop.is_set():
            self._stop.wait(max(GLOBAL_CONFIG.memory_monitor_interval_s, 0.1))
            threshold = GLOBAL_CONFIG.memory_usage_threshold
            if threshold >= 1.0 or threshold <= 0:
                continue
            used, total = node_memory_usage()
            if not total or used / total < threshold:
                continue
            # catch broadly: RpcChannel.call re-raises arbitrary
            # deserialized server-side exceptions, and this daemon thread
            # dying would silently strip the node of OOM protection
            ch = None
            try:
                ch = protocol.RpcChannel(
                    protocol.tunnel_connect(*self.head, "gcs"),
                    negotiate=True)
                resp = ch.call("pick_oom_victim", node_id=self.node_id,
                               frac=used / total)
                pid = resp.get("pid")
                # only kill pids of processes THIS agent spawned — the
                # head's view may be stale, and a recycled pid must never
                # be signaled
                for p in self._procs:
                    if pid and p.pid == pid and p.poll() is None:
                        logger.warning(
                            "memory %.0f%% >= %.0f%%: OOM-killing worker "
                            "pid=%d", 100 * used / total,
                            100 * threshold, pid)
                        confirmed = False
                        try:
                            # confirm first: the head marks the task as
                            # OOM-killed only when the kill actually
                            # happens (a skipped kill must not mislabel a
                            # later unrelated death), and only if the
                            # picked task is STILL the one running
                            confirmed = ch.call(
                                "confirm_oom_kill", pid=pid,
                                worker_id=resp.get("worker_id"),
                                task_id=resp.get("task_id")).get("ok")
                        except Exception:  # noqa: BLE001
                            pass
                        if confirmed:
                            try:
                                p.kill()
                            except OSError:
                                pass
                        break
            except Exception:  # noqa: BLE001 - keep the monitor alive
                logger.exception("memory watch pass failed")
            finally:
                if ch is not None:
                    try:
                        ch.close()
                    except OSError:
                        pass

    def _liveness_watch(self) -> None:
        try:
            self._conn.recv()  # the head never sends; EOF = detached
        except (EOFError, OSError):
            pass
        if not self._stop.is_set():
            logger.error("lost connection to head; shutting down pool")
            self.stop()

    # -- worker pool ---------------------------------------------------------
    def _advertise_host(self) -> str:
        """This host's address as seen on the route to the head — what
        actor TCP listeners advertise to cross-host callers."""
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(self.head)  # UDP connect: no packets, just routing
            return s.getsockname()[0]
        except OSError:
            return "127.0.0.1"
        finally:
            s.close()

    def _spawn(self, gpu: bool = False) -> subprocess.Popen:
        env = dict(os.environ)
        env["RTT_PROXY_ADDR"] = f"{self.head[0]}:{self.head[1]}"
        env["RTT_NODE_ID"] = self.node_id
        env["RTT_ADVERTISE_HOST"] = self._advertise_host()
        env["RTT_SPOOL_DIR"] = self._spool_dir
        env["RTT_DATA_ADDR"] = self._data_plane.advertise_addr
        if self.raylet is not None:
            # workers attach task/ctl conns to the LOCAL raylet socket
            # (and route release oneways there for netting) instead of
            # tunneling every frame to the head
            env["RTT_RAYLET_SOCK"] = self.raylet.sock_path
        if gpu:
            # device-holding worker: sees this host's cards, and says so
            # when it registers and attaches (the raylet and the head
            # start GPU leases on it alone)
            env["RTT_GPU_WORKER"] = "1"
            env["CUDA_VISIBLE_DEVICES"] = cuda_visible_devices(self.num_gpus)
        else:
            # plain workers never see a card: no CUDA context in every
            # process, and no quiet CPU path for device work
            env.pop("RTT_GPU_WORKER", None)
            env["CUDA_VISIBLE_DEVICES"] = ""
        env.pop("RTT_SESSION_DIR", None)
        sink = None if os.environ.get("RTT_AGENT_WORKER_LOG") \
            else subprocess.DEVNULL  # debug: inherit stderr when set
        return subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.worker_main"],
            env=env, stdout=sink, stderr=sink)

    def _spawn_extra(self) -> None:
        """Raylet callback: fork one replacement worker (pool blocked in
        get() with leased work queued).  Not respawned on exit — the
        base pool slots are the durable capacity."""
        if self._stop.is_set():
            return
        self._extra_procs.append(self._spawn())

    def run(self) -> None:
        """Maintain the pool until stopped; respawn dead workers with
        exponential backoff (a head outage or startup import error must
        not become a silent fork loop)."""
        self._procs = [self._spawn(gpu=i < self._gpu_slots)
                       for i in range(self._gpu_slots + self.num_workers)]
        spawn_times = [time.monotonic()] * len(self._procs)
        backoff = [1.0] * len(self._procs)
        while not self._stop.is_set():
            time.sleep(0.5)
            # reap finished replacement workers (no respawn)
            self._extra_procs = [p for p in self._extra_procs
                                 if p.poll() is None]
            for i, p in enumerate(self._procs):
                if p.poll() is None or self._stop.is_set():
                    continue
                lived = time.monotonic() - spawn_times[i]
                if lived < 5.0:
                    backoff[i] = min(backoff[i] * 2, 30.0)
                    logger.warning(
                        "worker slot %d exited after %.1fs (rc=%s); "
                        "respawning in %.0fs", i, lived, p.returncode,
                        backoff[i])
                    self._stop.wait(backoff[i])
                else:
                    backoff[i] = 1.0
                if self._stop.is_set():
                    break  # stop() during the backoff wait: no respawn
                # slot i keeps its role: a dead GPU worker must come back
                # GPU-capable or GPU tasks pinned to this node hang forever
                self._procs[i] = self._spawn(gpu=i < self._gpu_slots)
                spawn_times[i] = time.monotonic()

    def drain(self, reason: str = "preemption",
              deadline_s: float = 0.0) -> None:
        """Provider-initiated preemption warning (DESIGN.md §4j): report
        ``node_draining`` upstream so the head stops placing work here
        and the elasticity manager can re-mesh the training group away,
        then stop after the warning window.  Idempotent; SIGTERM with
        ``RTT_DRAIN_GRACE_S`` set routes here (the Kubernetes
        terminationGracePeriod model: TERM = warning, KILL = deadline)."""
        if self._draining or self._stop.is_set():
            return
        self._draining = True
        logger.warning("draining node %s (%s): stopping in %.0fs",
                       self.node_id[:8], reason, deadline_s)
        ch = None
        try:  # fresh conn: the add_node conn belongs to liveness/raylet
            ch = protocol.RpcChannel(
                protocol.tunnel_connect(*self.head, "gcs"),
                negotiate=True)
            ch.call("node_draining", node_id=self.node_id,
                    reason=reason, deadline_s=deadline_s)
        except Exception:  # noqa: BLE001 - head gone: just stop on time
            logger.exception("node_draining report failed")
        finally:
            if ch is not None:
                try:
                    ch.close()
                except OSError:
                    pass
        if deadline_s > 0:
            t = threading.Timer(deadline_s, self.stop)
            t.daemon = True
            t.name = "agent-drain-deadline"
            t.start()
        else:
            self.stop()

    def stop(self) -> None:
        self._stop.set()
        if self.raylet is not None:
            # clean leave: the raylet flushes its unsettled results and
            # netted releases, RETURNS unstarted leases, and detaches —
            # the head reclaims nothing by death-detection and removes
            # the node itself (no remove_node RPC needed)
            self.raylet.stop()
        for p in self._procs + self._extra_procs:
            try:
                p.terminate()
            except OSError:
                pass
        if self.raylet is None:
            ch = None
            try:  # fresh conn: the attach conn is dedicated to liveness
                ch = protocol.RpcChannel(
                    protocol.tunnel_connect(*self.head, "gcs"),
                    negotiate=True)
                ch.call("remove_node", node_id=self.node_id)
            except Exception:  # noqa: BLE001 - head may already be gone
                pass
            finally:
                if ch is not None:
                    ch.close()
        try:
            self._conn.close()
        except OSError:
            pass
        self._data_plane.stop()
        logger.info("data plane served %d objects / %d bytes over %d conns",
                    self._data_plane.objects_served,
                    self._data_plane.bytes_served,
                    self._data_plane.conns_accepted)
        import shutil
        shutil.rmtree(self._spool_dir, ignore_errors=True)


def parse_labels(spec: str) -> Dict[str, str]:
    """``k=v,k2=v2`` → dict (CLI --labels format).  A bare item without
    '=' is rejected: a typo'd label (e.g. ``ici_domain`` for
    ``ici_domain=...``) must fail fast, not register an empty-string label
    that label-equality placement would silently group on."""
    out: Dict[str, str] = {}
    for item in (spec or "").split(","):
        if not item:
            continue
        k, sep, v = item.partition("=")
        if not sep or not k.strip():
            raise ValueError(f"malformed label {item!r}: expected k=v")
        out[k.strip()] = v.strip()
    return out


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="ray_tpu_torch node-agent")
    ap.add_argument("--address", required=True, help="head HOST:PORT "
                    "(the head's --client-server-port)")
    ap.add_argument("--num-cpus", type=int, default=0)
    ap.add_argument("--num-gpus", type=float, default=None,
                    help="CUDA cards on this host (default: $RTT_NUM_GPUS, "
                         "else the cards torch sees); served by the head's "
                         "gpu_workers_per_node device-holding workers")
    ap.add_argument("--labels", default=os.environ.get("RTT_NODE_LABELS", ""),
                    help="node labels k=v,k2=v2 (default: $RTT_NODE_LABELS)")
    args = ap.parse_args(argv)
    host, _, port = args.address.partition(":")
    protocol.set_authkey_from_env()
    rtlog.setup("node-agent", None)
    labels = parse_labels(args.labels)
    agent = NodeAgent(host, int(port or 10001),
                      num_cpus=args.num_cpus or None,
                      num_gpus=detect_gpus() if args.num_gpus is None
                      else args.num_gpus,
                      labels=labels or None)
    def _on_term(*_):
        # TERM is the provider's preemption warning when a grace window
        # is configured (Kubernetes terminationGracePeriod model): the
        # agent reports node_draining and keeps serving until the
        # deadline.  No grace -> the old immediate clean leave.  The RPC
        # runs off-thread: signal handlers must not block on sockets.
        grace = float(os.environ.get("RTT_DRAIN_GRACE_S", "0") or 0)
        if grace > 0:
            threading.Thread(
                target=agent.drain,
                kwargs=dict(reason="sigterm", deadline_s=grace),
                daemon=True, name="agent-drain").start()
        else:
            agent.stop()

    signal.signal(signal.SIGTERM, _on_term)
    try:
        agent.run()
    except KeyboardInterrupt:
        agent.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
