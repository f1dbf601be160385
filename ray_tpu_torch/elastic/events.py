"""Fleet lifecycle event feed: the subscription side of DESIGN.md §4j.

The GCS keeps a bounded ring of node add / drain / remove events
(``gcs._fleet_events``) behind two RPCs:

- ``fleet_events(since)`` — cursor read of the ring; a lagging reader
  may miss events (bounded ring) and should reconcile against
  ``list_nodes``.
- ``fleet_state()`` — one-call rollup: nodes by lifecycle phase and
  the demand backlog.

``FleetEventSubscriber`` is the polling client for drain-aware code: a
daemon thread delivering new events to a callback in feed order.  Polling, not
push — matching the autoscaler's reconcile idiom; the warning window of
a real preemption (30s+ on GCE) dwarfs the poll period.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import rtlog
from ray_tpu_torch._private import worker as _worker_mod

logger = rtlog.get("elastic")


def _rpc(kind: str, **kw) -> dict:
    return _worker_mod.global_worker().rpc(kind, **kw)


def fleet_events(since: int = 0) -> Tuple[List[dict], int]:
    """Events with seq > ``since`` plus the feed's current cursor."""
    resp = _rpc("fleet_events", since=since)
    return resp["events"], resp["seq"]


# one wrapper for the fleet_state RPC lives in the state API; re-export
# so elastic callers don't grow a drifting duplicate
from ray_tpu_torch.util.state import fleet_state  # noqa: E402,F401


def drain_node(node_id: Optional[str] = None,
               label: Optional[Dict[str, str]] = None,
               deadline_s: float = 0.0,
               reason: str = "preemption") -> Optional[str]:
    """Signal a provider-initiated preemption warning for one node
    (by id, or by label match — e.g. ``{"ray-pod": pod_name}`` from the
    Kubernetes provider).  Returns the drained node's id, or None when
    no live node matched."""
    resp = _rpc("node_draining", node_id=node_id, label=label,
                deadline_s=deadline_s, reason=reason)
    return resp["node_id"] if resp.get("ok") else None


class FleetEventSubscriber:
    """Deliver fleet events to ``callback(event_dict)`` in feed order.

    ``kinds`` filters delivery (e.g. ``("node_draining",)``); the cursor
    still advances over filtered-out events.  Callback exceptions are
    logged and swallowed — a broken handler must not stop the feed.
    """

    def __init__(self, callback: Callable[[dict], None],
                 poll_s: float = 0.2,
                 kinds: Optional[Tuple[str, ...]] = None):
        self._callback = callback
        self._poll_s = max(poll_s, 0.02)
        self._kinds = tuple(kinds) if kinds else None
        # feed cursor, shared between the polling thread and inline
        # poll_once callers (ELASTIC_LOCK_DAG in lock_watchdog.py)
        self._cursor_lock = threading.Lock()
        self._since = 0                    # guarded by: _cursor_lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self, from_now: bool = True) -> "FleetEventSubscriber":
        if from_now:
            # skip history: only events after subscription fire
            try:
                _, seq = fleet_events(since=1 << 62)
            except Exception:  # noqa: BLE001 - feed not up yet
                seq = 0
            with self._cursor_lock:
                self._since = seq
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-event-subscriber")
        self._thread.start()
        return self

    def poll_once(self) -> List[dict]:
        """One synchronous poll (the inline mode): returns the
        newly delivered events after invoking the callback on each.
        The RPC and the callbacks run OUTSIDE the cursor lock (blocking
        under a leaf lock is forbidden; §4d)."""
        with self._cursor_lock:
            since = self._since
        events, seq = fleet_events(since=since)
        with self._cursor_lock:
            if seq > self._since:
                self._since = seq
        delivered = []
        for ev in events:
            if self._kinds and ev.get("kind") not in self._kinds:
                continue
            delivered.append(ev)
            try:
                self._callback(ev)
            except Exception:  # noqa: BLE001 - keep the feed alive
                logger.exception("fleet event callback failed: %r", ev)
        return delivered

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - transient RPC failures
                if self._stop.is_set():
                    return
                logger.debug("fleet event poll failed", exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
