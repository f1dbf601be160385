"""Cluster-wide request tracing + device-trace merge onto the timeline.

Reference: ``python/ray/util/tracing/`` (SURVEY.md §5.1) — OpenTelemetry
span context rides task/actor metadata so a request's causal tree spans
processes; and ``ray timeline`` renders host-side Chrome trace events.
Device addition (§5.1 rebuild note): ``torch.profiler`` device traces
(CUDA activity) are merged ONTO THE SAME CLOCK as the host spans, so one
``ray_tpu_torch.timeline()`` dump shows a train step's host dispatch span
above the kernels it ran.

Since the Dapper-style tracing overhaul, span context also rides the wire
protocol itself (the compact optional ``trace`` frame field,
``wire.TRACE_FIELD``, attached only on connections that negotiated a
trace-aware version) so one request's tree spans client → GCS → worker →
data-plane → Serve/LLM engine.  Sampling is **head-based**: the ROOT of a
trace decides once —

- ``tracing.trace(name)`` roots are always sampled (the user asked);
- ``tracing.request_trace(name)`` roots (per-request auto-spans, e.g. the
  Serve proxy) sample at ``trace_sample_rate``;
- children inherit the root's decision, and an UNSAMPLED context neither
  emits events nor rides the wire — the always-on cost of a sampled-out
  request is one ``random()`` call.

Usage::

    from ray_tpu_torch.util import tracing

    with tracing.trace("ingest-and-train"):       # driver: new trace root
        ref = preprocess.remote(batch)            # ctx propagates to tasks
        ...

    with tracing.profile_device("train_step"):    # any process with torch
        metrics = step_fn(state, batch)           # device events captured
        torch.cuda.synchronize()
    # both land in ray_tpu_torch.timeline(): host spans carry
    # trace_id/span_id/parent_id args; device events carry cat="device".

Span context lives in a ``contextvars.ContextVar`` (not a bare
``threading.local``): each thread still has its own current span, and the
context additionally flows into asyncio tasks scheduled from a thread
that holds a span (``run_coroutine_threadsafe`` captures the caller's
context), so async actor methods and Serve deployments inherit it.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import random
import threading
import time
import weakref
from typing import Iterator, List, Optional

_SPAN: "contextvars.ContextVar[Optional[SpanContext]]" = \
    contextvars.ContextVar("rtt_span", default=None)


class SpanContext:
    __slots__ = ("trace_id", "span_id", "parent_id", "name", "sampled",
                 "attrs")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str,
                 sampled: bool = True, attrs: Optional[dict] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.sampled = sampled
        # mutable span attributes merged into the event args at emit time
        # (lets a caller tag e.g. byte counts known only at span close)
        self.attrs = attrs

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name}

    @staticmethod
    def from_dict(d: Optional[dict]) -> Optional["SpanContext"]:
        if not d:
            return None
        return SpanContext(d["trace_id"], d["span_id"],
                           d.get("parent_id"), d.get("name", ""))

    # ------------------------------------------------- wire frame field
    # Compact form riding the optional ``trace`` frame field
    # (wire.TRACE_FIELD) on trace-aware connections: [trace_id, span_id].
    # parent/name never cross the wire — the receiver only ever creates
    # CHILDREN of the sender's span.  Only sampled contexts are packed
    # (head-based sampling: an unsampled root costs the wire nothing).
    def to_wire(self) -> list:
        return [self.trace_id, self.span_id]

    @staticmethod
    def from_wire(v, name: str = "") -> Optional["SpanContext"]:
        if not isinstance(v, (list, tuple)) or len(v) < 2:
            return None
        return SpanContext(str(v[0]), str(v[1]), None, name)


def current_span() -> Optional[SpanContext]:
    return _SPAN.get()


def _set_span(ctx: Optional[SpanContext]) -> None:
    _SPAN.set(ctx)


# Span/trace id generator: 64 random bits as hex.  NOT uuid4 — that is
# ~30µs/call on small sandboxed hosts (the PR-2 task-id finding), and a
# fully-traced task can mint several ids; a urandom-seeded PRNG is
# ~0.3µs with the same collision math for 64-bit ids.
_ids = random.Random(int.from_bytes(os.urandom(8), "big"))
_ids_lock = threading.Lock()


def _new_id() -> str:
    with _ids_lock:
        return f"{_ids.getrandbits(64):016x}"


# ------------------------------------------------------- wire plumbing
# The ONLY writers/readers of the optional ``trace`` frame field
# (rtlint's wire-trace rule keeps ad-hoc ``msg["trace"]`` plumbing out
# of the protocol layer — see tools/rtlint/wirecheck.py).

def attach_wire_trace(msg: dict,
                      ctx: Optional[SpanContext] = None) -> None:
    """Attach the current (or an explicitly carried) sampled span to an
    outgoing frame dict.

    Callers gate on the negotiated connection version
    (``wire.PROTO_TRACE`` / ``wire.DATA_PROTO_TRACE``) so un-upgraded
    peers never see the field."""
    if ctx is None:
        ctx = _SPAN.get()
    if ctx is not None and ctx.sampled:
        from ray_tpu_torch._private import wire
        msg[wire.TRACE_FIELD] = [ctx.trace_id, ctx.span_id]


def extract_wire_trace(msg: dict, name: str = "") -> Optional[SpanContext]:
    """Pop and decode the ``trace`` field from an incoming frame dict
    (absent / malformed → None; the frame itself is never rejected)."""
    from ray_tpu_torch._private import wire
    v = msg.pop(wire.TRACE_FIELD, None)
    if v is None:
        return None
    return SpanContext.from_wire(v, name=name)


def adopt(ctx: Optional[SpanContext]):
    """Make ``ctx`` the current span; returns a token for restore().
    Server dispatch loops bracket handler execution with adopt/restore
    so an adopted caller span can never leak onto the next frame."""
    return _SPAN.set(ctx)


def restore(token) -> None:
    _SPAN.reset(token)


# -------------------------------------------------------- thread rows
# Stable per-thread timeline rows.  ``threading.get_ident() % 100000``
# collided across threads (idents are reused pthread addresses — a new
# thread can inherit a dead one's ident, and with it its row AND name);
# instead rows are keyed by the Thread OBJECT (unique per thread
# lifetime, weakly held so dead threads' entries drop) and each thread
# gets a monotonically-assigned small id.  The FIRST span from a thread
# also emits a Chrome ``thread_name`` metadata event so multi-threaded
# spans render on distinct, named rows.
_tid_lock = threading.Lock()
_tid_counter = itertools.count(1)
# Thread object -> [tid, name_emitted_for_pid set]
_tids: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _thread_row(pid) -> tuple:
    """(tid, metadata_event_or_None) for the calling thread."""
    t = threading.current_thread()
    with _tid_lock:
        ent = _tids.get(t)
        if ent is None:
            ent = _tids[t] = [next(_tid_counter), set()]
        tid, seen_pids = ent
        if pid in seen_pids:
            return tid, None
        seen_pids.add(pid)
    return tid, {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": t.name}}


@contextlib.contextmanager
def trace(name: str, **attrs) -> Iterator[SpanContext]:
    """Open a span (new trace root, or child of the current span).

    Submissions made inside inherit the span context through task
    metadata and the wire trace field, so worker-side spans link back to
    this one in the timeline dump.  Extra keyword ``attrs`` (and anything
    added to ``ctx.attrs`` inside the block) are merged into the event
    args.  A child of an UNSAMPLED root inherits the sampled-out decision
    and emits nothing (head-based sampling)."""
    parent = _SPAN.get()
    ctx = SpanContext(
        trace_id=parent.trace_id if parent else _new_id(),
        span_id=_new_id(),
        parent_id=parent.span_id if parent else None,
        name=name,
        sampled=parent.sampled if parent else True,
        attrs=dict(attrs) if attrs else None)
    _SPAN.set(ctx)
    t0 = time.time()
    try:
        yield ctx
    finally:
        _SPAN.set(parent)
        if ctx.sampled:
            pid = _host_pid()
            tid, meta = _thread_row(pid)
            args = ctx.to_dict()
            if ctx.attrs:
                args.update(ctx.attrs)
            evs = [] if meta is None else [meta]
            evs.append({"name": name, "cat": "span", "ph": "X",
                        "pid": pid, "tid": tid,
                        "ts": t0 * 1e6, "dur": (time.time() - t0) * 1e6,
                        "args": args})
            _emit(evs)


@contextlib.contextmanager
def request_trace(name: str, **attrs) -> Iterator[Optional[SpanContext]]:
    """Per-request auto-root (e.g. one Serve HTTP request): when no span
    is current, roots a new trace sampled at ``trace_sample_rate``; under
    an existing span it is an ordinary child.  Sampled-out requests carry
    an unsampled context so every downstream propagation point skips the
    work — the whole tree costs one random() call."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    parent = _SPAN.get()
    if parent is None:
        rate = GLOBAL_CONFIG.trace_sample_rate
        sampled = bool(rate > 0.0 and random.random() < rate)
        if GLOBAL_CONFIG.metrics_enabled:
            from ray_tpu_torch.util import metrics_catalog as mcat
            mcat.get("rtt_trace_sampled_total").inc(
                tags={"decision": "sampled" if sampled else "dropped"})
        if not sampled:
            tok = _SPAN.set(SpanContext(_new_id(), _new_id(), None, name,
                                        sampled=False))
            try:
                yield None
            finally:
                _SPAN.reset(tok)
            return
    with trace(name, **attrs) as ctx:
        yield ctx


def child_span(parent: Optional[SpanContext], name: str) -> SpanContext:
    """A child context of ``parent`` (or a fresh sampled root when
    ``parent`` is None) — for execution paths that carry context by hand
    (task exec, actor dispatch) rather than via the context variable."""
    if parent is None:
        return SpanContext(_new_id(), _new_id(), None, name)
    return SpanContext(parent.trace_id, _new_id(), parent.span_id, name,
                       sampled=parent.sampled)


def emit_span(name: str, parent: Optional[SpanContext], t0: float,
              dur: float, cat: str = "span", pid=None, tid=None,
              **attrs) -> Optional[SpanContext]:
    """Emit one completed span as a child of an EXPLICIT parent context —
    for event-loop / cross-thread code (LLM engine iterations, GCS
    dispatch, data-plane serving) where the context variable does not
    follow the work.  ``t0`` is wall-clock seconds; returns the child
    context (so callers can link further spans under it), or None when
    the parent is absent or sampled out."""
    if parent is None or not parent.sampled:
        return None
    ctx = SpanContext(parent.trace_id, _new_id(), parent.span_id, name)
    if pid is None:
        pid = _host_pid()
    evs: List[dict] = []
    if tid is None:
        tid, meta = _thread_row(pid)
        if meta is not None:
            evs.append(meta)
    args = ctx.to_dict()
    if attrs:
        args.update(attrs)
    evs.append({"name": name, "cat": cat, "ph": "X", "pid": pid,
                "tid": tid, "ts": t0 * 1e6, "dur": dur * 1e6,
                "args": args})
    _emit(evs)
    return ctx


def emit_ctx_span(ctx: Optional[SpanContext], name: str, t0: float,
                  dur: float, cat: str = "span", **attrs) -> None:
    """Emit the completed-span event for an EXISTING context (one whose
    id was already handed to children — e.g. an actor method span set
    before execution): the event must carry that same span_id or the
    children orphan."""
    if ctx is None or not ctx.sampled:
        return
    pid = _host_pid()
    tid, meta = _thread_row(pid)
    evs: List[dict] = [] if meta is None else [meta]
    args = ctx.to_dict()
    if attrs:
        args.update(attrs)
    evs.append({"name": name, "cat": cat, "ph": "X", "pid": pid,
                "tid": tid, "ts": t0 * 1e6, "dur": dur * 1e6,
                "args": args})
    _emit(evs)


def span_event(name: str, parent: Optional[SpanContext], t0: float,
               dur: float, cat: str, pid, tid, **attrs) -> Optional[dict]:
    """Build (but do not ship) one span event as a child of ``parent`` —
    for processes that own an event buffer directly (the GCS appends
    under its own ``_events_lock`` instead of paying an RPC)."""
    if parent is None or not parent.sampled:
        return None
    ctx = SpanContext(parent.trace_id, _new_id(), parent.span_id, name)
    args = ctx.to_dict()
    if attrs:
        args.update(attrs)
    return {"name": name, "cat": cat, "ph": "X", "pid": pid, "tid": tid,
            "ts": t0 * 1e6, "dur": dur * 1e6, "args": args}


def _host_pid() -> str:
    """Timeline row for this process: the executing node for workers,
    'driver' for the driver (matching the task-event convention)."""
    from ray_tpu_torch._private import worker as worker_mod
    w = worker_mod.try_global_worker()
    if w is None or w.role == "driver":
        return "driver"
    return w.node_id or "worker"


def _emit(events) -> None:
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    if not GLOBAL_CONFIG.timeline_enabled:
        return  # operator disabled the timeline: emit nothing anywhere,
        # so trace trees never appear partially (and GCS events stay flat)
    w = worker_mod.try_global_worker()
    if w is None:
        return
    if GLOBAL_CONFIG.metrics_enabled:
        from ray_tpu_torch.util import metrics_catalog as mcat
        for e in events:
            if e.get("ph") != "M":
                mcat.get("rtt_trace_spans_total").inc(
                    tags={"cat": e.get("cat", "span")})
    if w.role == "driver":
        # drivers have no task conn; ship via rpc (best effort)
        try:
            w.rpc_oneway("ingest_events", events=events)
        except Exception:  # noqa: BLE001 - tracing must never break work
            pass
    else:
        w._send_event({"kind": "profile_events", "events": events})


def profile_event_lists(out_dir: str):
    """Yield one raw Chrome-trace event list per ``*.trace.json`` file a
    torch profiler capture wrote under ``out_dir`` — the single parser
    for the capture's output layout."""
    import glob
    import json

    for path in glob.glob(os.path.join(out_dir, "*.trace.json")):
        with open(path) as f:
            data = json.load(f)
        yield data.get("traceEvents", [])


def _rebase_device_events(raw, host_start_us: float, span, name: str
                          ) -> List[dict]:
    """Re-base one device-trace event list onto the wall-clock epoch
    axis.  Complete (``X``) events AND counter (``C``) events — memory /
    occupancy series — are carried through; counters keep their value
    args (merged with the span tag) so they render in the merged
    timeline.  Returns [] when the capture held no complete events
    (nothing to anchor the re-basing to)."""
    xs = [e["ts"] for e in raw
          if e.get("ts") is not None and e.get("ph") == "X"]
    if not xs:
        return []
    base = min(xs)
    events: List[dict] = []
    for e in raw:
        ph = e.get("ph")
        if ph not in ("X", "C") or e.get("ts") is None:
            continue
        ev = {"name": e.get("name", "?"), "cat": "device",
              "ph": ph,
              "pid": f"device:{name}",
              "tid": e.get("tid", 0),
              "ts": host_start_us + (e["ts"] - base)}
        if ph == "X":
            ev["dur"] = e.get("dur", 0)
        args = dict(e.get("args") or {}) if ph == "C" else {}
        if span is not None:
            args.update(span.to_dict())
        if args:
            ev["args"] = args
        events.append(ev)
    return events


@contextlib.contextmanager
def profile_device(name: str = "device",
                   keep_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a torch.profiler trace (CPU and, where a card is visible,
    CUDA activity) and merge it onto the cluster timeline's clock.

    The profiler writes a Chrome trace with its own time base; events are
    re-based to wall-clock epoch µs (the timeline's clock) using the
    capture-start host time, tagged cat="device", and shipped to the GCS —
    one ``ray_tpu_torch.timeline()`` dump then shows host task/span rows
    and the device's kernel rows together."""
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    out_dir = keep_dir or tempfile.mkdtemp(prefix="rtt_devtrace_")
    span = current_span()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    host_start_us = time.time() * 1e6
    prof = profile(activities=activities)
    try:
        with prof:
            yield
    finally:
        try:
            prof.export_chrome_trace(
                os.path.join(out_dir, f"{name}.trace.json"))
        except Exception:  # noqa: BLE001 - tracing must never break work
            pass
        events = []
        try:
            for raw in profile_event_lists(out_dir):
                events.extend(_rebase_device_events(
                    raw, host_start_us, span, name))
        except Exception:  # noqa: BLE001 - tracing must never break work
            events = []
        if events:
            _emit(events)
        if keep_dir is None:
            shutil.rmtree(out_dir, ignore_errors=True)
