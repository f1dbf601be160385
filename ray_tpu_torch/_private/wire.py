"""Versioned wire framing + a language-neutral control-message codec.

Reference analog: ``src/ray/protobuf/*.proto`` + ``src/ray/rpc/`` — the
reference's control plane is schema'd protobuf over gRPC, so any language
can speak it and versions negotiate at the channel level.  r3's wire format
was raw pickled dicts: single-language, unversioned, and every decode was a
``pickle.loads`` of peer-supplied bytes (HMAC-gated, but still the widest
possible parser).  This module closes that L0 gap (VERDICT r3 missing #3):

**Frame format.**  Every framed message is ``[version u8][codec u8][body]``
sent via ``Connection.send_bytes``.  Version bytes are 1..127 — a raw
pickle stream always begins with the PROTO opcode ``0x80``, so legacy
(pre-framing, version-0) peers are detected by the first byte and decoded
transparently: framed and legacy senders interoperate on one socket.

**Codecs.**  ``codec=1`` is *rtmsg*, a ~100-line tagged binary format for
the JSON-plus-bytes subset control messages actually use (None/bool/int/
float/str/bytes/list/tuple/dict).  Decoding rtmsg executes no code — unlike
pickle — and the format is demonstrably implementable in any language: the
C client ``native/src/rtmsg_client.c`` speaks it against a live head
(tests/test_polyglot_client.py), and ``native/src/wirecodec.c`` implements
it as a CPython extension at 2.2µs/frame — faster than C pickle — so with
the native build present EVERY encodable frame rides rtmsg, hot kinds
included.  ``codec=0`` is pickle, the per-frame fallback for genuinely
Python payloads (task arg objects, exceptions) and the no-toolchain path.

**Negotiation.**  A client opens at version 0 (legacy), sends a
``__proto_hello__`` RPC advertising ``[PROTO_MIN..PROTO_MAX]``; the server
answers with the highest common version (its own ceiling capped by the
client's) or rejects when the client's ceiling is below the server's
configured floor (``proto_min_version``).  Tested both ways in
tests/test_protocol_versioning.py.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, Tuple

PROTO_MIN = 1   # framed, pickle codec only
PROTO_TRACE = 3  # understands the optional TRACE_FIELD on any frame
PROTO_RAYLET = 4  # speaks the raylet lease kinds (RAYLET_KINDS below)
PROTO_REPL = 5  # speaks the GCS replication kinds (REPL_KINDS below)
PROTO_MAX = 5   # framed, rtmsg + pickle + trace + raylet + replication
_PICKLE_OPCODE = 0x80  # first byte of every pickle protocol>=2 stream

# Optional span-context frame field (Dapper-style wire propagation):
# ``msg[TRACE_FIELD] = [trace_id, span_id]`` — attached ONLY on
# connections that negotiated >= PROTO_TRACE (control plane) or
# >= DATA_PROTO_TRACE (data plane), so un-upgraded peers see
# byte-identical frames.  The single writer/reader of this field is
# ray_tpu_torch/util/tracing.py (attach_wire_trace / extract_wire_trace);
# rtlint's wire-trace rule rejects ad-hoc plumbing of the key.
TRACE_FIELD = "trace"

_CODEC_PICKLE = 0
_CODEC_RTMSG = 1

# ----------------------------------------------------------------- rtmsg
# Tag table (one byte each; lengths/counts are big-endian u32, ints are
# big-endian signed 64-bit, floats are IEEE-754 doubles):
#   0x01 None | 0x02 False | 0x03 True
#   0x10 int64 | 0x11 float64
#   0x20 str(u32 len, utf-8) | 0x21 bytes(u32 len)
#   0x30 list(u32 count) | 0x31 tuple(u32 count) | 0x32 dict(u32 count)
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1
_pack_i64 = struct.Struct(">q").pack
_pack_f64 = struct.Struct(">d").pack
_pack_u32 = struct.Struct(">I").pack
_unpack_i64 = struct.Struct(">q").unpack_from
_unpack_f64 = struct.Struct(">d").unpack_from
_unpack_u32 = struct.Struct(">I").unpack_from


class WireError(ValueError):
    """Malformed or unsupported frame."""


class ProtocolVersionError(WireError):
    """Peer speaks a version outside our supported range."""


def _rtmsg_encode_into(buf: bytearray, obj: Any) -> None:
    # bool before int: isinstance(True, int)
    if obj is None:
        buf.append(0x01)
    elif obj is False:
        buf.append(0x02)
    elif obj is True:
        buf.append(0x03)
    elif type(obj) is int:
        if not _I64_MIN <= obj <= _I64_MAX:
            raise TypeError("int out of i64 range")
        buf.append(0x10)
        buf += _pack_i64(obj)
    elif type(obj) is float:
        buf.append(0x11)
        buf += _pack_f64(obj)
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        buf.append(0x20)
        buf += _pack_u32(len(raw))
        buf += raw
    elif type(obj) in (bytes, bytearray, memoryview):
        # buffer widening: bytearray/memoryview encode as the bytes tag
        # and DECODE as bytes — fine for wire payloads (out-of-band
        # buffers, inline object data), where only content round-trips.
        # memoryview len() counts ELEMENTS, not bytes: cast to a flat
        # byte view first (non-contiguous views raise TypeError and fall
        # to the caller's pickle fallback, same as other unencodables).
        if type(obj) is memoryview:
            obj = obj.cast("B")
        buf.append(0x21)
        buf += _pack_u32(len(obj))
        buf += obj
    elif type(obj) is list:
        buf.append(0x30)
        buf += _pack_u32(len(obj))
        for v in obj:
            _rtmsg_encode_into(buf, v)
    elif type(obj) is tuple:
        buf.append(0x31)
        buf += _pack_u32(len(obj))
        for v in obj:
            _rtmsg_encode_into(buf, v)
    elif type(obj) is dict:
        buf.append(0x32)
        buf += _pack_u32(len(obj))
        for k, v in obj.items():
            _rtmsg_encode_into(buf, k)
            _rtmsg_encode_into(buf, v)
    else:
        # subclasses (numpy scalars, IntEnum, namedtuples) intentionally
        # land here: their identity would not round-trip
        raise TypeError(f"not rtmsg-encodable: {type(obj)!r}")


def _rtmsg_decode_from(buf, off: int) -> Tuple[Any, int]:
    tag = buf[off]
    off += 1
    if tag == 0x01:
        return None, off
    if tag == 0x02:
        return False, off
    if tag == 0x03:
        return True, off
    if tag == 0x10:
        return _unpack_i64(buf, off)[0], off + 8
    if tag == 0x11:
        return _unpack_f64(buf, off)[0], off + 8
    if tag == 0x20:
        n = _unpack_u32(buf, off)[0]
        off += 4
        return str(buf[off:off + n], "utf-8"), off + n
    if tag == 0x21:
        n = _unpack_u32(buf, off)[0]
        off += 4
        return bytes(buf[off:off + n]), off + n
    if tag in (0x30, 0x31):
        n = _unpack_u32(buf, off)[0]
        off += 4
        items = []
        for _ in range(n):
            v, off = _rtmsg_decode_from(buf, off)
            items.append(v)
        return (tuple(items) if tag == 0x31 else items), off
    if tag == 0x32:
        n = _unpack_u32(buf, off)[0]
        off += 4
        d = {}
        for _ in range(n):
            k, off = _rtmsg_decode_from(buf, off)
            v, off = _rtmsg_decode_from(buf, off)
            d[k] = v
        return d, off
    raise WireError(f"bad rtmsg tag 0x{tag:02x} at {off - 1}")


def rtmsg_dumps(obj: Any) -> bytes:
    buf = bytearray()
    _rtmsg_encode_into(buf, obj)
    return bytes(buf)


def rtmsg_loads(raw: bytes) -> Any:
    obj, off = _rtmsg_decode_from(memoryview(raw), 0)
    if off != len(raw):
        raise WireError(f"trailing bytes after rtmsg value ({len(raw)-off})")
    return obj


# ----------------------------------------------------------------- frames
# Codec selection at v2 (measured, this host):
#   C rtmsg (native/src/wirecodec.c)  ~2.2µs/frame roundtrip
#   C pickle                          ~4.4µs
#   pure-Python rtmsg                 ~31µs
# With the native codec built (the normal case — gcc is in the image and
# the build caches), EVERY encodable frame rides rtmsg: fastest AND
# language-neutral, so hot kinds need no pickle carve-out.  Without it,
# the µs-critical kinds below stay on pickle and only non-hot control
# messages pay the pure-Python encoder; a polyglot peer can still
# negotiate v2 and read every non-payload control kind as rtmsg either
# way (BASELINE #7 latency contract unchanged).
_HOT_KINDS = frozenset({
    "submit_batch", "submit_task", "get_meta", "peek_meta", "wait",
    "add_ref", "add_refs", "release", "release_batch", "release_all",
    "task_done", "call", "put_object", "put_chunk", "fetch_chunk"})

# Refcount-plane oneway kinds: the GCS coalesces consecutive frames of
# these per connection and applies them in one batched lock acquisition
# (stream order preserved).  Declared here, next to the frame schema,
# because it is a wire-level contract: anything added must stay a pure
# refcount mutation with no reply and no cross-table side effects.
# One kind per line: tools/rtlint's wire pass anchors its findings (and
# their waivers) to the declaring line.
REF_KINDS = frozenset({
    # single-ref alias kept for minimal polyglot peers; the in-tree
    # Python client batches via add_refs, so no producer exists here
    # rtlint: wire-no-producer-ok(wire-compat alias of add_refs)
    "add_ref",
    "add_refs",
    "release",
    "release_batch",
    "release_all",
})

# ------------------------------------------------------- raylet lease plane
# Per-node local schedulers (``_private/raylet.py``, DESIGN.md §4i;
# reference analog: ``src/ray/raylet/`` NodeManager + LocalTaskManager).
# A raylet converts one GCS connection into a bidirectional lease channel
# with ``raylet_attach`` and from then on the channel carries ONLY these
# kinds — none of them ever appears on a connection that negotiated
# < PROTO_RAYLET, so old peers see byte-identical traffic (the PR-4/PR-7
# hello pattern).  All lease frames are oneways (rid None): the channel
# is a stream in both directions, never request/response — loss of the
# channel IS the failure signal (lease reclaim / node removal).
#
# Declared here, next to the frame schema, because it is a wire-level
# contract: tools/rtlint's wire pass asserts every kind has exactly one
# GCS dispatch arm (downstream set) or raylet dispatch arm (upstream
# set) plus a producer on the other side.
# One kind per line (line-anchored waivers, like REF_KINDS).

# GCS -> raylet pushes:
RAYLET_DOWN_KINDS = frozenset({
    "lease_grant",     # bulk block of task specs + their resource claims
    "lease_revoke",    # cancel: drop queued / cancel running specs
    "worker_ctl",      # forward an OOB ctl frame to a local worker
    "raylet_stop",     # clean shutdown request (head shutting down)
})
# raylet -> GCS reports:
RAYLET_UP_KINDS = frozenset({
    "raylet_attach",       # converts the conn (carried at >= PROTO_RAYLET)
    "raylet_done_batch",   # batched task completions + lease handoffs
    "raylet_ref_batch",    # netted owner-local refcount deltas (reconcile)
    "raylet_lease_return", # unstarted leases given back (idle / shutdown)
    "raylet_fwd",          # verbatim worker event (actor_ready, logs, ...)
    "raylet_worker_died",  # local worker process death (ledger cleanup)
    "raylet_task_blocked",   # leased task parked in get(): CPU released
    "raylet_task_unblocked", # ... and re-acquired
    "raylet_heartbeat",    # keepalive + local scheduler stats (the ONE
    #                        liveness path in raylet mode: no agent_attach)
    "raylet_workers",      # worker roster re-announce after a head restart
    "raylet_detach",       # clean leave: reclaim leases, remove the node
})
RAYLET_KINDS = RAYLET_DOWN_KINDS | RAYLET_UP_KINDS

# -------------------------------------------------- GCS replication plane
# Ledger replication to a warm standby head (``_private/replication.py``,
# DESIGN.md §4l; reference analog: GCS fault tolerance via Redis-backed
# table persistence).  A standby converts one GCS connection into a
# one-way replication stream with ``repl_attach`` — version-fenced at
# PROTO_REPL exactly like the raylet lease channel, so no older peer
# ever sees these kinds.  Every frame is a oneway (rid None): the
# stream's loss IS the failure signal (the standby probes the endpoint
# and promotes).  One kind per line (line-anchored waivers, like
# REF_KINDS); tools/rtlint's wire pass asserts arm + producer per kind.

# standby -> GCS:
REPL_UP_KINDS = frozenset({
    "repl_attach",     # converts the conn into the replication stream
})
# GCS -> standby pushes:
REPL_DOWN_KINDS = frozenset({
    "repl_snapshot",   # full durable-state bootstrap (+ wal position)
    "repl_wal",        # batch of ledger WAL records, seq-ordered
    "repl_heartbeat",  # liveness + current epoch/seq
    "repl_tsdb",       # head TSDB raw-ring deltas (history handoff)
})
REPL_KINDS = REPL_DOWN_KINDS | REPL_UP_KINDS

# ------------------------------------------------------------- data ops
# Request kinds the data-plane server (``data_plane.DataPlaneServer``)
# dispatches on (the ``op`` field).  Declared here, next to the control
# kind tables, so tools/rtlint's protostate pass can assert the
# ``fetch_stream`` session FSM below and the server's dispatch arms
# never drift apart.
DATA_OPS = frozenset({
    "__proto_hello__",   # data-plane version negotiation (v1+ pullers)
    "fetch_object",      # legacy size probe (seed protocol)
    "fetch_chunk",       # legacy request-per-chunk pull (seed protocol)
    "fetch_stream",      # streamed pull: ack + bulk frames (v1+)
    "delete_object",     # spool delete (invalidates the fd cache)
    "stats",             # serve counters (tests / autopilot probes)
})

# ------------------------------------------------------------ bulk frames
# Data-plane streaming (``_private/data_plane.py``): after a
# ``fetch_stream`` request/acknowledge exchange (ordinary control
# messages), the holder pushes the object's bytes as a sequence of
# length-prefixed RAW BINARY frames — no pickle, no per-chunk
# request/response round trip.  On a direct TCP connection the frames
# are written straight on the socket fd (header ``writev`` +
# ``os.sendfile`` from the spool file: the payload never enters
# userspace on the send side) and read with ``recv_into`` straight into
# the receiver's pre-sized buffer.  Through the head's message-pump
# relay (which re-frames ``recv_bytes``/``send_bytes`` messages and
# would corrupt raw fd traffic) each frame instead rides one
# ``send_bytes`` message: same zero-pickle payload, Connection framing
# as the length prefix, and a zero-length message as the abort marker.
#
# Frame header: ``[u8 kind][u32 payload length]`` big-endian.
#   BULK_DATA  payload = raw object bytes at the stream cursor
#   BULK_END   payload empty — stream complete (defensive trailer; the
#              ack already declared the exact byte count)
#   BULK_ERR   payload = utf-8 error text; the conn STAYS usable (the
#              server returns to message mode), so a pooled connection
#              survives a mid-stream miss
BULK_DATA = 0x01
BULK_END = 0x02
BULK_ERR = 0x03
_BULK_HDR = struct.Struct(">BI")
BULK_HDR_LEN = _BULK_HDR.size


def bulk_pack_header(kind: int, length: int) -> bytes:
    return _BULK_HDR.pack(kind, length)


def bulk_unpack_header(buf) -> Tuple[int, int]:
    """(kind, payload_length) from a BULK_HDR_LEN-byte header."""
    return _BULK_HDR.unpack_from(buf, 0)


# Data-plane protocol versions, negotiated per connection with the same
# ``__proto_hello__`` exchange the control plane uses (PR-2).  A legacy
# holder answers the hello with an unknown-op error and the puller
# degrades to the v0 chunk ops; a legacy puller never sends the hello
# and the server keeps speaking v0 to it.
DATA_PROTO_MIN = 0   # request-per-chunk pickled dicts (seed protocol)
DATA_PROTO_TRACE = 2  # accepts the optional TRACE_FIELD on fetch_stream
DATA_PROTO_MAX = 2   # fetch_stream + bulk frames + trace field


# ------------------------------------------------- session FSMs (§4p)
# Per-channel session state machines, declared next to the kind tables
# they constrain.  ``tools/rtlint/protostate.py`` (a) checks every
# producer and dispatch arm emits/handles only kinds these FSMs allow
# for its side, and (b) exhaustively explores each FSM across the full
# old×new version matrix (client max-version × server floor × server
# max-version) proving no reachable state deadlocks, double-replies,
# or drops a reply-expected frame.
#
# Transition tuples: ``(state, who, kind, min_version, effect, next)``
#  - who:    "c" = the dialing side, "s" = the serving side, "x" = either
#  - kind:   a wire kind, or a ``*``-prefixed pseudo-kind (a frame
#            family or event, not a literal kind string): ``*rpc`` = any
#            two-way control kind, ``*ref`` = any REF_KINDS oneway,
#            ``*reply``/``*hello_ok``/``*hello_reject`` = reply frames
#            (matched by rid, not kind), ``*bulk_*`` = raw binary bulk
#            frames, ``*eof`` = connection loss/close.
#  - min_version: the transition exists only at session version >= this
#            (the version fence: e.g. ``raylet_attach`` at PROTO_RAYLET).
#  - effect: "request" opens a reply obligation, "reply" settles one,
#            "oneway" neither, "convert" hands the conn to another
#            channel (must settle all obligations first), "teardown"
#            closes the conn (EOF settles obligations by construction —
#            the peer observes the loss).
#
# ``pre_version`` is the wire version of frames before a ``hello``
# reply pins the negotiated version; channels without a ``hello`` ride
# a control conn that already negotiated.
SESSION_FSMS = {
    # ---- control negotiation + RPC (v1..v5 matrix; ISSUE v2-v5 plus
    # the v1 floor peers still speak) ---------------------------------
    "control": {
        "versions": (PROTO_MIN, PROTO_MAX),
        "pre_version": PROTO_MIN,
        "hello": "__proto_hello__",
        "initial": "start",
        "finals": ("closed", "converted"),
        "transitions": (
            ("start", "c", "__proto_hello__", 1, "request",
             "hello_wait"),
            ("hello_wait", "s", "*hello_ok", 1, "reply", "ready"),
            ("hello_wait", "s", "*hello_reject", 1, "reply", "closed"),
            # hello-less legacy sessions stay at the floor version
            ("start", "c", "*rpc", 1, "request", "start_wait"),
            ("start_wait", "s", "*reply", 1, "reply", "start"),
            ("start", "c", "*ref", 1, "oneway", "start"),
            ("ready", "c", "*rpc", 1, "request", "ready_wait"),
            ("ready_wait", "s", "*reply", 1, "reply", "ready"),
            ("ready", "c", "*ref", 1, "oneway", "ready"),
            # channel conversions: the conn leaves the control FSM
            ("ready", "c", "attach_task_conn", 1, "convert",
             "converted"),
            ("ready", "c", "attach_worker_ctl", 1, "convert",
             "converted"),
            ("ready", "c", "agent_attach", 1, "convert", "converted"),
            ("ready", "c", "raylet_attach", PROTO_RAYLET, "convert",
             "converted"),
            ("ready", "c", "repl_attach", PROTO_REPL, "convert",
             "converted"),
            ("start", "x", "*eof", 1, "teardown", "closed"),
            ("ready", "x", "*eof", 1, "teardown", "closed"),
        ),
    },
    # ---- raylet lease channel (§4i): pure oneway streams ------------
    "raylet": {
        "versions": (PROTO_MIN, PROTO_MAX),
        "initial": "unattached",
        # "unattached" is final: at < PROTO_RAYLET the channel simply
        # never opens (the version fence, byte-identical old traffic)
        "finals": ("unattached", "closed"),
        "transitions": (
            ("unattached", "c", "raylet_attach", PROTO_RAYLET,
             "oneway", "attached"),
            ("attached", "c", "raylet_done_batch", PROTO_RAYLET,
             "oneway", "attached"),
            ("attached", "c", "raylet_ref_batch", PROTO_RAYLET,
             "oneway", "attached"),
            ("attached", "c", "raylet_lease_return", PROTO_RAYLET,
             "oneway", "attached"),
            ("attached", "c", "raylet_fwd", PROTO_RAYLET,
             "oneway", "attached"),
            ("attached", "c", "raylet_worker_died", PROTO_RAYLET,
             "oneway", "attached"),
            ("attached", "c", "raylet_task_blocked", PROTO_RAYLET,
             "oneway", "attached"),
            ("attached", "c", "raylet_task_unblocked", PROTO_RAYLET,
             "oneway", "attached"),
            ("attached", "c", "raylet_heartbeat", PROTO_RAYLET,
             "oneway", "attached"),
            ("attached", "c", "raylet_workers", PROTO_RAYLET,
             "oneway", "attached"),
            ("attached", "s", "lease_grant", PROTO_RAYLET,
             "oneway", "attached"),
            ("attached", "s", "lease_revoke", PROTO_RAYLET,
             "oneway", "attached"),
            ("attached", "s", "worker_ctl", PROTO_RAYLET,
             "oneway", "attached"),
            ("attached", "s", "raylet_stop", PROTO_RAYLET,
             "oneway", "stopping"),
            ("attached", "c", "raylet_detach", PROTO_RAYLET,
             "oneway", "closed"),
            # drain: completions/returns still flow after raylet_stop,
            # and in-flight GCS pushes may race the stop frame
            ("stopping", "c", "raylet_done_batch", PROTO_RAYLET,
             "oneway", "stopping"),
            ("stopping", "c", "raylet_ref_batch", PROTO_RAYLET,
             "oneway", "stopping"),
            ("stopping", "c", "raylet_lease_return", PROTO_RAYLET,
             "oneway", "stopping"),
            ("stopping", "c", "raylet_fwd", PROTO_RAYLET,
             "oneway", "stopping"),
            ("stopping", "c", "raylet_worker_died", PROTO_RAYLET,
             "oneway", "stopping"),
            ("stopping", "c", "raylet_heartbeat", PROTO_RAYLET,
             "oneway", "stopping"),
            ("stopping", "s", "lease_grant", PROTO_RAYLET,
             "oneway", "stopping"),
            ("stopping", "s", "lease_revoke", PROTO_RAYLET,
             "oneway", "stopping"),
            ("stopping", "s", "worker_ctl", PROTO_RAYLET,
             "oneway", "stopping"),
            ("stopping", "c", "raylet_detach", PROTO_RAYLET,
             "oneway", "closed"),
            ("attached", "x", "*eof", PROTO_RAYLET, "teardown",
             "closed"),
            ("stopping", "x", "*eof", PROTO_RAYLET, "teardown",
             "closed"),
        ),
    },
    # ---- GCS replication stream (§4l): one-way pushes ---------------
    "repl": {
        "versions": (PROTO_MIN, PROTO_MAX),
        "initial": "unattached",
        "finals": ("unattached", "closed"),
        "transitions": (
            ("unattached", "c", "repl_attach", PROTO_REPL,
             "oneway", "syncing"),
            # a repl_wal racing the bootstrap snapshot ahead of it is
            # legal (the standby pre-buffers it; replication.py)
            ("syncing", "s", "repl_wal", PROTO_REPL,
             "oneway", "syncing"),
            ("syncing", "s", "repl_heartbeat", PROTO_REPL,
             "oneway", "syncing"),
            ("syncing", "s", "repl_tsdb", PROTO_REPL,
             "oneway", "syncing"),
            ("syncing", "s", "repl_snapshot", PROTO_REPL,
             "oneway", "streaming"),
            ("streaming", "s", "repl_wal", PROTO_REPL,
             "oneway", "streaming"),
            ("streaming", "s", "repl_heartbeat", PROTO_REPL,
             "oneway", "streaming"),
            ("streaming", "s", "repl_tsdb", PROTO_REPL,
             "oneway", "streaming"),
            ("syncing", "x", "*eof", PROTO_REPL, "teardown", "closed"),
            ("streaming", "x", "*eof", PROTO_REPL, "teardown",
             "closed"),
        ),
    },
    # ---- data-plane fetch_stream (DATA_PROTO v0..v2) ----------------
    "fetch_stream": {
        "versions": (DATA_PROTO_MIN, DATA_PROTO_MAX),
        "pre_version": DATA_PROTO_MIN,
        "hello": "__proto_hello__",
        "initial": "idle",
        "finals": ("idle", "closed"),
        "transitions": (
            ("idle", "c", "__proto_hello__", 0, "request",
             "hello_wait"),
            ("hello_wait", "s", "*hello_ok", 0, "reply", "idle"),
            # negotiation failure replies {"error"} and KEEPS the conn
            # serving seed-protocol ops (data_plane._serve)
            ("hello_wait", "s", "*hello_reject", 0, "reply", "idle"),
            ("idle", "c", "fetch_object", 0, "request", "req_wait"),
            ("idle", "c", "fetch_chunk", 0, "request", "req_wait"),
            ("idle", "c", "delete_object", 0, "request", "req_wait"),
            ("idle", "c", "stats", 0, "request", "req_wait"),
            ("req_wait", "s", "*reply", 0, "reply", "idle"),
            ("idle", "c", "fetch_stream", 1, "request", "stream_wait"),
            # {size,len} ack opens the bulk-frame phase ...
            ("stream_wait", "s", "*stream_ack", 1, "reply", "bulk"),
            # ... unless the payload rode the ack (small-range inline
            # path) or the request pre-stream missed ({"error"}: the
            # conn stays pooled, wire.py BULK_ERR contract)
            ("stream_wait", "s", "*inline_reply", 1, "reply", "idle"),
            ("stream_wait", "s", "*miss_reply", 1, "reply", "idle"),
            ("bulk", "s", "*bulk_data", 1, "oneway", "bulk"),
            ("bulk", "s", "*bulk_end", 1, "oneway", "idle"),
            ("bulk", "s", "*bulk_err", 1, "oneway", "idle"),
            ("idle", "x", "*eof", 0, "teardown", "closed"),
            ("bulk", "x", "*eof", 0, "teardown", "closed"),
        ),
    },
}

_c_codec = None
_c_codec_tried = False


def _native_codec():
    """The C rtmsg codec, or None (no toolchain / RTT_NO_NATIVE).
    Lazy: wire.py imports during package init, ray_tpu_torch.native cannot."""
    global _c_codec, _c_codec_tried
    if not _c_codec_tried:
        _c_codec_tried = True
        try:
            from ray_tpu_torch.native import load_wirecodec
            _c_codec = load_wirecodec()
        except Exception:  # noqa: BLE001 - any failure → pure-Python path
            _c_codec = None
    return _c_codec


def encode_frame(obj: Any, version: int,
                 prefer_pickle: bool = False) -> bytes:
    """Encode one message at the negotiated version (0 = legacy pickle).

    ``prefer_pickle`` marks a hot-path frame (reply to a hot kind); it
    only matters when the native codec is absent — C rtmsg beats pickle,
    so with it built there is nothing to prefer.
    """
    if version == 0:
        return pickle.dumps(obj)
    if not PROTO_MIN <= version <= PROTO_MAX:
        raise ProtocolVersionError(f"cannot encode version {version}")
    if version >= 2:
        cc = _native_codec()
        if cc is not None:
            # ValueError: >200-deep nesting (C recursion guard);
            # BufferError: non-contiguous memoryview — both mean "not
            # rtmsg-able", same as TypeError: fall back to pickle
            try:
                return bytes((version, _CODEC_RTMSG)) + cc.dumps(obj)
            except (TypeError, ValueError, BufferError):
                pass  # Python-payload message → pickle codec
        elif not prefer_pickle and (not isinstance(obj, dict)
                                    or obj.get("kind") not in _HOT_KINDS):
            try:
                return bytes((version, _CODEC_RTMSG)) + rtmsg_dumps(obj)
            except TypeError:
                pass
    return bytes((version, _CODEC_PICKLE)) + pickle.dumps(obj)


def decode_frame(raw: bytes) -> Tuple[Any, int]:
    """Decode one message → (obj, observed_version)."""
    obj, ver, _codec = decode_frame_ex(raw)
    return obj, ver


def decode_frame_ex(raw: bytes) -> Tuple[Any, int, int]:
    """Decode one message → (obj, observed_version, observed_codec).

    Accepts legacy raw-pickle streams (version 0, codec reported as
    pickle) alongside framed messages, so a versioned reader can serve
    un-upgraded peers.  The codec matters to SERVERS: replies to a peer
    that spoke rtmsg must come back rtmsg (it may not be able to read
    pickle at all — the polyglot contract), while pickle-speaking peers
    keep the C-speed hot-kind reply path.
    """
    if not raw:
        raise WireError("empty frame")
    first = raw[0]
    if first == _PICKLE_OPCODE:
        return pickle.loads(raw), 0, _CODEC_PICKLE
    if first > PROTO_MAX:
        raise ProtocolVersionError(
            f"frame version {first} > supported max {PROTO_MAX}")
    if len(raw) < 2:
        raise WireError("truncated frame header")
    codec = raw[1]
    if codec == _CODEC_RTMSG:
        cc = _native_codec()
        if cc is not None:
            try:
                return cc.loads(raw[2:]), first, _CODEC_RTMSG
            except ValueError as e:
                raise WireError(str(e))
        return rtmsg_loads(raw[2:]), first, _CODEC_RTMSG
    if codec == _CODEC_PICKLE:
        return pickle.loads(raw[2:]), first, _CODEC_PICKLE
    raise WireError(f"unknown codec {codec}")


def conn_send(conn, obj: Any, version: int,
              prefer_pickle: bool = False) -> None:
    if version == 0:
        conn.send(obj)  # legacy peers do a plain pickle recv()
    else:
        conn.send_bytes(encode_frame(obj, version, prefer_pickle))


def conn_recv(conn) -> Tuple[Any, int]:
    """recv one message from a Connection → (obj, observed_version)."""
    return decode_frame(conn.recv_bytes())


def conn_recv_ex(conn) -> Tuple[Any, int, int]:
    """recv one message → (obj, observed_version, observed_codec)."""
    return decode_frame_ex(conn.recv_bytes())


def negotiate_version(client_versions, server_min: int,
                      server_max: int = PROTO_MAX) -> int:
    """Server-side half of ``__proto_hello__``: highest common version, or
    raise when the ranges are disjoint."""
    try:
        client_max = max(int(v) for v in client_versions)
    except (TypeError, ValueError):
        raise ProtocolVersionError(f"bad hello versions {client_versions!r}")
    agreed = min(server_max, client_max)
    if agreed < server_min:
        raise ProtocolVersionError(
            f"client speaks <= v{client_max}, server requires >= "
            f"v{server_min}")
    return agreed
