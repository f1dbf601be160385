"""Cross-process trace assembly: timeline events → one causal tree.

``ray_tpu_torch.timeline()`` returns every process's Chrome-trace events in one
flat list; sampled spans carry ``args.{trace_id, span_id, parent_id}``
(util/tracing.py).  This module filters one trace out of the dump,
re-links the spans into a tree — driver root → GCS dispatch → worker
exec → data-plane pulls → Serve/LLM engine iterations — and renders it
as text or as a Chrome/Perfetto-loadable trace (device rows captured
under the same trace, ``profile_device``, ride along: they share the
span's ids).

CLI: ``ray_tpu_torch trace <trace_id> [-o out.json]``.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def trace_events(events: List[dict], trace_id: str) -> List[dict]:
    """Events belonging to one trace (spans + device rows tagged with
    the trace's span args), ts-ordered.  Metadata (``ph:"M"``) events
    for rows that appear in the trace are kept so named thread rows
    survive the filter."""
    rows = set()
    out = []
    for e in events:
        args = e.get("args") or {}
        if args.get("trace_id") == trace_id:
            out.append(e)
            rows.add((e.get("pid"), e.get("tid")))
    meta = [e for e in events if e.get("ph") == "M"
            and (e.get("pid"), e.get("tid")) in rows]
    out.sort(key=lambda e: e.get("ts") or 0)
    return meta + out


class SpanNode:
    __slots__ = ("span_id", "events", "children")

    def __init__(self, span_id: str):
        self.span_id = span_id
        self.events: List[dict] = []
        self.children: List["SpanNode"] = []

    @property
    def primary(self) -> dict:
        """The span's own completed event (device rows tagged with the
        same ids are secondaries)."""
        for e in self.events:
            if e.get("cat") != "device":
                return e
        return self.events[0] if self.events else {}

    @property
    def name(self) -> str:
        return self.primary.get("name", "?")

    @property
    def parent_id(self) -> Optional[str]:
        return (self.primary.get("args") or {}).get("parent_id")


def build_tree(events: List[dict], trace_id: str) -> List[SpanNode]:
    """Assemble one trace's span tree; returns the root nodes (a
    well-formed trace has exactly one).  Spans whose parent never
    surfaced (e.g. sampled-out half, lost process) become roots — the
    tree degrades instead of dropping them."""
    nodes: Dict[str, SpanNode] = {}
    for e in trace_events(events, trace_id):
        if e.get("ph") == "M":
            continue
        sid = (e.get("args") or {}).get("span_id")
        if not sid:
            continue
        nodes.setdefault(sid, SpanNode(sid)).events.append(e)
    roots: List[SpanNode] = []
    for node in nodes.values():
        pid = node.parent_id
        if pid and pid in nodes:
            nodes[pid].children.append(node)
        else:
            roots.append(node)
    for node in nodes.values():
        node.children.sort(key=lambda n: n.primary.get("ts") or 0)
    roots.sort(key=lambda n: n.primary.get("ts") or 0)
    return roots


def render_tree(roots: List[SpanNode]) -> str:
    """Indented text rendering of an assembled trace tree."""
    lines: List[str] = []

    def walk(node: SpanNode, depth: int) -> None:
        ev = node.primary
        dur = ev.get("dur")
        extra = ""
        args = ev.get("args") or {}
        for k in ("bytes", "tokens", "batch", "path", "task_id"):
            if k in args:
                extra += f" {k}={args[k]}"
        dev = sum(1 for e in node.events if e.get("cat") == "device")
        if dev:
            extra += f" device_events={dev}"
        lines.append(
            f"{'  ' * depth}{node.name}  "
            f"[{ev.get('cat', '?')}@{ev.get('pid', '?')}]"
            f"{f'  {dur / 1e3:.2f}ms' if dur is not None else ''}{extra}")
        for c in node.children:
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)
    return "\n".join(lines)


def to_chrome(events: List[dict], trace_id: str) -> dict:
    """Chrome/Perfetto ``traceEvents`` document for one trace (host
    spans + device rows merged — load in chrome://tracing / ui.perfetto
    directly)."""
    return {"traceEvents": trace_events(events, trace_id),
            "displayTimeUnit": "ms",
            "metadata": {"trace_id": trace_id}}


def trace_ids(events: List[dict]) -> List[str]:
    """Distinct trace ids present in a timeline dump, most recent
    activity first — `ray_tpu_torch trace` with no id lists these."""
    last: Dict[str, float] = {}
    for e in events:
        tid = (e.get("args") or {}).get("trace_id")
        if tid:
            last[tid] = max(last.get(tid, 0.0), e.get("ts") or 0.0)
    return [t for t, _ in sorted(last.items(), key=lambda kv: -kv[1])]
