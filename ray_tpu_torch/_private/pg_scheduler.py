"""Placement-group bundle → node assignment.

Reference: ``GcsPlacementGroupScheduler`` strategies PACK / SPREAD /
STRICT_PACK / STRICT_SPREAD with 2-phase bundle reservation
(SURVEY.md §2.1, §2.4).  TPU extension: bundles may request
``{"TPU": k}`` chips or a whole slice via ``{"tpu_slice_<topo>": 1}``;
STRICT_PACK additionally requires all bundles land inside one ICI domain,
which on this scheduler means nodes sharing an ``ici_domain`` label
(multi-host slices are modeled as one logical node per host carrying the
same ``ici_domain`` label — see parallel/topology.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


def _fits(avail: Dict[str, float], req: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) >= v - 1e-9 for k, v in req.items() if v > 0)


def _take(avail: Dict[str, float], req: Dict[str, float]) -> None:
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) - v


def schedule_bundles(nodes: Sequence[object], bundles: List[Dict[str, float]],
                     strategy: str) -> Optional[List[str]]:
    """Returns node_id per bundle, or None if infeasible right now.

    Pure function over a snapshot of node availability — the caller (GCS)
    holds the lock and commits reservations atomically (the reference's
    2-phase prepare/commit degenerates to this under one lock).
    """
    sim = {n.node_id: dict(n.resources_avail) for n in nodes}
    domains: Dict[str, List[str]] = {}
    for n in nodes:
        dom = getattr(n, "labels", {}).get("ici_domain", n.node_id)
        domains.setdefault(dom, []).append(n.node_id)
    order = sorted(sim, key=lambda nid: -sum(sim[nid].values()))

    def pack(candidates: List[str]) -> Optional[List[str]]:
        local = {nid: dict(sim[nid]) for nid in candidates}
        out: List[str] = []
        for b in bundles:
            placed = None
            for nid in candidates:
                if _fits(local[nid], b):
                    placed = nid
                    break
            if placed is None:
                return None
            _take(local[placed], b)
            out.append(placed)
        return out

    if strategy == "STRICT_PACK":
        # all bundles on one node; else one ICI domain, on a minimal
        # contiguous window of hosts (slice_host order = ICI adjacency
        # along the slice's host dimension — parallel/topology.py)
        for nid in order:
            local = dict(sim[nid])
            ok = True
            for b in bundles:
                if not _fits(local, b):
                    ok = False
                    break
                _take(local, b)
            if ok:
                return [nid] * len(bundles)
        host_idx: Dict[str, int] = {}
        for n in nodes:
            try:
                host_idx[n.node_id] = int(
                    getattr(n, "labels", {}).get("slice_host", ""))
            except ValueError:
                host_idx[n.node_id] = 1 << 30  # unindexed hosts sort last
        for dom_nodes in domains.values():
            if len(dom_nodes) < 2:
                continue
            ordered = sorted(dom_nodes, key=lambda nid: (host_idx[nid], nid))
            best: Optional[List[str]] = None
            best_span = len(ordered) + 1
            for start in range(len(ordered)):
                local = {nid: dict(sim[nid]) for nid in ordered}
                out: List[str] = []
                cur = start
                for b in bundles:
                    while cur < len(ordered) and not _fits(local[ordered[cur]], b):
                        cur += 1
                    if cur >= len(ordered):
                        out = []
                        break
                    _take(local[ordered[cur]], b)
                    out.append(ordered[cur])
                if out:
                    span = cur - start
                    if span < best_span:
                        best, best_span = out, span
            if best is not None:
                return best
            # contiguous windows infeasible (heterogeneous bundles can
            # defeat the forward-only scan) — any same-domain packing
            # still satisfies the STRICT_PACK contract
            got = pack(sorted(dom_nodes,
                              key=lambda nid: -sum(sim[nid].values())))
            if got is not None:
                return got
        return None

    if strategy == "STRICT_SPREAD":
        used: set = set()
        out = []
        for b in bundles:
            placed = None
            for nid in order:
                if nid in used:
                    continue
                if _fits(sim[nid], b):
                    placed = nid
                    break
            if placed is None:
                return None
            _take(sim[placed], b)
            used.add(placed)
            out.append(placed)
        return out

    if strategy == "SPREAD":
        out = []
        for b in bundles:
            cands = sorted(sim, key=lambda nid: sum(
                1 for o in out if o == nid))
            placed = None
            for nid in cands:
                if _fits(sim[nid], b):
                    placed = nid
                    break
            if placed is None:
                return None
            _take(sim[placed], b)
            out.append(placed)
        return out

    # PACK (default): fill nodes in order, spill to next
    return pack(order)
