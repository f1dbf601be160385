"""Placement groups — public API.

Reference: ``python/ray/util/placement_group.py`` + the GCS placement-group
manager.  Bundles are resource dicts; an accelerator bundle asks for
``{"GPU": n}`` (CUDA cards on one node, fractions allowed) and is placed
by the port's ``pg_scheduler`` in the GCS, or per host of a slice by
:func:`tpu_slice_bundles` (the reference's name), which STRICT_PACK
keeps in one ICI domain.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private import worker as _worker
from ray_tpu_torch._private.ids import PlacementGroupID


class PlacementGroup:
    def __init__(self, pg_id: str, bundles: List[Dict[str, float]], strategy: str):
        self.id = pg_id
        self.bundle_specs = bundles
        self.strategy = strategy

    def ready(self):
        """Returns an ObjectRef-like waitable; get() blocks until scheduled."""
        return _PgReady(self)

    def wait(self, timeout_seconds: Optional[float] = None) -> bool:
        w = _worker.global_worker()
        resp = w.rpc("pg_wait", pg_id=self.id, timeout=timeout_seconds)
        return resp["ready"]

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs, self.strategy))


class _PgReady:
    """Duck-typed ref so ``ray_tpu_torch.get(pg.ready())`` works like the
    reference."""

    def __init__(self, pg: PlacementGroup):
        self.pg = pg

    def __ray_get__(self, timeout: Optional[float] = None) -> PlacementGroup:
        if not self.pg.wait(timeout_seconds=timeout):
            from ray_tpu_torch.exceptions import GetTimeoutError
            raise GetTimeoutError(f"placement group {self.pg.id} not ready")
        return self.pg


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "", lifetime: Optional[str] = None
                    ) -> PlacementGroup:
    """``lifetime`` (``None`` or ``"detached"``) is accepted as the
    reference accepts it: a group lives until ``remove_placement_group``
    or the cluster's shutdown either way."""
    if strategy not in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be non-empty dicts")
    w = _worker.global_worker()
    pg_id = PlacementGroupID.new()
    w.rpc("pg_create", pg_id=pg_id, bundles=[dict(b) for b in bundles],
          strategy=strategy, name=name)
    return PlacementGroup(pg_id, bundles, strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    _worker.global_worker().rpc("pg_remove", pg_id=pg.id)


def placement_group_table() -> dict:
    return _worker.global_worker().rpc("pg_table")["pgs"]


def tpu_slice_bundles(topology: str) -> List[Dict[str, float]]:
    """Expand a slice topology into per-host bundles: ``v4-32`` → 8 hosts
    of ``{"GPU": 4.0}`` (the reference's ``{"TPU": 4.0}``).  Use with
    STRICT_PACK so all hosts land in one ICI domain (the slice leased
    atomically)."""
    from ray_tpu_torch.parallel.topology import slice_spec
    spec = slice_spec(topology)
    return [{"GPU": float(spec.chips_per_host)}
            for _ in range(spec.num_hosts)]
