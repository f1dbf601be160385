"""Slice topologies (port of ``ray_tpu/parallel/topology.py``).

A slice is hosts × accelerators a host, leased atomically: the reference's
pod slice (``v4-32`` is 8 hosts × 4 chips wired into one ICI domain).
This module is the registry that maps topology names → (hosts,
accelerators a host, interconnect mesh shape), which ``ScalingConfig(
topology=)`` and ``util.placement_group.tpu_slice_bundles`` read.  The
names and node labels keep the reference's meaning; a bundle the port
builds from them asks for ``"GPU"`` where the reference's asks for
``"TPU"``, as every bundle of the port does.

Chip counts follow the public naming convention: the suffix is chip count
for v4/v5p (which have 2 TensorCores/chip, "megacore" on v4), and chips for
v5e/v6e as well (1 core/chip).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class SliceSpec:
    name: str                 # e.g. "v4-32"
    generation: str           # "v4"
    num_chips: int
    chips_per_host: int
    ici_mesh: Tuple[int, ...]  # physical interconnect mesh shape (chips)
    megacore: bool            # 2 TensorCores fused per chip

    @property
    def num_hosts(self) -> int:
        return max(1, self.num_chips // self.chips_per_host)


# chips per host and megacore by generation
_GEN = {
    "v2": (8, False), "v3": (8, False),
    "v4": (4, True), "v5p": (4, True),
    "v5e": (4, False), "v5litepod": (4, False),
    "v6e": (4, False),
}


def _default_mesh(num_chips: int) -> Tuple[int, ...]:
    """Factor a chip count into a near-cubic 3D torus shape (v4-style)."""
    if num_chips <= 4:
        return (num_chips,) if num_chips else (1,)
    best = (num_chips, 1, 1)
    for x in range(1, int(round(num_chips ** (1 / 3))) + 2):
        if num_chips % x:
            continue
        rest = num_chips // x
        for y in range(x, int(rest ** 0.5) + 1):
            if rest % y:
                continue
            cand = (x, y, rest // y)
            if max(cand) - min(cand) < max(best) - min(best):
                best = cand
    return tuple(sorted(best))


def slice_spec(topology: str) -> SliceSpec:
    """Parse ``v4-32`` / ``v5e-8`` / ``v5p-128`` style names."""
    m = re.fullmatch(r"(v\d+[a-z]*|v5litepod)-(\d+)", topology.strip().lower())
    if m is None:
        raise ValueError(f"unrecognized TPU topology {topology!r} "
                         "(expected e.g. 'v4-32', 'v5e-8')")
    gen, n = m.group(1), int(m.group(2))
    if gen not in _GEN:
        raise ValueError(f"unknown TPU generation {gen!r}")
    chips_per_host, megacore = _GEN[gen]
    return SliceSpec(name=topology, generation=gen, num_chips=n,
                     chips_per_host=min(chips_per_host, n),
                     ici_mesh=_default_mesh(n), megacore=megacore)


def detect_local_topology() -> Optional[SliceSpec]:
    """Best effort, as the reference's: the slice this host's
    accelerators form, None without any.  On the card's machine it reads
    the CUDA cards this process sees (``torch.cuda.device_count()``; the
    reference reads its JAX device list, and an override the port leaves
    out with the rest of ``tpu_topology``).  A CUDA host is one host of
    its cards, which no TPU generation names: the spec is named
    ``gpu-<cards>``, of generation ``"gpu"``, its cards one interconnect
    domain (``slice_spec`` parses only the reference's names)."""
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        return None
    return SliceSpec(name=f"gpu-{n}", generation="gpu", num_chips=n,
                     chips_per_host=n, ici_mesh=_default_mesh(n),
                     megacore=False)


def ici_domain_label(slice_name: str, slice_idx: int = 0,
                     host_index: Optional[int] = None) -> Dict[str, str]:
    """Node labels marking co-membership in one ICI domain (for STRICT_PACK).

    ``host_index`` is the host's position along the slice's host dimension;
    the PG scheduler uses it to keep multi-host reservations on ICI-adjacent
    hosts (a contiguous window) instead of arbitrary members of the domain.
    """
    labels = {"ici_domain": f"{slice_name}/{slice_idx}",
              "slice_topology": slice_name}
    if host_index is not None:
        labels["slice_host"] = str(host_index)
    return labels
