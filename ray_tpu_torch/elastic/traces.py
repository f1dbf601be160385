"""Seeded fleet traces: scripted preemption + diurnal demand.

The same trace-replay idiom as ``benchmarks/llm_bench.py`` (seeded
``numpy`` RNG, diurnal modulation plus bursts) applied to fleet events:
a trace is data, generated once from a seed, and every consumer —
the fleet simulator, the churn test, ``fleet_bench.py`` — replays the
identical event list, so a 100-node simulation is reproducible from
``(seed, params)`` alone.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class PreemptionEvent:
    t: float              # sim seconds from trace start
    slice_index: int      # which fleet slot the preemption hits
    warning_s: float      # advance notice (0 = unwarned SIGKILL)


@dataclass
class StragglerEvent:
    """One node degrades (slow HBM, thermal throttle, noisy neighbor):
    from ``t`` the victim's compute runs at ``factor`` of nominal for
    ``duration_s`` — and a synchronous training domain runs at its
    slowest member's pace, so the WHOLE job drags until the node is
    drained (the autopilot's reflex) or the episode ends."""

    t: float
    slice_index: int
    factor: float
    duration_s: float


@dataclass
class PreemptionTrace:
    duration_s: float
    events: List[PreemptionEvent] = field(default_factory=list)
    # launch-outage windows: [start, end) during which the provider
    # cannot boot replacements (spot capacity crunch) — demand backlogs
    # and MUST fully drain once the window closes (the no-strand test)
    outages: List[tuple] = field(default_factory=list)
    # degradation episodes (closed-loop autopilot traces)
    stragglers: List[StragglerEvent] = field(default_factory=list)

    def in_outage(self, t: float) -> bool:
        return any(a <= t < b for a, b in self.outages)


def synthetic_preemption_trace(
        seed: int, duration_s: float, n_slices: int,
        mean_interval_s: float = 180.0,
        warning_s: float = 30.0,
        unwarned_fraction: float = 0.0,
        outage_every_s: Optional[float] = None,
        outage_len_s: float = 120.0,
        straggler_every_s: Optional[float] = None,
        straggler_factor: float = 0.4,
        straggler_len_s: float = 900.0) -> PreemptionTrace:
    """Poisson preemption arrivals over a fleet of ``n_slices`` slots.

    ``unwarned_fraction`` of events carry no advance notice (hard
    SIGKILL — the restart-only failure mode both recovery policies pay
    full price for); the rest give ``warning_s`` of drain window.

    ``straggler_every_s`` adds seeded degradation episodes (the
    autopilot's straggler-reflex input) from an INDEPENDENT rng stream
    (``seed + 2``), so a straggler-bearing trace replays the exact
    preemption/outage event list of its straggler-free sibling — the
    closed-loop A/B compares reflexes, not different weather.
    """
    import numpy as np
    rng = np.random.default_rng(seed)
    events: List[PreemptionEvent] = []
    t = 0.0
    while True:
        t += float(rng.exponential(mean_interval_s))
        if t >= duration_s:
            break
        warned = rng.random() >= unwarned_fraction
        events.append(PreemptionEvent(
            t=round(t, 3),
            slice_index=int(rng.integers(0, n_slices)),
            warning_s=warning_s if warned else 0.0))
    outages = []
    if outage_every_s:
        start = outage_every_s
        while start < duration_s:
            outages.append((start, min(start + outage_len_s, duration_s)))
            start += outage_every_s
    stragglers: List[StragglerEvent] = []
    if straggler_every_s:
        srng = np.random.default_rng(seed + 2)
        t = 0.0
        while True:
            t += float(srng.exponential(straggler_every_s))
            if t >= duration_s:
                break
            stragglers.append(StragglerEvent(
                t=round(t, 3),
                slice_index=int(srng.integers(0, n_slices)),
                factor=straggler_factor,
                duration_s=straggler_len_s))
    return PreemptionTrace(duration_s=duration_s, events=events,
                           outages=outages, stragglers=stragglers)


@dataclass
class DemandTrace:
    """Diurnal + burst demand curve: ``shapes_at(t)`` -> how many
    worker-shaped resource demands are outstanding at sim time t."""

    duration_s: float
    base: int
    amplitude: int
    period_s: float
    bursts: List[tuple]    # (t_start, extra, length_s)

    def shapes_at(self, t: float) -> int:
        level = self.base + self.amplitude * math.sin(
            2 * math.pi * t / self.period_s)
        for start, extra, length in self.bursts:
            if start <= t < start + length:
                level += extra
        return max(int(round(level)), 0)


def diurnal_demand_trace(seed: int, duration_s: float,
                         base: int = 8, amplitude: int = 4,
                         period_s: float = 3600.0,
                         burst_rate_per_hour: float = 2.0,
                         burst_extra: int = 6,
                         burst_len_s: float = 300.0) -> DemandTrace:
    import numpy as np
    rng = np.random.default_rng(seed + 1)
    bursts = []
    t = 0.0
    while True:
        t += float(rng.exponential(3600.0 / max(burst_rate_per_hour, 1e-9)))
        if t >= duration_s:
            break
        bursts.append((round(t, 3),
                       int(rng.integers(1, burst_extra + 1)),
                       burst_len_s))
    return DemandTrace(duration_s=duration_s, base=base,
                       amplitude=amplitude, period_s=period_s,
                       bursts=bursts)
