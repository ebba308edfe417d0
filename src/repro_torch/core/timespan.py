"""Timespan management (paper §4.5, Fig. 4).

History is divided into non-overlapping timespans holding a roughly equal
number of events (uniform-in-events is the paper's practical choice);
partitioning and slot maps are frozen within a span and rebuilt at
boundaries.  ``tune_timespan_length`` implements the paper's g(T) - f(T)
maxima argument as an explicit cost model the benchmarks sweep.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.events import EventLog


@dataclasses.dataclass
class TimeSpan:
    tsid: int
    t_start: int  # inclusive
    t_end: int  # inclusive
    ev_lo: int  # event index range [lo, hi) in the global log
    ev_hi: int


def split_timespans(events: EventLog, events_per_span: int) -> List[TimeSpan]:
    """Equal-event-count spans; boundaries never split a timestamp (all
    events of one t land in one span, keeping snapshots well-defined)."""
    n = len(events)
    if n == 0:
        return [TimeSpan(0, 0, 0, 0, 0)]
    spans: List[TimeSpan] = []
    lo = 0
    tsid = 0
    while lo < n:
        hi = min(lo + events_per_span, n)
        # extend to include all events with the same timestamp
        if hi < n:
            t_edge = events.t[hi - 1]
            while hi < n and events.t[hi] == t_edge:
                hi += 1
        spans.append(
            TimeSpan(tsid, int(events.t[lo]), int(events.t[hi - 1]), lo, hi)
        )
        tsid += 1
        lo = hi
    return spans


def span_for_time(spans: List[TimeSpan], t: int) -> TimeSpan:
    """The span whose range contains t (or the last one before it)."""
    for s in reversed(spans):
        if t >= s.t_start:
            return s
    return spans[0]


# ---------------------------------------------------------------------------
# f(T) / g(T) cost model (paper §4.5 closing discussion)
# ---------------------------------------------------------------------------


def partition_quality_penalty(span_events: int, events_per_span: int,
                              drift_rate: float = 1e-6) -> float:
    """f(T): expected extra micro-delta seeks on k-hop queries due to a
    stale partitioning — grows with span length as the graph drifts away
    from the layout computed at span start."""
    return drift_rate * span_events * (span_events / max(events_per_span, 1))


def version_query_gain(events_per_span: int, mean_query_interval_events: float) -> float:
    """g(T): version queries spanning fewer timespans touch fewer slot
    maps / partition generations; gain saturates once a span covers the
    average query interval."""
    return min(events_per_span / max(mean_query_interval_events, 1.0), 1.0)


def tune_timespan_length(candidates, mean_query_interval_events: float,
                         drift_rate: float = 1e-6) -> int:
    """argmax over candidates of g(T) - f(T) (the paper's maxima)."""
    best, best_v = candidates[0], -np.inf
    for c in candidates:
        v = version_query_gain(c, mean_query_interval_events) - partition_quality_penalty(
            c, c, drift_rate
        )
        if v > best_v:
            best, best_v = c, v
    return int(best)
