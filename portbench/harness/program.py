"""The program's own spans and counters in a traced window.

The program (``repro_torch.obs``) records host ranges named
``hgs:<what>`` and counts work while a profiler records.
``harness.trace.reduce`` reads only the harness's ``pb:`` spans and
leaves the program's out; ``reduce`` here takes the same raw events and
gives, on the same clock:

* the device seconds of the window's operations by the program's spans
  open on the launching thread at their launch (``seconds_under``);
* the window's idle seconds by the program's spans open on the main
  thread (``idle_under``): each idle gap is cut at the edges of those
  spans, so a gap that straddles a span counts inside it only for the
  part that lies inside.

``counters()`` gives the program's counters: a run profiles its window
alone and the program counts only while a profiler records, so after the
window they are the window's.  A program without ``repro_torch.obs`` has
neither; both then give nothing.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Optional, Tuple

from harness.trace import DEVICE_ACTIVITIES, LAUNCH_ACTIVITIES, WINDOW, _Span, open_spans

PREFIX = "hgs:"
HOST = ("cpu_op", "user_annotation")


@dataclasses.dataclass
class ProgramTrace:
    window_s: float
    device_s: float  # every device operation's seconds in the window
    device: Dict[Tuple[str, ...], float]  # device seconds by program spans open at launch
    idle: Dict[Tuple[str, ...], float]  # idle seconds by program spans open on the main thread

    def seconds_under(self, span: str, innermost: bool = False) -> float:
        if innermost:
            return sum(s for k, s in self.device.items() if k and k[-1] == span)
        return sum(s for k, s in self.device.items() if span in k)

    def idle_under(self, span: str) -> float:
        return sum(s for k, s in self.idle.items() if span in k)


def _program_spans(raw):
    """The program's ranges: host records (operator scope, so no range of
    theirs lies on the device's timeline)."""
    return [_Span(e["tid"], e["start"], e["end"], e["name"]) for e in raw
            if e["activity"] in HOST and e["name"].startswith(PREFIX)]


def reduce(raw, main_tid: Optional[int] = None) -> ProgramTrace:
    """The window's device and idle seconds by the program's open spans
    (the window, its operations and gaps as ``harness.trace.reduce``
    takes them)."""
    windows = [e for e in raw if e["name"] == WINDOW and e["activity"] == "user_annotation"]
    if not windows:
        raise ValueError(f"the trace has no {WINDOW} range")
    win = max(windows, key=lambda e: e["end"] - e["start"])
    w0, w1 = win["start"], win["end"]
    main_tid = win["tid"] if main_tid is None else main_tid
    spans = _program_spans(raw)
    launches = {e["corr"]: e for e in raw if e["activity"] in LAUNCH_ACTIVITIES}
    host_by_corr = {e["corr"]: e for e in raw if e["activity"] == "cpu_op"}
    ops = [e for e in raw
           if e["activity"] in DEVICE_ACTIVITIES and e["end"] >= w0 and e["start"] <= w1]
    queries, seconds = [], []
    unlaunched = 0.0
    for e in ops:
        s = (min(e["end"], w1) - max(e["start"], w0)) / 1e9
        launch = launches.get(e["corr"]) or host_by_corr.get(e.get("linked", 0))
        if launch:
            queries.append((launch["tid"], launch["start"]))
            seconds.append(s)
        else:
            unlaunched += s
    intervals = sorted((max(e["start"], w0), min(e["end"], w1)) for e in ops)
    gaps, t = [], w0
    for s, e in intervals + [(w1, w1)]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    edges = sorted({x for s in spans if s.tid == main_tid for x in (s.start, s.end)})
    pieces = []
    for a, b in gaps:
        cuts = edges[bisect.bisect_right(edges, a):bisect.bisect_left(edges, b)]
        points = [a, *cuts, b]
        pieces += [(p, q) for p, q in zip(points, points[1:]) if q > p]
    n_ops = len(queries)
    queries += [(main_tid, (p + q) // 2) for p, q in pieces]
    open_ = open_spans(spans, queries)
    device: Dict[Tuple[str, ...], float] = {(): unlaunched} if unlaunched else {}
    for names, s in zip(open_[:n_ops], seconds):
        device[names] = device.get(names, 0.0) + s
    idle: Dict[Tuple[str, ...], float] = {}
    for names, (p, q) in zip(open_[n_ops:], pieces):
        idle[names] = idle.get(names, 0.0) + (q - p) / 1e9
    return ProgramTrace(window_s=(w1 - w0) / 1e9, device_s=sum(seconds) + unlaunched,
                        device=device, idle=idle)


def counters() -> Optional[dict]:
    """The program's counters, or None for a program without them."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.counters()


def moe_counts(c: Optional[dict]) -> Optional[Tuple[int, int, int]]:
    """(pairs routed, pairs dropped, slots computed) of the program's MoE
    layers, or None where none was routed."""
    if not c or not c.get("moe.routed"):
        return None
    return c["moe.routed"], int(sum(c["moe.dropped"])), c["moe.slots"]
