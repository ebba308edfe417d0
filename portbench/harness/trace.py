"""From a ``torch.profiler`` trace of the window to device time by span.

The harness's spans are ``record_function`` ranges named ``pb:<what>``
(``harness.spans``); a backward region is a pair of zero-length marks,
``pb:<what>:bwd<`` and ``pb:<what>:bwd>``, on the thread that runs the
backward.  A device operation (kernel, copy or fill) belongs to the spans
open on the thread that launched it at the moment of its launch (the
launch is the runtime or driver call with its correlation id).

Busy time is the length of the union of the device operations'
intervals inside the window (``tools/train_step_profile.py``'s
arithmetic); idle is the rest of the window.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Sequence, Tuple

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_ACTIVITIES = ("cuda_runtime", "cuda_driver")
WINDOW = "pb:window"


@dataclasses.dataclass
class Op:
    name: str
    start: int  # ns, the trace's clock
    end: int
    spans: Tuple[str, ...]  # the harness's spans open at its launch, outermost first

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


@dataclasses.dataclass
class Trace:
    ops: List[Op]  # device operations inside the window
    window_s: float
    busy_s: float
    idle_gaps: List[Tuple[str, float]]  # (what the host was doing, seconds), summed

    @property
    def device_s(self) -> float:
        return sum(o.seconds for o in self.ops)

    def seconds_under(self, span: str, innermost: bool = False) -> float:
        """Device seconds of the operations launched inside ``span`` (as
        the innermost of the harness's spans, with ``innermost``)."""
        if innermost:
            return sum(o.seconds for o in self.ops if o.spans and o.spans[-1] == span)
        return sum(o.seconds for o in self.ops if span in o.spans)

    def busy_under(self, span: str) -> float:
        """Seconds in which an operation launched inside ``span`` ran."""
        return union_ns((o.start, o.end) for o in self.ops if span in o.spans) / 1e9

    def count_under(self, span: str) -> int:
        return sum(1 for o in self.ops if span in o.spans)

    def seconds_named(self, parts: Sequence[str]) -> float:
        """Device seconds of the operations whose name holds one of ``parts``."""
        return sum(o.seconds for o in self.ops if any(p in o.name for p in parts))

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        by: Dict[str, float] = {}
        for o in self.ops:
            by[o.name] = by.get(o.name, 0.0) + o.seconds
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]


def union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


@dataclasses.dataclass
class _Span:
    tid: int
    start: int
    end: int
    name: str


def _spans(raw) -> List[_Span]:
    """The harness's ranges, and the backward regions its marks bound."""
    out, opened = [], {}
    for e in raw:
        name = e["name"]
        if not name.startswith("pb:") or e["activity"] != "user_annotation":
            continue
        if name.endswith(":bwd<"):
            opened.setdefault((e["tid"], name[:-5]), []).append(e["start"])
        elif name.endswith(":bwd>"):
            stack = opened.get((e["tid"], name[:-5]))
            if stack:
                out.append(_Span(e["tid"], stack.pop(), e["start"], name[:-5]))
        else:
            out.append(_Span(e["tid"], e["start"], e["end"], name))
    return out


def open_spans(spans: List[_Span], queries: List[Tuple[int, int]]) -> List[Tuple[str, ...]]:
    """For each (thread, time) query, the spans open on that thread then,
    outermost first: one sweep over each thread's span edges."""
    out: List[Tuple[str, ...]] = [()] * len(queries)
    by_tid: Dict[int, list] = {}
    for s in spans:
        # at one time: starts before queries before ends, so a query at a
        # span's edge is inside it
        by_tid.setdefault(s.tid, []).append((s.start, 0, s))
        by_tid.setdefault(s.tid, []).append((s.end, 2, s))
    for qi, (tid, t) in enumerate(queries):
        by_tid.setdefault(tid, []).append((t, 1, qi))
    for edges in by_tid.values():
        edges.sort(key=lambda x: (x[0], x[1]))
        active: List[_Span] = []
        for _, kind, item in edges:
            if kind == 0:
                active.append(item)
            elif kind == 2:
                active.remove(item)
            else:
                out[item] = tuple(s.name for s in active)
    return out


def _activity(e, dev: str) -> str:
    """The kind of a profiler event: its own ``activity_type`` where the
    torch build has it, else read from its device and name."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    name = e.name()
    if dev == "CUDA":
        if name.startswith("pb:"):
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    annotation = getattr(e, "is_user_annotation", None)
    if name.startswith("pb:") or (annotation is not None and annotation()):
        return "user_annotation"
    if name.startswith(("cuda", "cuLaunch", "cuMem")):
        return "cuda_runtime"
    return "cpu_op"


def raw_events(prof) -> List[dict]:
    """The profiler's events as plain records."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).split(".")[-1]
        start = e.start_ns()
        end = e.end_ns() if hasattr(e, "end_ns") else start + e.duration_ns()
        out.append({"name": e.name(), "activity": _activity(e, dev), "start": start, "end": end,
                    "tid": e.start_thread_id(), "corr": e.correlation_id(),
                    "linked": e.linked_correlation_id()})
    return out


def reduce(raw: List[dict], main_tid: int = None) -> Trace:
    """The window's device operations with their spans, its busy time and
    its idle gaps labelled by what the main thread was doing."""
    windows = [e for e in raw if e["name"] == WINDOW and e["activity"] == "user_annotation"]
    if not windows:
        raise ValueError(f"the trace has no {WINDOW} range")
    win = max(windows, key=lambda e: e["end"] - e["start"])
    w0, w1 = win["start"], win["end"]
    main_tid = win["tid"] if main_tid is None else main_tid
    spans = _spans(raw)
    launches = {e["corr"]: e for e in raw if e["activity"] in LAUNCH_ACTIVITIES}
    host_by_corr = {e["corr"]: e for e in raw if e["activity"] == "cpu_op"}
    device = [e for e in raw
              if e["activity"] in DEVICE_ACTIVITIES and e["end"] >= w0 and e["start"] <= w1]
    queries, where = [], []
    for e in device:
        launch = launches.get(e["corr"]) or host_by_corr.get(e.get("linked", 0))
        where.append(len(queries) if launch else None)
        if launch:
            queries.append((launch["tid"], launch["start"]))
    intervals = sorted((max(e["start"], w0), min(e["end"], w1)) for e in device)
    busy = union_ns(intervals)
    gap_list, t = [], w0
    for s, e in intervals + [(w1, w1)]:
        if s > t:
            gap_list.append((t, s))
        t = max(t, e)
    n_ops = len(queries)
    queries += [(main_tid, (a + b) // 2) for a, b in gap_list]
    open_ = open_spans(spans, queries)
    ops = [Op(e["name"], max(e["start"], w0), min(e["end"], w1),
              open_[w] if w is not None else ()) for e, w in zip(device, where)]
    host_ops = sorted((e["start"], e["end"], e["name"]) for e in raw
                      if e["tid"] == main_tid and e["activity"] == "cpu_op")
    host_starts = [h[0] for h in host_ops]
    gaps: Dict[str, float] = {}
    for (a, b), names in zip(gap_list, open_[n_ops:]):
        label = "/".join(n for n in names if n != WINDOW) or "the window, outside other spans"
        label += " | " + _host_op_at(host_ops, host_starts, (a + b) // 2)
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
    return Trace(ops=ops, window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                 idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:10])


def _host_op_at(host_ops, starts, t: int, look_back: int = 64) -> str:
    """The innermost host operation running at t on the main thread."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - look_back, -1), -1):
        if host_ops[j][1] >= t:
            return host_ops[j][2]
    return "python"
