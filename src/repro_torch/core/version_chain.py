"""Version chains (paper §4.3c): per-node chronological pointers into the
delta sets — CSR arrays over the node-id space, keyed by (t, tsid,
eventlist bucket).  This is the entity-centric index leg that gives TGI
its |V|+1-fetch node-history cost (Table 1).

Updates are append-only in time, so ``append`` does NOT re-derive the
chains from the full log (the old path lexsorted every reference on
every batch — O(total history) per update).  Each appended batch becomes
one small CSR *segment* (O(batch log batch) to build); ``get`` drains the
base CSR plus every segment's per-node slice, which stays chronological
because segments are time-ordered.  ``consolidate`` folds the segments
back into the base in one vectorized pass — compaction calls it, and it
auto-runs once the segment list grows past ``AUTO_CONSOLIDATE`` so read
fan-out stays bounded.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.events import EventLog

_CSR = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _refs_csr(events: EventLog, span_of_event: np.ndarray,
              bucket_of_event: np.ndarray, n_nodes: int) -> _CSR:
    """(indptr, t, tsid, bucket) CSR of one batch's references: each event
    references its src node, and its dst node for edge events."""
    src = events.src
    dst = events.dst
    has_dst = dst >= 0
    nid = np.concatenate([src, dst[has_dst]])
    t = np.concatenate([events.t, events.t[has_dst]])
    ts = np.concatenate([span_of_event, span_of_event[has_dst]])
    bk = np.concatenate([bucket_of_event, bucket_of_event[has_dst]])
    order = np.lexsort((t, nid))
    nid, t, ts, bk = nid[order], t[order], ts[order], bk[order]
    indptr = np.searchsorted(nid, np.arange(n_nodes + 1))
    return (indptr.astype(np.int64), t.astype(np.int64),
            ts.astype(np.int32), bk.astype(np.int32))


def _csr_slice(csr: _CSR, nid: int, t0, t1):
    indptr, t_arr, ts_arr, bk_arr = csr
    if nid < 0 or nid + 1 >= len(indptr):
        z = np.empty(0, np.int64)
        return z, z.astype(np.int32), z.astype(np.int32)
    lo, hi = int(indptr[nid]), int(indptr[nid + 1])
    t = t_arr[lo:hi]
    sel = np.ones(hi - lo, bool)
    if t0 is not None:
        sel &= t > t0
    if t1 is not None:
        sel &= t <= t1
    idx = np.nonzero(sel)[0] + lo
    return t_arr[idx], ts_arr[idx], bk_arr[idx]


@dataclasses.dataclass
class VersionChains:
    indptr: np.ndarray  # (N+1,) int64
    t: np.ndarray  # (R,) int64 — event time
    tsid: np.ndarray  # (R,) int32 — timespan of the reference
    bucket: np.ndarray  # (R,) int32 — micro-eventlist bucket within span
    # appended-batch CSR segments, chronological (see module docstring)
    segments: List[_CSR] = dataclasses.field(default_factory=list)

    AUTO_CONSOLIDATE = 64  # max segments before reads force a merge

    @classmethod
    def build(cls, events: EventLog, span_of_event: np.ndarray,
              bucket_of_event: np.ndarray, n_nodes: int) -> "VersionChains":
        """span_of_event / bucket_of_event: per-event placement, aligned
        with the (chronologically sorted) global log."""
        indptr, t, ts, bk = _refs_csr(events, span_of_event, bucket_of_event,
                                      n_nodes)
        return cls(indptr=indptr, t=t, tsid=ts, bucket=bk)

    def append(self, events: EventLog, span_of_event: np.ndarray,
               bucket_of_event: np.ndarray, n_nodes: int) -> None:
        """Extend the chains with one append-only batch — O(batch) work,
        independent of total history size."""
        if not len(events):
            return
        self.segments.append(
            _refs_csr(events, span_of_event, bucket_of_event, n_nodes))
        if len(self.segments) > self.AUTO_CONSOLIDATE:
            self.consolidate()

    def consolidate(self) -> None:
        """Fold the appended segments into the base CSR (one vectorized
        interleave over all references)."""
        if not self.segments:
            return
        csrs = [(self.indptr, self.t, self.tsid, self.bucket)] + self.segments
        n_nodes = max(len(c[0]) - 1 for c in csrs)
        nid = np.concatenate([
            np.repeat(np.arange(len(c[0]) - 1, dtype=np.int64), np.diff(c[0]))
            for c in csrs
        ])
        t = np.concatenate([c[1] for c in csrs])
        ts = np.concatenate([c[2] for c in csrs])
        bk = np.concatenate([c[3] for c in csrs])
        rank = np.concatenate([
            np.full(len(c[1]), i, np.int32) for i, c in enumerate(csrs)
        ])
        # per-node chronological order; segment rank breaks same-t ties in
        # ingest order (base first), preserving the chains' stable order
        order = np.lexsort((rank, t, nid))
        nid, t, ts, bk = nid[order], t[order], ts[order], bk[order]
        self.indptr = np.searchsorted(nid, np.arange(n_nodes + 1)).astype(np.int64)
        self.t, self.tsid, self.bucket = t, ts, bk
        self.segments = []

    def snapshot(self) -> "VersionChains":
        """O(1) structural snapshot for MVCC read views: shares the base
        arrays (rebound — never mutated in place — by ``consolidate``)
        and copies the segment *list*, so a reader holding the snapshot
        keeps a stable chain while the live object consolidates or grows
        under the index's MVCC lock."""
        return VersionChains(self.indptr, self.t, self.tsid, self.bucket,
                             list(self.segments))

    def get(self, nid: int, t0=None, t1=None):
        """References for node nid with t in (t0, t1] (paper Alg. 2 l.2-3)."""
        parts = [_csr_slice((self.indptr, self.t, self.tsid, self.bucket),
                            nid, t0, t1)]
        parts.extend(_csr_slice(seg, nid, t0, t1) for seg in self.segments)
        if len(parts) == 1:
            return parts[0]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]),
                np.concatenate([p[2] for p in parts]))

    def n_versions(self, nid: int) -> int:
        n = 0
        for indptr, *_ in [(self.indptr,)] + [(s[0],) for s in self.segments]:
            if 0 <= nid < len(indptr) - 1:
                n += int(indptr[nid + 1] - indptr[nid])
        return n

    def to_arrays(self):
        self.consolidate()
        return {"indptr": self.indptr, "t": self.t, "tsid": self.tsid,
                "bucket": self.bucket}

    @classmethod
    def from_arrays(cls, d):
        return cls(d["indptr"], d["t"], d["tsid"], d["bucket"])
