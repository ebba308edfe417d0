"""SoN / SoTS operands (paper §5.1, Def. 6-7).

A temporal node is stored exactly as the paper prescribes for NodeT: the
*initial snapshot* of the node at t0 followed by its *chronologically
sorted events* in (t0, t1] — CSR over the node set, with padded dense
views for vectorized/TPU execution (the SoA answer to Spark's
RDD<NodeT>).  SoTS adds the initial 1-hop adjacency, making SubgraphT a
star-subgraph sequence (k-hop via composition, as in the paper).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.events import (
    EDGE_ADD,
    EDGE_DEL,
    EATTR_SET,
    NATTR_SET,
    NODE_ADD,
    NODE_DEL,
    EventLog,
)
from repro_torch.core.snapshot import GraphState


def _field_dict(x) -> Dict:
    """Declared dataclass fields only (``vars()`` would also leak lazily
    cached attributes like ``_node_of_ev`` into constructor kwargs)."""
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


@dataclasses.dataclass
class SoN:
    """Set of Temporal Nodes over [t0, t1)."""

    node_ids: np.ndarray  # (N,) int32
    t0: int
    t1: int
    init_present: np.ndarray  # (N,) int8 — state at t0
    init_attrs: np.ndarray  # (N, K) int32
    ev_indptr: np.ndarray  # (N+1,) int64 — per-node event runs
    ev_t: np.ndarray
    ev_kind: np.ndarray
    ev_key: np.ndarray
    ev_val: np.ndarray
    ev_other: np.ndarray  # edge partner (-1 for node events)

    def __len__(self):
        return len(self.node_ids)

    def n_events(self, i: int) -> int:
        return int(self.ev_indptr[i + 1] - self.ev_indptr[i])

    def events_of(self, i: int):
        lo, hi = int(self.ev_indptr[i]), int(self.ev_indptr[i + 1])
        return {
            "t": self.ev_t[lo:hi], "kind": self.ev_kind[lo:hi],
            "key": self.ev_key[lo:hi], "val": self.ev_val[lo:hi],
            "other": self.ev_other[lo:hi],
        }

    def change_points(self) -> np.ndarray:
        """All distinct event times in the set (default evaluation points
        of the temporal operators)."""
        return np.unique(self.ev_t)

    def node_of_events(self) -> np.ndarray:
        """Row index (into this SoN) of every CSR event — the inverse of
        ``ev_indptr``.  Cached: the replay engine asks repeatedly."""
        cached = getattr(self, "_node_of_ev", None)
        if cached is None or len(cached) != len(self.ev_t):
            cached = np.repeat(
                np.arange(len(self), dtype=np.int64),
                self.ev_indptr[1:] - self.ev_indptr[:-1],
            )
            self._node_of_ev = cached
        return cached

    def subset(self, idx: np.ndarray) -> "SoN":
        idx = np.asarray(idx)
        counts = (self.ev_indptr[1:] - self.ev_indptr[:-1])[idx]
        indptr = np.r_[0, np.cumsum(counts)]
        take = np.concatenate([
            np.arange(self.ev_indptr[i], self.ev_indptr[i + 1]) for i in idx
        ]) if len(idx) else np.empty(0, np.int64)
        take = take.astype(np.int64)
        return SoN(
            node_ids=self.node_ids[idx], t0=self.t0, t1=self.t1,
            init_present=self.init_present[idx], init_attrs=self.init_attrs[idx],
            ev_indptr=indptr, ev_t=self.ev_t[take], ev_kind=self.ev_kind[take],
            ev_key=self.ev_key[take], ev_val=self.ev_val[take],
            ev_other=self.ev_other[take],
        )

    def padded_events(self, emax: Optional[int] = None):
        """Dense (N, Emax) views (pad t = +inf sentinel) for vmap paths."""
        counts = self.ev_indptr[1:] - self.ev_indptr[:-1]
        emax = emax or (int(counts.max()) if len(counts) else 0)
        emax = max(emax, 1)
        N = len(self)
        t = np.full((N, emax), np.iinfo(np.int64).max, np.int64)
        kind = np.full((N, emax), -1, np.int8)
        key = np.full((N, emax), -1, np.int16)
        val = np.full((N, emax), -1, np.int32)
        other = np.full((N, emax), -1, np.int32)
        for i in range(N):
            lo, hi = int(self.ev_indptr[i]), int(self.ev_indptr[i + 1])
            n = min(hi - lo, emax)
            t[i, :n] = self.ev_t[lo : lo + n]
            kind[i, :n] = self.ev_kind[lo : lo + n]
            key[i, :n] = self.ev_key[lo : lo + n]
            val[i, :n] = self.ev_val[lo : lo + n]
            other[i, :n] = self.ev_other[lo : lo + n]
        return {"t": t, "kind": kind, "key": key, "val": val, "other": other}


@dataclasses.dataclass
class SoTS(SoN):
    """Set of Temporal Subgraphs (1-hop stars; k-hop by composition)."""

    adj_indptr: np.ndarray = None  # (N+1,) initial neighbors at t0
    adj_nbr: np.ndarray = None
    adj_val: np.ndarray = None

    def neighbors_of(self, i: int):
        lo, hi = int(self.adj_indptr[i]), int(self.adj_indptr[i + 1])
        return self.adj_nbr[lo:hi], self.adj_val[lo:hi]

    def subset(self, idx: np.ndarray) -> "SoTS":
        idx = np.asarray(idx)
        base = SoN.subset(self, idx)
        counts = (self.adj_indptr[1:] - self.adj_indptr[:-1])[idx]
        indptr = np.r_[0, np.cumsum(counts)].astype(np.int64)
        take = np.concatenate([
            np.arange(self.adj_indptr[i], self.adj_indptr[i + 1]) for i in idx
        ]).astype(np.int64) if len(idx) else np.empty(0, np.int64)
        return SoTS(
            **_field_dict(base),
            adj_indptr=indptr,
            adj_nbr=self.adj_nbr[take],
            adj_val=self.adj_val[take],
        )


# ---------------------------------------------------------------------------
# Construction from TGI (the paper's parallel-fetch path, §5.2)
# ---------------------------------------------------------------------------


def _per_node_events(events: EventLog, node_ids: np.ndarray):
    """CSR of events per node (an event touching both endpoints appears in
    both nodes' runs, mirroring NodeT semantics)."""
    nid = np.concatenate([events.src, events.dst[events.dst >= 0]])
    rep_idx = np.concatenate([
        np.arange(len(events)), np.nonzero(events.dst >= 0)[0]
    ])
    other = np.concatenate([
        np.where(events.dst >= 0, events.dst, -1),
        events.src[events.dst >= 0],
    ])
    sel = np.isin(nid, node_ids)
    nid, rep_idx, other = nid[sel], rep_idx[sel], other[sel]
    order = np.lexsort((events.t[rep_idx], nid))
    nid, rep_idx, other = nid[order], rep_idx[order], other[order]
    # map nid -> dense index
    pos = np.searchsorted(node_ids, nid)
    indptr = np.searchsorted(pos, np.arange(len(node_ids) + 1))
    return (
        indptr.astype(np.int64),
        events.t[rep_idx],
        events.kind[rep_idx],
        events.key[rep_idx],
        events.val[rep_idx],
        other.astype(np.int32),
    )


def build_son(tgi, t0: int, t1: int, node_ids: Optional[np.ndarray] = None,
              c: int = 1, pids: Optional[np.ndarray] = None,
              projection=None, snap: Optional[GraphState] = None) -> SoN:
    """Fetch a SoN from the TGI: Timeslice-at-t0 snapshot + event runs.

    The snapshot fetch is partition-parallel (paper Fig. 10): each QP
    reads only its placement chunks; `c` is the parallel fetch factor.
    ``pids``/``projection`` are the planner's pushdown hooks: a partition
    subset known to cover ``node_ids`` (pruned fetch) and the optional
    payload fields actually needed (attribute projection).  ``snap`` lets
    a caller that already fetched the t0 snapshot (build_sots) reuse it.

    The whole build runs under one ``tgi.read_guard()``: the t0 snapshot
    and the (t0, t1] event replay come from the same pinned epoch, so a
    concurrent ingest or background compaction can't tear the operand.
    """
    with tgi.read_guard() as view:
        if snap is None:
            snap = tgi.get_snapshot(t0, c=c, pids=pids, projection=projection)
        if node_ids is None:
            node_ids = snap.node_ids()
        node_ids = np.unique(np.asarray(node_ids, np.int32))
        ev = view.events
        sel = (ev.t > t0) & (ev.t <= t1)
        ev = ev.take(np.nonzero(sel)[0])
        indptr, t, kind, key, val, other = _per_node_events(ev, node_ids)
        snap.grow(int(node_ids.max()) + 1 if len(node_ids) else 0)
        return SoN(
            node_ids=node_ids, t0=t0, t1=t1,
            init_present=snap.present[node_ids],
            init_attrs=snap.attrs[node_ids],
            ev_indptr=indptr, ev_t=t, ev_kind=kind, ev_key=key, ev_val=val,
            ev_other=other,
        )


def build_sots(tgi, t0: int, t1: int, node_ids: Optional[np.ndarray] = None,
               k: int = 1, c: int = 1, pids: Optional[np.ndarray] = None,
               projection=None) -> SoTS:
    """SoTS = SoN + initial 1-hop adjacency (k>1 composes neighborhoods).

    Pruned fetches stay exact: snapshot deltas mirror every edge under
    both endpoints' slots, so a partition subset covering the member
    nodes carries their complete initial adjacency.
    """
    assert k == 1, "k-hop SoTS composes 1-hop stars (paper §5.1)"
    # one guard around snapshot + SoN build: nested guards reuse the
    # outer pinned epoch, so the adjacency and the event runs agree
    with tgi.read_guard():
        snap = tgi.get_snapshot(t0, c=c, pids=pids, projection=projection)
        if node_ids is None:
            node_ids = snap.node_ids()
        son = build_son(tgi, t0, t1, node_ids, c=c, pids=pids,
                        projection=projection, snap=snap)
    src, dst, val = snap.edges()
    # adjacency restricted to son.node_ids as center
    both_src = np.concatenate([src, dst])
    both_dst = np.concatenate([dst, src])
    both_val = np.concatenate([val, val])
    sel = np.isin(both_src, son.node_ids)
    bs, bd, bv = both_src[sel], both_dst[sel], both_val[sel]
    order = np.lexsort((bd, bs))
    bs, bd, bv = bs[order], bd[order], bv[order]
    pos = np.searchsorted(son.node_ids, bs)
    indptr = np.searchsorted(pos, np.arange(len(son.node_ids) + 1)).astype(np.int64)
    return SoTS(
        **_field_dict(son),
        adj_indptr=indptr, adj_nbr=bd.astype(np.int32), adj_val=bv.astype(np.int32),
    )
