"""Batched multi-timepoint temporal replay engine.

The Kairos insight (arXiv 2401.02563), applied to the TAF compute layer:
when a query evaluates T timepoints over the same operand, share ONE
chronological pass over the event log across all of them instead of
rescanning per timepoint.  Every event is assigned the *first* query
timepoint it applies to (a searchsorted against the sorted timepoints);
last-write-wins per (entity, timepoint-bucket) plus a forward-fill along
the time axis then yields the state at every timepoint in O(E + N·T)
instead of O(E·T).

Three engines live here:

* ``state_at_many``  — node presence/attrs at T timepoints in one pass
                       (the batched generalization of
                       ``operators._state_at``; bit-identical to the
                       ``_state_at_ref`` loop, property-tested);
* ``EdgeReplay``     — a per-SoTS (center, neighbor) pair table built
                       once from the initial adjacency + edge events;
                       answers ``exist_matrix``/``degree_series``/
                       ``neighbors_at``/``csr_at`` at any set of
                       timepoints without re-touching the event log;
* ``graph_at_many``  — materialized ``GraphState`` per timepoint riding
                       both engines (the state extraction under
                       density/LCC/PageRank-over-time series).

``ReplayCache`` is the small LRU the plan executor keys on
``(operand identity, timepoints)`` so repeated slices of the same
operand don't replay at all.
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.events import EDGE_ADD, EDGE_DEL, NATTR_SET, NODE_ADD, NODE_DEL
from repro_torch.core.snapshot import GraphState, pack_edge_key
from repro_torch.taf.son import SoN, SoTS


_T_NEG_INF = np.iinfo(np.int64).min


def _sorted_axis(ts) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ts, ts_sorted, order) with ts int64 1-D.  Results are computed on
    the sorted axis and scattered back through ``order`` so callers keep
    their requested timepoint order (duplicates allowed)."""
    ts = np.asarray(ts, np.int64).ravel()
    order = np.argsort(ts, kind="stable")
    return ts, ts[order], order


def _ffill_last_write(written: np.ndarray, values: np.ndarray,
                      base: np.ndarray) -> np.ndarray:
    """Row-wise forward-fill of sparse writes along the last axis.

    ``written``  (..., T) bool  — a write landed in this column;
    ``values``   (..., T)       — the written value (garbage where not);
    ``base``     (...,)         — the value before the first write.
    """
    T = written.shape[-1]
    col = np.arange(T, dtype=np.int32)
    idx = np.where(written, col, np.int32(-1))
    np.maximum.accumulate(idx, axis=-1, out=idx)
    filled = np.take_along_axis(values, np.maximum(idx, 0), axis=-1)
    return np.where(idx >= 0, filled, base[..., None])


# ---------------------------------------------------------------------------
# Node state at many timepoints (one sorted-event pass)
# ---------------------------------------------------------------------------


def state_at_many(son: SoN, ts) -> Tuple[np.ndarray, np.ndarray]:
    """Presence/attrs of every node at every timepoint in ONE pass.

    Returns ``(present (N, T), attrs (N, T, K))`` with column j equal to
    ``operators._state_at_ref(son, ts[j])`` bit-for-bit.  Each event is
    bucketed to the first timepoint it applies to; last-write-wins per
    (node, bucket) [presence] / (node, key, bucket) [attrs] + a forward
    fill along the sorted time axis replaces the per-timepoint rescan.
    """
    N = len(son)
    K = son.init_attrs.shape[1]
    ts, tss, order = _sorted_axis(ts)
    T = len(ts)
    if T == 0:
        return (np.empty((N, 0), son.init_present.dtype),
                np.empty((N, 0, K), son.init_attrs.dtype))
    if not len(son.ev_t):
        return (np.repeat(son.init_present[:, None], T, axis=1),
                np.repeat(son.init_attrs[:, None, :], T, axis=1))

    # bucket = first sorted timepoint the event applies to (ev_t <= t)
    bkt_all = np.searchsorted(tss, son.ev_t, side="left")
    idx = np.nonzero(bkt_all < T)[0]  # events beyond every timepoint drop out
    nodes = son.node_of_events()[idx]
    kind = son.ev_kind[idx]
    bkt = bkt_all[idx]

    # --- presence: last node-state event per (node, bucket) wins ---
    pm = (kind == NODE_ADD) | (kind == NODE_DEL) | (kind == NATTR_SET)
    if pm.any():
        pn, pb = nodes[pm], bkt[pm]
        pv = (kind[pm] != NODE_DEL).astype(np.int8)
        # CSR order is chronological within a node, and buckets are
        # monotone in time, so group-last is a boundary test
        last = np.r_[(pn[1:] != pn[:-1]) | (pb[1:] != pb[:-1]), True]
        upd = np.full((N, T), -1, np.int8)
        upd[pn[last], pb[last]] = pv[last]
        present_s = _ffill_last_write(
            upd >= 0, upd, son.init_present.astype(np.int8)
        ).astype(son.init_present.dtype)
    else:
        present_s = np.repeat(son.init_present[:, None], T, axis=1)

    # --- attrs: last write per (node, key, bucket) wins; a NODE_DEL is
    # a write of -1 to every key ---
    am = kind == NATTR_SET
    dm = kind == NODE_DEL
    if am.any() or dm.any():
        seq = idx  # chronological rank within each node's run
        an, ak = nodes[am], son.ev_key[idx][am].astype(np.int64)
        ab, av, aseq = bkt[am], son.ev_val[idx][am], seq[am]
        dn, db, dseq = nodes[dm], bkt[dm], seq[dm]
        karr = np.arange(K, dtype=np.int64)
        wn = np.concatenate([an, np.repeat(dn, K)])
        wk = np.concatenate([ak, np.tile(karr, len(dn))])
        wb = np.concatenate([ab, np.repeat(db, K)])
        wv = np.concatenate([av, np.full(len(dn) * K, -1, son.init_attrs.dtype)])
        ws = np.concatenate([aseq, np.repeat(dseq, K)])
        o2 = np.lexsort((ws, wb, wk, wn))
        wn, wk, wb, wv = wn[o2], wk[o2], wb[o2], wv[o2]
        last = np.r_[(wn[1:] != wn[:-1]) | (wk[1:] != wk[:-1])
                     | (wb[1:] != wb[:-1]), True]
        vals = np.zeros((N, K, T), son.init_attrs.dtype)
        written = np.zeros((N, K, T), bool)
        vals[wn[last], wk[last], wb[last]] = wv[last]
        written[wn[last], wk[last], wb[last]] = True
        attrs_s = _ffill_last_write(written, vals, son.init_attrs)
        attrs_s = np.ascontiguousarray(attrs_s.transpose(0, 2, 1))  # (N, T, K)
    else:
        attrs_s = np.repeat(son.init_attrs[:, None, :], T, axis=1)

    # scatter back to the caller's timepoint order
    present = np.empty_like(present_s)
    attrs = np.empty_like(attrs_s)
    present[:, order] = present_s
    attrs[:, order] = attrs_s
    return present, attrs


# ---------------------------------------------------------------------------
# Edge replay: (center, neighbor) pair table over a SoTS
# ---------------------------------------------------------------------------


class EdgeReplay:
    """One-pass edge-event replay table for a SoTS.

    Built once per operand: every (center row, neighbor id) pair that
    ever exists — from the initial 1-hop adjacency or an EDGE_ADD/DEL
    event — becomes one row of a sorted table carrying its chronological
    state flips.  Any set of timepoints is then answered with a single
    searchsorted + last-state-per-bucket + forward-fill, replacing the
    per-(node, t) Python-set loops of the old ``neighbors_at``/``graph``.
    """

    def __init__(self, sots: SoTS):
        N = len(sots)
        em = (sots.ev_kind == EDGE_ADD) | (sots.ev_kind == EDGE_DEL)
        eidx = np.nonzero(em)[0]
        en = sots.node_of_events()[eidx]
        eo = sots.ev_other[eidx].astype(np.int64)
        et = sots.ev_t[eidx]
        es = (sots.ev_kind[eidx] == EDGE_ADD).astype(np.int8)
        i0 = np.repeat(np.arange(N, dtype=np.int64),
                       sots.adj_indptr[1:] - sots.adj_indptr[:-1])
        v0 = sots.adj_nbr.astype(np.int64)

        c = np.concatenate([i0, en])
        o = np.concatenate([v0, eo])
        # init entries sort before every event of their pair (seq -1) and
        # apply at every timepoint (t = -inf)
        seq = np.concatenate([np.full(len(i0), -1, np.int64), eidx])
        st = np.concatenate([np.ones(len(i0), np.int8), es])
        tt = np.concatenate([np.full(len(i0), _T_NEG_INF, np.int64), et])
        ordr = np.lexsort((seq, o, c))
        self.c = c[ordr]
        self.o = o[ordr]
        self.seq = seq[ordr]
        self.st = st[ordr]
        self.t = tt[ordr]

        if len(self.c):
            newp = np.r_[True, (self.c[1:] != self.c[:-1])
                         | (self.o[1:] != self.o[:-1])]
        else:
            newp = np.empty(0, bool)
        self.pair_id = np.cumsum(newp) - 1 if len(newp) else np.empty(0, np.int64)
        self.n_pairs = int(self.pair_id[-1]) + 1 if len(self.pair_id) else 0
        first = np.nonzero(newp)[0]
        self.pair_center = self.c[first].astype(np.int64)  # row index into sots
        self.pair_other = self.o[first].astype(np.int64)  # global node id
        # pair existed in the initial adjacency (baseline before events)
        self.base = (self.seq[first] == -1).astype(np.int8)
        self.n_rows = N

    def exist_matrix(self, ts) -> np.ndarray:
        """(n_pairs, T) int8 — pair existence at each requested timepoint
        (columns follow the caller's ``ts`` order)."""
        ts, tss, order = _sorted_axis(ts)
        T = len(ts)
        if self.n_pairs == 0 or T == 0:
            return np.zeros((self.n_pairs, T), np.int8)
        evm = self.seq >= 0
        b = np.searchsorted(tss, self.t[evm], side="left")
        keep = b < T
        p = self.pair_id[evm][keep]
        bb = b[keep]
        ss = self.st[evm][keep]
        upd = np.full((self.n_pairs, T), -1, np.int8)
        if len(p):
            # entries are (pair-major, chronological); buckets monotone
            last = np.r_[(p[1:] != p[:-1]) | (bb[1:] != bb[:-1]), True]
            upd[p[last], bb[last]] = ss[last]
        exist_s = _ffill_last_write(upd >= 0, upd, self.base).astype(np.int8)
        exist = np.empty_like(exist_s)
        exist[:, order] = exist_s
        return exist

    def degree_series(self, ts) -> np.ndarray:
        """(N, T) neighbor-set size of every center at every timepoint —
        the batched replacement for ``len(neighbors_at(i, t))`` loops."""
        exist = self.exist_matrix(ts)
        deg = np.zeros((self.n_rows, exist.shape[1]), np.int64)
        np.add.at(deg, self.pair_center, exist.astype(np.int64))
        return deg

    def neighbors_at(self, i: int, t: int) -> np.ndarray:
        """Sorted neighbor ids of center row i at time t (single-pair
        query path: touches only row i's slice of the table)."""
        lo, hi = np.searchsorted(self.c, [i, i + 1])
        if lo == hi:
            return np.empty(0, np.int32)
        ok = np.nonzero(self.t[lo:hi] <= t)[0]
        if not len(ok):
            return np.empty(0, np.int32)
        p = self.pair_id[lo:hi][ok]
        last = np.r_[p[1:] != p[:-1], True]
        sel = ok[last]
        alive = self.st[lo:hi][sel] == 1
        return self.o[lo:hi][sel][alive].astype(np.int32)  # o-sorted already

    def csr_at(self, t: int) -> Tuple[np.ndarray, np.ndarray]:
        """(indptr (N+1), neighbors) adjacency snapshot at time t."""
        exist = self.exist_matrix([int(t)])[:, 0] == 1
        centers = self.pair_center[exist]
        nbrs = self.pair_other[exist].astype(np.int32)
        indptr = np.searchsorted(centers, np.arange(self.n_rows + 1))
        return indptr.astype(np.int64), nbrs

    def device_export(self) -> Dict[str, np.ndarray]:
        """Device-friendly padded flip table (cached per EdgeReplay).

        The variable-length per-pair event runs become dense
        ``flip_t (n_pairs, F)`` / ``flip_s (n_pairs, F)`` arrays (F = max
        flips per pair, pad ``flip_s = -1``, pad ``flip_t = int64 max``),
        chronological within each row.  Pair existence at any timepoint is
        then one searchsorted per row — the layout the whole-plan compiler
        (repro.taf.compile) uploads once per operand and reuses for every
        jitted dispatch.  ``base``/``pair_center``/``pair_other`` ride
        along so a device program can rebuild adjacency without touching
        the host table again.
        """
        cached = getattr(self, "_device_export", None)
        if cached is not None:
            return cached
        evm = self.seq >= 0
        p = self.pair_id[evm]
        counts = (np.bincount(p, minlength=self.n_pairs).astype(np.int64)
                  if self.n_pairs else np.zeros(0, np.int64))
        F = max(int(counts.max()) if len(counts) else 0, 1)
        flip_t = np.full((self.n_pairs, F), np.iinfo(np.int64).max, np.int64)
        flip_s = np.full((self.n_pairs, F), -1, np.int8)
        if len(p):
            # table order is (pair-major, chronological): column index is
            # the event's rank within its pair's run
            col = np.arange(len(p)) - np.r_[0, np.cumsum(counts)][p]
            flip_t[p, col] = self.t[evm]
            flip_s[p, col] = self.st[evm]
        cached = {
            "flip_t": flip_t, "flip_s": flip_s,
            "base": self.base.astype(np.int8),
            "pair_center": self.pair_center.astype(np.int32),
            "pair_other": self.pair_other.copy(),
        }
        self._device_export = cached
        return cached


def member_rows(other: np.ndarray, node_ids: np.ndarray) -> np.ndarray:
    """Map global node ids to row indices into ``node_ids`` (-1 for ids
    outside the member set) — the pair-table -> adjacency hop the device
    programs need (``pair_other`` is a global id, not a row)."""
    other = np.asarray(other, np.int64)
    node_ids = np.asarray(node_ids, np.int64)
    if not len(node_ids):
        return np.full(len(other), -1, np.int32)
    pos = np.clip(np.searchsorted(node_ids, other), 0, len(node_ids) - 1)
    return np.where(node_ids[pos] == other, pos, -1).astype(np.int32)


def edge_replay(sots: SoTS) -> EdgeReplay:
    """The operand's cached EdgeReplay (built on first use; SoN/SoTS
    operands are immutable once fetched, so the table stays valid)."""
    cached = getattr(sots, "_edge_replay", None)
    if cached is None or cached.n_rows != len(sots):
        cached = EdgeReplay(sots)
        sots._edge_replay = cached
    return cached


def degree_series(sots: SoTS, ts) -> np.ndarray:
    """(N, T) degree of every member at every timepoint, one pass."""
    return edge_replay(sots).degree_series(ts)


def neighbors_at_many(sots: SoTS, i: int, ts) -> List[np.ndarray]:
    """Neighbor sets of center i at each timepoint (shared table)."""
    er = edge_replay(sots)
    return [er.neighbors_at(int(i), int(t)) for t in np.asarray(ts).ravel()]


# ---------------------------------------------------------------------------
# Materialized graphs at many timepoints
# ---------------------------------------------------------------------------


def graph_at_many(sots: SoTS, ts) -> List[GraphState]:
    """GraphState of the SoTS members at each timepoint.  Node state and
    edge existence each come from one batched pass; per-timepoint work is
    only the cheap assembly.  Semantics match ``operators.graph``: edges
    need both endpoints in the member set and a present center."""
    ts = np.asarray(ts, np.int64).ravel()
    K = sots.init_attrs.shape[1]
    n = int(sots.node_ids.max()) + 1 if len(sots) else 0
    present, attrs = state_at_many(sots, ts)
    er = edge_replay(sots)
    exist = er.exist_matrix(ts)
    member_ok = np.isin(er.pair_other, sots.node_ids.astype(np.int64))
    out: List[GraphState] = []
    for j in range(len(ts)):
        g = GraphState.empty(n, K)
        g.present[sots.node_ids] = present[:, j]
        g.attrs[sots.node_ids] = attrs[:, j]
        sel = (exist[:, j] == 1) & member_ok & (present[er.pair_center, j] == 1)
        if sel.any():
            u = sots.node_ids[er.pair_center[sel]].astype(np.int64)
            v = er.pair_other[sel]
            keys = np.unique(pack_edge_key(np.minimum(u, v), np.maximum(u, v)))
            g.edge_key = keys
            g.edge_val = np.full(len(keys), -1, np.int32)
        out.append(g)
    return out


# ---------------------------------------------------------------------------
# LRU replay cache (plan-executor seam)
# ---------------------------------------------------------------------------


def operand_key(son: SoN) -> Tuple:
    """Cheap identity key for an operand (id + shape fields)."""
    return (id(son), son.t0, son.t1, len(son), len(son.ev_t))


class ReplayCache:
    """Small LRU for replayed timeslices/snapshots, keyed on
    ``(operand_key(son), timepoints)`` by the plan executor.

    ``id()`` can be recycled after gc, so every entry also carries a
    weakref to its owning operand; a hit is only served when the owner
    is literally the same live object (a dead or recycled owner entry
    is evicted on lookup).

    Instances are shared class-level by the executor and hit from
    arbitrary query threads, so every dict operation holds an internal
    lock (values are treated as immutable once inserted)."""

    def __init__(self, maxsize: int = 32):
        self.maxsize = maxsize
        # key -> (owner weakref | None, value)
        self._d: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key, owner=None) -> Optional[object]:
        with self._lock:
            entry = self._d.get(key)
            if entry is None:
                self.misses += 1
                return None
            wr, val = entry
            if wr is not None and wr() is not owner:
                del self._d[key]  # stale: owner died / address recycled
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return val

    def put(self, key, value, owner=None) -> None:
        wr = weakref.ref(owner) if owner is not None else None
        with self._lock:
            self._d[key] = (wr, value)
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)
