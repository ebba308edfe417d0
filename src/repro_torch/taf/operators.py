"""Temporal graph operators (paper §5.1, operators 1-9).

The operand is a SoN/SoTS; operators are vectorized over the node axis
(vmap/shard_map on device — see taf.exec — or numpy on host).  The two
evaluation styles the paper benchmarks (Fig. 17):

* ``node_compute_temporal``: re-evaluate f on every materialized version
  — O(N·T);
* ``node_compute_delta``: evaluate f once on the initial state, then fold
  f_delta over events with carried auxiliary state — O(N+T).

Multi-timepoint evaluation rides the batched replay engine
(``repro.taf.replay``): one sorted-event pass serves every requested
timepoint, and setting ``f.vectorized`` (plus ``f_delta.vectorized`` for
the incremental style) unlocks fully array-level evaluation with zero
per-node Python.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.events import (
    EDGE_ADD,
    EDGE_DEL,
    EATTR_SET,
    NATTR_SET,
    NODE_ADD,
    NODE_DEL,
)
from repro_torch.core.snapshot import GraphState
from repro_torch.taf import replay
from repro_torch.taf.son import SoN, SoTS


# ---------------------------------------------------------------------------
# 1. Selection
# ---------------------------------------------------------------------------


def selection(son: SoN, pred: Callable[[SoN], np.ndarray]) -> SoN:
    """Entity-centric filter; pred receives the SoN and returns a boolean
    mask over nodes (vectorized — no per-node python)."""
    mask = np.asarray(pred(son), bool)
    return son.subset(np.nonzero(mask)[0])


# ---------------------------------------------------------------------------
# 2. Timeslice
# ---------------------------------------------------------------------------


def _state_at_ref(son: SoN, t: int):
    """Reference per-event replay (the pre-vectorization semantics the
    fast path below is property-tested against)."""
    N = len(son)
    present = son.init_present.copy()
    attrs = son.init_attrs.copy()
    upto = son.ev_t <= t
    node_of_ev = np.repeat(np.arange(N), son.ev_indptr[1:] - son.ev_indptr[:-1])
    sel = np.nonzero(upto)[0]
    for j in sel:  # per-node chronological; bounded by |events <= t|
        i = node_of_ev[j]
        k = son.ev_kind[j]
        if k == NODE_ADD:
            present[i] = 1
        elif k == NODE_DEL:
            present[i] = 0
            attrs[i] = -1
        elif k == NATTR_SET:
            present[i] = 1
            attrs[i, son.ev_key[j]] = son.ev_val[j]
    return present, attrs


def _state_at(son: SoN, t: int):
    """Vectorized last-write-wins replay of per-node events up to t over
    the initial state.  Returns (present (N,), attrs (N,K)).

    The CSR event arrays are grouped by node and chronological within a
    node, so "last entry of each group" is exactly the replay result:
    presence takes the final NODE_ADD/NODE_DEL/NATTR_SET per node; attrs
    take the final write per (node, key), where a NODE_DEL counts as
    writing -1 to every key.
    """
    N = len(son)
    present = son.init_present.copy()
    attrs = son.init_attrs.copy()
    K = attrs.shape[1]
    if not len(son.ev_t):
        return present, attrs
    idx = np.nonzero(son.ev_t <= t)[0]
    if not len(idx):
        return present, attrs
    node_of_ev = np.repeat(np.arange(N), son.ev_indptr[1:] - son.ev_indptr[:-1])
    nodes = node_of_ev[idx]
    kind = son.ev_kind[idx]

    # --- presence: last node-state event per node wins ---
    pm = (kind == NODE_ADD) | (kind == NODE_DEL) | (kind == NATTR_SET)
    if pm.any():
        pn, pk = nodes[pm], kind[pm]
        last = np.r_[pn[1:] != pn[:-1], True]
        present[pn[last]] = (pk[last] != NODE_DEL).astype(present.dtype)

    # --- attrs: last write per (node, key) wins ---
    am = kind == NATTR_SET
    dm = kind == NODE_DEL
    if am.any() or dm.any():
        seq = np.arange(len(idx))  # chronological rank within the replay
        an, ak = nodes[am], son.ev_key[idx][am].astype(np.int64)
        av, aseq = son.ev_val[idx][am], seq[am]
        dn, dseq = nodes[dm], seq[dm]
        # a NODE_DEL clears every attribute slot: expand it to K writes
        wn = np.concatenate([an, np.repeat(dn, K)])
        wk = np.concatenate([ak, np.tile(np.arange(K, dtype=np.int64), len(dn))])
        wv = np.concatenate([av, np.full(len(dn) * K, -1, attrs.dtype)])
        ws = np.concatenate([aseq, np.repeat(dseq, K)])
        order = np.lexsort((ws, wk, wn))
        wn, wk, wv = wn[order], wk[order], wv[order]
        last = np.r_[(wn[1:] != wn[:-1]) | (wk[1:] != wk[:-1]), True]
        attrs[wn[last], wk[last]] = wv[last]
    return present, attrs


def timeslice(son: SoN, ts) -> Dict[str, np.ndarray]:
    """State of each node at time(s) ts.  Returns dict with 'present'
    (N,[T]) and 'attrs' (N,[T],K).  Multi-timepoint requests run ONE
    batched replay (``replay.state_at_many``), not T rescans."""
    if np.isscalar(ts):
        p, a = _state_at(son, int(ts))
        return {"present": p, "attrs": a, "t": np.asarray([int(ts)])}
    ts = np.asarray(list(ts), np.int64)
    p, a = replay.state_at_many(son, ts)
    return {"present": p, "attrs": a, "t": ts}


def _neighbors_at_ref(sots: SoTS, i: int, t: int) -> np.ndarray:
    """Reference per-event set replay (the pre-vectorization semantics
    ``replay.EdgeReplay`` is property-tested against)."""
    nbr0, _ = sots.neighbors_of(i)
    cur = set(int(x) for x in nbr0)
    evs = sots.events_of(i)
    for j in range(len(evs["t"])):
        if evs["t"][j] > t:
            break
        if evs["kind"][j] == EDGE_ADD:
            cur.add(int(evs["other"][j]))
        elif evs["kind"][j] == EDGE_DEL:
            cur.discard(int(evs["other"][j]))
    return np.asarray(sorted(cur), np.int32)


def neighbors_at(sots: SoTS, i: int, t: int) -> np.ndarray:
    """Neighbor set of node i at time t (initial adjacency + edge events,
    answered from the operand's cached ``EdgeReplay`` pair table)."""
    return replay.edge_replay(sots).neighbors_at(int(i), int(t))


# ---------------------------------------------------------------------------
# 3. Graph
# ---------------------------------------------------------------------------


def graph(sots: SoTS, t: Optional[int] = None) -> GraphState:
    """In-memory GraphS of the SoTS members (edges with both endpoints in
    the set), optionally timesliced at t.  Runs on the vectorized CSR
    path (``replay.graph_at_many``); edge keys use the guarded int64
    shift packing of ``repro.core.snapshot.pack_edge_key``."""
    t = t if t is not None else sots.t0
    return replay.graph_at_many(sots, [int(t)])[0]


def graph_at_many(sots: SoTS, ts) -> List[GraphState]:
    """Batched ``graph``: the GraphS at each timepoint from one shared
    replay pass (state + edge-existence tables built once)."""
    return replay.graph_at_many(sots, ts)


# ---------------------------------------------------------------------------
# 4-6. NodeCompute / NodeComputeTemporal / NodeComputeDelta
# ---------------------------------------------------------------------------


def node_compute(son: SoN, f: Callable, t: Optional[int] = None) -> np.ndarray:
    """Map f over the (timesliced) static nodes.  f receives dict(state)
    for one node and returns a scalar; or set f.vectorized = True to
    receive the whole arrays."""
    t = t if t is not None else son.t0
    present, attrs = _state_at(son, t)
    if getattr(f, "vectorized", False):
        return f(present=present, attrs=attrs, son=son, t=t)
    return np.asarray([
        f(present=present[i], attrs=attrs[i], son=son, i=i, t=t)
        for i in range(len(son))
    ])


def eval_points(son: SoN, points=None) -> np.ndarray:
    """Default: all change points (paper: 'evaluated at all the points of
    change'); points may be an array or a callable(son) -> array."""
    if points is None:
        return son.change_points()
    if callable(points):
        return np.asarray(points(son))
    return np.asarray(points)


def node_compute_temporal(son: SoN, f: Callable, points=None) -> Tuple[np.ndarray, np.ndarray]:
    """f evaluated afresh at every point.  Returns (points (T,),
    values (N, T)).

    States at every point come from ONE batched replay
    (``replay.state_at_many``) instead of T rescans.  With
    ``f.vectorized`` set, f is called once with the full ``present
    (N, T)`` / ``attrs (N, T, K)`` arrays and ``t`` the (T,) points —
    zero per-node Python (the fast path the paper's Fig.-17 temporal
    curve rides); otherwise f is still invoked per (node, point), the
    O(N·T) baseline semantics.
    """
    ts = eval_points(son, points)
    N = len(son)
    present, attrs = replay.state_at_many(son, ts)
    if getattr(f, "vectorized", False):
        out = f(present=present, attrs=attrs, son=son, t=ts)
        return ts, np.asarray(out, np.float64).reshape(N, len(ts))
    out = np.empty((N, len(ts)), np.float64)
    for j, t in enumerate(ts):
        pj, aj = present[:, j], attrs[:, j]
        for i in range(N):
            out[i, j] = f(present=pj[i], attrs=aj[i], son=son, i=i, t=int(t))
    return ts, out


def node_compute_delta(son: SoN, f: Callable, f_delta: Callable,
                       points=None) -> Tuple[np.ndarray, np.ndarray]:
    """Incremental evaluation (paper operator 6): f once on the initial
    state, then f_delta(aux, value, event) -> (aux, value) folded over
    each node's events — O(N + T).

    Returns (points, values (N, T)) sampled at the same points as the
    temporal variant (value carried forward between events).

    When BOTH ``f.vectorized`` and ``f_delta.vectorized`` are set the
    fold is batched: f returns ``(aux, values (N,))`` for the whole set,
    and f_delta is called once per inter-point window with the window's
    event arrays (``node`` row indices, ``kind``, ``key``, ``val_``,
    ``other``) — T vectorized steps instead of N·E Python iterations.
    """
    ts = eval_points(son, points)
    N = len(son)
    out = np.empty((N, len(ts)), np.float64)
    if getattr(f, "vectorized", False) and getattr(f_delta, "vectorized", False):
        aux, val = f(present=son.init_present, attrs=son.init_attrs,
                     son=son, init=True)
        val = np.asarray(val, np.float64).copy()
        order = np.argsort(ts, kind="stable")
        tss = ts[order]
        bkt = np.searchsorted(tss, son.ev_t, side="left")
        node_of_ev = son.node_of_events()
        for pj in range(len(tss)):
            w = np.nonzero(bkt == pj)[0]  # CSR order within the window
            if len(w):
                aux, val = f_delta(
                    aux, val, node=node_of_ev[w], kind=son.ev_kind[w],
                    key=son.ev_key[w], val_=son.ev_val[w],
                    other=son.ev_other[w], son=son,
                )
                val = np.asarray(val, np.float64)
            out[:, order[pj]] = val
        return ts, out
    for i in range(N):
        aux, val = f(present=son.init_present[i], attrs=son.init_attrs[i],
                     son=son, i=i, init=True)
        evs = son.events_of(i)
        ne = len(evs["t"])
        j = 0  # event cursor
        for pj, t in enumerate(ts):
            while j < ne and evs["t"][j] <= t:
                aux, val = f_delta(
                    aux, val,
                    kind=evs["kind"][j], key=evs["key"][j],
                    val_=evs["val"][j], other=evs["other"][j], i=i, son=son,
                )
                j += 1
            out[i, pj] = val
    return ts, out


# ---------------------------------------------------------------------------
# 7-9. Compare / Evolution / TempAggregation
# ---------------------------------------------------------------------------


def compare(son_a: SoN, son_b: SoN, f: Callable, points=None):
    """Scalar f over both operands; returns (node_ids, difference) for the
    common ids (paper operator 7)."""
    common = np.intersect1d(son_a.node_ids, son_b.node_ids)
    ia = np.searchsorted(son_a.node_ids, common)
    ib = np.searchsorted(son_b.node_ids, common)
    va = node_compute(son_a, f)
    vb = node_compute(son_b, f)
    return common, va[ia] - vb[ib]


def compare_timeslices(son: SoN, f: Callable, t_a: int, t_b: int):
    """The paper's single-operand variant: compare f at two timepoints
    (both states come from one batched replay)."""
    present, attrs = replay.state_at_many(son, np.asarray([t_a, t_b], np.int64))
    pa, aa = present[:, 0], attrs[:, 0]
    pb, ab = present[:, 1], attrs[:, 1]
    va = np.asarray([f(present=pa[i], attrs=aa[i], son=son, i=i, t=t_a)
                     for i in range(len(son))])
    vb = np.asarray([f(present=pb[i], attrs=ab[i], son=son, i=i, t=t_b)
                     for i in range(len(son))])
    return son.node_ids, va - vb


def evolution(son: SoN, f: Callable, points=None, n_samples: int = 10):
    """Aggregate quantity f(son, t) sampled over time (paper operator 8).
    Default points: n_samples uniform over [t0, t1].  With
    ``f.vectorized`` set, f is called once with the whole (T,) points
    array and must return the (T,) series (one shared replay pass)."""
    if points is None:
        points = np.linspace(son.t0, son.t1, n_samples).astype(np.int64)
    else:
        points = eval_points(son, points)
    if getattr(f, "vectorized", False):
        return points, np.asarray(f(son, np.asarray(points, np.int64)))
    return points, np.asarray([f(son, int(t)) for t in points])


def temp_aggregate(series: np.ndarray, op: str, t: Optional[np.ndarray] = None):
    """Max/Min/Mean/Peak/Saturate over a scalar timeseries (operator 9)."""
    series = np.asarray(series, np.float64)
    if op == "max":
        return float(series.max())
    if op == "min":
        return float(series.min())
    if op == "mean":
        return float(series.mean())
    if op == "peak":
        # indices of strict local maxima (eventful timepoints)
        if len(series) < 3:
            return np.empty(0, np.int64)
        mid = (series[1:-1] > series[:-2]) & (series[1:-1] > series[2:])
        idx = np.nonzero(mid)[0] + 1
        return (t[idx] if t is not None else idx)
    if op == "saturate":
        final = series[-1]
        if final == 0:
            return t[0] if t is not None else 0
        # sign-aware band around the final value: |s - final| within 5%
        # of |final|.  (The old ``series >= 0.95 * final`` test inverted
        # for negative-valued series — e.g. difference series from
        # ``compare`` — where -0.1 >= 0.95 * -1.0 holds at t=0.)
        reached = np.nonzero(np.abs(series - final) <= 0.05 * abs(final))[0]
        i = int(reached[0]) if len(reached) else len(series) - 1
        return t[i] if t is not None else i
    raise ValueError(op)
