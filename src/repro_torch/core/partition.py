"""Dynamic graph partitioning (paper §4.5).

A timespan's event stream is projected to a single weighted static graph
with a time-collapse function Ω ∈ {median, union-max, union-mean}, then
statically partitioned.  The paper's default — Union-Max edge weights +
uniform node weights — is ours too.

The static partitioner is a streaming LDG-style greedy (BFS order,
capacity-penalized neighbor affinity) followed by bounded
Kernighan-Lin-style refinement sweeps; pure numpy, runs at timespan
boundaries on the host (control plane — the TPU only consumes the
resulting layout).  1-hop edge-cut replication (paper Fig. 5d) is
computed here and stored as auxiliary micro-deltas by the TGI builder.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.events import EDGE_ADD, EDGE_DEL, EventLog


# ---------------------------------------------------------------------------
# Ω time-collapse (paper §4.5: Median / Union-Max / Union-Mean)
# ---------------------------------------------------------------------------


def collapse(events: EventLog, omega: str = "union_max",
             t0: Optional[int] = None, t1: Optional[int] = None):
    """Project a timespan's edge events to a static weighted edge list.

    Returns (src, dst, weight) numpy arrays (canonical src<dst, unique).
    Weight semantics: presence duration/max as per Ω; an edge deleted and
    never re-added ends with weight 0 under 'median' at a t where absent.
    """
    t0 = events.t[0] if (t0 is None and len(events)) else (t0 or 0)
    t1 = events.t[-1] if (t1 is None and len(events)) else (t1 or 0)
    is_edge = (events.kind == EDGE_ADD) | (events.kind == EDGE_DEL)
    ev = events.take(np.nonzero(is_edge)[0])
    if not len(ev):
        z = np.empty(0, np.int32)
        return z, z, np.empty(0, np.float32)
    key = ev.src.astype(np.int64) * (2**31) + ev.dst.astype(np.int64)
    if omega == "median":
        tm = (int(t0) + int(t1)) // 2
        upto = ev.up_to(tm)
        key_m = upto.src.astype(np.int64) * (2**31) + upto.dst.astype(np.int64)
        # last op per edge decides presence at median time
        order = np.arange(len(upto))
        last = {}
        for i in order:  # small per-timespan streams; clarity over speed
            last[key_m[i]] = i
        idx = np.array([i for k, i in last.items() if upto.kind[i] == EDGE_ADD], int)
        if not len(idx):
            z = np.empty(0, np.int32)
            return z, z, np.empty(0, np.float32)
        w = np.where(upto.val[idx] >= 0, upto.val[idx], 1).astype(np.float32)
        return upto.src[idx], upto.dst[idx], w
    # union variants: any edge that ever existed in the span
    uniq, inv = np.unique(key, return_inverse=True)
    w_ev = np.where(ev.val >= 0, ev.val, 1).astype(np.float32)
    if omega == "union_max":
        w = np.zeros(len(uniq), np.float32)
        np.maximum.at(w, inv, np.where(ev.kind == EDGE_ADD, w_ev, 0.0))
    elif omega == "union_mean":
        # time-fraction weighted mean presence; approximate with fraction
        # of span the edge is present times its (last) weight
        span = max(int(t1) - int(t0), 1)
        present_time = np.zeros(len(uniq), np.float64)
        last_on = np.full(len(uniq), -1, np.int64)
        for i in range(len(ev)):  # chronological
            e = inv[i]
            if ev.kind[i] == EDGE_ADD and last_on[e] < 0:
                last_on[e] = ev.t[i]
            elif ev.kind[i] == EDGE_DEL and last_on[e] >= 0:
                present_time[e] += ev.t[i] - last_on[e]
                last_on[e] = -1
        still = last_on >= 0
        present_time[still] += int(t1) - last_on[still]
        w = (present_time / span).astype(np.float32)
    else:
        raise ValueError(omega)
    src = (uniq // (2**31)).astype(np.int32)
    dst = (uniq % (2**31)).astype(np.int32)
    keep = w > 0
    return src[keep], dst[keep], w[keep]


# ---------------------------------------------------------------------------
# Static partitioning
# ---------------------------------------------------------------------------


def edge_cut(src, dst, assign) -> int:
    return int((assign[src] != assign[dst]).sum())


def partition_graph(node_ids: np.ndarray, src: np.ndarray, dst: np.ndarray,
                    weights: Optional[np.ndarray], k: int,
                    refine_sweeps: int = 2, seed: int = 0) -> np.ndarray:
    """Returns assignment (len(node_ids),) in [0,k) — balanced (ceil/floor)
    min-cut heuristic.  node_ids sorted unique; src/dst are node *ids*."""
    n = len(node_ids)
    if n == 0:
        return np.empty(0, np.int32)
    idx_of = {int(v): i for i, v in enumerate(node_ids)}
    s = np.array([idx_of[int(x)] for x in src], np.int64) if len(src) else np.empty(0, np.int64)
    d = np.array([idx_of[int(x)] for x in dst], np.int64) if len(src) else np.empty(0, np.int64)
    w = (weights if weights is not None else np.ones(len(s), np.float32))
    cap = int(np.ceil(n / k))

    # adjacency (CSR over both directions)
    deg_src = np.concatenate([s, d])
    deg_dst = np.concatenate([d, s])
    deg_w = np.concatenate([w, w])
    order = np.argsort(deg_src, kind="stable")
    adj_src = deg_src[order]
    adj_dst = deg_dst[order]
    adj_w = deg_w[order]
    indptr = np.searchsorted(adj_src, np.arange(n + 1))

    assign = np.full(n, -1, np.int32)
    sizes = np.zeros(k, np.int64)
    rng = np.random.RandomState(seed)

    # BFS order from highest-degree seeds (locality streaming)
    degs = np.diff(indptr)
    visit_order = []
    visited = np.zeros(n, bool)
    for root in np.argsort(-degs):
        if visited[root]:
            continue
        stack = [int(root)]
        visited[root] = True
        while stack:
            u = stack.pop()
            visit_order.append(u)
            for j in range(indptr[u], indptr[u + 1]):
                v = int(adj_dst[j])
                if not visited[v]:
                    visited[v] = True
                    stack.append(v)

    for u in visit_order:
        aff = np.zeros(k, np.float64)
        for j in range(indptr[u], indptr[u + 1]):
            v = int(adj_dst[j])
            if assign[v] >= 0:
                aff[assign[v]] += adj_w[j]
        penalty = 1.0 - sizes / cap  # LDG balance term
        score = aff * np.maximum(penalty, 0.0) + 1e-9 * penalty
        full = sizes >= cap
        score[full] = -np.inf
        p = int(np.argmax(score))
        if np.isinf(score[p]):
            p = int(np.argmin(sizes))
        assign[u] = p
        sizes[p] += 1

    # bounded KL-style refinement: move nodes whose gain > 0, respecting caps
    for _ in range(refine_sweeps):
        moved = 0
        for u in rng.permutation(n):
            cur = assign[u]
            aff = np.zeros(k, np.float64)
            for j in range(indptr[u], indptr[u + 1]):
                v = int(adj_dst[j])
                aff[assign[v]] += adj_w[j]
            best = int(np.argmax(aff))
            if best != cur and aff[best] > aff[cur] and sizes[best] < cap:
                assign[u] = best
                sizes[cur] -= 1
                sizes[best] += 1
                moved += 1
        if not moved:
            break
    return assign


def partition_timespan(events: EventLog, n_parts: int, strategy: str = "hash",
                       omega: str = "union_max", seed: int = 0):
    """Returns (node_ids, assignment or None).  strategy 'hash' returns
    None (SlotMap hashes); 'locality' runs Ω-collapse + min-cut."""
    nids = np.unique(np.concatenate([
        events.src, events.dst[events.dst >= 0]
    ])) if len(events) else np.empty(0, np.int32)
    nids = nids[nids >= 0].astype(np.int32)
    if strategy == "hash":
        return nids, None
    src, dst, w = collapse(events, omega)
    assign = partition_graph(nids, src, dst, w, n_parts, seed=seed)
    return nids, assign


def replication_lists(src, dst, assign_of) -> Dict[int, np.ndarray]:
    """1-hop edge-cut replication: for each partition p, the set of
    *external* neighbor node-ids that its nodes connect to (stored as
    auxiliary micro-deltas so snapshot/node reads are unaffected)."""
    out: Dict[int, list] = {}
    ps, pd = assign_of(src), assign_of(dst)
    cut = ps != pd
    for p in np.unique(np.concatenate([ps, pd])):
        ext = np.concatenate([dst[cut & (ps == p)], src[cut & (pd == p)]])
        out[int(p)] = np.unique(ext)
    return {p: v for p, v in out.items()}
