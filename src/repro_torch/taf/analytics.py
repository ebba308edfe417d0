"""Network-science analytics over SoN/SoTS — the paper's worked examples:
highest local clustering coefficient (Fig. 7a), community comparison
(7b), network-density evolution (7c), incremental label counting (Fig. 8),
plus degree series and PageRank-over-time.

These are thin shims over the unified query layer: each series function
builds a ``TemporalQuery`` over its operand and executes the compiled
plan on ``device`` (None: the CUDA card; repro_torch.taf.query is the
preferred surface for new code).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.events import EDGE_ADD, EDGE_DEL, NATTR_SET
from repro_torch.core.snapshot import GraphState
from repro_torch.taf import operators as ops
from repro_torch.taf import replay
from repro_torch.taf.query import TemporalQuery
from repro_torch.taf.son import SoN, SoTS


# ---------------------------------------------------------------------------
# Local clustering coefficient (paper Fig. 7a)
# ---------------------------------------------------------------------------


def local_clustering(g: GraphState) -> Dict[int, float]:
    """LCC per present node of an in-memory GraphS."""
    src, dst, _ = g.edges()
    nbrs: Dict[int, set] = {}
    for u, v in zip(src.tolist(), dst.tolist()):
        nbrs.setdefault(u, set()).add(v)
        nbrs.setdefault(v, set()).add(u)
    out = {}
    for u in np.nonzero(g.present)[0].tolist():
        ns = nbrs.get(u, set())
        k = len(ns)
        if k < 2:
            out[u] = 0.0
            continue
        links = 0
        ns_l = list(ns)
        for i in range(k):
            links += len(nbrs.get(ns_l[i], set()) & ns)
        out[u] = links / (k * (k - 1))
    return out


def max_lcc(sots: SoTS, t: Optional[int] = None) -> Tuple[int, float]:
    """Paper Fig. 7a: node with the highest LCC at a timeslice."""
    g = ops.graph(sots, t)
    lcc = local_clustering(g)
    if not lcc:
        return -1, 0.0
    nid = max(lcc, key=lcc.get)
    return int(nid), float(lcc[nid])


# ---------------------------------------------------------------------------
# Density evolution (paper Fig. 7c)
# ---------------------------------------------------------------------------


def density_evolution(sots: SoTS, n_samples: int = 10, device=None):
    def density(son, ts):
        # vectorized over timepoints: all graphs from one replay pass
        out = np.empty(len(ts), np.float64)
        for j, g in enumerate(ops.graph_at_many(sots, ts)):
            n = int(g.present.sum())
            e = len(g.edge_key)
            out[j] = 0.0 if n < 2 else 2.0 * e / (n * (n - 1))
        return out

    density.vectorized = True
    return (TemporalQuery.over(sots, device=device)
            .evolution(density, n_samples=n_samples).execute())


# ---------------------------------------------------------------------------
# Degree series — both evaluation styles (the Fig. 17 benchmark pair)
# ---------------------------------------------------------------------------


def degree_series_temporal(sots: SoTS, points=None, device=None):
    """Per-version recompute (Fig. 17's temporal curve), fully batched:
    one ``state_at_many`` pass for presence + one ``EdgeReplay`` pass for
    all neighbor-set sizes — no per-(node, t) Python."""

    def f(present, attrs, son, t, **kw):
        ts = np.atleast_1d(np.asarray(t, np.int64))
        deg = replay.degree_series(sots, ts).astype(np.float64)
        return np.where(present.reshape(len(sots), len(ts)) == 1, deg, 0.0)

    f.vectorized = True
    return (TemporalQuery.over(sots, device=device)
            .node_compute(f, style="temporal", points=points, label="degree")
            .execute())


def degree_series_delta(sots: SoTS, points=None, device=None):
    """Incremental evaluation (Fig. 17's delta curve) on the vectorized
    window fold: init degrees once, then one array update per
    inter-point window."""

    def f(present, attrs, son, init, **kw):
        deg = (son.adj_indptr[1:] - son.adj_indptr[:-1]).astype(np.float64)
        return None, np.where(present == 1, deg, 0.0)

    def f_delta(aux, val, node, kind, key, val_, other, son, **kw):
        np.add.at(val, node[kind == EDGE_ADD], 1.0)
        np.add.at(val, node[kind == EDGE_DEL], -1.0)
        return aux, val

    f.vectorized = True
    f_delta.vectorized = True
    return (TemporalQuery.over(sots, device=device)
            .node_compute(f, style="delta", f_delta=f_delta, points=points,
                          label="degree")
            .execute())


# ---------------------------------------------------------------------------
# Label counting in neighborhoods (paper Fig. 8) — temporal vs delta
# ---------------------------------------------------------------------------


def label_count_temporal(sots: SoTS, label: int, attr_key: int = 0, points=None, device=None):
    """Count neighbors carrying `label` at every version — O(N·T)."""
    label_of = _label_lookup(sots, attr_key)

    def f(present, attrs, son, i, t):
        if not present:
            return 0.0
        nbrs = ops.neighbors_at(sots, i, t)
        return float(sum(1 for v in nbrs if label_of(int(v), t) == label))

    return (TemporalQuery.over(sots, device=device)
            .node_compute(f, style="temporal", points=points,
                          label=f"label_count({label})")
            .execute())


def label_count_delta(sots: SoTS, label: int, attr_key: int = 0, points=None, device=None):
    """Incremental variant: auxiliary state = current neighbor set; each
    edge event adjusts the count in O(1) (paper Fig. 8b)."""
    label_of = _label_lookup(sots, attr_key)

    def f(present, attrs, son, i, init):
        nbrs, _ = sots.neighbors_of(i)
        cnt = float(sum(1 for v in nbrs if label_of(int(v), sots.t0) == label))
        return set(int(v) for v in nbrs), cnt

    def f_delta(aux, val, kind, key, val_, other, i, son):
        if kind == EDGE_ADD and int(other) not in aux:
            aux.add(int(other))
            if label_of(int(other), None) == label:
                val += 1.0
        elif kind == EDGE_DEL and int(other) in aux:
            aux.discard(int(other))
            if label_of(int(other), None) == label:
                val -= 1.0
        return aux, val

    return (TemporalQuery.over(sots, device=device)
            .node_compute(f, style="delta", f_delta=f_delta, points=points,
                          label=f"label_count({label})")
            .execute())


def _label_lookup(sots: SoTS, attr_key: int):
    """label_of(nid, t): node label; labels in our streams are written
    once at node birth, so the t argument may be None (delta path)."""
    ids = sots.node_ids
    init = dict(zip(ids.tolist(), sots.init_attrs[:, attr_key].tolist()))
    # fold NATTR events (first write wins = birth label)
    for i in range(len(sots)):
        evs = sots.events_of(i)
        for j in range(len(evs["t"])):
            if evs["kind"][j] == NATTR_SET and evs["key"][j] == attr_key:
                nid = int(ids[i])
                if init.get(nid, -1) == -1:
                    init[nid] = int(evs["val"][j])
                break

    def label_of(nid: int, t):
        return init.get(nid, -1)

    return label_of


# ---------------------------------------------------------------------------
# PageRank over time (warm-started power iteration per timeslice)
# ---------------------------------------------------------------------------


def pagerank_over_time(sots: SoTS, points, damping: float = 0.85,
                       iters: int = 30, warm_start: bool = True):
    """PageRank at each timepoint; warm-starting from the previous
    timeslice's ranks cuts iterations on slowly-changing graphs (the
    incremental-computation theme of §5.2 applied to a global metric)."""
    ranks = None
    out = []
    iters_used = []
    # state extraction for ALL timepoints rides one batched replay pass
    graphs = ops.graph_at_many(sots, np.asarray(list(points), np.int64))
    for g in graphs:
        nids = np.nonzero(g.present)[0]
        n = len(nids)
        if n == 0:
            out.append({})
            iters_used.append(0)
            continue
        pos = {int(v): i for i, v in enumerate(nids)}
        src, dst, _ = g.edges()
        r = np.full(n, 1.0 / n)
        if warm_start and ranks:
            for v, i in pos.items():
                if v in ranks:
                    r[i] = ranks[v]
            r /= r.sum()
        deg = np.zeros(n)
        su = np.array([pos[int(u)] for u in src], int) if len(src) else np.empty(0, int)
        dv = np.array([pos[int(v)] for v in dst], int) if len(dst) else np.empty(0, int)
        np.add.at(deg, su, 1)
        np.add.at(deg, dv, 1)
        used = iters
        for it in range(iters):
            contrib = np.where(deg > 0, r / np.maximum(deg, 1), 0.0)
            nxt = np.zeros(n)
            np.add.at(nxt, dv, contrib[su])
            np.add.at(nxt, su, contrib[dv])
            dangling = r[deg == 0].sum()
            nxt = (1 - damping) / n + damping * (nxt + dangling / n)
            if np.abs(nxt - r).sum() < 1e-10:
                used = it + 1
                r = nxt
                break
            r = nxt
        iters_used.append(used)
        ranks = {int(v): float(r[i]) for v, i in pos.items()}
        out.append(ranks)
    return out, iters_used
