"""Synthetic temporal-graph event streams.

The paper's datasets (Wikipedia citation history, Friendster+synthetic
events) are not redistributable; this generator produces streams with the
two skews the paper calls out (§4.4): *temporal* skew (bursty activity)
and *topological* skew (preferential attachment).  Deterministic by seed.
"""
from __future__ import annotations

from typing import Optional

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


def generate(
    n_events: int = 20_000,
    n_nodes_hint: int = 0,
    seed: int = 0,
    p_edge_del: float = 0.1,
    p_nattr: float = 0.15,
    p_eattr: float = 0.05,
    p_node_del: float = 0.01,
    n_attr_keys: int = 4,
    n_labels: int = 16,
    burstiness: float = 2.0,
    pa_alpha: float = 0.8,
) -> EventLog:
    """Preferential-attachment growth + deletions + attribute churn.

    burstiness > 1 concentrates events into hot periods (temporal skew);
    pa_alpha in [0,1] interpolates uniform -> preferential attachment
    (topological skew).
    """
    rng = np.random.RandomState(seed)
    n_nodes_hint = n_nodes_hint or max(n_events // 8, 16)

    t = 0
    ts, kinds, srcs, dsts, keys, vals = [], [], [], [], [], []
    alive: list = []
    alive_set = set()
    deg: dict = {}
    edges: set = set()
    edge_list: list = []
    next_node = 0

    def emit(kind, src, dst=-1, key=-1, val=-1):
        nonlocal t
        # bursty clock: hot periods advance slowly, cold ones jump
        if rng.rand() < 0.1:
            t += int(rng.exponential(burstiness * 10)) + 1
        elif rng.rand() < 0.5:
            t += 1
        ts.append(t)
        kinds.append(kind)
        srcs.append(src)
        dsts.append(dst)
        keys.append(key)
        vals.append(val)

    def add_node():
        nonlocal next_node
        nid = next_node
        next_node += 1
        alive.append(nid)
        alive_set.add(nid)
        deg[nid] = 0
        emit(NODE_ADD, nid)
        emit(NATTR_SET, nid, key=0, val=int(rng.randint(n_labels)))

    def pick_node():
        if pa_alpha > 0 and rng.rand() < pa_alpha and edge_list:
            e = edge_list[rng.randint(len(edge_list))]
            cand = e[rng.randint(2)]
            if cand in alive_set:
                return cand
        return alive[rng.randint(len(alive))]

    for _ in range(4):
        add_node()

    while len(ts) < n_events:
        r = rng.rand()
        if len(alive) < n_nodes_hint and r < 0.25:
            add_node()
            # connect the newcomer preferentially
            u = alive[-1]
            for _ in range(min(1 + rng.poisson(1.0), len(alive) - 1)):
                v = pick_node()
                if v == u:
                    continue
                a, b = min(u, v), max(u, v)
                if (a, b) not in edges:
                    edges.add((a, b))
                    edge_list.append((a, b))
                    deg[a] += 1
                    deg[b] += 1
                    emit(EDGE_ADD, a, b, val=int(rng.randint(1, 8)))
        elif r < 0.25 + p_edge_del and edges:
            i = rng.randint(len(edge_list))
            a, b = edge_list[i]
            if (a, b) in edges:
                edges.discard((a, b))
                deg[a] -= 1
                deg[b] -= 1
                emit(EDGE_DEL, a, b)
        elif r < 0.25 + p_edge_del + p_nattr and alive:
            u = pick_node()
            emit(NATTR_SET, u, key=int(rng.randint(n_attr_keys)),
                 val=int(rng.randint(n_labels)))
        elif r < 0.25 + p_edge_del + p_nattr + p_eattr and edge_list:
            i = rng.randint(len(edge_list))
            a, b = edge_list[i]
            if (a, b) in edges:
                emit(EATTR_SET, a, b, key=0, val=int(rng.randint(1, 8)))
        elif r < 0.25 + p_edge_del + p_nattr + p_eattr + p_node_del and len(alive) > 8:
            # delete an isolated-ish node (edges first)
            u = alive[rng.randint(len(alive))]
            incident = [(a, b) for (a, b) in list(edges) if a == u or b == u]
            for a, b in incident:
                edges.discard((a, b))
                deg[a] -= 1
                deg[b] -= 1
                emit(EDGE_DEL, a, b)
            alive.remove(u)
            alive_set.discard(u)
            emit(NODE_DEL, u)
        else:
            # add an edge between existing nodes
            if len(alive) >= 2:
                u, v = pick_node(), pick_node()
                if u != v:
                    a, b = min(u, v), max(u, v)
                    if (a, b) not in edges:
                        edges.add((a, b))
                        edge_list.append((a, b))
                        deg[a] += 1
                        deg[b] += 1
                        emit(EDGE_ADD, a, b, val=int(rng.randint(1, 8)))

    return EventLog.from_arrays(
        ts[:n_events], kinds[:n_events], srcs[:n_events], dsts[:n_events],
        keys[:n_events], vals[:n_events], sort=True
    )


def naive_state_at(events: EventLog, t: int, n_attrs: int = 4):
    """Oracle: full replay to time t (the Log approach, paper §2)."""
    from repro_torch.core.snapshot import GraphState

    g = GraphState.empty(events.n_nodes, n_attrs)
    ev = events.up_to(t)
    # strict chronological replay, one timestamp at a time
    if len(ev):
        bounds = np.r_[0, np.nonzero(np.diff(ev.t))[0] + 1, len(ev)]
        for i in range(len(bounds) - 1):
            g.apply_bucket(ev.take(slice(int(bounds[i]), int(bounds[i + 1]))))
    return g
