"""Temporal analytics on the PyTorch port, through the unified query
surface: community comparison (paper Fig 7b), evolution + temporal
aggregation (7c), the incremental-vs-version computation pair (Fig 8 /
17), PageRank over time, and the planner's fetch pushdown.

The same steps and printed lines as ``examples/temporal_analytics.py``,
on ``repro_torch``: the chain is lazy, compiles to a typed Plan (see
.explain()), and the executor applies partition pruning + projection
before touching storage.  Node computes and PageRank run on the host, as
the reference's; the store's device runs the fused plans.  ``--device``
defaults to the CUDA card and raises without one.

  PYTHONPATH=src python examples/temporal_analytics_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.core.events import EDGE_ADD, EDGE_DEL
from repro_torch.data.temporal_graph_gen import generate
from repro_torch.device import resolve
from repro_torch.storage.kvstore import DeltaStore
from repro_torch.taf import HistoricalGraphStore, analytics, operators as ops


def deg_init(present, attrs, son, i, init):
    deg = son.adj_indptr[i + 1] - son.adj_indptr[i]
    return None, float(deg if present else 0)


def deg_delta(aux, val, kind, key, val_, other, i, son):
    if kind == EDGE_ADD:
        return aux, val + 1.0
    if kind == EDGE_DEL:
        return aux, val - 1.0
    return aux, val


def density(son, t):
    g = ops.graph(son, t)
    n = int(g.present.sum())
    e = len(g.edge_key)
    return 0.0 if n < 2 else 2.0 * e / (n * (n - 1))


def main(device=None, n_events: int = 10_000, seed: int = 1) -> dict:
    """Run the analytics tour on ``device``; returns the values behind
    every printed line."""
    dev = resolve(device)  # no card and no device given: raise before any work
    events = generate(n_events=n_events, seed=seed)
    store = HistoricalGraphStore.build(
        events, n_shards=4, parts_per_shard=2, events_per_span=2_500,
        store=DeltaStore(m=4, r=1, backend="mem"), device=dev)
    t0g, t1g = store.time_range()

    t0 = int(t0g + 0.3 * (t1g - t0g))
    t1 = int(t0g + 0.9 * (t1g - t0g))
    tm = (t0 + t1) // 2

    # one fetch, many computes: materialize the SoTS operand once
    q = store.subgraphs(t0, t1).materialize()
    sots = q.operand
    sots_deltas = store.last_cost.n_deltas
    print(f"SoTS: {len(sots)} temporal nodes over ({t0}, {t1}] "
          f"({sots_deltas} deltas fetched)")

    # --- compare two "communities" (label-0 vs label-1 nodes), Fig 7b style
    communities = {}
    for name, label in (("A", 0), ("B", 1)):
        com = (q.filter(lambda s, _l=label: s.init_attrs[:, 0] == _l,
                        label=f"attr0=={label}")
                .timeslice(tm)
                .node_compute(deg_init, style="delta", f_delta=deg_delta,
                              label="degree"))
        r = com.run()
        deg = r.value[1][:, 0]
        on = r.operand.init_present == 1
        communities[name] = (len(r.operand), float(deg[on].mean()))
        print(f"community {name} ({len(r.operand)} nodes) "
              f"mean degree @tm: {deg[on].mean():.2f}")
    explain = com.explain()
    print(explain)

    # --- evolution + temporal aggregation (Fig 7c + operator 9)
    pts, dens = q.evolution(density, n_samples=10).execute()
    peak = ops.temp_aggregate(dens, "peak", pts)
    mean = ops.temp_aggregate(dens, "mean")
    print("density peak timepoints:", peak)
    print("density mean:", f"{mean:.5f}")

    # --- incremental vs per-version computation (Fig 8 / Fig 17)
    label = int(np.bincount(sots.init_attrs[:, 0][sots.init_attrs[:, 0] >= 0]).argmax())
    lpts = sots.change_points()[::4][:64]
    w0 = time.perf_counter()
    _, a = analytics.label_count_temporal(sots, label, points=lpts, device=dev)
    t_temporal = time.perf_counter() - w0
    w0 = time.perf_counter()
    _, b = analytics.label_count_delta(sots, label, points=lpts, device=dev)
    t_delta = time.perf_counter() - w0
    on = sots.init_present == 1
    assert np.allclose(a[on], b[on])
    print(f"label-count over {len(lpts)} versions: "
          f"NodeComputeTemporal {t_temporal*1e3:.0f}ms vs "
          f"NodeComputeDelta {t_delta*1e3:.0f}ms "
          f"({t_temporal / max(t_delta, 1e-9):.1f}x)")

    # --- fetch pushdown: a selective query reads fewer shards + no attrs
    full_cost = store.nodes(t0, t1).run().cost
    hub = int(sots.node_ids[np.argmax(np.diff(sots.adj_indptr))])
    sel = (store.nodes(t0, t1)
           .filter(node_ids=[hub])
           .khop(1)
           .project(attrs=False)
           .timeslice(tm)
           .node_compute(deg_init, style="delta", f_delta=deg_delta))
    r = sel.run()
    print(f"pushdown: hub degree @tm = {r.value[1][0, 0]:.0f} via "
          f"{r.cost.n_deltas} deltas / {r.cost.n_bytes}B "
          f"(full fetch: {full_cost.n_deltas} deltas / {full_cost.n_bytes}B)")

    # --- PageRank over time with warm starts
    ppts = np.linspace(t0, t1, 6).astype(np.int64)
    ranks, iters = analytics.pagerank_over_time(sots, ppts, warm_start=True)
    _, iters_cold = analytics.pagerank_over_time(sots, ppts, warm_start=False)
    top = sorted(ranks[-1], key=ranks[-1].get)[-3:]
    print(f"top-3 PageRank at t1: {top}; warm-start iterations {iters} "
          f"vs cold {iters_cold}")
    return dict(t0=t0, t1=t1, tm=tm, n_sots=len(sots), sots_deltas=int(sots_deltas),
                communities=communities, explain=explain, dens_pts=np.asarray(pts),
                dens=np.asarray(dens, np.float64), peak=peak, mean=float(mean), label=label,
                label_points=np.asarray(lpts), a=np.asarray(a), b=np.asarray(b), hub=hub,
                hub_degree=float(r.value[1][0, 0]), pushdown=(int(r.cost.n_deltas),
                                                              int(r.cost.n_bytes)),
                full_fetch=(int(full_cost.n_deltas), int(full_cost.n_bytes)), ranks=ranks,
                top=top, iters=list(iters), iters_cold=list(iters_cold))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    main(ap.parse_args().device)
