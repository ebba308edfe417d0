"""Quickstart on the PyTorch port: index a synthetic history behind the
HistoricalGraphStore facade, run the paper's retrieval primitives, and
the Fig-7a analytics example through the lazy TemporalQuery surface.

The same steps and printed lines as ``examples/quickstart.py``, on
``repro_torch``.  Like the reference it folds snapshots on the host
(``use_kernel=False``); the store's device runs the fused plans, here
``density_evolution``'s.  ``--device`` defaults to the CUDA card and
raises without one; ``--device cpu`` runs the plain PyTorch versions.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.tgi import TGIConfig
from repro_torch.data.temporal_graph_gen import generate
from repro_torch.device import resolve
from repro_torch.storage.kvstore import DeltaStore
from repro_torch.taf import HistoricalGraphStore, analytics


def main(device=None, n_events: int = 20_000, seed: int = 42) -> dict:
    """Run the quickstart on ``device``; returns the values behind every
    printed line, the snapshot ``g`` and the 2-hop ``hood`` too."""
    dev = resolve(device)  # no card and no device given: raise before any work
    # 1. a synthetic temporal graph: 20k events, bursty + preferential
    events = generate(n_events=n_events, seed=seed)
    t0, t1 = events.time_range()
    print(f"history: {len(events)} events over [{t0}, {t1}], "
          f"{events.n_nodes} node ids")

    # 2. index it behind the facade: 4 horizontal shards x 2 micro-partitions,
    #    4 checkpoints per timespan, on an in-memory 4-node store with r=2
    cfg = TGIConfig(n_shards=4, parts_per_shard=2, events_per_span=5_000,
                    eventlist_size=256, checkpoints_per_span=4)
    kv = DeltaStore(m=4, r=2, backend="mem")
    store = HistoricalGraphStore.build(events, cfg=cfg, store=kv, device=dev)
    print(f"index: {len(store.tgi.spans)} timespans, "
          f"{kv.stats.bytes_written / 1e6:.1f} MB written")

    # 3. snapshot retrieval (Algorithm 1) — any point in the past
    t = (t0 + t1) // 2
    g = store.snapshot(t, c=4)
    n_deltas = store.last_cost.n_deltas
    print(f"snapshot@{t}: {int(g.present.sum())} nodes, {len(g.edge_key)} edges "
          f"({n_deltas} deltas fetched)")

    # 4. node history (Algorithm 2)
    hub = int(np.argmax(g.degree()))
    init, ev = store.node_history(hub, t, t1)
    print(f"node {hub} history: initial degree {len(init['neighbors'])}, "
          f"{len(ev)} change events in ({t}, {t1}]")

    # 5. k-hop neighborhood (Algorithm 3/4)
    hood = store.k_hop(hub, t, k=2)
    print(f"2-hop of {hub}: {int(hood.present.sum())} nodes, {len(hood.edge_key)} edges")

    # 6. survive a storage-node failure (replication r=2).  Drop the
    # snapshot LRU first so the read really hits storage, not the cache.
    kv.fail_node(0)
    store.tgi.invalidate_caches()
    g2 = store.snapshot(t, c=4)
    assert (g2.edge_key == g.edge_key).all()
    kv.heal_node(0)
    print(f"snapshot identical with node 0 down (failovers: {kv.stats.failovers})")

    # 7. TAF via the lazy query surface: fetch the SoTS operand once, then
    #    the paper's Fig-7a example + density evolution over it
    q = store.subgraphs(t, t1).materialize()
    nid, lcc = analytics.max_lcc(q.operand, t)
    print(f"max LCC at t={t}: node {nid} (LCC={lcc:.3f})")

    pts, dens = analytics.density_evolution(q.operand, n_samples=8, device=dev)
    print("density evolution:", ", ".join(f"{d:.4f}" for d in dens))
    return dict(n_events=len(events), t0=int(t0), t1=int(t1), n_node_ids=int(events.n_nodes),
                n_spans=len(store.tgi.spans), bytes_written=int(kv.stats.bytes_written),
                t=int(t), g=g, n_deltas=int(n_deltas), hub=hub,
                init_degree=len(init["neighbors"]), n_change_events=len(ev), hood=hood,
                failovers=int(kv.stats.failovers), nid=int(nid), lcc=float(lcc),
                pts=np.asarray(pts), dens=np.asarray(dens, np.float64))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    main(ap.parse_args().device)
