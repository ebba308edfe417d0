"""The port's read path as a whole against the reference: one seeded
event stream built into both packages under the same TGIConfig gives
byte-identical TGI2 blocks, equal snapshots with the kernel folds on,
and equal query results and notes through ``nodes()``/``subgraphs()``
on the CPU."""
import dataclasses
import re

import numpy as np
import pytest

from repro.core.tgi import TGIConfig as RefConfig
from repro.data.temporal_graph_gen import generate
from repro.taf import HistoricalGraphStore as RefStore
from repro.taf import compile as ref_tc
from repro_torch import carry
from repro_torch.core.tgi import TGIConfig
from repro_torch.taf import HistoricalGraphStore
from repro_torch.taf import compile as tc

CFG = dict(n_shards=2, parts_per_shard=2, events_per_span=800,
           eventlist_size=128, checkpoints_per_span=2)


@pytest.fixture(scope="module")
def stores():
    ev = generate(3000, seed=5)
    port_ev = carry.eventlog_from_arrays(
        {f.name: getattr(ev, f.name) for f in dataclasses.fields(ev)})
    ref = RefStore.build(ev, RefConfig(**CFG))
    port = HistoricalGraphStore.build(port_ev, TGIConfig(**CFG), device="cpu")
    return ref, port


def _blocks(store):
    return {tuple(k): v for node in store.store._mem for k, v in node.items()}


def _same_state(a, b):
    assert len(a.present) == len(b.present)
    np.testing.assert_array_equal(a.present, b.present)
    np.testing.assert_array_equal(a.attrs, b.attrs)
    np.testing.assert_array_equal(a.edge_key, b.edge_key)
    np.testing.assert_array_equal(a.edge_val, b.edge_val)


def _times(store, T):
    lo, hi = store.time_range()
    return np.linspace(lo + (hi - lo) // 3, hi, T).astype(np.int64)


def test_blocks_byte_identical(stores):
    ref, port = stores
    want, got = _blocks(ref), _blocks(port)
    assert got.keys() == want.keys() and len(got) > 10
    for k in want:
        assert got[k] == want[k], k


def test_snapshot_kernel_fold_matches_reference(stores):
    ref, port = stores
    for t in _times(port, 3):
        _same_state(port.snapshot(int(t), use_kernel=True),
                    ref.snapshot(int(t), use_kernel=True))


def test_snapshots_kernel_fold_matches_reference(stores):
    """Batched Algorithm 1 with the time-batched kernel fold == the
    reference's batched fold (host) and its per-t kernel fold."""
    ref, port = stores
    ts = _times(port, 24)
    port.tgi.invalidate_caches()  # no snapshot-LRU hits from other tests
    got = port.snapshots(ts, use_kernel=True)
    for g, w in zip(got, ref.snapshots(ts, use_kernel=False)):
        _same_state(g, w)
    for j in (0, 11, 23):
        _same_state(got[j], ref.snapshot(int(ts[j]), use_kernel=True))


def test_snapshots_kernel_fold_of_one_wide_group(stores):
    """Some 300 timepoints inside one checkpoint window fold as one group
    of some 300 layers; the kernel fold == the reference's host fold."""
    ref, port = stores
    si = port.tgi.spans[len(port.tgi.spans) // 2]
    ts = np.unique(np.linspace(si.checkpoint_ts[0] + 1, si.checkpoint_ts[1] - 1,
                               300).astype(np.int64))
    assert len(ts) > 250
    port.tgi.invalidate_caches()
    for g, w in zip(port.snapshots(ts, use_kernel=True),
                    ref.snapshots(ts, use_kernel=False)):
        _same_state(g, w)


def test_reference_batched_kernel_fold_takes_the_wrong_axis(stores):
    """The reference's ``_fold_group`` kernel branch slices the
    (P, S, T, K) attrs with ``[..., j]`` (the K axis): past T > K it
    raises.  The port slices axis 2; this pins the reference's fault."""
    ref, port = stores
    ts = _times(port, 24)
    with pytest.raises(IndexError):
        ref.snapshots(ts, use_kernel=True)
    assert len(port.snapshots(ts, use_kernel=True)) == len(ts)


def _queries(m, store, ts, t0, t1):
    return [
        store.nodes(t0, t1).timeslice(list(ts)),
        store.nodes(t0, t1).timeslice([int(ts[3]), int(ts[9])]),
        store.nodes(t0, t1).filter(node_ids=range(0, 400, 3)).timeslice(list(ts)),
        store.subgraphs(t0, t1).node_compute(m.components(iters=12),
                                             style="temporal", points=ts),
        store.subgraphs(t0, t1).node_compute(m.triangles(), style="temporal",
                                             points=ts),
        store.subgraphs(t0, t1).evolution(m.component_count(iters=12),
                                          points=ts),
        store.subgraphs(t0, t1).node_compute(m.pagerank(iters=8),
                                             style="temporal", points=ts),
    ]


def test_queries_match_reference_values_and_notes(stores):
    ref, port = stores
    lo, hi = port.time_range()
    t0, t1 = lo + (hi - lo) // 3, hi
    ts = np.linspace(t0, t1 - 1, 20).astype(np.int64)
    tc.clear_cache()
    ref_tc.clear_cache()
    got = [q.run() for q in _queries(tc, port, ts, t0, t1)]
    want = [q.run() for q in _queries(ref_tc, ref, ts, t0, t1)]
    def notes(r):  # the read-epoch counter also counts other tests' reads
        return [re.sub(r"read epoch \d+", "read epoch", n) for n in r.notes]

    for i, (g, w) in enumerate(zip(got, want)):
        assert notes(g) == notes(w), (i, g.notes, w.notes)
        if isinstance(w.value, dict):
            for k in w.value:
                np.testing.assert_array_equal(g.value[k], w.value[k])
                assert g.value[k].dtype == w.value[k].dtype
        elif i == len(got) - 1:  # pagerank: f32 device vs f32 device
            np.testing.assert_allclose(g.value[1], w.value[1], atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(g.value[0], w.value[0])
            np.testing.assert_array_equal(g.value[1], w.value[1])
    assert any("fused compute[triangles]" in n for n in got[4].notes)
    assert any("staged slice" in n for n in got[1].notes)
