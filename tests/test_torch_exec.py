"""repro_torch.taf.exec vs the reference's exec on the CPU: the degree
kernels (one timepoint and time-batched) bit for bit on seeded operands
and on a small store, the device-operand cache counts, the kernels'
compile keys, style="kernel" through TemporalQuery, the worker padding
rule, the mesh guard, and the dense analytics kernels on the dense stack
of a store's subgraphs against the fused ops they are the dense form of
(components bit for bit, PageRank within 1e-5)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data.temporal_graph_gen import generate
from repro.taf import HistoricalGraphStore as RefStore
from repro.taf import TemporalQuery as RefQuery
from repro.taf import exec as ref_exec
from repro_torch import carry
from repro_torch.kernels.temporal_cc import ops as cc_ops
from repro_torch.kernels.temporal_pagerank import ops as pr_ops
from repro_torch.taf import HistoricalGraphStore, TemporalQuery, replay
from repro_torch.taf import compile as tc
from repro_torch.taf import exec as taf_exec

from tests.test_replay import random_sots


def _pair(seed, N=None):
    rng = np.random.RandomState(seed)
    ref_sots = random_sots(rng, N=N or rng.randint(4, 14))
    return ref_sots, carry.sots_from_arrays(
        {f.name: getattr(ref_sots, f.name) for f in dataclasses.fields(ref_sots)})


def _exact(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def stores():
    ev = generate(2000, seed=9)
    port_ev = carry.eventlog_from_arrays(
        {f.name: getattr(ev, f.name) for f in dataclasses.fields(ev)})
    cfg = dict(n_shards=2, parts_per_shard=2, events_per_span=600)
    ref = RefStore.build(ev, **cfg)
    port = HistoricalGraphStore.build(port_ev, device="cpu", **cfg)
    lo, hi = port.time_range()
    return ref, port, lo + (hi - lo) // 2, hi


@pytest.mark.parametrize("seed", [20, 21, 22])
def test_degree_at_matches_reference(seed):
    ref_sots, sots = _pair(seed)
    for t in (0, 17, 40):
        _exact(taf_exec.sharded_degree_at(sots, t, device="cpu"),
               np.asarray(ref_exec.sharded_degree_at(ref_sots, t)))


@pytest.mark.parametrize("seed", [23, 24])
def test_degree_series_matches_reference(seed):
    ref_sots, sots = _pair(seed)
    ts = np.array([0, 3, 3, 11, 25, 39, 40], np.int64)
    _exact(taf_exec.sharded_degree_series(sots, ts, device="cpu"),
           np.asarray(ref_exec.sharded_degree_series(ref_sots, ts)))


def test_degree_on_a_store_matches_reference_and_host_replay(stores):
    ref, port, t0, t1 = stores
    ref_sots = ref.subgraphs(t0, t1).materialize().operand
    sots = port.subgraphs(t0, t1).materialize().operand
    ts = np.linspace(t0, t1, 6).astype(np.int64)
    got = taf_exec.sharded_degree_series(sots, ts, device="cpu")
    _exact(got, np.asarray(ref_exec.sharded_degree_series(ref_sots, ts)))
    _exact(taf_exec.sharded_degree_at(sots, int(ts[2]), device="cpu"),
           np.asarray(ref_exec.sharded_degree_at(ref_sots, int(ts[2]))))
    on = sots.init_present == 1
    np.testing.assert_array_equal(got[on], replay.degree_series(sots, ts)[on])
    np.testing.assert_array_equal(got[:, 2], taf_exec.sharded_degree_at(
        sots, int(ts[2]), device="cpu"))


def test_operand_cache_counts_as_the_reference():
    """tests/test_compile.py's memoization test, replayed on the port:
    each sharded_degree_series call patches a fresh operand and uploads
    it once; re-running a kernel over the same operand is a cache hit."""
    _, sots = _pair(15, N=9)
    ts = tuple(range(0, 12, 3))
    before = dict(taf_exec.STATS)
    d1 = taf_exec.sharded_degree_series(sots, ts, device="cpu")
    mid = dict(taf_exec.STATS)
    d2 = taf_exec.sharded_degree_series(sots, ts, device="cpu")
    after = dict(taf_exec.STATS)
    np.testing.assert_array_equal(d1, d2)
    assert mid["operand_transfers"] == before["operand_transfers"] + 1
    assert after["operand_transfers"] == mid["operand_transfers"] + 1
    patched = taf_exec.with_init_degree(sots)
    k = taf_exec.degree_at_kernel(5)
    taf_exec.sharded_node_compute(patched, k, device="cpu")
    base = dict(taf_exec.STATS)
    taf_exec.sharded_node_compute(patched, taf_exec.degree_series_kernel(ts),
                                  device="cpu")
    assert taf_exec.STATS["operand_cache_hits"] == base["operand_cache_hits"] + 1
    assert taf_exec.STATS["operand_transfers"] == base["operand_transfers"]
    taf_exec.clear_device_caches()
    taf_exec.sharded_node_compute(patched, k, device="cpu")
    assert taf_exec.STATS["operand_transfers"] == base["operand_transfers"] + 1


def test_compile_keys_equal_the_reference():
    for port_k, ref_k in [
            (taf_exec.degree_series_kernel([1, 2, 3]),
             ref_exec.degree_series_kernel([1, 2, 3])),
            (taf_exec.degree_at_kernel(7), ref_exec.degree_at_kernel(7))]:
        assert port_k.compile_key == ref_k.compile_key
    k1, k2 = (taf_exec.degree_series_kernel(np.array([1, 2, 3])) for _ in range(2))
    assert k1 is not k2 and k1.compile_key == k2.compile_key
    assert taf_exec.degree_at_kernel(7).compile_key == ("degree_at", 7)


def test_kernel_style_through_temporal_query():
    ref_sots, sots = _pair(30, N=11)
    patched = taf_exec.with_init_degree(sots)
    ref_patched = dataclasses.replace(ref_sots, init_attrs=patched.init_attrs.copy())
    q = TemporalQuery.over(patched, device="cpu").node_compute(
        taf_exec.degree_at_kernel(20), style="kernel", label="deg")
    assert "Compute[deg, style=kernel, backend=torch]" in q.explain()
    result = q.run()
    assert any("style='kernel'" in n for n in result.notes), result.notes
    want = (RefQuery.over(ref_patched)
            .node_compute(ref_exec.degree_at_kernel(20), style="kernel").execute())
    _exact(result.value, np.asarray(want))


def test_padding_rows_carry_absent_and_are_cut(monkeypatch):
    """With more workers than one, the node axis is padded with present
    = -1 rows, which the kernel sees and the result drops."""
    _, sots = _pair(31, N=7)
    seen = {}

    def kernel(present, attrs, ev_t, ev_kind, ev_val):
        seen["present"] = present.clone()
        return present * 10

    monkeypatch.setattr(taf_exec, "WORKERS", 4)
    taf_exec.clear_device_caches()
    out = taf_exec.sharded_node_compute(sots, kernel, device="cpu")
    taf_exec.clear_device_caches()
    assert seen["present"].shape == (8,) and int(seen["present"][-1]) == -1
    np.testing.assert_array_equal(out, sots.init_present.astype(np.int32) * 10)


def test_fourth_positional_argument_is_the_references_extra_args():
    """The reference's slots are (son, kernel, mesh, extra_args): a fourth
    positional argument is accepted and ignored, and never taken as the
    device."""
    ref_sots, sots = _pair(33, N=8)
    patched = taf_exec.with_init_degree(sots)
    ref_patched = dataclasses.replace(ref_sots, init_attrs=patched.init_attrs.copy())
    k = taf_exec.degree_at_kernel(12)
    want = taf_exec.sharded_node_compute(patched, k, device="cpu")
    got = taf_exec.sharded_node_compute(patched, k, None, {}, device="cpu")
    _exact(got, want)
    _exact(got, np.asarray(ref_exec.sharded_node_compute(
        ref_patched, ref_exec.degree_at_kernel(12), None, {})))


def test_mesh_other_than_none_raises():
    """A mesh other than None must be a ("workers",) DeviceMesh; the
    sharded path itself runs in tests/test_torch_distributed.py."""
    _, sots = _pair(32, N=5)
    with pytest.raises(ValueError, match="workers"):
        taf_exec.sharded_degree_at(sots, 3, mesh=object(), device="cpu")


def test_parallel_fetch_is_a_deprecated_shim(stores):
    _, port, t0, t1 = stores
    with pytest.warns(DeprecationWarning):
        son = taf_exec.parallel_fetch(port.tgi, t0, t1)
    assert len(son) == len(port.nodes(t0, t1).materialize().operand)


def test_dense_kernels_match_the_fused_ops(stores):
    """The dense stack of a store's subgraphs (live edges only, both
    endpoints present) through temporal_cc / temporal_pagerank equals the
    fused components (bit for bit) and pagerank (within 1e-5) plans."""
    _, port, t0, t1 = stores
    sots = port.subgraphs(t0, t1).filter(node_ids=range(120)).materialize().operand
    ts = np.linspace(t0, t1 - 1, 16).astype(np.int64)
    adj, active = tc.dense_stack(sots, ts, device="cpu")
    assert adj.shape == (16, len(sots), len(sots)) and active.shape == (16, len(sots))
    assert torch.equal(adj, adj.transpose(1, 2)) and adj.sum() > 0

    def fused(op):
        q = TemporalQuery.over(sots, device="cpu").node_compute(
            op, style="temporal", points=ts)
        return q.execute()[1]

    labels = cc_ops.temporal_cc(adj, active).numpy().T
    np.testing.assert_array_equal(labels, fused(tc.components()).astype(np.int32))
    ranks = pr_ops.temporal_pagerank(adj, active).numpy().T
    np.testing.assert_allclose(ranks, fused(tc.pagerank()), atol=1e-5, rtol=0)
