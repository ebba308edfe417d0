"""repro_torch plan compiler vs the reference: every fused terminal stage
(slice, the three FusedOps, each FusedScalarOp evolution, an aggregate
epilogue) on one seeded SoTS carried across with ``carry``, run fused by
both packages on the CPU.  Integer outputs are bit-identical with equal
dtypes; PageRank agrees within the reference's documented f32/f64
tolerance (1e-5).  Also: the port's own fused == staged, zero re-traces
on a repeated plan shape, and the device rules of the entry points."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.taf import TemporalQuery as RefQuery
from repro.taf import compile as ref_tc
from repro_torch import carry
from repro_torch.core.tgi import TGI, TGIConfig
from repro_torch.data.temporal_graph_gen import generate
from repro_torch.storage.kvstore import DeltaStore
from repro_torch.taf import HistoricalGraphStore, TemporalQuery
from repro_torch.taf import compile as tc
from repro_torch.taf.plan import PlanExecutor

from tests.test_replay import random_sots


def _carried(ref_sots):
    return carry.sots_from_arrays(
        {f.name: getattr(ref_sots, f.name) for f in dataclasses.fields(ref_sots)})


def _pair(seed, N=None, T=18):
    rng = np.random.RandomState(seed)
    ref_sots = random_sots(rng, N=N or rng.randint(4, 14))
    ts = np.sort(rng.randint(0, 41, size=T)).astype(np.int64)
    return ref_sots, _carried(ref_sots), ts


def _run_both(ref_sots, sots, build):
    """``build(query, compile_module)`` extends each package's query."""
    got = build(TemporalQuery.over(sots, device="cpu"), tc).run()
    want = build(RefQuery.over(ref_sots), ref_tc).run()
    assert any("compile: fused" in n for n in got.notes), got.notes
    assert any("compile: fused" in n for n in want.notes), want.notes
    return got.value, want.value


def _exact(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_fused_slice_matches_reference(seed):
    ref_sots, sots, ts = _pair(seed, T=24)
    got, want = _run_both(ref_sots, sots, lambda q, m: q.timeslice(list(ts)))
    for k in ("present", "attrs", "t"):
        _exact(got[k], want[k])


@pytest.mark.parametrize("seed,op", [(200, "components"), (201, "components"),
                                     (300, "triangles"), (301, "triangles")])
def test_fused_integer_compute_matches_reference(seed, op):
    ref_sots, sots, ts = _pair(seed)
    kw = {"components": {"iters": 12}, "triangles": {}}[op]
    got, want = _run_both(ref_sots, sots, lambda q, m: q.node_compute(
        getattr(m, op)(**kw), style="temporal", points=ts))
    _exact(got[0], want[0])
    _exact(got[1], want[1])


@pytest.mark.parametrize("seed", [100, 101])
def test_fused_pagerank_matches_reference(seed):
    ref_sots, sots, ts = _pair(seed)
    got, want = _run_both(ref_sots, sots, lambda q, m: q.node_compute(
        m.pagerank(iters=8), style="temporal", points=ts))
    _exact(got[0], want[0])
    assert got[1].dtype == want[1].dtype
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("name,exact", [("triangle_count", True),
                                        ("component_count", True),
                                        ("max_pagerank", False)])
def test_fused_evolution_matches_reference(name, exact):
    ref_sots, sots, ts = _pair(7, N=10)
    got, want = _run_both(ref_sots, sots, lambda q, m: q.evolution(
        getattr(m, name)(), points=ts))
    _exact(got[0], want[0])
    if exact:
        _exact(got[1], want[1])
    else:
        np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("agg", ["max", "min", "mean", "sum", "std"])
def test_fused_aggregate_matches_reference(agg):
    ref_sots, sots, ts = _pair(9, N=10)
    got, want = _run_both(ref_sots, sots, lambda q, m: q.node_compute(
        m.components(iters=12), style="temporal", points=ts).aggregate(agg))
    _exact(got, want)


@pytest.mark.parametrize("op", ["components", "triangles"])
def test_port_fused_matches_port_staged(op):
    _, sots, ts = _pair(8, N=12)
    q = TemporalQuery.over(sots, device="cpu").node_compute(
        getattr(tc, op)(), style="temporal", points=ts)
    fused = q.run()
    with tc.disabled():
        staged = q.run()
    assert any("staged" in n for n in staged.notes), staged.notes
    _exact(fused.value[1], staged.value[1])


def test_repeated_plan_shape_builds_no_new_program():
    _, sots, ts = _pair(10, N=10, T=20)
    q = TemporalQuery.over(sots, device="cpu").node_compute(
        tc.pagerank(iters=6), style="temporal", points=ts)
    first = q.run()
    traces0 = tc.STATS["traces"]
    ts2 = np.minimum(ts + 1, sots.t1).astype(np.int64)
    second = TemporalQuery.over(sots, device="cpu").node_compute(
        tc.pagerank(iters=6), style="temporal", points=ts2).run()
    assert tc.STATS["traces"] == traces0
    assert any("cache hit" in n for n in second.notes), second.notes
    assert any("traced" in n or "cache hit" in n for n in first.notes)


def test_kernel_style_is_a_later_slice():
    """style="kernel" (ported after the first slice, in taf/exec.py) runs
    staged, outside the plan compiler, and matches the reference."""
    from repro.taf import exec as ref_exec
    from repro_torch.taf import exec as taf_exec

    ref_sots, sots, ts = _pair(11, N=6)
    patched = taf_exec.with_init_degree(sots)
    ref_patched = dataclasses.replace(ref_sots, init_attrs=patched.init_attrs.copy())
    got = TemporalQuery.over(patched, device="cpu").node_compute(
        taf_exec.degree_series_kernel(ts), style="kernel").run()
    want = RefQuery.over(ref_patched).node_compute(
        ref_exec.degree_series_kernel(ts), style="kernel").run()
    assert any("staged compute" in n for n in got.notes), got.notes
    _exact(got.value, np.asarray(want.value))


def _entry_points():
    _, sots, ts = _pair(12, N=6, T=20)
    events = generate(200, seed=3)
    return {
        "TemporalQuery.over": lambda: TemporalQuery.over(sots).timeslice(
            list(ts)).run(),
        "HistoricalGraphStore.build": lambda: HistoricalGraphStore.build(events),
        "TGI": lambda: TGI(TGIConfig(), DeltaStore(m=1, r=1)),
        "PlanExecutor": lambda: PlanExecutor(),
    }


@pytest.mark.parametrize("entry", ["TemporalQuery.over",
                                   "HistoricalGraphStore.build", "TGI",
                                   "PlanExecutor"])
def test_no_card_and_no_device_raises(monkeypatch, entry):
    """Without a card, an entry point called without device= raises: no
    path falls back to the CPU behind the caller's back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[entry]()
