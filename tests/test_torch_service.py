"""The port's service plane against the reference's: one seeded event
stream built into a port ``HistoricalGraphStore`` over a port
``LocalCluster`` and into the reference's over its own (3 cells, r=2,
file backend) gives the same snapshots, with the port's fold on the host
and through its kernel wrapper (``device="cpu"``: the plain version),
the same query results, and byte-identical chunk and extent files in
every cell.  Subprocess cells run ``repro_torch.service.cell``, and a
read with one cell SIGKILLed still serves every key through failover.
No test here bounds a time: ``timeout`` markers only guard against a
hang."""
import dataclasses
import hashlib
from pathlib import Path

import numpy as np
import pytest

from repro.core.tgi import TGIConfig as RefConfig
from repro.data.temporal_graph_gen import generate
from repro.service import ClusterSpec as RefSpec
from repro.service import LocalCluster as RefCluster
from repro.service import stress as ref_stress
from repro.taf import HistoricalGraphStore as RefStore
from repro.taf import compile as ref_tc
from repro_torch import carry
from repro_torch.core.tgi import TGIConfig
from repro_torch.service import ClusterSpec, LocalCluster, stress
from repro_torch.service.cluster import CELL_MODULE
from repro_torch.storage.kvstore import DeltaKey
from repro_torch.taf import HistoricalGraphStore
from repro_torch.taf import compile as tc

# the reference's own cluster parity config (tests/test_service.py)
CFG = dict(n_shards=3, parts_per_shard=2, events_per_span=900,
           eventlist_size=128, checkpoints_per_span=4)


def _port_events(ev):
    return carry.eventlog_from_arrays(
        {f.name: getattr(ev, f.name) for f in dataclasses.fields(ev)})


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """(reference store, port store, reference root, port root): both
    built from ``generate(2500, seed=11)`` over thread-mode clusters of
    3 file-backed cells, r=2."""
    root = tmp_path_factory.mktemp("service")
    ev = generate(2500, seed=11)
    with RefCluster(RefSpec(n_cells=3, r=2, backend="file", root=str(root / "ref")),
                    mode="thread") as rc, \
            LocalCluster(ClusterSpec(n_cells=3, r=2, backend="file",
                                     root=str(root / "port")), mode="thread") as pc:
        ref = RefStore.build(ev, RefConfig(**CFG), store=rc.client(timeout=5.0))
        port = HistoricalGraphStore.build(_port_events(ev), TGIConfig(**CFG),
                                          store=pc.client(timeout=5.0), device="cpu")
        yield ref, port, root / "ref", root / "port"
        ref.store.close()
        port.store.close()


def _times(store, n=5):
    lo, hi = store.time_range()
    return [int(lo + f * (hi - lo)) for f in np.linspace(0.1, 1.0, n)]


def _same_state(got, want):
    n = max(len(got.present), len(want.present))
    got.grow(n)
    want.grow(n)
    np.testing.assert_array_equal(got.present, want.present)
    on = want.present == 1
    np.testing.assert_array_equal(got.attrs[on], want.attrs[on])
    np.testing.assert_array_equal(got.edge_key, want.edge_key)
    np.testing.assert_array_equal(got.edge_val, want.edge_val)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("use_kernel", [False, True], ids=["host fold", "kernel fold"])
def test_wire_snapshot_matches_reference_cluster(clusters, use_kernel):
    ref, port, _, _ = clusters
    assert port.store.backend == "remote" and port.tgi.device.type == "cpu"
    for t in _times(port):
        port.tgi.invalidate_caches()  # the snapshot LRU ignores use_kernel
        _same_state(port.tgi.get_snapshot(t, c=4, use_kernel=use_kernel),
                    ref.tgi.get_snapshot(t, c=4))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("use_kernel", [False, True], ids=["host fold", "kernel fold"])
def test_wire_snapshots_match_reference_cluster(clusters, use_kernel):
    ref, port, _, _ = clusters
    lo, hi = port.time_range()
    ts = np.linspace(lo + (hi - lo) // 4, hi, 24).astype(np.int64)
    port.tgi.invalidate_caches()
    got = port.tgi.get_snapshots(ts, c=4, use_kernel=use_kernel)
    want = ref.tgi.get_snapshots(ts, c=4)
    assert len(got) == len(want) == len(ts)
    for g, w in zip(got, want):
        _same_state(g, w)


@pytest.mark.timeout(120)
def test_wire_queries_match_reference_cluster(clusters):
    """``density_evolution`` and a fused ``components`` plan over the
    wire, port against reference."""
    ref, port, _, _ = clusters
    lo, hi = port.time_range()
    t0 = lo + (hi - lo) // 3  # a subgraph operand's members are those at t0
    density = port.density_evolution(t0, hi, n_samples=4)
    for g, w in zip(density, ref.density_evolution(t0, hi, n_samples=4)):
        np.testing.assert_array_equal(g, w)
    assert (density[1] > 0).all()
    ts = np.linspace(t0, hi - 1, 16).astype(np.int64)
    got = port.subgraphs(t0, hi).node_compute(tc.components(), style="temporal",
                                              points=ts).run()
    want = ref.subgraphs(t0, hi).node_compute(ref_tc.components(), style="temporal",
                                              points=ts).run()
    assert any("compile: fused" in n for n in got.notes)
    np.testing.assert_array_equal(got.value[0], want.value[0])
    np.testing.assert_array_equal(got.value[1], want.value[1])
    assert len(np.unique(got.value[1])) > 1


def _digests(root: Path, suffixes=(".tgi", ".tgx")):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.suffix in suffixes}


@pytest.mark.timeout(120)
def test_cell_files_byte_identical_to_reference_cells(clusters):
    """Every cell's chunk (.tgi) and extent (.tgx) files, written over the
    wire by the port's client and cells, equal the reference's byte for
    byte."""
    _, _, ref_root, port_root = clusters
    want, got = _digests(ref_root), _digests(port_root)
    assert {Path(k).parts[0] for k in want} == {"cell0", "cell1", "cell2"}
    assert any(k.endswith(".tgi") for k in want) and any(k.endswith(".tgx") for k in want)
    assert got == want


def _fill(store):
    rng = np.random.RandomState(3)
    keys = [DeltaKey(t, s, "X:fill", p) for t in range(4) for s in range(3)
            for p in range(2)]
    for k in keys:
        store.put(k, {"t": np.arange(150, dtype=np.int64) * (k.tsid + 1),
                      "v": rng.randn(150).astype(np.float32)})
    return keys


@pytest.mark.timeout(120)
def test_subprocess_cells_are_the_ports_and_survive_a_kill(tmp_path):
    """Subprocess cells run the port's cell module.  With one cell
    SIGKILLed, every key is still read (through its surviving replica),
    the client counts failovers, and a snapshot rebuilt through the
    kernel wrapper is unchanged."""
    ev = generate(2500, seed=11)
    spec = ClusterSpec(n_cells=3, r=2, backend="file", root=str(tmp_path / "cluster"))
    with LocalCluster(spec, mode="subprocess") as cl:
        for proc in cl._procs:
            assert proc.args[1:3] == ["-m", CELL_MODULE]
        assert CELL_MODULE == "repro_torch.service.cell"
        store = cl.client(timeout=2.0, retries=1, backoff=0.02, suspect_ttl=30.0)
        keys = _fill(store)
        hs = HistoricalGraphStore.build(_port_events(ev), TGIConfig(**CFG), store=store,
                                        device="cpu")
        t = _times(hs)[2]
        before = hs.tgi.get_snapshot(t, c=4, use_kernel=True)
        cl.kill(0)
        store.clear_pool()
        hs.tgi.invalidate_caches()
        out = store.multiget(keys, c=4)
        assert sorted(out) == sorted(keys)
        for k in keys:
            assert out[k]["t"][1] == k.tsid + 1
        _same_state(hs.tgi.get_snapshot(t, c=4, use_kernel=True), before)
        assert store.stats.failovers > 0
        store.close()


@pytest.mark.parametrize("token", [0, 1, 16, 17, 1_000_003, 2**31 + 5])
def test_stress_payloads_match_reference(token):
    """The multi-writer stress client's keyspace and seeded payloads, and
    the exact bytes a writer fans out, are the reference's."""
    for slot in (0, 1, 7, token % 64):
        assert tuple(stress.key_for(slot)) == tuple(ref_stress.key_for(slot))
    got, want = stress.payload_arrays(token), ref_stress.payload_arrays(token)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])
    for fmt in (None, "TGI1"):
        assert stress.encode_token(stress.key_for(token % 64), token, fmt) == \
            ref_stress.encode_token(ref_stress.key_for(token % 64), token, fmt)
