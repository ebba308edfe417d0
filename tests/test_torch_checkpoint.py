"""repro_torch's checkpoint store vs the reference's
(``tests/test_fault_tolerance.py`` mirrored on the port): exact round
trips through snapshot + XOR-delta chains, a delta save smaller than a
full one, restore with a storage node down, async = sync, the train
loop's crash/resume equivalence (12 steps straight against 8 + a resume
from the step-7 save, within rtol 1e-5); every chunk blob byte-identical
to the reference's for the same tree; tensor leaves (bfloat16 included)
put back on the example tree's devices and types; and the copied
elastic coordinator's plan equal to the reference's."""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro.launch.elastic import Coordinator as RefCoordinator
from repro.storage.checkpoint import CheckpointConfig as RefCkptConfig
from repro.storage.checkpoint import CheckpointStore as RefCkptStore
from repro.storage.kvstore import DeltaStore as RefDeltaStore
from repro_torch.launch.elastic import Coordinator, pipeline_seek
from repro_torch.launch.train import run
from repro_torch.storage.checkpoint import (
    CheckpointConfig,
    CheckpointStore,
    tree_flatten,
    tree_unflatten,
)
from repro_torch.storage.kvstore import DeltaStore


def _tree(seed, scale=1.0):
    """test_fault_tolerance._tree."""
    rng = np.random.RandomState(seed)
    return {
        "w": rng.randn(300, 170).astype(np.float32) * scale,
        "b": {"x": rng.randn(1000).astype(np.float32),
              "s": np.asarray(seed, np.int32)},
    }


def _trees_equal(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_checkpoint_roundtrip_exact():
    store = CheckpointStore(DeltaStore(m=4, r=2, backend="mem"),
                            CheckpointConfig(snapshot_every=3))
    trees = []
    for s in range(7):
        t = _tree(s)
        trees.append(t)
        store.save(s, t)
    for s in range(7):
        got, step = store.restore(step=s)
        assert step == s
        _trees_equal(got, trees[s])


def test_checkpoint_delta_chain_smaller_than_full():
    base = _tree(0)
    store = CheckpointStore(DeltaStore(m=2, r=1, backend="mem"),
                            CheckpointConfig(snapshot_every=100))
    store.save(0, base)
    b0 = store.store.stats.bytes_written
    leaves, treedef = tree_flatten(base)
    drift = tree_unflatten(treedef, [
        x + (np.random.RandomState(1).randn(*x.shape) * 1e-3).astype(x.dtype)
        if x.dtype == np.float32 else x for x in leaves])
    store.save(1, drift)
    b1 = store.store.stats.bytes_written - b0
    assert b1 < 0.8 * b0, (b1, b0)
    got, _ = store.restore(step=1)
    _trees_equal(got, drift)


def test_checkpoint_restore_with_node_failure():
    ds = DeltaStore(m=4, r=2, backend="mem")
    store = CheckpointStore(ds, CheckpointConfig(snapshot_every=2))
    trees = [_tree(s) for s in range(4)]
    for s, t in enumerate(trees):
        store.save(s, t)
    ds.fail_node(1)
    got, step = store.restore()
    assert step == 3
    _trees_equal(got, trees[3])
    assert ds.stats.failovers > 0


def test_async_save_matches_sync():
    store = CheckpointStore(DeltaStore(m=2, r=1, backend="mem"))
    t = _tree(5)
    store.save_async(0, t).result()
    got, _ = store.restore()
    _trees_equal(got, t)


def test_chunk_blobs_byte_identical_to_reference():
    """The same trees through both stores (a snapshot, then XOR deltas):
    every parameter block's stored bytes are the reference's; the
    manifests differ only in the ``treedef`` string."""
    ref = RefCkptStore(RefDeltaStore(m=4, r=2, backend="mem"), RefCkptConfig(snapshot_every=3))
    port = CheckpointStore(DeltaStore(m=4, r=2, backend="mem"), CheckpointConfig(snapshot_every=3))
    for s in range(4):
        want, got = ref.save(s, _tree(s)), port.save(s, _tree(s))
        assert {k: v for k, v in got.items() if k != "treedef"} == \
            {k: v for k, v in want.items() if k != "treedef"}

    def blobs(store):
        return {k: v for node in store.store._mem for k, v in node.items()
                if k.did.startswith("P:")}

    want, got = blobs(ref), blobs(port)
    assert got.keys() == want.keys() and len(got) == 4 * 3
    for k in want:
        assert got[k] == want[k], k


def test_tensor_leaves_restore_onto_the_example():
    """Tensor leaves (float32, int32 and bfloat16, the last with no numpy
    type) save their bits and come back as tensors of the example's types
    on its devices, through a delta chain and an async save."""
    g = torch.Generator().manual_seed(0)
    trees = [{"p": {"w": torch.randn(40, 30, generator=g), "e": torch.randn(
        513, generator=g).to(torch.bfloat16)}, "n": torch.tensor(i, dtype=torch.int32),
        "np": np.arange(5, dtype=np.int64) + i} for i in range(3)]
    store = CheckpointStore(DeltaStore(m=2, r=1, backend="mem"),
                            CheckpointConfig(snapshot_every=2))
    saved = []
    for i, t in enumerate(trees):
        saved.append(tree_flatten(t)[0])
        saved[-1][3] = saved[-1][3].clone()
        store.save_async(i, t).result()
        t["p"]["w"].add_(1.0)  # the trainer updates in place after a save
    assert [m["dtype"] for m in store.saves[1]["leaves"]] == [
        "int32", "int64", "bfloat16", "float32"]  # n, np, p.e, p.w
    for i in range(3):
        got, step = store.restore(step=i, example_tree=trees[i])
        assert step == i
        for a, b, like in zip(tree_flatten(got)[0], saved[i], tree_flatten(trees[i])[0]):
            if torch.is_tensor(like):
                assert torch.is_tensor(a) and a.dtype == like.dtype and a.device == like.device
                assert torch.equal(a, b)
            else:
                np.testing.assert_array_equal(a, b)
    bare, _ = store.restore(step=2)
    assert bare["p"]["e"].dtype == torch.bfloat16 and isinstance(bare["p"]["w"], np.ndarray)


def test_saved_tree_freed_without_the_garbage_collector():
    """Flattening, rebuilding, saving and restoring a tree of tensors
    leaves no reference cycle that holds its leaves: with the garbage
    collector off they go as soon as the caller drops them (a nested
    walk that called itself once kept a whole training state alive on
    the card until the collector ran)."""
    tree = {"p": {"w": torch.randn(40, 30), "e": torch.randn(7).to(torch.bfloat16)},
            "n": [torch.tensor(1), None]}
    refs = [weakref.ref(t) for t in tree_flatten(tree)[0]]
    store = CheckpointStore(DeltaStore(m=2, r=1, backend="mem"),
                            CheckpointConfig(snapshot_every=2))
    gc.disable()
    try:
        leaves, treedef = tree_flatten(tree)
        again = tree_unflatten(treedef, leaves)
        store.save(0, again)
        store.save_async(1, tree).result()
        got, _ = store.restore(step=1, example_tree=tree)
        got_refs = [weakref.ref(t) for t in tree_flatten(got)[0]]
        del tree, leaves, again, got
        assert [r() for r in refs + got_refs] == [None] * (len(refs) + len(got_refs))
    finally:
        gc.enable()


def test_train_crash_resume_equivalence():
    """12 steps straight vs 8 steps + a crash + a resume from the step-7
    save, with the same run config: the same losses."""
    kw = dict(arch="qwen3-1.7b", steps=12, batch=4, seq=32, checkpoint_every=4, seed=11,
              log_every=100, device="cpu")
    store = CheckpointStore(DeltaStore(m=2, r=1, backend="mem"),
                            CheckpointConfig(snapshot_every=2))
    _, _, losses = run(**kw, store=store)
    store2 = CheckpointStore(DeltaStore(m=2, r=1, backend="mem"),
                             CheckpointConfig(snapshot_every=2))
    _, _, la = run(**kw, store=store2, stop_after=8)
    _, _, lb = run(**kw, store=store2, resume=True)
    assert [e["step"] for e in store.saves] == [3, 7, 11]
    np.testing.assert_allclose(losses[:8], la, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(losses[8:], lb, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cls", [Coordinator, RefCoordinator])
def test_elastic_coordinator_plans_like_the_reference(cls):
    clock = [0.0]
    co = cls(n_hosts=8, chips_per_host=4, heartbeat_timeout=10, straggler_factor=2.0,
             clock=lambda: clock[0])
    for step in range(20):
        clock[0] += 1.0
        for h in range(8):
            if h == 3 and step > 5:
                continue  # host 3 dies
            co.heartbeat(h, 1.0 if h != 5 else 3.5)  # host 5 straggles
    clock[0] += 20.0
    for h in range(8):
        if h != 3:
            co.heartbeat(h)
    plan = co.plan(data_axis=8, model_axis=4)
    assert plan == {"gen": 1, "dead": [3], "quarantined": [5], "hosts": [0, 1, 2, 4],
                    "mesh": (4, 4), "action": "restore_from_checkpoint_and_reseek"}
    assert pipeline_seek(120, 64, 4)["shard_seeds"] == [(120, s) for s in range(4)]
