"""repro_torch delta_overlay vs the reference: the port's ``overlay`` and
``overlay_batch`` on CPU tensors (the plain PyTorch versions the CPU path
runs), and the plain emulations of the CUDA kernels' walks, against the
reference Pallas kernels in interpret mode, bit for bit, over the
reference kernel tests' shape grid plus S that is not a multiple of the
Pallas tile, T > K, and the edges of the single fold's seed from layer 0."""
import numpy as np
import pytest
import torch

from repro.core.delta import Delta as RefDelta
from repro.core.delta import delta_sum as ref_delta_sum
from repro.kernels.delta_overlay import ops as ref_ops
from repro_torch.core.delta import Delta, delta_sum
from repro_torch.kernels.delta_overlay import ops, ref

OVERLAY_GRID = [(2, 1, 256, 1), (4, 3, 256, 4), (8, 2, 512, 2), (3, 2, 300, 3),
                (5, 2, 777, 4), (3, 1, 256, 20)]
BATCH_GRID = [(2, 1, 256, 1, 1), (4, 2, 256, 3, 4), (6, 2, 300, 2, 3),
              (8, 1, 512, 2, 8), (5, 2, 777, 4, 9)]


def _stacks(rng, h, P, S, K):
    valid = rng.rand(h, P, S) < 0.4
    present = (rng.rand(h, P, S) < 0.7).astype(np.int8)
    attrs = rng.randint(-1, 5, size=(h, P, S, K)).astype(np.int32)
    return valid, present, attrs


def _assert_same(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("h,P,S,K", OVERLAY_GRID)
def test_overlay_matches_reference_kernel(h, P, S, K):
    rng = np.random.RandomState(h * 100 + P)
    valid, present, attrs = _stacks(rng, h, P, S, K)
    got = ops.overlay(*(torch.from_numpy(x) for x in (valid, present, attrs)))
    want = ref_ops.overlay(valid, present, attrs, use_pallas=True)
    _assert_same(got, want)


@pytest.mark.parametrize("h,P,S,K,T", BATCH_GRID)
def test_overlay_batch_matches_reference_kernel(h, P, S, K, T):
    rng = np.random.RandomState(h * 10 + T)
    valid, present, attrs = _stacks(rng, h, P, S, K)
    tmask = (rng.rand(h, T) < 0.6).astype(np.int8)
    tmask[0, :] = 1
    got = ops.overlay_batch(*(torch.from_numpy(x)
                              for x in (valid, present, attrs, tmask)))
    want = ref_ops.overlay_batch(valid, present, attrs, tmask, use_pallas=True)
    assert tuple(got[2].shape) == (P, S, T, K)
    _assert_same(got, want)


@pytest.mark.parametrize("h,P,S,K", OVERLAY_GRID)
def test_seeded_walk_matches_reference_kernel(h, P, S, K):
    """The single-fold kernel's walk (seeded from layer 0, step 1 in full,
    invalid layers skipped from step 2 on) in plain PyTorch, bit for bit
    against the reference Pallas kernel in interpret mode and the port's
    plain fold, on seeded random stacks."""
    rng = np.random.RandomState(h * 100 + P + 7)
    valid, present, attrs = _stacks(rng, h, P, S, K)
    got = ref.overlay_seeded_ref(*(torch.from_numpy(x) for x in (valid, present, attrs)))
    _assert_same(got, ref_ops.overlay(valid, present, attrs, use_pallas=True))
    _assert_same(got, [x.numpy() for x in ref.overlay_ref(
        *(torch.from_numpy(x) for x in (valid, present, attrs)))])


_EDGES = list(ref.overlay_edge_stacks(1))


@pytest.mark.parametrize("K", [1, 4, 5, 20])
@pytest.mark.parametrize("case", _EDGES)
def test_overlay_seed_edges_match_reference_kernel(case, K):
    """Where the single fold's seed from layer 0 differs from the batch
    fold's neutral start (h = 1, an invalid layer 0 that is present, a
    tombstoned layer 0 with attrs followed by a valid layer of attrs -1 or
    by an invalid one, a present layer 0 kept through a layer 1 of attrs
    -1), at K = 1, 4, 5 and 20 (two and a half 8-wide passes) and a ragged
    S: the port's fold and the kernel's walk, bit for bit against the
    reference Pallas kernel."""
    stacks = ref.overlay_edge_stacks(K, S=300, seed=K)[case]
    valid, present, attrs = (x.numpy() for x in stacks)
    want = ref_ops.overlay(valid, present, attrs, use_pallas=True)
    _assert_same(ops.overlay(*stacks), want)
    _assert_same(ref.overlay_seeded_ref(*stacks), want)


def _chain(rng, mk, h=4, P=2, S=256, K=3):
    ds = []
    for _ in range(h):
        d = mk(P, S, K)
        d.valid = rng.rand(P, S) < 0.5
        d.present = np.where(d.valid, rng.rand(P, S) < 0.8, 0).astype(np.int8)
        d.attrs = np.where((d.valid & (d.present == 1))[..., None],
                           rng.randint(-1, 4, size=(P, S, K)), -1).astype(np.int32)
        ds.append(d)
    return ds


@pytest.mark.parametrize("seed", range(3))
def test_overlay_matches_both_delta_chains(seed):
    """The fold == the left Δ-sum chain of the port's and the reference's
    core.delta on every valid slot."""
    ds = _chain(np.random.RandomState(seed), Delta.empty)
    ref_ds = _chain(np.random.RandomState(seed), RefDelta.empty)
    acc, ref_acc = ds[0], ref_ds[0]
    for d, rd in zip(ds[1:], ref_ds[1:]):
        acc, ref_acc = delta_sum(acc, d), ref_delta_sum(ref_acc, rd)
    got_v, got_p, got_a = (x.numpy() for x in ops.overlay(*(
        torch.from_numpy(np.stack([getattr(d, f) for d in ds]))
        for f in ("valid", "present", "attrs"))))
    for want in (acc, ref_acc):
        np.testing.assert_array_equal(got_v, want.valid)
        on = want.valid
        np.testing.assert_array_equal(got_p[on], want.present[on])
        np.testing.assert_array_equal(got_a[on], want.attrs[on])


def test_overlay_keeps_tombstone_clear():
    """Algorithm 1's left fold across a tombstone leaves the re-added
    node's attrs unset — the documented non-associativity is kept."""
    valid = np.ones((3, 1, 1), bool)
    present = np.array([1, 0, 1], np.int8).reshape(3, 1, 1)
    attrs = np.full((3, 1, 1, 1), -1, np.int32)
    attrs[0, 0, 0, 0] = 7
    v, p, a = ops.overlay(*(torch.from_numpy(x) for x in (valid, present, attrs)))
    assert bool(v[0, 0]) and int(p[0, 0]) == 1 and int(a[0, 0, 0]) == -1
    want = ref_ops.overlay(valid, present, attrs, use_pallas=True)
    _assert_same((v, p, a), want)


def test_overlay_refuses_other_devices():
    x = torch.zeros((2, 1, 4), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.overlay(x, x, torch.zeros((2, 1, 4, 1), dtype=torch.int32,
                                      device="meta"))


def _tmasks():
    """(name, tmask): the wide snapshot group's structure (2 shared path
    layers fed to every timepoint, then one eventlist layer per
    timepoint), a random mask with a column no layer feeds and a layer no
    timepoint uses, one layer, and one timepoint."""
    rng = np.random.RandomState(5)
    wide = np.zeros((2 + 6, 6), np.int8)
    wide[:2] = 1
    wide[2 + np.arange(6), np.arange(6)] = 1
    ragged = (rng.rand(7, 6) < 0.6).astype(np.int8)
    ragged[:, 2] = 0
    ragged[4] = 0
    return [("wide group", wide), ("random, empty column, unused layer", ragged),
            ("h=1", np.array([[1, 0, 1]], np.int8)),
            ("T=1", (rng.rand(5, 1) < 0.6).astype(np.int8))]


@pytest.mark.parametrize("name,tmask", _tmasks(), ids=[n for n, _ in _tmasks()])
def test_layer_lists_fold_matches_reference_kernel(name, tmask):
    """The CUDA kernel's decomposition (the pre-pass's per-timepoint layer
    lists, then a fold of only the listed layers that skips invalid ones)
    in plain PyTorch, bit for bit against the reference Pallas kernel in
    interpret mode and the port's plain batch fold."""
    h, T = tmask.shape
    valid, present, attrs = _stacks(np.random.RandomState(h * 31 + T), h, 1, 256, 4)
    lists, counts = ref.layer_lists_ref(torch.from_numpy(tmask))
    assert lists.shape == (T, h) and counts.shape == (T,)
    assert lists.dtype == counts.dtype == torch.int32
    for t in range(T):
        want = np.nonzero(tmask[:, t])[0]
        assert counts[t] == len(want)
        np.testing.assert_array_equal(lists[t, :len(want)].numpy(), want)
        assert (lists[t, len(want):] == -1).all()
    assert all(torch.equal(a, b) for a, b in zip(
        ops.layer_lists(torch.from_numpy(tmask)), (lists, counts)))
    stacks = [torch.from_numpy(x) for x in (valid, present, attrs)]
    got = ref.overlay_lists_ref(*stacks, lists, counts)
    _assert_same(got, ref_ops.overlay_batch(valid, present, attrs, tmask,
                                            use_pallas=True))
    _assert_same(got, ops.overlay_batch(*stacks, torch.from_numpy(tmask)))
