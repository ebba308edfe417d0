"""repro_torch temporal_pagerank vs the reference: the port's op on CPU
tensors (the plain PyTorch version the CPU path runs) against the
reference Pallas kernel in interpret mode, within atol=1e-6, rtol=1e-5
(the reference's own kernel-vs-ref tolerance: float32 sums taken in
another order).  Covers N below, past and at the Pallas lane tile, an
asymmetric weighted adjacency that pins the orientation, a timepoint with
no active node, and a damping other than 0.85.

The CUDA kernel's packed form has plain versions too: ``pack_ref`` (the
column words, deg and the all-ones flag of the pack pass) and
``pagerank_words_ref`` (the iteration over the words, times the weights
on a weighted stack), held here against the dense plain version and the
reference kernel, with the same tolerance: N not a multiple of 32, N=1,
an asymmetric weighted stack with negative entries, a set diagonal, a
timepoint with no active node; and the regime rule that picks between
the kernel's two iteration schemes."""
import numpy as np
import pytest
import torch

from repro.kernels.temporal_pagerank import ops as ref_ops
from repro_torch.kernels.temporal_pagerank import ops, ref

TOL = dict(atol=1e-6, rtol=1e-5)


def _graphs(seed, T=3, N=40, p=0.08):
    """(T, N, N) symmetric 0/1 adjacency (zero diagonal) with edges only
    between active nodes, and the (T, N) active mask."""
    rng = np.random.RandomState(seed)
    active = (rng.rand(T, N) < 0.8).astype(np.int32)
    adj = (rng.rand(T, N, N) < p).astype(np.float32)
    adj = np.maximum(adj, adj.transpose(0, 2, 1))
    for j in range(T):
        adj[j] *= active[j][:, None] * active[j][None, :]
        np.fill_diagonal(adj[j], 0.0)
    return adj, active


def _both(adj, active, **kw):
    got = ops.temporal_pagerank(torch.from_numpy(adj), torch.from_numpy(active), **kw)
    want = np.asarray(ref_ops.temporal_pagerank(adj, active, use_pallas=True, **kw))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("seed,N", [(0, 40), (1, 130), (2, 256)])
def test_pagerank_matches_reference_kernel(seed, N):
    adj, active = _graphs(seed, N=N)
    got, want = _both(adj, active, iters=10)
    np.testing.assert_allclose(got, want, **TOL)
    # the active ranks form a distribution at every timepoint
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-4)


def test_asymmetric_weighted_adjacency_pins_the_orientation():
    """deg is the column sums and rank flows i -> j along adj[i, j]: on a
    weighted, asymmetric stack with dangling columns and edges touching
    inactive nodes, the transposed stack gives other ranks."""
    rng = np.random.RandomState(5)
    T, N = 3, 40
    adj = (rng.rand(T, N, N) * 2.0 * (rng.rand(T, N, N) < 0.06)).astype(np.float32)
    active = (rng.rand(T, N) < 0.8).astype(np.float32)
    got, want = _both(adj, active, iters=12)
    np.testing.assert_allclose(got, want, **TOL)
    flipped, _ = _both(np.ascontiguousarray(adj.transpose(0, 2, 1)), active, iters=12)
    assert np.abs(flipped - got).max() > 1e-3
    assert (adj.sum(axis=1) == 0).any()  # dangling columns are exercised


def test_timepoint_with_no_active_node_ranks_zero():
    adj, active = _graphs(6, N=40)
    active[1] = 0
    adj[1] = 0.0
    got, want = _both(adj, active, iters=10)
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[1] == 0).all() and got[0].sum() > 0.99


@pytest.mark.parametrize("damping", [0.5, 0.99])
def test_damping_other_than_default(damping):
    adj, active = _graphs(7, N=130)
    got, want = _both(adj, active, damping=damping, iters=15)
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_call_launches_no_kernel():
    adj, active = _graphs(8, N=40)
    before = dict(ops.LAUNCHES)
    ops.temporal_pagerank(torch.from_numpy(adj), torch.from_numpy(active))
    assert ops.LAUNCHES == before


def _packed_case(case):
    """(adj, active) of one named packed-form case."""
    rng = np.random.RandomState(sum(map(ord, case)))
    if case == "N=1":
        return np.ones((2, 1, 1), np.float32), np.array([[1], [0]], np.float32)
    if case == "N=45":
        return _graphs(10, N=45, p=0.15)
    if case == "N=64, rows 31 and 63 set":  # the sign bit of a word
        adj, active = _graphs(11, N=64, p=0.1)
        adj[:, [31, 63], :] = 1.0
        return adj, active
    if case == "asymmetric weighted, negative entries":
        T, N = 3, 70
        adj = (rng.rand(T, N, N) < 0.1) * rng.uniform(0.25, 2.0, (T, N, N))
        adj *= np.where(rng.rand(T, N, N) < 0.15, -0.1, 1.0)
        adj[:, :, 5] = (rng.rand(T, N) < 0.6) * rng.uniform(0.25, 2.0, (T, N))
        return adj.astype(np.float32), (rng.rand(T, N) < 0.8).astype(np.float32)
    if case == "one weighted timepoint beside 0/1 ones":
        adj, active = _graphs(14, N=50)
        adj[1] *= rng.uniform(0.5, 2.0, (50, 50)).astype(np.float32)
        return adj, active
    if case == "diagonal set":
        adj, active = _graphs(12, N=50)
        adj[:, np.arange(0, 50, 3), np.arange(0, 50, 3)] = 1.0
        return adj, active
    adj, active = _graphs(13, N=40)  # a timepoint with no active node
    active[1] = 0
    return adj, active


PACKED_CASES = ["N=45", "N=1", "N=64, rows 31 and 63 set",
                "asymmetric weighted, negative entries", "diagonal set",
                "no active node at t=1", "one weighted timepoint beside 0/1 ones"]


@pytest.mark.parametrize("case", PACKED_CASES)
def test_packed_form_matches_dense_and_reference_kernel(case):
    adj, active = _packed_case(case)
    a, act = torch.from_numpy(adj), torch.from_numpy(active)
    words, deg, ones = ref.pack_ref(a)
    np.testing.assert_array_equal(ones.numpy(), ((adj == 0) | (adj == 1)).all(axis=(1, 2)))
    got = ref.pagerank_words_ref(words, deg, ones, a, act, iters=12).numpy()
    np.testing.assert_allclose(got, ref.pagerank_ref(a, act, iters=12).numpy(), **TOL)
    want = np.asarray(ref_ops.temporal_pagerank(adj, active, use_pallas=True, iters=12))
    np.testing.assert_allclose(got, want, **TOL)
    if case.startswith("no active"):
        assert (got[1] == 0).all()


@pytest.mark.parametrize("N", [1, 31, 32, 33, 70])
def test_pack_ref_layout(N):
    """Bit i % 32 of words[t, i // 32, j] is entry (i, j); tail bits are
    zero; deg is the column sums, negative weights included; the all-ones
    flag is per timepoint."""
    rng = np.random.RandomState(N)
    adj = ((rng.rand(2, N, N) < 0.3) * rng.uniform(-1, 2, (2, N, N))).astype(np.float32)
    words, deg, ones = ref.pack_ref(torch.from_numpy(adj))
    W = (N + 31) // 32
    assert words.dtype == torch.int32 and tuple(words.shape) == (2, W, N)
    u = words.numpy().view(np.uint32)
    bits = (u[:, :, None, :] >> np.arange(32, dtype=np.uint32)[:, None]) & 1
    bits = bits.reshape(2, 32 * W, N)  # row 32 w + b of column j
    np.testing.assert_array_equal(bits[:, :N], adj != 0)
    assert not bits[:, N:].any()  # tail bits
    np.testing.assert_allclose(deg.numpy(), adj.sum(axis=1), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ones.numpy(), ((adj == 0) | (adj == 1)).all(axis=(1, 2)))
    assert ref.pack_ref(torch.from_numpy((adj != 0).astype(np.float32)))[2].all()


def test_regime_rule():
    """The cluster regime up to N = CLUSTER_MAX_N = 3072, streaming past
    it (the .cu launchers reject a cluster size that does not fit)."""
    assert [ops.regime(n) for n in (1, 1000, 1295, 3072)] == ["cluster"] * 4
    assert [ops.regime(n) for n in (3073, 4000, 8192)] == ["stream"] * 3
