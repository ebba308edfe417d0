"""repro_torch temporal_pagerank vs the reference: the port's op on CPU
tensors (the plain PyTorch version the CPU path runs) against the
reference Pallas kernel in interpret mode, within atol=1e-6, rtol=1e-5
(the reference's own kernel-vs-ref tolerance: float32 sums taken in
another order).  Covers N below, past and at the Pallas lane tile, an
asymmetric weighted adjacency that pins the orientation, a timepoint with
no active node, and a damping other than 0.85."""
import numpy as np
import pytest
import torch

from repro.kernels.temporal_pagerank import ops as ref_ops
from repro_torch.kernels.temporal_pagerank import ops

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
