"""repro_torch temporal_cc vs the reference: the port's op on CPU tensors
(the plain PyTorch version the CPU path runs) against the reference
Pallas kernel in interpret mode, bit for bit (integer labels).  Covers
iters=N at N below and past the Pallas lane tile, iters=2 on a path graph
(pins the Jacobi order: every round reads the previous round's labels),
and inactive nodes that relay labels along their edges."""
import numpy as np
import pytest
import torch

from repro.kernels.temporal_cc import ops as ref_ops
from repro_torch.kernels.temporal_cc import ops


def _both(adj, active, iters):
    got = ops.temporal_cc(torch.from_numpy(adj), torch.from_numpy(active), iters=iters)
    want = np.asarray(ref_ops.temporal_cc(adj, active, iters=iters, use_pallas=True))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


def _path(N):
    adj = np.zeros((1, N, N), np.float32)
    for i in range(N - 1):
        adj[0, i, i + 1] = adj[0, i + 1, i] = 1.0
    return adj


@pytest.mark.parametrize("seed,N", [(3, 40), (4, 130)])
def test_cc_matches_reference_kernel(seed, N):
    rng = np.random.RandomState(seed)
    active = (rng.rand(3, N) < 0.8).astype(np.int32)
    a = np.triu((rng.rand(3, N, N) < 0.05).astype(np.float32), 1)
    got = _both(a + a.transpose(0, 2, 1), active, iters=N)
    assert (got[active == 0] == -1).all()
    assert len(np.unique(got[active == 1])) > 1  # several components


def test_two_rounds_on_a_path_are_jacobi():
    """Round k moves each label k hops: node j holds max(j - 2, 0) after
    two rounds.  An in-place (Gauss-Seidel) sweep would give all zeros."""
    got = _both(_path(6), np.ones((1, 6), np.int32), iters=2)
    np.testing.assert_array_equal(got, [[0, 0, 0, 1, 2, 3]])


def test_inactive_nodes_relay_labels():
    """0 - 1 - 2 - 3 with node 1 inactive: node 1 passes label 0 on to
    node 2 (and on to 3 in the third round), but reads -1 itself."""
    active = np.array([[1, 0, 1, 1]], np.int32)
    np.testing.assert_array_equal(_both(_path(4), active, iters=2),
                                  [[0, -1, 0, 2]])
    np.testing.assert_array_equal(_both(_path(4), active, iters=3),
                                  [[0, -1, 0, 0]])


def test_negative_weight_is_not_an_edge():
    adj = _path(3) * np.array([1.0, -1.0, 1.0], np.float32)[None, :, None]
    adj[0, 1, 2] = adj[0, 2, 1] = -0.5  # both directions of 1 - 2 negative
    got = _both(adj, np.ones((1, 3), np.int32), iters=3)
    np.testing.assert_array_equal(got, [[0, 0, 2]])
