"""repro_torch temporal_motif vs the reference: the port's op on CPU
tensors (the plain PyTorch version the CPU path runs) against the
reference Pallas kernel in interpret mode, bit for bit, for N below, at
and past the Pallas lane tile."""
import numpy as np
import pytest
import torch

from repro.kernels.temporal_motif import ops as ref_ops
from repro_torch.kernels.temporal_motif import ops


def _adjacency(rng, T, N, p):
    a = np.triu((rng.rand(T, N, N) < p).astype(np.float32), 1)
    return a + a.transpose(0, 2, 1)


@pytest.mark.parametrize("N", [40, 130, 256])
def test_motif_matches_reference_kernel(N):
    rng = np.random.RandomState(N)
    adj = _adjacency(rng, 3, N, 0.15)
    got = ops.temporal_motif(torch.from_numpy(adj))
    want = np.asarray(ref_ops.temporal_motif(adj, use_pallas=True))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


def test_motif_counts_a_known_graph():
    """K4 plus a pendant: each K4 node sits in 3 triangles, the pendant
    in none; an empty timepoint counts zero."""
    adj = np.zeros((2, 5, 5), np.float32)
    for i in range(4):
        for j in range(4):
            adj[0, i, j] = float(i != j)
    adj[0, 3, 4] = adj[0, 4, 3] = 1.0
    got = ops.temporal_motif(torch.from_numpy(adj)).numpy()
    np.testing.assert_array_equal(got, [[3, 3, 3, 3, 0], [0, 0, 0, 0, 0]])
