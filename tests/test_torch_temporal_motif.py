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


def _bitpacked_counts(adj):
    """The CUDA kernel's arithmetic in numpy: rows and columns packed into
    uint32 words (tail bits zero), then for each edge (i, j) the popcount
    of row i AND column j, summed per column and halved."""
    T, N, _ = adj.shape
    W = -(-N // 32)
    weights = 1 << np.arange(32, dtype=np.uint64)

    def pack(a):  # bit b of word w of line x: a[x, 32 w + b]
        bits = np.zeros((T, N, 32 * W), bool)
        bits[:, :, :N] = a != 0
        return (bits.reshape(T, N, W, 32) * weights).sum(-1).astype(np.uint32)

    rows, cols = pack(adj), pack(adj.transpose(0, 2, 1))
    out = np.zeros((T, N), np.int32)
    for t, i, j in zip(*np.nonzero(adj != 0)):
        out[t, j] += sum(bin(int(w)).count("1") for w in rows[t, i] & cols[t, j])
    return out // 2


@pytest.mark.parametrize("N", [31, 32, 33])
def test_motif_asymmetric_with_diagonal(N):
    """Beyond the symmetric case: an asymmetric 0/1 stack with a set
    diagonal (the function sums (A·A)[i, j] over A[i, j] != 0 and halves,
    truncating an odd sum).  The plain version equals the reference's
    Pallas kernel (interpret mode) bit for bit, and the bit-packed
    popcount arithmetic of the CUDA kernel equals both, around one word."""
    rng = np.random.RandomState(100 + N)
    adj = (rng.rand(2, N, N) < 0.3).astype(np.float32)
    adj[:, np.arange(0, N, 2), np.arange(0, N, 2)] = 1.0
    assert (adj != adj.transpose(0, 2, 1)).any()
    got = ops.temporal_motif(torch.from_numpy(adj))
    want = np.asarray(ref_ops.temporal_motif(adj, use_pallas=True))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_bitpacked_counts(adj), want)
    assert (want % 2).any() or want.sum() > 0
