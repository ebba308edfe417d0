"""repro_torch temporal_cc vs the reference: the port's op on CPU tensors
(the plain PyTorch version the CPU path runs) against the reference
Pallas kernel in interpret mode, bit for bit (integer labels).  Covers
iters=N at N below and past the Pallas lane tile, iters=2 on a path graph
(pins the Jacobi order: every round reads the previous round's labels),
and inactive nodes that relay labels along their edges.

The CUDA kernel's packed form has plain versions too: ``pack_ref`` (the
column words of the entries > 0) and ``cc_words_ref`` (the rounds over
the words), held here bit for bit against the dense plain version and the
reference kernel: N not a multiple of 32, N=1, an asymmetric weighted
stack with negative entries, a set diagonal, a timepoint with no active
node, and the path graph at iters=2."""
import numpy as np
import pytest
import torch

from repro.kernels.temporal_cc import ops as ref_ops
from repro_torch.kernels.temporal_cc import ops, ref


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


def _packed_case(case):
    rng = np.random.RandomState(sum(map(ord, case)))
    if case == "N=1":
        return np.ones((2, 1, 1), np.float32), np.array([[1], [0]], np.int32), 3
    if case == "path, iters=2":
        return _path(6), np.ones((1, 6), np.int32), 2
    if case == "path, node 1 inactive":
        return _path(4), np.array([[1, 0, 1, 1]], np.int32), 2
    T, N = 3, {"N=45": 45, "N=64": 64}.get(case, 70)
    active = (rng.rand(T, N) < 0.8).astype(np.int32)
    a = np.triu((rng.rand(T, N, N) < 0.04).astype(np.float32), 1)
    adj = a + a.transpose(0, 2, 1)
    if case == "asymmetric weighted, negative entries":
        adj = ((rng.rand(T, N, N) < 0.04) * rng.uniform(-1.0, 2.0, (T, N, N)))
        adj[:, :, 5] = (rng.rand(T, N) < 0.6) * rng.uniform(-1.0, 2.0, (T, N))
        adj = adj.astype(np.float32)
    elif case == "diagonal set":
        adj[:, np.arange(0, N, 3), np.arange(0, N, 3)] = 1.0
    elif case == "no active node at t=1":
        active[1] = 0
    return adj, active, N


@pytest.mark.parametrize("case", [
    "N=45", "N=64", "N=1", "asymmetric weighted, negative entries", "diagonal set",
    "no active node at t=1", "path, iters=2", "path, node 1 inactive"])
def test_packed_form_matches_dense_and_reference_kernel(case):
    adj, active, iters = _packed_case(case)
    a, act = torch.from_numpy(adj), torch.from_numpy(active)
    words = ref.pack_ref(a)
    assert words.dtype == torch.int32 and tuple(words.shape) == (
        adj.shape[0], (adj.shape[1] + 31) // 32, adj.shape[1])
    got = ref.cc_words_ref(words, act, iters=iters)
    assert torch.equal(got, ref.cc_ref(a, act, iters=iters))
    want = np.asarray(ref_ops.temporal_cc(adj, active, iters=iters, use_pallas=True))
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "path, iters=2":
        np.testing.assert_array_equal(got.numpy(), [[0, 0, 0, 1, 2, 3]])
    if case == "no active node at t=1":
        assert (got[1] == -1).all()


def test_pack_ref_takes_positive_entries_only():
    adj = np.array([[[0.0, 2.0, -1.0], [0.5, 0.0, 0.0], [-0.0, 1.0, 0.0]]], np.float32)
    bits = ref.pack_ref(torch.from_numpy(adj)).numpy()[0, 0]
    # column j's word: bit i set where adj[i, j] > 0
    np.testing.assert_array_equal(bits, [0b010, 0b101, 0b000])
