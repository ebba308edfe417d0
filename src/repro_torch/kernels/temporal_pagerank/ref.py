"""Plain PyTorch version of the temporal PageRank kernel: the damped power
iteration (uniform dangling-mass redistribution, fixed iteration count,
inactive nodes pinned to 0) of the reference's ``pagerank_ref``, with the
operations in the same order, batched over timepoints.  Float32
throughout; the sums run in another order than the reference's, so the
two agree within float32 tolerance, not bit for bit.

Beside it, the plain versions of the kernel's packed form: the pack pass
(``pack_columns_ref``, ``pack_ref``: column words, deg and the all-ones
flag) and the iteration over the words (``pagerank_words_ref``)."""
from __future__ import annotations

import torch


def pagerank_ref(adj, active, damping: float = 0.85, iters: int = 20):
    """adj: (T, N, N) dense adjacency (any float32 weights: ``deg`` is the
    column sums and rank flows along rows, ``nxt[j] = sum_i contrib[i] *
    adj[i, j]``); active: (T, N) mask.  Returns ranks (T, N) float32."""
    a = torch.as_tensor(adj).to(torch.float32)
    return _power(a, a.sum(dim=1), active, damping, iters)


def _power(a, deg, active, damping, iters):
    """The power iteration on the (T, N, N) matrix ``a`` with column sums
    ``deg`` (T, N)."""
    act = torch.as_tensor(active).to(torch.float32).unsqueeze(1)  # (T, 1, N)
    deg = deg.unsqueeze(1)  # (T, 1, N)
    n = act.sum(dim=2, keepdim=True).clamp_min(1.0)  # (T, 1, 1)
    r = act / n
    dangling_mask = act * (deg == 0).to(torch.float32)
    # a true division, as the reference's; filled on the device, so the
    # plain version never waits for the card
    base = torch.full_like(n, 1.0 - damping) / n
    for _ in range(iters):
        contrib = torch.where(deg > 0, r / deg.clamp_min(1.0), 0.0)
        nxt = torch.bmm(contrib, a)
        dangling = (r * dangling_mask).sum(dim=2, keepdim=True)
        r = act * (base + damping * (nxt + dangling / n))
    return r.squeeze(1)


def pack_columns_ref(edge):
    """Column words of a (T, N, N) boolean edge stack, as the pack pass
    writes them: (T, W, N) int32 holding uint32 bits, W = ceil(N / 32),
    bit i % 32 of ``words[t, i // 32, j]`` set where ``edge[t, i, j]``;
    the bits of rows past N are zero."""
    T, N, _ = edge.shape
    W = (N + 31) // 32
    e = torch.zeros((T, 32 * W, N), dtype=torch.int64, device=edge.device)
    e[:, :N] = edge
    shifts = torch.arange(32, dtype=torch.int64, device=edge.device).view(1, 1, 32, 1)
    words = (e.view(T, W, 32, N) << shifts).sum(dim=2)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_columns_ref(words, N: int):
    """The (T, N, N) boolean edge stack whose column words are ``words``."""
    T, W, _ = words.shape
    shifts = torch.arange(32, dtype=torch.int32, device=words.device).view(1, 1, 32, 1)
    bits = (words.unsqueeze(2) >> shifts) & 1
    return bits.reshape(T, 32 * W, N)[:, :N] != 0


def pack_ref(adj):
    """The PageRank pack pass: column words of ``adj != 0``, deg (T, N)
    the column sums of the weights (negative ones included), and (T,)
    whether every nonzero entry of a timepoint is 1.0 (the kernel then
    iterates on its bits alone)."""
    a = torch.as_tensor(adj).to(torch.float32)
    ones = ((a == 0) | (a == 1)).flatten(1).all(dim=1)
    return pack_columns_ref(a != 0), a.sum(dim=1), ones


def pagerank_words_ref(words, deg, ones, adj, active,
                       damping: float = 0.85, iters: int = 20):
    """The iteration over the packed form: ``nxt[j]`` sums ``contrib[i]``
    over the set bits i of column j, each times ``adj[i, j]`` at the
    timepoints that are weighted (``ones`` false)."""
    N = words.shape[-1]
    edge = unpack_columns_ref(words, N).to(torch.float32)
    weights = torch.as_tensor(adj).to(torch.float32)
    a = torch.where(ones.view(-1, 1, 1), edge, edge * weights)
    return _power(a, deg, active, damping, iters)
