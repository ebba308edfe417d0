"""Plain PyTorch version of the temporal connected-components kernel: the
reference's ``cc_ref``, bounded min-label propagation batched over
timepoints.  Every round reads the previous round's labels (Jacobi
order).  Integer labels, so it is bit-identical to the reference.

Beside it, the plain versions of the kernel's packed form: the pack pass
(``pack_ref``, column words of the entries > 0) and the rounds over the
words (``cc_words_ref``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.temporal_pagerank.ref import pack_columns_ref, unpack_columns_ref


def cc_ref(adj, active, iters: int = 32):
    """adj: (T, N, N) dense adjacency (an entry > 0 is an edge i -> j);
    active: (T, N) mask.  Returns labels (T, N) int32: the least row
    index that reached each node within ``iters`` rounds, -1 on inactive
    nodes.  Inactive nodes are masked only at the start and the end, so
    one with edges relays labels as the reference's does."""
    return _propagate(torch.as_tensor(adj).to(torch.float32) > 0, active, iters)


def _propagate(edge, active, iters):
    act = torch.as_tensor(active) != 0
    N = edge.shape[-1]
    iota = torch.arange(N, dtype=torch.int32, device=edge.device)
    labels = torch.where(act, iota, N).to(torch.int32)
    for _ in range(iters):
        neigh = torch.where(edge, labels[:, :, None], N).amin(dim=1)
        labels = torch.minimum(labels, neigh)
    return torch.where(act, labels, -1)


def pack_ref(adj):
    """The components pack pass: (T, ceil(N / 32), N) int32 column words
    of ``adj > 0`` (weights and negative entries need no more)."""
    return pack_columns_ref(torch.as_tensor(adj).to(torch.float32) > 0)


def cc_words_ref(words, active, iters: int = 32):
    """The rounds over the packed form: each node takes the least previous
    label over the set bits of its column."""
    return _propagate(unpack_columns_ref(words, words.shape[-1]), active, iters)
