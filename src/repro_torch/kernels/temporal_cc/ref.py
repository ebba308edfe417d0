"""Plain PyTorch version of the temporal connected-components kernel: the
reference's ``cc_ref``, bounded min-label propagation batched over
timepoints.  Every round reads the previous round's labels (Jacobi
order).  Integer labels, so it is bit-identical to the reference."""
from __future__ import annotations

import torch


def cc_ref(adj, active, iters: int = 32):
    """adj: (T, N, N) dense adjacency (an entry > 0 is an edge i -> j);
    active: (T, N) mask.  Returns labels (T, N) int32: the least row
    index that reached each node within ``iters`` rounds, -1 on inactive
    nodes.  Inactive nodes are masked only at the start and the end, so
    one with edges relays labels as the reference's does."""
    edge = torch.as_tensor(adj).to(torch.float32) > 0
    act = torch.as_tensor(active) != 0
    N = edge.shape[-1]
    iota = torch.arange(N, dtype=torch.int32, device=edge.device)
    labels = torch.where(act, iota, N).to(torch.int32)
    for _ in range(iters):
        neigh = torch.where(edge, labels[:, :, None], N).amin(dim=1)
        labels = torch.minimum(labels, neigh)
    return torch.where(act, labels, -1)
