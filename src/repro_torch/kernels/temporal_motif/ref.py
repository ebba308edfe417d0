"""Plain PyTorch version of the temporal motif kernel: per-node triangle
counts as the column sums of (A·A)∘A halved, per timepoint, with any
nonzero entry of A an edge.  The product runs in float64, exact for
every N a dense stack can hold, so the counts are exact integers."""
from __future__ import annotations

import torch


def motif_ref(adj):
    """adj: (T, N, N) adjacency, any nonzero entry an edge (any pattern;
    symmetric with a zero diagonal for triangles).  Returns the per-node
    counts (T, N) int32."""
    a = (torch.as_tensor(adj) != 0).to(torch.float64)
    tri = (torch.bmm(a, a) * a).sum(dim=1) * 0.5
    return tri.to(torch.int32)
