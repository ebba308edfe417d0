"""Plain PyTorch version of the temporal PageRank kernel: the damped power
iteration (uniform dangling-mass redistribution, fixed iteration count,
inactive nodes pinned to 0) of the reference's ``pagerank_ref``, with the
operations in the same order, batched over timepoints.  Float32
throughout; the sums run in another order than the reference's, so the
two agree within float32 tolerance, not bit for bit."""
from __future__ import annotations

import torch


def pagerank_ref(adj, active, damping: float = 0.85, iters: int = 20):
    """adj: (T, N, N) dense adjacency (any float32 weights: ``deg`` is the
    column sums and rank flows along rows, ``nxt[j] = sum_i contrib[i] *
    adj[i, j]``); active: (T, N) mask.  Returns ranks (T, N) float32."""
    a = torch.as_tensor(adj).to(torch.float32)
    act = torch.as_tensor(active).to(torch.float32).unsqueeze(1)  # (T, 1, N)
    deg = a.sum(dim=1, keepdim=True)  # (T, 1, N) column sums
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
