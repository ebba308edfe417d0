"""Plain PyTorch version of the RG-LRU scan kernel: the first-order linear
recurrence ``h_t = exp(log_a_t) * h_{t-1} + b_t`` with ``h_0 = 0``, by a
log-depth (Hillis-Steele) scan over the sequence axis, the same
combination ``(la1, b1) . (la2, b2) = (la1 + la2, exp(la2) * b1 + b2)``
as the reference's associative scan.  Float32 throughout."""
from __future__ import annotations

import torch


def rglru_ref(log_a, b):
    """log_a, b: (B, S, W) float32 -> h: (B, S, W) float32."""
    la = torch.as_tensor(log_a).to(torch.float32)
    h = torch.as_tensor(b).to(torch.float32)
    S = la.shape[1]
    off = 1
    while off < S:
        # element t takes the prefix ending at t - off: h_t += a(t-off, t] h_{t-off}
        h = torch.cat([h[:, :off], torch.exp(la[:, off:]) * h[:, :-off] + h[:, off:]], dim=1)
        la = torch.cat([la[:, :off], la[:, off:] + la[:, :-off]], dim=1)
        off *= 2
    return h
