"""Plain PyTorch versions of the RG-LRU scan kernels: the first-order
linear recurrence ``h_t = exp(log_a_t) * h_{t-1} + b_t`` with ``h_0 =
0``, by a log-depth (Hillis-Steele) scan over the sequence axis, the same
combination ``(la1, b1) . (la2, b2) = (la1 + la2, exp(la2) * b1 + b2)``
as the reference's associative scan; its backward (the same scan run in
reverse); and the plain emulations of both kernels' chunk
decompositions.  Float32 throughout."""
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


def rglru_chunked_ref(log_a, b, chunk):
    """The kernel's decomposition in plain PyTorch, for tests and checks:
    cut the sequence into chunks of ``chunk`` steps (the last padded with
    log_a = 0, b = 0, which leave h as it is), scan each chunk from h = 0
    for its aggregate (decay = the product of its exp(log_a), hl = its
    last value), carry ``decay * carry + hl`` from chunk to chunk in
    order, and rescan each chunk from its carry.  log_a, b: (B, S, W)
    float32 -> h: (B, S, W) float32."""
    la = torch.as_tensor(log_a).to(torch.float32)
    x = torch.as_tensor(b).to(torch.float32)
    B, S, W = la.shape
    n = -(-S // chunk)
    pad = n * chunk - S
    a = torch.exp(torch.nn.functional.pad(la, (0, 0, 0, pad))).view(B, n, chunk, W)
    x = torch.nn.functional.pad(x, (0, 0, 0, pad)).view(B, n, chunk, W)
    decay = la.new_ones(B, n, W)
    hl = la.new_zeros(B, n, W)
    for u in range(chunk):
        hl = a[:, :, u] * hl + x[:, :, u]
        decay = decay * a[:, :, u]
    carry = [la.new_zeros(B, W)]
    for c in range(n - 1):
        carry.append(decay[:, c] * carry[-1] + hl[:, c])
    hv = torch.stack(carry, dim=1)
    out = la.new_empty(B, n, chunk, W)
    for u in range(chunk):
        hv = a[:, :, u] * hv + x[:, :, u]
        out[:, :, u] = hv
    return out.view(B, n * chunk, W)[:, :S]


def rglru_bwd_ref(log_a, h, dh):
    """The scan's backward in plain PyTorch: the reverse scan
    ``g_t = dh_t + exp(log_a_{t+1}) g_{t+1}`` (``g_S = 0``), run as the
    forward scan over the reversed sequence with ``log_a`` shifted by
    one step, then ``dlog_a_t = g_t exp(log_a_t) h_{t-1}`` (``h_{-1} =
    0``) and ``db_t = g_t``.  log_a, h, dh: (B, S, W) -> (dlog_a, db),
    float32."""
    la, h, dh = (torch.as_tensor(t).to(torch.float32) for t in (log_a, h, dh))
    la_next = torch.nn.functional.pad(la[:, 1:], (0, 0, 0, 1))
    g = rglru_ref(la_next.flip(1), dh.flip(1)).flip(1)
    h_prev = torch.nn.functional.pad(h[:, :-1], (0, 0, 1, 0))
    return g * torch.exp(la) * h_prev, g


def rglru_bwd_chunked_ref(log_a, h, dh, chunk):
    """The backward kernel's decomposition in plain PyTorch: chunks of
    ``chunk`` steps (the last padded with log_a = 0, dh = 0), each
    chunk's aggregate from a zero carry walking back from its last step
    (decay = the product of its exp(log_a), el = exp(log_a) g at its first
    step), the carry ``decay * carry + el`` handed from the last chunk to
    the first, and each chunk rescanned backwards from its carry.
    Returns (dlog_a, db) as ``rglru_bwd_ref``."""
    la, h, dh = (torch.as_tensor(t).to(torch.float32) for t in (log_a, h, dh))
    B, S, W = la.shape
    n = -(-S // chunk)
    pad = n * chunk - S
    a = torch.exp(torch.nn.functional.pad(la, (0, 0, 0, pad))).view(B, n, chunk, W)
    d = torch.nn.functional.pad(dh, (0, 0, 0, pad)).view(B, n, chunk, W)
    decay = la.new_ones(B, n, W)
    el = la.new_zeros(B, n, W)
    for u in reversed(range(chunk)):
        el = a[:, :, u] * (d[:, :, u] + el)
        decay = decay * a[:, :, u]
    carry = [la.new_zeros(B, W)]  # into the last chunk
    for c in reversed(range(1, n)):
        carry.append(decay[:, c] * carry[-1] + el[:, c])
    e = torch.stack(carry[::-1], dim=1)  # e[:, c]: the carry into chunk c
    g = la.new_empty(B, n, chunk, W)
    for u in reversed(range(chunk)):
        g[:, :, u] = d[:, :, u] + e
        e = a[:, :, u] * g[:, :, u]
    g = g.view(B, n * chunk, W)[:, :S]
    h_prev = torch.nn.functional.pad(h[:, :-1], (0, 0, 1, 0))
    return g * torch.exp(la) * h_prev, g
