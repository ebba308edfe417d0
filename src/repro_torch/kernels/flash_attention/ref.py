"""Plain PyTorch versions of the flash-attention kernels: the naive
masked softmax of the reference's ``attention_ref``, each row's
log-sum-exp, and the backward by its explicit formulas, in float32.
They materialise the (B, H, Sq, Sk) scores: 4.3 GB at B=4, H=16,
S=4096."""
from __future__ import annotations

import torch

NEG = -0.7 * torch.finfo(torch.float32).max


def position_mask(q_pos, k_pos, *, causal: bool = True, window: int = 0):
    """(Sq, Sk) bool: query i may attend key j.  ``k_pos = -1`` is a hole;
    causal keeps ``k_pos <= q_pos``; window > 0 keeps
    ``k_pos > q_pos - window``."""
    q_pos, k_pos = q_pos.to(torch.int64), k_pos.to(torch.int64)
    ok = (k_pos >= 0)[None, :].expand(q_pos.shape[0], -1)
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    return ok


def attention_ref(q, k, v, q_pos, k_pos, *, causal: bool = True, window: int = 0,
                  scale=None):
    """q: (B, H, Sq, D); k, v: (B, H, Sk, D); q_pos (Sq,), k_pos (Sk,).
    Returns (B, H, Sq, D) float32; rows with no key to attend give 0."""
    scale = scale or q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k.to(torch.float32)) * scale
    ok = position_mask(q_pos, k_pos, causal=causal, window=window)
    s = torch.where(ok, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
    return torch.where(ok.any(dim=-1)[:, None], out, 0.0)


def _scores(q, k, q_pos, k_pos, causal, window, scale):
    scale = scale or q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k.to(torch.float32)) * scale
    return s, position_mask(q_pos, k_pos, causal=causal, window=window)


def lse_ref(q, k, q_pos, k_pos, *, causal: bool = True, window: int = 0, scale=None):
    """(B, H, Sq) float32: log sum_j exp(scale q_i . k_j) over the keys
    the masks allow; -inf for a row with no key."""
    s, ok = _scores(q, k, q_pos, k_pos, causal, window, scale)
    return torch.logsumexp(torch.where(ok, s, -torch.inf), dim=-1)


def attention_bwd_ref(q, k, v, q_pos, k_pos, o, lse, do, *, causal: bool = True,
                      window: int = 0, scale=None):
    """The backward of ``attention_ref`` at output ``o`` with row
    log-sum-exp ``lse``: P = exp(scale S - lse) under the masks,
    dV = P^T dO, dP = dO V^T, delta = rowsum(dO * O), dS = P (dP - delta),
    dQ = scale dS K, dK = scale dS^T Q.  Returns (dq, dk, dv) float32; a row
    with no key gives zero gradients."""
    scale = scale or q.shape[-1] ** -0.5
    q, k, v, o, do, lse = (t.to(torch.float32) for t in (q, k, v, o, do, lse))
    s, ok = _scores(q, k, q_pos, k_pos, causal, window, scale)
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    ds = p * (dp - (do * o).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    return dq, dk, dv
