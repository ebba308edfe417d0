"""Plain PyTorch version of the flash-attention kernel: the naive masked
softmax of the reference's ``attention_ref``, in float32.  It
materialises the (B, H, Sq, Sk) scores: 4.3 GB at B=4, H=16, S=4096."""
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
