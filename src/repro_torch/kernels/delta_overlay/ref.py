"""Plain PyTorch versions of the delta_overlay kernels: the sequential
last-writer-wins fold over a stacked delta chain (node payload of
Algorithm 1's Σ Δ_si + Σ Δ_ei).  Semantics mirror
``repro_torch.core.delta._node_sum`` exactly, including the per-step
attribute clear on deletion.  Run on any device; the CPU path of
``ops`` and the kernel comparisons on the card use them."""
from __future__ import annotations

import torch


def overlay_ref(valid, present, attrs):
    """valid: (h, P, S) int8/bool; present: (h, P, S) int8;
    attrs: (h, P, S, K) int32.  Returns folded (valid bool, present,
    attrs)."""
    acc_v = valid[0] != 0
    acc_p = present[0]
    acc_a = attrs[0]
    for i in range(1, valid.shape[0]):
        vi = valid[i] != 0
        acc_p = torch.where(vi, present[i], acc_p)
        ai = attrs[i]
        acc_a = torch.where(vi[..., None] & (ai != -1), ai, acc_a)
        acc_a = torch.where((acc_p == 0)[..., None], -1, acc_a)
        acc_v = acc_v | vi
    return acc_v, acc_p.clone(), acc_a.clone()


def overlay_batch_ref(valid, present, attrs, tmask):
    """Time-batched fold: per timepoint t, fold the layers whose
    ``tmask[i, t]`` is set, from a neutral accumulator (valid 0,
    present 0, attrs -1).  All T timepoints advance together, one layer
    at a time.  Returns valid bool / present (P, S, T) and attrs
    (P, S, T, K)."""
    T = tmask.shape[-1]
    use = (tmask != 0).to(valid.device)
    grid = (T,) + tuple(valid.shape[1:])
    acc_v = torch.zeros(grid, dtype=torch.bool, device=valid.device)
    acc_p = torch.zeros(grid, dtype=present.dtype, device=valid.device)
    acc_a = torch.full(grid + (attrs.shape[-1],), -1, dtype=attrs.dtype,
                       device=valid.device)
    lead = (T,) + (1,) * (valid.dim() - 1)
    for i in range(valid.shape[0]):
        vi = (valid[i] != 0) & use[i].view(lead)
        acc_p = torch.where(vi, present[i], acc_p)
        ai = attrs[i]
        acc_a = torch.where(vi[..., None] & (ai != -1), ai, acc_a)
        acc_a = torch.where((acc_p == 0)[..., None], -1, acc_a)
        acc_v = acc_v | vi
    return (acc_v.movedim(0, -1).contiguous(),
            acc_p.movedim(0, -1).contiguous(),
            acc_a.movedim(0, -2).contiguous())
