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


def layer_lists_ref(tmask):
    """The batch kernel's pre-pass in plain PyTorch, for tests and checks:
    for each timepoint t of an (h, T) mask, the layers i with
    ``tmask[i, t]`` set, in index order.  Returns lists (T, h) int32,
    -1 past each count, and counts (T,) int32."""
    use = (torch.as_tensor(tmask) != 0).T
    h = use.shape[1]
    idx = torch.arange(h, device=use.device).expand_as(use)
    lists = torch.where(use, idx, h).sort(dim=1).values
    return (torch.where(lists == h, -1, lists).to(torch.int32),
            use.sum(dim=1).to(torch.int32))


def overlay_lists_ref(valid, present, attrs, lists, counts):
    """The batch kernel's fold in plain PyTorch, for tests and checks:
    timepoint t folds only the layers ``lists[t, :counts[t]]``, in that
    order, from the neutral accumulator, and a layer whose valid byte is 0
    changes nothing (present == 0 implies attrs == -1 after every step, so
    the clear of such a step is a no-op).  Same outputs as
    ``overlay_batch_ref``."""
    T = lists.shape[0]
    grid = (T,) + tuple(valid.shape[1:])
    acc_v = torch.zeros(grid, dtype=torch.bool, device=valid.device)
    acc_p = torch.zeros(grid, dtype=present.dtype, device=valid.device)
    acc_a = torch.full(grid + (attrs.shape[-1],), -1, dtype=attrs.dtype,
                       device=valid.device)
    lead = (T,) + (1,) * (valid.dim() - 1)
    for j in range(int(counts.max())):
        i = lists[:, j].clamp(min=0).long()
        vi = (valid[i] != 0) & (counts > j).view(lead)
        acc_p = torch.where(vi, present[i], acc_p)
        ai = attrs[i]
        acc_a = torch.where(vi[..., None] & (ai != -1), ai, acc_a)
        acc_a = torch.where((vi & (acc_p == 0))[..., None], -1, acc_a)
        acc_v = acc_v | vi
    return (acc_v.movedim(0, -1).contiguous(),
            acc_p.movedim(0, -1).contiguous(),
            acc_a.movedim(0, -2).contiguous())
