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


def overlay_seeded_ref(valid, present, attrs):
    """The single-fold kernel's walk in plain PyTorch, for tests and
    checks: the accumulator seeded from layer 0 raw, step 1 in full (its
    clear runs whether layer 1 is valid or not), then from step 2 on a
    layer whose valid byte is 0 changes nothing (after step 1, present ==
    0 implies attrs == -1, so the clear of such a step is a no-op).  Same
    outputs as ``overlay_ref``."""
    acc_v = valid[0] != 0
    acc_p = present[0]
    acc_a = attrs[0]
    for i in range(1, valid.shape[0]):
        vi = valid[i] != 0
        acc_p = torch.where(vi, present[i], acc_p)
        ai = attrs[i]
        acc_a = torch.where(vi[..., None] & (ai != -1), ai, acc_a)
        clear = acc_p == 0 if i == 1 else vi & (acc_p == 0)
        acc_a = torch.where(clear[..., None], -1, acc_a)
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


def overlay_edge_stacks(K, S=300, seed=0, device="cpu"):
    """Seeded (h, 1, S[, K]) stacks, by name, at the edges of the single
    fold's seed from layer 0 (where its semantics differ from the batch
    fold's), for tests and checks.  Each case sets layers 0 and 1 as named
    and draws the rest at random (40% valid, 70% present, attrs in
    [-1, 5))."""
    g = torch.Generator().manual_seed(seed)

    def draw(h):
        return ((torch.rand(h, 1, S, generator=g) < 0.4).to(torch.int8),
                (torch.rand(h, 1, S, generator=g) < 0.7).to(torch.int8),
                torch.randint(-1, 5, (h, 1, S, K), generator=g, dtype=torch.int32))

    cases = {"h=1": draw(1), "h=2": draw(2)}
    v, p, a = draw(5)
    v[0], p[0] = 0, 1
    cases["valid[0]=0, present[0]=1"] = (v, p, a)
    for name, layer1 in (("layer 1 valid, attrs -1", 1), ("layer 1 invalid", 0)):
        v, p, a = draw(5)
        p[0] = 0
        a[0] = torch.randint(0, 5, a[0].shape, generator=g, dtype=torch.int32)
        v[1] = layer1
        a[1] = -1
        cases[f"present[0]=0, attrs[0]!=-1, {name}"] = (v, p, a)
    v, p, a = draw(5)
    p[0], v[1], p[1], a[1] = 1, 1, 1, -1
    cases["present[0]=1, layer 1 valid, present, attrs -1"] = (v, p, a)
    return {name: tuple(x.to(device) for x in c) for name, c in cases.items()}
