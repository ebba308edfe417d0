"""Plain PyTorch versions of the flash-attention kernels: the naive
masked softmax of the reference's ``attention_ref``, each row's
log-sum-exp, and the backward by its explicit formulas, in float32.
They materialise the (B, H, Sq, Sk) scores: 4.3 GB at B=4, H=16,
S=4096.  ``attention_bwd_bf16_ref`` emulates the bf16 backward kernels'
own arithmetic, a tile at a time; ``attention_3xtf32_ref`` and
``attention_bwd_3xtf32_ref`` the float32 kernels' (3xTF32 products,
``split_tf32``)."""
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


TILE = 64  # rows of the bf16 backward kernels' query and key tiles (``tcb::BM``)
LOG2E = 1.4426950408889634


def tile_pairs(q_pos, k_pos, causal, window):
    """(nqt, nkt) bool ``hidden`` and ``whole`` of each (64-query, 64-key)
    tile pair, by the kernels' rules: hidden when no query of the tile may
    see a key of the other (``tile_hidden``); whole when every pair is
    allowed (no hole or slot past Sk among the keys, and the causal and
    window edges clear), so no per-element mask is needed."""
    big = 2 ** 31 - 1
    qp, kp = q_pos.to(torch.int64), k_pos.to(torch.int64)
    nqt, nkt = -(-qp.numel() // TILE), -(-kp.numel() // TILE)

    def tiles(x, n, fill):
        return torch.cat([x, x.new_full((n * TILE - x.numel(),), fill)]).view(n, TILE)

    qmin = tiles(qp, nqt, big).amin(1)[:, None]
    qmax = tiles(qp, nqt, -big - 1).amax(1)[:, None]
    valid = tiles(kp >= 0, nkt, False)
    kv = tiles(kp, nkt, -1)
    kmin = torch.where(valid, kv, big).amin(1)[None]
    kmax = torch.where(valid, kv, -big - 1).amax(1)[None]
    hole = (~valid).any(1)[None]
    hidden = (kmin > kmax) | (qmin > qmax)
    if causal:
        hidden = hidden | (kmin > qmax)
    if window > 0:
        hidden = hidden | (kmax <= qmin - window)
    whole = ~hole & (kmax <= qmin if causal else True) \
        & (kmin > qmax - window if window > 0 else True)
    return hidden, whole.expand(hidden.shape)


def attention_bwd_bf16_ref(q, k, v, q_pos, k_pos, o, lse, do, *, causal: bool = True,
                           window: int = 0, skip: bool = True):
    """What the bfloat16 backward kernels compute (``flash_attention.cu``,
    ``tcb::``), in plain torch: delta = rowsum(dO * O) in float32;
    P = exp2(scale log2(e) S - log2(e) lse) (+inf in place of a row's
    -inf lse, so a row with no key gets no gradient); dS = P (dP - delta)
    from the float32 P; dV = P^T dO and dK = scale dS^T Q summed over the
    query tiles of 64 in order, dQ = scale dS K over the key tiles of 64
    in order, P^T, dS^T and dS rounded to bfloat16 as the products' A
    operands and every sum in float32.  With ``skip`` a tile pair that
    ``tile_pairs`` finds hidden is left out and one it finds whole runs
    without the per-element mask, as in the kernels; ``skip=False`` masks
    every pair (the same numbers: the rules only drop exact zeros and
    all-true masks).  Returns (dq, dk, dv) in q's type."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    f32 = torch.float32
    sl2 = torch.tensor(D ** -0.5, dtype=f32) * torch.tensor(LOG2E, dtype=f32)
    qf, kf, vf, gf = (t.to(f32) for t in (q, k, v, do))
    delta = (gf * o.to(f32)).sum(-1)
    lse = lse.to(f32)
    lse2 = torch.where(lse > -torch.inf, lse * torch.tensor(LOG2E, dtype=f32), torch.inf)
    mask = position_mask(q_pos, k_pos, causal=causal, window=window)
    if skip:  # the pair rules, grown from tiles to elements
        hidden, whole = (x.repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)[:Sq, :Sk]
                         for x in tile_pairs(q_pos, k_pos, causal, window))
        mask = ~hidden & (whole | mask)

    def bf(x):  # an A operand: rounded to bf16
        return x.to(torch.bfloat16).to(f32)

    def p_ds(rows, cols):
        s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, rows], kf[:, :, cols])
        p = torch.where(mask[rows, cols], torch.exp2(s * sl2 - lse2[:, :, rows, None]), 0.0)
        dp = torch.einsum("bhqd,bhkd->bhqk", gf[:, :, rows], vf[:, :, cols])
        return p, p * (dp - delta[:, :, rows, None])

    dk = torch.zeros(B, H, Sk, D, device=q.device)
    dv = torch.zeros_like(dk)
    for t0 in range(0, Sq, TILE):  # dK, dV: the query tiles in order
        rows = slice(t0, t0 + TILE)
        p, ds = p_ds(rows, slice(None))
        dv += torch.einsum("bhqk,bhqd->bhkd", bf(p), gf[:, :, rows])
        dk += torch.einsum("bhqk,bhqd->bhkd", bf(ds), qf[:, :, rows])
    dq = torch.zeros(B, H, Sq, D, device=q.device)
    for k0 in range(0, Sk, TILE):  # dQ: the key tiles in order
        cols = slice(k0, k0 + TILE)
        _, ds = p_ds(slice(None), cols)
        dq += torch.einsum("bhqk,bhkd->bhqd", bf(ds), kf[:, :, cols])
    scale = torch.tensor(D ** -0.5, dtype=f32)
    return (dq * scale).to(q.dtype), (dk * scale).to(q.dtype), dv.to(q.dtype)


# ---------------------------------------------------------------------------
# The float32 kernels' arithmetic: 3xTF32 products on the tensor cores
# ---------------------------------------------------------------------------

FWD_KEYS = 32  # keys of the float32 forward's tiles and of a dK/dV block (``tf::BT``)


def split_tf32(x):
    """``(hi, lo)``, float32 tensors holding TF32 values (10 explicit
    mantissa bits) with ``x = hi + lo`` up to ``x``'s last 2^-22 or so:
    ``hi`` is ``x`` rounded to TF32 to nearest, ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds, and ``lo`` is ``x - hi`` rounded the same
    way.  Finite inputs."""
    def rna(y):
        bits = y.to(torch.float32).contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x.to(torch.float32) - hi)


def mm_tf32(a, b, terms: int = 3):
    """``a @ b`` as the float32 kernels form it on the tensor cores: each
    operand split (``split_tf32``) and lo·hi + hi·lo + hi·hi summed in
    float32 (TF32 products are exact in float32); ``terms=1`` is one TF32
    product, hi·hi alone."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    if terms == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def attention_3xtf32_ref(q, k, v, q_pos, k_pos, *, causal: bool = True, window: int = 0,
                         terms: int = 3):
    """What the float32 forward kernel (``flash_attention.cu``, ``tf::``)
    computes, in plain torch: the online softmax over key tiles of 32 in
    order (m from the reference's NEG, a masked score -inf), S = Q K^T and
    O += P V as ``mm_tf32`` products; each tile's two halves of 16 keys
    (the two warps that share a row group) keep their own row sums l and
    outputs O under one running max, added at the end: out = O / l (0 for
    a row with no key).  The kernel's hidden-tile skip and unmasked whole
    tiles change nothing: they drop exact zeros and all-true masks.
    Returns ``(out, lse)``: out in q's type, lse (B, H, Sq) float32, -inf
    for a row with no key.  ``terms=1``: every product one TF32 product."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    f32 = torch.float32
    qf, kf, vf = (t.to(f32) for t in (q, k, v))
    scale = torch.tensor(D ** -0.5, dtype=f32)
    mask = position_mask(q_pos, k_pos, causal=causal, window=window)
    m = torch.full((B, H, Sq), NEG, dtype=f32, device=q.device)
    l = [torch.zeros(B, H, Sq, device=q.device) for _ in range(2)]
    o = [torch.zeros(B, H, Sq, D, device=q.device) for _ in range(2)]
    half = FWD_KEYS // 2
    for k0 in range(0, Sk, FWD_KEYS):
        cols = slice(k0, k0 + FWD_KEYS)
        s = mm_tf32(qf, kf[:, :, cols].transpose(-1, -2), terms) * scale
        s = torch.where(mask[:, cols], s, -torch.inf)
        m2 = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m2[..., None])
        alpha = torch.exp(m - m2)
        for h in range(2):
            ph, vh = p[..., h * half:(h + 1) * half], vf[:, :, k0 + h * half:k0 + (h + 1) * half]
            l[h] = l[h] * alpha + ph.sum(dim=-1)
            o[h] = o[h] * alpha[..., None] + mm_tf32(ph, vh, terms)
        m = m2
    l, o = l[0] + l[1], o[0] + o[1]
    lse = torch.where(l > 0, m + torch.log(l), -torch.inf)
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype), lse


def attention_bwd_3xtf32_ref(q, k, v, q_pos, k_pos, o, lse, do, *, causal: bool = True,
                             window: int = 0, terms: int = 3):
    """What the float32 backward kernels (``tf::dq_kernel``,
    ``tf::dkdv_kernel``) compute, in plain torch: delta = rowsum(dO * O);
    P = exp(scale S - lse) under the masks (+inf in place of a row's -inf
    lse, so a row with no key gets no gradient), dS = P (dP - delta),
    every product an ``mm_tf32`` one; dV = P^T dO and dK = scale dS^T Q
    over the query tiles of 32 in order, dQ = scale dS K over the key
    tiles in order (16 keys at D > 64, else 32), each tile's two halves
    summed apart (two warps) and added at the end.  Returns (dq, dk, dv)
    float32.  ``terms=1``: every product one TF32 product."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    f32 = torch.float32
    qf, kf, vf, of, gf = (t.to(f32) for t in (q, k, v, o, do))
    scale = torch.tensor(D ** -0.5, dtype=f32)
    delta = (gf * of).sum(-1)
    lse = lse.to(f32)
    lse = torch.where(lse > -torch.inf, lse, torch.inf)
    mask = position_mask(q_pos, k_pos, causal=causal, window=window)
    s = mm_tf32(qf, kf.transpose(-1, -2), terms)
    p = torch.where(mask, torch.exp(s * scale - lse[..., None]), 0.0)
    dp = mm_tf32(gf, vf.transpose(-1, -2), terms)
    ds = p * (dp - delta[..., None])

    def tiled(a, b, n, tile):  # sum_i a[:, :, :, i] b[:, :, i] over tiles, halves apart
        parts = [0.0, 0.0]
        for t0 in range(0, n, tile):
            for h in range(2):
                i = slice(t0 + h * tile // 2, t0 + (h + 1) * tile // 2)
                parts[h] = parts[h] + mm_tf32(a[..., i], b[:, :, i], terms)
        return parts[0] + parts[1]

    pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)
    dv = tiled(pt, gf, Sq, FWD_KEYS)
    dk = tiled(dst, qf, Sq, FWD_KEYS) * scale
    dq = tiled(ds, kf, Sk, 16 if D > 64 else 32) * scale
    return dq, dk, dv
