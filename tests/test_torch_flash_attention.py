"""repro_torch flash_attention vs the reference: the port's op on CPU
tensors (the plain PyTorch version the CPU path runs) against the
reference Pallas kernel in interpret mode, on the grid of the
reference's own kernel test (causal, sliding window with padding, cross
attention, a single query, bf16, ring-cache holes) at its tolerances
(float32 2e-5, bfloat16 2e-2); and the port's plain full-sequence paths
(``blockwise_attention``, ``direct_attention``, the (B, S, H, hd) layout)
against ``repro.models.attention``'s, within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_ops
from repro.models import attention as ref_attn
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import attention


def _qkv(seed, B, H, Sq, Sk, D, scale=0.5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, H, n, D) * scale).astype(np.float32) for n in (Sq, Sk, Sk)]


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,window,dtype", [
    (1, 2, 64, 64, 32, True, 0, "float32"),
    (2, 1, 128, 128, 16, True, 0, "bfloat16"),
    (1, 2, 96, 160, 32, True, 48, "float32"),   # sliding window + padding
    (1, 1, 64, 256, 64, False, 0, "float32"),   # cross attention
    (2, 2, 1, 96, 32, True, 0, "float32"),      # decode-style single query
    (1, 2, 160, 160, 96, True, 0, "bfloat16"),  # D = 96 (phi-3-vision), causal
    (1, 2, 150, 150, 64, False, 0, "bfloat16"),  # encoder: non-causal, ragged S
    (2, 1, 40, 150, 64, False, 0, "bfloat16"),  # cross: Sq != Sk, ragged Sk
    (2, 1, 40, 150, 64, False, 0, "float32"),
])
def test_flash_attention_matches_reference_kernel(B, H, Sq, Sk, D, causal, window, dtype):
    q, k, v = _qkv(B * 7 + Sk, B, H, Sq, Sk, D)
    q_pos = np.arange(Sk - Sq, Sk, dtype=np.int32) if causal else np.arange(Sq, dtype=np.int32)
    k_pos = np.arange(Sk, dtype=np.int32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    launches = dict(ops.LAUNCHES)
    got = ops.flash_attention(*(_torch(a, tdt) for a in (q, k, v)), torch.from_numpy(q_pos),
                              torch.from_numpy(k_pos), causal=causal, window=window)
    assert ops.LAUNCHES == launches  # the CPU path launches no kernel
    assert got.dtype == tdt and tuple(got.shape) == (B, H, Sq, D)
    want = ref_ops.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                   jnp.asarray(q_pos), jnp.asarray(k_pos), causal=causal,
                                   window=window, blk_q=32, blk_k=32)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_flash_attention_ring_cache_holes():
    """k_pos = -1 holes (unfilled ring-buffer slots) are masked out, and a
    query with no valid key gives 0."""
    q, k, v = _qkv(0, 1, 1, 2, 64, 16, scale=1.0)
    k_pos = np.where(np.arange(64) < 40, np.arange(64), -1).astype(np.int32)
    q_pos = np.asarray([39, -5], np.int32)  # the second sees no key
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              torch.from_numpy(q_pos), torch.from_numpy(k_pos))
    want = ref_ops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(q_pos),
                                   jnp.asarray(k_pos), blk_q=8, blk_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert not got[0, 0, 1].any()


@pytest.mark.parametrize("window", [0, 40])
def test_plain_paths_match_the_reference_model(window):
    """(B, S, H, hd) layout, as the model calls them: the port's op through
    the transposed views, its blockwise and direct paths, against the
    reference's blockwise attention."""
    B, S, H, D = 2, 96, 2, 32
    q, k, v = (a.transpose(0, 2, 1, 3).copy() for a in _qkv(1, B, H, S, S, D, scale=0.3))
    pos = np.arange(S, dtype=np.int32)
    want = np.asarray(ref_attn.blockwise_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(pos), jnp.asarray(pos),
        causal=True, window=window, blk_q=32, blk_k=32))
    tq, tk, tv, tpos = (torch.from_numpy(a) for a in (q, k, v, pos))
    kernel_path = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                                      tv.transpose(1, 2), tpos, tpos, window=window)
    blockwise = attention.blockwise_attention(tq, tk, tv, tpos, tpos, window=window,
                                              blk_q=32, blk_k=32)
    direct = attention.direct_attention(tq, tk, tv, tpos, tpos, causal=True, window=window,
                                        logit_cap=0.0)
    for got in (kernel_path.transpose(1, 2), blockwise, direct):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv", [1, 2])
def test_expand_kv_groups_heads_consecutively(kv):
    """``jnp.repeat`` grouping; one KV head becomes a stride-0 view."""
    k = torch.randn(2, 5, kv, 8)
    ek, ev = attention._expand_kv(k, k, 4)
    want = np.repeat(k.numpy(), 4 // kv, axis=2)
    np.testing.assert_array_equal(ek.numpy(), want)
    if kv == 1:
        assert ek.stride(2) == 0 and ek.data_ptr() == k.data_ptr()


# ---------------------------------------------------------------------------
# The bfloat16 tensor-core kernel's arithmetic, mirrored in plain torch
# ---------------------------------------------------------------------------


def _hidden(kmin, kmax, qmin, qmax, causal, window):
    """The kernels' tile test: no query of [qmin, qmax] may see a key of
    the tile (flash_attention.cu, ``tile_hidden``)."""
    return (kmin > kmax or qmin > qmax or (causal and kmin > qmax)
            or (window > 0 and kmax <= qmin - window))


def _wgmma_mirror(q, k, v, q_pos, k_pos, *, causal, window, skip=True):
    """What ``fa_wgmma`` computes: blocks of 128 queries, two warpgroups of
    64 rows each, KV tiles of 64 keys.  A tile hidden from the block is
    never loaded, one hidden from a warpgroup is skipped there, and a tile
    every row of a warpgroup sees whole runs without the per-element mask
    (``skip=False`` masks every tile instead).  Online softmax in float32
    (masked scores -inf, m from the reference's NEG); the row sums add the
    float32 p, and P is rounded to bfloat16 before P·V.  Output in q's
    type."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()  # bf16 values, exact in float32
    q_pos, k_pos = q_pos.to(torch.int64), k_pos.to(torch.int64)
    out = torch.zeros(B, H, Sq, D)
    for q0 in range(0, Sq, 128):
        bq = q_pos[q0:q0 + 128]
        for w0 in range(q0, min(q0 + 128, Sq), 64):
            rows = slice(w0, min(w0 + 64, Sq))
            qp = q_pos[rows]
            n = qp.shape[0]
            m = torch.full((B, H, n), ref.NEG)
            l = torch.zeros(B, H, n)
            o = torch.zeros(B, H, n, D)
            for k0 in range(0, Sk, 64):
                kp = k_pos[k0:k0 + 64]
                ok = kp >= 0
                kmin = int(kp[ok].min()) if ok.any() else 2**31 - 1
                kmax = int(kp[ok].max()) if ok.any() else -2**31
                if skip and (_hidden(kmin, kmax, int(bq.min()), int(bq.max()), causal, window)
                             or _hidden(kmin, kmax, int(qp.min()), int(qp.max()), causal,
                                        window)):
                    continue
                whole = (skip and bool(ok.all()) and kp.shape[0] == 64
                         and (not causal or kmax <= int(qp.min()))
                         and (window <= 0 or kmin > int(qp.max()) - window))
                s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, rows], kf[:, :, k0:k0 + 64]) \
                    * D ** -0.5
                if not whole:
                    mask = ref.position_mask(qp, kp, causal=causal, window=window)
                    s = torch.where(mask, s, -torch.inf)
                m2 = torch.maximum(m, s.amax(dim=-1))
                p = torch.exp(s - m2[..., None])
                alpha = torch.exp(m - m2)
                l = l * alpha + p.sum(dim=-1)
                o = o * alpha[..., None] + torch.einsum(
                    "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vf[:, :, k0:k0 + 64])
                m = m2
            out[:, :, rows] = o / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


_GRID = [  # the reference's kernel-test grid, plus blocks of 128 and ring holes
    (1, 2, 64, 64, 32, True, 0, None),
    (2, 1, 128, 128, 16, True, 0, None),
    (1, 2, 96, 160, 32, True, 48, None),    # sliding window, ragged tiles
    (1, 1, 64, 256, 64, False, 0, None),    # cross attention
    (2, 2, 1, 96, 32, True, 0, None),       # a single query
    (1, 1, 300, 300, 64, True, 100, None),  # three blocks, window across tiles
    (1, 1, 2, 64, 16, True, 0, 40),         # ring holes; the second query sees nothing
    (1, 2, 200, 200, 96, True, 0, None),    # D = 96: a whole swizzle atom and half of one
    (1, 1, 150, 150, 64, False, 0, None),   # encoder: non-causal, ragged last key tile
    (2, 1, 40, 150, 64, False, 0, None),    # cross: Sq != Sk, ragged Sk
]


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,window,holes", _GRID)
def test_wgmma_numerics_match_reference(B, H, Sq, Sk, D, causal, window, holes):
    """The bf16 kernel's arithmetic against the reference's Pallas kernel
    (interpret mode) and the plain version, within the bf16 kernel-test
    tolerance 2e-2.  Why it holds: the products of bf16 inputs are exact in
    float32 and only their order of summation differs; rounding P to bf16
    moves each weight by at most 2^-9 of itself, so the output by at most
    2^-9 * max|v| (~0.004 at these |v| <= 2); the output's own bf16
    rounding adds 2^-9 of its size.  Both sit well inside 2e-2 + 2e-2|out|.
    The tile skip and the unmasked whole tiles are exact no-ops: the same
    arithmetic with every tile masked gives the same output to float32
    rounding."""
    q, k, v = _qkv(B * 11 + Sk + D, B, H, Sq, Sk, D)
    q_pos = np.arange(Sk - Sq, Sk, dtype=np.int32) if causal else np.arange(Sq, dtype=np.int32)
    k_pos = np.arange(Sk, dtype=np.int32)
    if holes:
        k_pos = np.where(k_pos < holes, k_pos, -1).astype(np.int32)
        q_pos = np.asarray([holes - 1, -5], np.int32)
    tq, tk, tv = (_torch(a, torch.bfloat16) for a in (q, k, v))
    tqp, tkp = torch.from_numpy(q_pos), torch.from_numpy(k_pos)
    got = _wgmma_mirror(tq, tk, tv, tqp, tkp, causal=causal, window=window)
    masked = _wgmma_mirror(tq, tk, tv, tqp, tkp, causal=causal, window=window, skip=False)
    np.testing.assert_allclose(got.float().numpy(), masked.float().numpy(), atol=1e-6, rtol=0)
    plain = ref.attention_ref(tq, tk, tv, tqp, tkp, causal=causal, window=window)
    kernel = ref_ops.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                     jnp.asarray(q_pos), jnp.asarray(k_pos), causal=causal,
                                     window=window, blk_q=32, blk_k=32)
    for want in (plain.numpy(), np.asarray(kernel, np.float32)):
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)
    if holes:
        assert not got[:, :, 1].any()


def test_wgmma_tile_rules_on_scattered_positions():
    """Positions out of order, holes inside tiles and a whole tile of
    holes: the skip and whole-tile rules still change nothing (float32
    rounding), and the result stays within the bf16 tolerance of the
    plain version."""
    rng = np.random.RandomState(3)
    q, k, v = _qkv(5, 1, 2, 200, 320, 32)
    k_pos = rng.permutation(320).astype(np.int32)
    k_pos[rng.rand(320) < 0.1] = -1
    k_pos[128:192] = -1
    q_pos = np.sort(rng.choice(400, 200, replace=False)).astype(np.int32)
    args = [_torch(a, torch.bfloat16) for a in (q, k, v)] + [
        torch.from_numpy(q_pos), torch.from_numpy(k_pos)]
    for causal, window in ((True, 0), (True, 64), (False, 96)):
        got = _wgmma_mirror(*args, causal=causal, window=window)
        masked = _wgmma_mirror(*args, causal=causal, window=window, skip=False)
        np.testing.assert_allclose(got.float().numpy(), masked.float().numpy(), atol=1e-6)
        plain = ref.attention_ref(*args, causal=causal, window=window)
        np.testing.assert_allclose(got.float().numpy(), plain.numpy(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("layout", ["bshd", "mqa", "mqa_unshared", "unaligned", "one_query"])
def test_tma_view_layouts(layout):
    """The bf16 kernel's TMA maps: a (B, S, H, D) projection viewed as
    (B, H, S, D) and MQA's stride-0 head are read in place (the head axis
    collapsed to length 1); a stride-0 axis that may not be shared, or an
    unaligned base, is copied to a contiguous tensor."""
    B, S, H, D = 2, 5, 4, 32
    base = torch.zeros(2000, dtype=torch.bfloat16)
    if layout == "bshd":
        t, shared = base[:B * S * H * D].view(B, S, H, D).transpose(1, 2), True
        want = (B, H, S * H * D, D, H * D)
    elif layout in ("mqa", "mqa_unshared"):
        one = base[:B * S * D].view(B, S, 1, D)
        t, shared = one.expand(B, S, H, D).transpose(1, 2), layout == "mqa"
        want = (B, 1, S * D, S * D, D) if shared else (B, H, H * S * D, S * D, D)
    elif layout == "unaligned":
        t, shared = base[1:1 + B * H * S * D].view(B, H, S, D), True
        want = (B, H, H * S * D, S * D, D)
    else:
        t, shared = base[:B * H * D].view(B, H, 1, D), True
        want = (B, H, H * D, D, D)
    got, *dims = ops.tma_view(t, shared=shared)
    assert tuple(dims) == want
    assert torch.equal(got, t)
    in_place = layout in ("bshd", "mqa", "one_query")
    assert (got.data_ptr() == t.data_ptr()) == in_place
    assert got.data_ptr() % 16 == 0


@pytest.mark.parametrize("layout", ["contiguous", "bshd", "mqa", "unaligned", "odd_stride",
                                    "one_query"])
def test_f32_view_layouts(layout):
    """The float32 kernels' 16-byte ``cp.async`` copies: a (B, S, H, D)
    projection viewed as (B, H, S, D), MQA's stride-0 head and a length-1
    axis of any stride are read in place; an unaligned base or a stride
    that is no multiple of 4 elements is copied to a contiguous tensor."""
    B, S, H, D = 2, 5, 4, 32
    base = torch.arange(4000, dtype=torch.float32)
    if layout == "contiguous":
        t = base[:B * H * S * D].view(B, H, S, D)
    elif layout == "bshd":
        t = base[:B * S * H * D].view(B, S, H, D).transpose(1, 2)
    elif layout == "mqa":
        t = base[:B * S * D].view(B, 1, S, D).expand(B, H, S, D)
    elif layout == "unaligned":
        t = base[1:1 + B * H * S * D].view(B, H, S, D)
    elif layout == "odd_stride":
        t = base[:B * H * S * (D + 1)].view(B, H, S, D + 1)[..., :D]
    else:
        t = base.as_strided((B, H, 1, D), (H * D, D, 7, 1))  # the length-1 axis' stride unused
    got = ops.f32_view(t)
    assert torch.equal(got, t)
    in_place = layout in ("contiguous", "bshd", "mqa", "one_query")
    assert (got.data_ptr() == t.data_ptr()) == in_place
    assert got.data_ptr() % 16 == 0 and got.stride(-1) == 1
    assert all(s % 4 == 0 for n, s in zip(got.shape[:3], got.stride()[:3]) if n > 1)


# ---------------------------------------------------------------------------
# Backward and the row log-sum-exp
# ---------------------------------------------------------------------------

BWD_TOL = dict(atol=1e-5, rtol=1e-5)


def _bwd_case(seed, B, H, Sq, Sk, D, causal, window, holes):
    q, k, v = _qkv(seed, B, H, Sq, Sk, D)
    do = np.random.RandomState(seed + 1).randn(B, H, Sq, D).astype(np.float32) * 0.5
    k_pos = np.arange(Sk, dtype=np.int32)
    q_pos = (k_pos[Sk - Sq:] if causal else k_pos[:Sq]).copy()
    if holes:
        k_pos = np.where(k_pos % 5 == 2, -1, k_pos).astype(np.int32)
        q_pos[0] = -1  # a row with no key
    return q, k, v, do, q_pos, k_pos


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,window,holes", [
    (1, 2, 40, 40, 16, True, 0, False),
    (2, 1, 48, 80, 32, True, 24, False),   # window, Sq < Sk
    (1, 2, 33, 50, 16, False, 0, False),   # cross attention
    (1, 1, 45, 45, 32, True, 10, True),    # holes, a row with no key
])
def test_attention_bwd_ref_matches_jax_vjp(B, H, Sq, Sk, D, causal, window, holes):
    """``attention_bwd_ref`` (explicit formulas) and ``lse_ref`` against
    jax.vjp of the reference's oracle ``attention_ref``."""
    from repro.kernels.flash_attention.ref import attention_ref as jax_attention

    q, k, v, do, q_pos, k_pos = _bwd_case(Sq + D, B, H, Sq, Sk, D, causal, window, holes)
    kw = dict(causal=causal, window=window)
    out, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, jnp.asarray(q_pos),
                                                      jnp.asarray(k_pos), **kw),
                       *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo, tqp, tkp = (torch.from_numpy(a) for a in (q, k, v, do, q_pos, k_pos))
    lse = ref.lse_ref(tq, tk, tqp, tkp, **kw)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * D ** -0.5
    ok = ref.position_mask(tqp, tkp, **kw).numpy()
    want_lse = np.asarray(jax.nn.logsumexp(jnp.where(ok, s, -jnp.inf), axis=-1))
    np.testing.assert_allclose(lse.numpy(), want_lse, **BWD_TOL)
    assert np.isneginf(lse.numpy()[..., 0]).all() == holes
    got = ref.attention_bwd_ref(tq, tk, tv, tqp, tkp, torch.from_numpy(np.asarray(out)), lse,
                                tdo, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **BWD_TOL)
    if holes:
        assert not got[0][:, :, 0].any()


def test_attention_function_plumbing_on_cpu():
    """``FlashAttention`` (what the wrapper applies on the card) run on CPU
    tensors, where its forward and backward calls take the plain versions,
    with one KV head expanded at stride 0 as the model passes it: the
    gradients autograd gives through it (the expand's backward summing
    the heads' dK, dV) equal the reference's."""
    from repro.kernels.flash_attention.ref import attention_ref as jax_attention

    B, H, S, D = 2, 3, 40, 16
    q, k1, v1, do, q_pos, k_pos = _bwd_case(3, B, 1, S, S, D, True, 12, True)
    q = np.repeat(q, H, axis=1) * np.linspace(0.5, 1.5, H)[None, :, None, None]
    q = q.astype(np.float32)
    do = np.repeat(do, H, axis=1)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k1, v1)]
    launches = dict(ops.LAUNCHES)
    out = ops.FlashAttention.apply(leaves[0], leaves[1].expand(B, H, S, D),
                                   leaves[2].expand(B, H, S, D), torch.from_numpy(q_pos),
                                   torch.from_numpy(k_pos), True, 12)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert ops.LAUNCHES == launches

    def f(a, b, c):
        return jax_attention(a, jnp.repeat(b, H, axis=1), jnp.repeat(c, H, axis=1),
                             jnp.asarray(q_pos), jnp.asarray(k_pos), causal=True, window=12)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k1, v1)))
    for name, g, w in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,window,holes", [
    (1, 2, 40, 40, 16, True, 0, False),
    (2, 1, 48, 80, 32, True, 24, False),   # window, Sq < Sk
    (1, 2, 33, 50, 16, False, 0, False),   # cross attention
    (1, 1, 45, 45, 32, True, 10, True),    # holes, a row with no key
    (1, 2, 200, 200, 256, True, 96, False),  # D = 256, window across tiles
    (1, 2, 100, 100, 48, False, 0, False),   # D = 48, zero-filled to 64 on the card
    (2, 1, 40, 150, 96, False, 0, False),    # cross, ragged Sk, D = 96 (128 on the card)
])
def test_attention_bwd_bf16_ref_matches_jax_vjp(B, H, Sq, Sk, D, causal, window, holes):
    """``attention_bwd_bf16_ref`` (the bf16 wgmma backward's arithmetic) on
    bf16 inputs against jax.vjp of the reference's oracle on the same
    values, within 2^-7 of each output's largest value and rtol 2^-7
    (chip_smoke's BWD_TOL for bf16).  Why it holds: products of bf16
    values are exact in float32 and the sums are float32, so what differs
    is where the emulation rounds: O to bf16 (moving delta by ~2^-9 of
    |dO||O|), P^T and dS^T to bf16 before the updates (2^-9 of each term,
    the rounding errors adding as a random walk, so a few 2^-9 of the
    output's typical size at most), and the outputs to bf16 (2^-9 of
    each element, inside rtol).  The tile skip and the whole-tile rules
    change nothing: the same arithmetic with every pair masked agrees to
    1e-6."""
    from repro.kernels.flash_attention.ref import attention_ref as jax_attention

    q, k, v, do, q_pos, k_pos = _bwd_case(Sq + D, B, H, Sq, Sk, D, causal, window, holes)
    q, k, v, do = (_torch(a, torch.bfloat16).float().numpy() for a in (q, k, v, do))
    kw = dict(causal=causal, window=window)
    out, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, jnp.asarray(q_pos),
                                                      jnp.asarray(k_pos), **kw),
                       *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (_torch(a, torch.bfloat16) for a in (q, k, v, do))
    tqp, tkp = torch.from_numpy(q_pos), torch.from_numpy(k_pos)
    o = _torch(np.array(out), torch.bfloat16)
    lse = ref.lse_ref(tq, tk, tqp, tkp, **kw)
    got = ref.attention_bwd_bf16_ref(tq, tk, tv, tqp, tkp, o, lse, tdo, **kw)
    masked = ref.attention_bwd_bf16_ref(tq, tk, tv, tqp, tkp, o, lse, tdo, skip=False, **kw)
    for name, g, m, w in zip(("dq", "dk", "dv"), got, masked, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        np.testing.assert_allclose(g.float().numpy(), m.float().numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(g.float().numpy(), w, atol=2.0 ** -7 * np.abs(w).max(),
                                   rtol=2.0 ** -7, err_msg=name)
    if holes:
        assert not got[0][:, :, 0].any()


# ---------------------------------------------------------------------------
# The float32 kernels' arithmetic: 3xTF32 products, mirrored in plain torch
# ---------------------------------------------------------------------------


def _bits(x):
    return x.contiguous().view(torch.int32)


def test_split_tf32_rounds_to_nearest_ties_away():
    """``split_tf32`` as ``cvt.rna.tf32.f32``: hi and lo keep 10 explicit
    mantissa bits (the low 13 bits zero), hi is the nearest TF32 value with
    ties away from zero, and hi + lo leaves at most 2^-22 of x behind."""
    x = torch.tensor([1.0, 1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -12, 1 + 2 ** -12,
                      1 / 3, -1 / 3, 0.0, 1.5 * 2.0 ** -126, 65504.0])
    hi, lo = ref.split_tf32(x)
    assert hi[1] == 1 + 2 ** -10 and hi[2] == -(1 + 2 ** -10)  # ties away from zero
    assert hi[3] == 1 + 2 ** -10 and hi[4] == 1.0  # nearest
    rng = np.random.RandomState(0)
    x = torch.cat([x, torch.from_numpy(rng.randn(10_000).astype(np.float32)
                                       * np.float32(10.0) ** rng.randint(-8, 8, 10_000))])
    hi, lo = ref.split_tf32(x)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    xd, hd, ld = (t.double() for t in (x, hi, lo))
    assert ((xd - hd).abs() <= 2.0 ** -11 * xd.abs()).all()
    assert ((xd - hd - ld).abs() <= 2.0 ** -22 * xd.abs()).all()


_F32_GRID = [  # the float32 cases of the reference's kernel-test grid, ring holes, D = 256
    (1, 2, 64, 64, 32, True, 0, None),
    (1, 2, 96, 160, 32, True, 48, None),
    (1, 1, 64, 256, 64, False, 0, None),
    (2, 2, 1, 96, 32, True, 0, None),
    (1, 1, 2, 64, 16, True, 0, 40),
    (1, 2, 200, 200, 256, True, 96, None),
    (2, 1, 40, 150, 64, False, 0, None),  # cross, ragged Sk
]


def _f32_case(B, H, Sq, Sk, D, causal, window, holes):
    q, k, v = _qkv(B * 7 + Sk + D, B, H, Sq, Sk, D)
    q_pos = np.arange(Sk - Sq, Sk, dtype=np.int32) if causal else np.arange(Sq, dtype=np.int32)
    k_pos = np.arange(Sk, dtype=np.int32)
    if holes:
        k_pos = np.where(k_pos < holes, k_pos, -1).astype(np.int32)
        q_pos = np.asarray([holes - 1, -5], np.int32)
    return q, k, v, q_pos, k_pos


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,window,holes", _F32_GRID)
def test_3xtf32_forward_matches_reference_kernel(B, H, Sq, Sk, D, causal, window, holes):
    """``attention_3xtf32_ref`` (the float32 kernel's arithmetic: 3xTF32
    products, 32-key tiles split in two halves with their own sums) against
    the reference's Pallas kernel (interpret mode) within the reference's
    float32 tolerance 2e-5, and its lse against ``lse_ref``.  Why it holds:
    each split product is exact in float32 and the dropped lo·lo term and
    lo's own rounding sit near 2^-22 of a product, so the output moves by a
    few float32 roundings; the one-term test below shows the split is
    needed."""
    q, k, v, q_pos, k_pos = _f32_case(B, H, Sq, Sk, D, causal, window, holes)
    kw = dict(causal=causal, window=window)
    args = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
    got, lse = ref.attention_3xtf32_ref(*args, **kw)
    want = ref_ops.flash_attention(*(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)),
                                   blk_q=32, blk_k=32, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    want_lse = ref.lse_ref(*args[:2], *args[3:], **kw)
    assert torch.equal(torch.isfinite(lse), torch.isfinite(want_lse))
    finite = torch.isfinite(want_lse)
    np.testing.assert_allclose(lse[finite].numpy(), want_lse[finite].numpy(), atol=2e-5,
                               rtol=2e-5)
    if holes:
        assert not got[:, :, 1].any()


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,window,holes", [
    (1, 2, 40, 40, 16, True, 0, False),
    (2, 1, 48, 80, 32, True, 24, False),   # window, Sq < Sk
    (1, 2, 33, 50, 16, False, 0, False),   # cross attention
    (1, 1, 45, 45, 32, True, 10, True),    # holes, a row with no key
    (1, 2, 200, 200, 256, True, 96, False),  # D = 256: dQ's key tiles of 16
    (1, 2, 100, 100, 48, False, 0, False),   # D = 48 (compiled as 64)
    (2, 1, 40, 150, 64, False, 0, False),    # cross, ragged Sk
])
def test_attention_bwd_3xtf32_ref_matches_jax_vjp(B, H, Sq, Sk, D, causal, window, holes):
    """``attention_bwd_3xtf32_ref`` (the float32 backward kernels'
    arithmetic) against jax.vjp of the reference's oracle, within 2e-5."""
    from repro.kernels.flash_attention.ref import attention_ref as jax_attention

    q, k, v, do, q_pos, k_pos = _bwd_case(Sq + D, B, H, Sq, Sk, D, causal, window, holes)
    kw = dict(causal=causal, window=window)
    out, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, jnp.asarray(q_pos),
                                                      jnp.asarray(k_pos), **kw),
                       *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo, tqp, tkp = (torch.from_numpy(a) for a in (q, k, v, do, q_pos, k_pos))
    lse = ref.lse_ref(tq, tk, tqp, tkp, **kw)
    got = ref.attention_bwd_3xtf32_ref(tq, tk, tv, tqp, tkp, torch.from_numpy(np.array(out)),
                                       lse, tdo, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5, rtol=2e-5, err_msg=name)
    if holes:
        assert not got[0][:, :, 0].any()


def test_one_term_tf32_misses_the_tolerance():
    """The reason for the split: at D = 256 one TF32 product per product
    (``terms=1``: 11 significant bits) puts the forward and every gradient
    outside 2e-5 of the reference, where the 3xTF32 arithmetic sits inside
    it (the tests above)."""
    from repro.kernels.flash_attention.ref import attention_ref as jax_attention

    B, H, S, D, window = 1, 2, 200, 256, 96
    q, k, v, q_pos, k_pos = _f32_case(B, H, S, S, D, True, window, None)
    kw = dict(causal=True, window=window)
    args = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
    out, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, jnp.asarray(q_pos),
                                                      jnp.asarray(k_pos), **kw),
                       *(jnp.asarray(a) for a in (q, k, v)))
    do = np.random.RandomState(1).randn(B, H, S, D).astype(np.float32) * 0.5
    lse = ref.lse_ref(*args[:2], *args[3:], **kw)
    one = [ref.attention_3xtf32_ref(*args, terms=1, **kw)[0]] + list(
        ref.attention_bwd_3xtf32_ref(*args, torch.from_numpy(np.array(out)), lse,
                                     torch.from_numpy(do), terms=1, **kw))
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    for name, g, w in zip(("out", "dq", "dk", "dv"), one, want):
        assert not np.allclose(g.numpy(), w, atol=2e-5, rtol=2e-5), name
