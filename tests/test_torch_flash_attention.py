"""repro_torch flash_attention vs the reference: the port's op on CPU
tensors (the plain PyTorch version the CPU path runs) against the
reference Pallas kernel in interpret mode, on the grid of the
reference's own kernel test (causal, sliding window with padding, cross
attention, a single query, bf16, ring-cache holes) at its tolerances
(float32 2e-5, bfloat16 2e-2); and the port's plain full-sequence paths
(``blockwise_attention``, ``direct_attention``, the (B, S, H, hd) layout)
against ``repro.models.attention``'s, within 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_ops
from repro.models import attention as ref_attn
from repro_torch.kernels.flash_attention import ops
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
