"""The LM kernels' training path on the card: the forward attention
kernels' row log-sum-exp, the attention backward kernels and the RG-LRU
backward scan against their plain versions (``ref.lse_ref``,
``ref.attention_bwd_ref``, ``ref.rglru_bwd_ref`` and the emulation of the
reverse chunk decomposition), and the wrappers' gradients through their
``autograd.Function``s against autograd through the plain versions on the
CPU.  Causal, windowed and cross masks, ring-cache holes, a row with no
key, one KV head at stride 0, ragged tiles and chunks; float32 within
2e-5 and bfloat16 within 2e-2 (the reference's kernel-test tolerances),
the log-sum-exp within 1e-4.  The float32 kernels are also held within
2^-16 of each output's largest value of the emulation of their 3xTF32
arithmetic (``ref.attention_3xtf32_ref``, ``ref.attention_bwd_3xtf32_ref``),
at the reduced train step's shape, past 256 tiles of 32 (the kernels list
the tiles they may see 256 at a time) and on the layouts a caller may pass
(a (B, S, H, D) view, MQA's stride-0 head, an unaligned base, a sequence
stride that is no multiple of 4).  Needs the card; run there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_bwd_cuda.py

When ``test_rglru_function_gradients`` fails, it saves its inputs and
both sides' gradients under ``build/rglru_failures/`` and names the file;
``python3 tools/rglru_replay.py FILE`` reruns the CPU side from it in a
fresh process and says whether its bits repeat.
"""
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan import ref as rg_ref

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
LSE_TOL = dict(atol=1e-4, rtol=1e-4)
F32_REF_TOL = 2.0 ** -16  # chip_smoke's: split products, sums rounded otherwise
FAILURES = Path(__file__).resolve().parents[1] / "build" / "rglru_failures"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward passes are CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _attention(card, B, H, Sq, Sk, D, causal, window, holes, dtype, shared_kv, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = (torch.randn(B, H, Sq, D, generator=g) * 0.5).to(dtype)
    if shared_kv:  # one KV head expanded to H at stride 0, as the model passes it
        k, v = ((torch.randn(B, 1, Sk, D, generator=g) * 0.5).to(dtype).to(card)
                .expand(B, H, Sk, D) for _ in range(2))
    else:
        k, v = ((torch.randn(B, H, Sk, D, generator=g) * 0.5).to(dtype).to(card)
                for _ in range(2))
    k_pos = torch.arange(Sk, dtype=torch.int32)
    q_pos = k_pos[Sk - Sq:].clone() if causal else k_pos[:Sq].clone()
    if holes:
        k_pos = torch.where(k_pos % 5 == 2, -1, k_pos)
        q_pos[0] = -1  # sees no key
    do = (torch.randn(B, H, Sq, D, generator=g) * 0.5).to(dtype)
    return q.to(card), k, v, q_pos.to(card), k_pos.to(card), do.to(card)


ATTN_CASES = [
    (1, 2, 64, 64, 32, True, 0, False, torch.float32, False),
    (2, 2, 96, 160, 32, True, 48, False, torch.float32, False),
    (1, 1, 64, 256, 64, False, 0, False, torch.float32, False),
    (2, 2, 1, 96, 32, True, 0, False, torch.float32, False),
    (1, 2, 70, 70, 16, True, 0, True, torch.float32, True),
    (1, 2, 77, 77, 256, True, 20, True, torch.float32, False),
    (4, 4, 64, 64, 16, True, 32, False, torch.float32, True),  # the reduced train step
    (2, 2, 130, 130, 128, True, 40, True, torch.float32, True),  # dQ's 16-key tiles
    (1, 1, 8300, 8300, 16, True, 64, False, torch.float32, False),  # 260 tiles of 32
    (2, 4, 300, 300, 256, True, 128, False, torch.bfloat16, True),
    (1, 2, 200, 200, 64, True, 0, False, torch.bfloat16, False),
    (2, 3, 129, 129, 128, True, 40, True, torch.bfloat16, True),
    (1, 2, 100, 100, 48, False, 0, False, torch.bfloat16, False),
    (1, 3, 130, 130, 256, True, 0, True, torch.bfloat16, False),  # S not a multiple of 64
    (2, 2, 333, 333, 256, True, 100, False, torch.bfloat16, True),
    (2, 2, 70, 200, 128, True, 64, False, torch.bfloat16, True),  # cross: Sq < Sk
    (1, 2, 64, 256, 64, False, 0, False, torch.bfloat16, False),
    (2, 2, 1, 96, 32, True, 0, False, torch.bfloat16, False),  # a single query
    # D = 96 (the VLM's head dim) on the DP = 128 kernels: 32 padding columns
    (2, 3, 150, 150, 96, True, 0, False, torch.bfloat16, False),
    (1, 2, 100, 230, 96, False, 0, False, torch.bfloat16, False),  # Sq != Sk, ragged Sk
    (2, 2, 90, 300, 64, False, 0, False, torch.bfloat16, False),  # cross, Sk % 64 != 0
]


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,window,holes,dtype,shared_kv", ATTN_CASES)
def test_attention_lse_and_backward_kernels(card, B, H, Sq, Sk, D, causal, window, holes,
                                            dtype, shared_kv):
    q, k, v, q_pos, k_pos, do = _attention(card, B, H, Sq, Sk, D, causal, window, holes,
                                           dtype, shared_kv, seed=Sq * 31 + D)
    kw = dict(causal=causal, window=window)
    out, lse = fa_ops.flash_attention_lse(q, k, v, q_pos, k_pos, **kw)
    torch.cuda.synchronize()
    want_lse = fa_ref.lse_ref(q, k, q_pos, k_pos, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    finite = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), finite)
    torch.testing.assert_close(lse[finite], want_lse[finite], **LSE_TOL)
    assert torch.equal(out, fa_ops.flash_attention(q, k, v, q_pos, k_pos, **kw))

    launches = dict(fa_ops.LAUNCHES)
    got = fa_ops.flash_attention_bwd(q, k, v, q_pos, k_pos, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["bwd"] == launches["bwd"] + 1
    want = fa_ref.attention_bwd_ref(q, k, v, q_pos, k_pos, out, lse, do, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and torch.isfinite(a).all(), name
        torch.testing.assert_close(a, w.to(dtype), msg=name, **TOL[dtype])
    if holes:  # the row with no key gets no gradient
        assert not got[0][:, :, 0].any()
    again = fa_ops.flash_attention_bwd(q, k, v, q_pos, k_pos, out, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics
    if dtype == torch.float32:
        _hold_to_3xtf32(q, k, v, q_pos, k_pos, out, lse, do, got, kw)


def _hold_to_3xtf32(q, k, v, q_pos, k_pos, out, lse, do, grads, kw):
    """The float32 kernels' outputs against the emulation of their 3xTF32
    arithmetic, within F32_REF_TOL of each output's largest value."""
    want = [fa_ref.attention_3xtf32_ref(q, k, v, q_pos, k_pos, **kw)[0]]
    want += fa_ref.attention_bwd_3xtf32_ref(q, k, v, q_pos, k_pos, out, lse, do, **kw)
    for name, a, w in zip(("out", "dq", "dk", "dv"), (out,) + tuple(grads), want):
        lim = F32_REF_TOL * float(w.abs().max())
        torch.testing.assert_close(a, w, atol=lim, rtol=F32_REF_TOL, msg=name)


@pytest.mark.parametrize("layout", ["bshd", "mqa_bshd", "unaligned", "odd_stride"])
def test_f32_attention_layouts(card, layout):
    """float32 q, k, v (and o, dO) as a caller may pass them: a (B, S, H,
    D) projection viewed as (B, H, S, D) and MQA's stride-0 head go to the
    kernels in place; an unaligned base and a sequence stride of D + 1
    are copied first (``f32_view``).  Forward and backward against the
    plain versions and the 3xTF32 emulation."""
    B, S, H, D = 2, 77, 3, 32
    g = torch.Generator(device="cpu").manual_seed(7)

    def make(heads):
        x = torch.randn(B, S, heads, D, generator=g) * 0.5
        if layout == "unaligned":
            flat = torch.empty(x.numel() + 1)
            flat[1:] = x.flatten()
            return flat.to(card)[1:].view(B, S, heads, D).transpose(1, 2)
        if layout == "odd_stride":
            wide = torch.zeros(B, S, heads, D + 1)
            wide[..., :D] = x
            return wide.to(card).transpose(1, 2)[..., :D]
        return x.to(card).transpose(1, 2)

    q, do = make(H), make(H)
    if layout == "mqa_bshd":
        k, v = (make(1).expand(B, H, S, D) for _ in range(2))
        assert k.stride(1) == 0
    else:
        k, v = make(H), make(H)
    in_place = layout in ("bshd", "mqa_bshd")
    assert all((fa_ops.f32_view(t).data_ptr() == t.data_ptr()) == in_place for t in (q, k, v))
    pos = torch.arange(S, dtype=torch.int32, device=card)
    kw = dict(causal=True, window=30)
    out, lse = fa_ops.flash_attention_lse(q, k, v, pos, pos, **kw)
    got = fa_ops.flash_attention_bwd(q, k, v, pos, pos, out, lse, do, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, fa_ref.attention_ref(q, k, v, pos, pos, **kw),
                               **TOL[torch.float32])
    want = fa_ref.attention_bwd_ref(q, k, v, pos, pos, out, lse, do, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, w, msg=name, **TOL[torch.float32])
    _hold_to_3xtf32(q, k, v, pos, pos, out, lse, do, got, kw)


def test_attention_bf16_backward_is_deterministic(card):
    """Two calls of the bf16 backward (the wgmma kernels: no atomics, each
    accumulator summing its tiles in one fixed order) give the same bits,
    on a shape with many tiles a block: D = 256, one KV head at stride 0,
    causal with a window across tiles, S not a multiple of 64."""
    q, k, v, q_pos, k_pos, do = _attention(card, 2, 4, 1000, 1000, 256, True, 300, False,
                                           torch.bfloat16, True, seed=9)
    out, lse = fa_ops.flash_attention_lse(q, k, v, q_pos, k_pos, causal=True, window=300)
    first = fa_ops.flash_attention_bwd(q, k, v, q_pos, k_pos, out, lse, do, causal=True,
                                       window=300)
    for _ in range(2):
        again = fa_ops.flash_attention_bwd(q, k, v, q_pos, k_pos, out, lse, do, causal=True,
                                           window=300)
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), first, again):
            assert torch.equal(a, b), name


def test_attention_bf16_backward_tile_of_holes(card):
    """A whole 64-key tile of holes (its dK/dV block streams no query tile
    and writes zeros; no dQ block loads it) and a query that sees no key,
    under a window across tiles."""
    q, k, v, q_pos, k_pos, do = _attention(card, 1, 2, 200, 200, 64, True, 90, False,
                                           torch.bfloat16, False, seed=11)
    k_pos = k_pos.clone()
    k_pos[64:128] = -1
    q_pos = q_pos.clone()
    q_pos[5] = -1
    kw = dict(causal=True, window=90)
    out, lse = fa_ops.flash_attention_lse(q, k, v, q_pos, k_pos, **kw)
    got = fa_ops.flash_attention_bwd(q, k, v, q_pos, k_pos, out, lse, do, **kw)
    torch.cuda.synchronize()
    want = fa_ref.attention_bwd_ref(q, k, v, q_pos, k_pos, out, lse, do, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, w.to(torch.bfloat16), msg=name, **TOL[torch.bfloat16])
    assert not got[1][:, :, 64:128].any() and not got[2][:, :, 64:128].any()
    assert not got[0][:, :, 5].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_function_gradients(card, dtype):
    """The wrapper on tensors that need a gradient (one KV head expanded
    at stride 0, causal, window 24) against autograd through the plain
    version on the CPU."""
    B, H, S, D = 2, 4, 90, 64
    q, k, v, q_pos, k_pos, do = _attention(card, B, H, S, S, D, True, 24, False, dtype,
                                           True, seed=5)
    leaves = [q.clone().requires_grad_(), k[:, :1].clone().requires_grad_(),
              v[:, :1].clone().requires_grad_()]

    def run(qq, kk, vv, dev):
        kk, vv = kk.expand(B, H, S, D), vv.expand(B, H, S, D)
        out = fa_ops.flash_attention(qq, kk, vv, q_pos.to(dev), k_pos.to(dev), causal=True,
                                     window=24)
        return torch.autograd.grad(out, (qq, kk, vv), do.to(dev))

    before = dict(fa_ops.LAUNCHES)
    got = run(*leaves, card)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert fa_ops.LAUNCHES["bwd"] == before["bwd"] + 1
    host = [t.detach().cpu().float().requires_grad_() for t in leaves]
    want = run(*host, "cpu")
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float().cpu(), w, msg=name, **TOL[dtype])


def _scan_inputs(card, B, S, W, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    log_a = -torch.rand(B, S, W, generator=g) * 0.5
    b = torch.randn(B, S, W, generator=g)
    dh = torch.randn(B, S, W, generator=g)
    return log_a.to(card), b.to(card), dh.to(card)


def _offset(t):
    """``t`` copied into a contiguous view one element into its storage:
    every row 4 bytes off a 16-byte boundary."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return view.copy_(t)


@pytest.mark.parametrize("B,S,W,offset", [
    pytest.param(B, S, W, offset, id=f"{B}-{S}-{W}" + ("-offset" if offset else ""))
    for B, S, W, offset in [
        # W % 4 != 0: the per-lane load path
        (2, 1, 33, False), (1, 63, 33, False), (2, 64, 17, False), (1, 65, 65, False),
        (1, 3 * 64 + 5, 31, False), (1, 4097, 130, False),
        # W % 4 == 0: the bulk path; S = 1, S < CHUNK, S % CHUNK != 0, a tile of
        # 4 lanes (W = 4, and 132's last), the training path's shape
        (1, 1, 128, False), (1, 63, 64, False), (2, 70, 4, False), (1, 3 * 64 + 5, 132, False),
        (2, 4096, 256, False), (2, 4096, 4096, False),
        # W % 4 == 0 at an odd storage offset: the per-lane path
        (1, 130, 96, True)]])
def test_rglru_backward_kernel(card, B, S, W, offset):
    """Both load paths, chosen from W and the pointers, within TOL of the
    plain version and of the chunked emulation, the same bits twice, and
    the carries' scratch, kept from call to call, left zero."""
    log_a, b, dh = _scan_inputs(card, B, S, W, seed=S + W)
    h = rg_ops.rglru(log_a, b)
    if offset:
        log_a, h, dh = (_offset(t) for t in (log_a, h, dh))
    assert rg_ops.bwd_load_path(log_a, h, dh) == ("bulk" if W % 4 == 0 and not offset
                                                  else "lane")
    launches = dict(rg_ops.LAUNCHES)
    got = rg_ops.rglru_bwd(log_a, h, dh)
    torch.cuda.synchronize()
    assert rg_ops.LAUNCHES["bwd"] == launches["bwd"] + 1
    assert not rg_ops._bwd_scratch(log_a).any()  # left zero for the next launch
    for want in (rg_ref.rglru_bwd_ref(log_a, h, dh),
                 rg_ref.rglru_bwd_chunked_ref(log_a, h, dh, rg_ops.CHUNK)):
        for name, a, w in zip(("dlog_a", "db"), got, want):
            torch.testing.assert_close(a, w, msg=name, **TOL[torch.float32])
    again = rg_ops.rglru_bwd(log_a, h, dh)
    assert all(torch.equal(a, c) for a, c in zip(got, again))  # one fixed order


def _rglru_grads64(log_a, b, dh):
    """(dlog_a, db) of the recurrence step by step in float64 on the host:
    the yardstick that says which side of a failed comparison moved."""
    la, b, dh = (t.detach().cpu().double() for t in (log_a, b, dh))
    a = la.exp()
    h, hs = torch.zeros_like(b[:, 0]), []
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    h_prev = torch.stack([torch.zeros_like(h)] + hs[:-1], dim=1)
    g, gs = torch.zeros_like(h), []
    for t in reversed(range(b.shape[1])):
        g = dh[:, t] + (a[:, t + 1] * g if t + 1 < b.shape[1] else 0.0)
        gs.append(g)
    g = torch.stack(gs[::-1], dim=1)
    return g * a * h_prev, g


def test_rglru_function_gradients(card):
    log_a, b, dh = _scan_inputs(card, 2, 300, 96, seed=3)
    la, bb = log_a.clone().requires_grad_(), b.clone().requires_grad_()
    before = dict(rg_ops.LAUNCHES)
    got = torch.autograd.grad(rg_ops.rglru(la, bb), (la, bb), dh)
    torch.cuda.synchronize()
    assert rg_ops.LAUNCHES == {"rglru": before["rglru"] + 1, "bwd": before["bwd"] + 1}
    la_h, b_h = (t.detach().cpu().requires_grad_() for t in (log_a, b))
    want = torch.autograd.grad(rg_ops.rglru(la_h, b_h), (la_h, b_h), dh.cpu())
    exact = _rglru_grads64(log_a, b, dh)
    try:
        for name, a, w, x in zip(("dlog_a", "db"), got, want, exact):
            a = a.cpu()

            def why(msg, a=a, w=w, x=x, name=name):
                i = tuple(int(j) for j in np.unravel_index(int((a - w).abs().argmax()),
                                                           a.shape))
                return (f"{name}, card vs CPU: {msg}\nat {i}: card {a[i].item()!r}, CPU "
                        f"{w[i].item()!r}, float64 {x[i].item()!r}; largest distance from "
                        f"float64: card {(a - x).abs().max().item():.3g}, CPU "
                        f"{(w - x).abs().max().item():.3g}")

            torch.testing.assert_close(a, w, msg=why, **TOL[torch.float32])
    except AssertionError as e:
        path = _save_failure(log_a, b, dh, got, want)
        raise AssertionError(f"{e}\ninputs and both sides' gradients saved to {path}; "
                             f"python3 tools/rglru_replay.py {path} reruns the CPU side "
                             f"in a fresh process") from None


def _save_failure(log_a, b, dh, card_grads, cpu_grads) -> Path:
    """The failed comparison's inputs and gradients (each side's dlog_a and
    db) on the host, in a file of its own under FAILURES."""
    FAILURES.mkdir(parents=True, exist_ok=True)
    stamp = f"{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}"
    path = FAILURES / f"rglru_function_gradients_{stamp}.pt"
    host = [t.detach().cpu() for t in (log_a, b, dh)]
    torch.save({"log_a": host[0], "b": host[1], "dh": host[2],
                "card": [g.detach().cpu() for g in card_grads],
                "cpu": [g.detach().cpu() for g in cpu_grads],
                "torch": str(torch.__version__), "threads": torch.get_num_threads()}, path)
    return path


def test_f32_single_query_any_stride(card):
    """A single query (Sq = 1, as in decoding) whose sequence stride is no
    multiple of 4: the kernels never step over that axis, so they read q
    in place (the launchers get stride 0 there)."""
    B, H, Sk, D = 2, 3, 96, 32
    g = torch.Generator(device="cpu").manual_seed(3)
    q = (torch.randn(B * H * D, generator=g) * 0.5).to(card).as_strided((B, H, 1, D),
                                                                        (H * D, D, 7, 1))
    k, v, do = ((torch.randn(B, H, n, D, generator=g) * 0.5).to(card) for n in (Sk, Sk, 1))
    q_pos = torch.tensor([Sk - 1], dtype=torch.int32, device=card)
    k_pos = torch.arange(Sk, dtype=torch.int32, device=card)
    assert fa_ops.f32_view(q).data_ptr() == q.data_ptr()
    kw = dict(causal=True, window=40)
    out, lse = fa_ops.flash_attention_lse(q, k, v, q_pos, k_pos, **kw)
    got = fa_ops.flash_attention_bwd(q, k, v, q_pos, k_pos, out, lse, do, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, fa_ref.attention_ref(q, k, v, q_pos, k_pos, **kw),
                               **TOL[torch.float32])
    want = fa_ref.attention_bwd_ref(q, k, v, q_pos, k_pos, out, lse, do, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, w, msg=name, **TOL[torch.float32])
