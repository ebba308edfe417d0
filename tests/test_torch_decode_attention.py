"""Decode attention (``repro_torch.kernels.decode_attention``).

On the CPU: the plain version (``ref.decode_attention_ref``, the port's
decode attention as it ran before the kernel) and the wrapper's CPU
dispatch against a direct masked softmax over each query head's own KV
head, in float64; the kernel's decomposition
(``ref.decode_attention_splits_ref``: slot ranges with their own max and
unnormalised sums, P in the cache's type, merged) against the plain
version; the outputs of slot ranges attended apart, merged by their
log-sum-exps (``ref.merge_ranges``), against the whole; chip_smoke.py's
bf16 decode check rejecting a dropped range and P in fp8;
``attention_decode`` against the reference's (``repro.models.attention``)
on a ring cache with holes and positions past its length; the work plans;
the soft cap refused off the CPU.

On the card (``-m cuda``, skipped without one): the kernel against the
plain version at the decode cell's shape, at each family's decode shape and
at the edges (a window, holes, a wrapped ring, cross-attention, B = 1, a
row with no allowed slot, Sc no multiple of a range and smaller than one),
in bf16 within 2^-8 of the largest output and one bf16 step at the
element (``CARD_BF16_TOL``), the counters the kernel's last blocks leave
zero; its log-sum-exps against the plain version's and two halves of a
cache merged by them against the whole; the blocks an SM holds; and one
``attention_decode`` call counting one launch.  Run there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_decode_attention.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as port_config
from repro_torch.kernels.decode_attention import ops, ref
from repro_torch.models import attention
from repro_torch.models.common import Init

GROUPS = (1, 2, 4, 6, 7, 16)
HEAD_DIMS = (16, 64, 96, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
# the plain version against float64: float32 sums in another order; in bf16
# one rounding of P and of the output (2^-8 relative) at the element
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# the bf16 kernel against the plain version on the card: one bf16 step at
# the element (the two round the same float32 sums to either side of it)
# and 2^-8 of the largest output (atol, times max |plain|): chip_smoke.py's
# FWD_BF16_TOL, which rejects a dropped slot range and P in fp8
CARD_BF16_TOL = dict(atol=2.0 ** -8, rtol=2.0 ** -7)
LSE_TOL = dict(atol=1e-4, rtol=1e-5)  # float32 log-sum-exps, sums in another order
SPLIT = 64  # the emulated ranges: many of them over the test caches


def _cache(B, Sc, KV, G, hd, dtype, seed, *, holes=True, wrapped=True):
    """k, v, q, k_pos, pos: a ring cache whose slots hold positions in no
    order (past Sc when ``wrapped``), every seventh slot empty with
    ``holes``, each sequence's new token at its own position."""
    g = torch.Generator().manual_seed(seed)
    k, v = (torch.randn(B, Sc, KV, hd, generator=g).to(dtype) for _ in range(2))
    q = torch.randn(B, 1, KV * G, hd, generator=g).to(dtype)
    shift = Sc + 5 if wrapped else 0
    k_pos = torch.stack([torch.roll(torch.arange(Sc) + shift + b, 3 * b + 1)
                         for b in range(B)]).to(torch.int32)
    if holes:
        k_pos[:, ::7] = -1
    pos = (k_pos.max(dim=1).values - torch.arange(B)).to(torch.int32)
    return k, v, q, k_pos, pos


def _direct(k, v, q, k_pos, pos, window=0):
    """Each query head h against KV head h // G: masked scores, softmax,
    P V, in float64 (masked slots at the plain version's NEG)."""
    B, Sc, KV, hd = k.shape
    H = q.shape[2]
    out = torch.zeros(B, 1, H, hd, dtype=torch.float64)
    ok = (k_pos >= 0) & (k_pos <= pos[:, None])
    if window > 0:
        ok &= k_pos > pos[:, None] - window
    for b in range(B):
        for h in range(H):
            kh = h // (H // KV)
            s = k[b, :, kh].double() @ q[b, 0, h].double() * hd ** -0.5
            s = torch.where(ok[b], s, torch.tensor(ref.NEG, dtype=torch.float64))
            out[b, 0, h] = torch.softmax(s, 0) @ v[b, :, kh].double()
    return out


def _plain_case(k, v, q, k_pos, pos, window=0):
    got = ops.decode_attention(k, v, q, k_pos, pos, window)
    plain = ref.decode_attention_ref(k, v, q, k_pos, pos, window)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.equal(got, plain)  # the CPU runs the plain version
    tol = TOL[q.dtype]
    torch.testing.assert_close(plain.double(), _direct(k, v, q, k_pos, pos, window), **tol)
    split = ref.decode_attention_splits_ref(k, v, q, k_pos, pos, window, SPLIT)
    torch.testing.assert_close(split.float(), plain.float(), **tol)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_plain_version_and_cpu_dispatch(dtype, group, hd):
    kv = 1 if group == 16 else 2  # MQA: one KV head, a stride-0 expansion
    _plain_case(*_cache(2, 150, kv, group, hd, dtype, seed=group * 1000 + hd))


EDGES = {
    "window": dict(B=2, Sc=150, window=40),
    "window wider than the cache": dict(B=2, Sc=150, window=400),
    "ring not wrapped, no holes": dict(B=2, Sc=150, holes=False, wrapped=False),
    "one sequence": dict(B=1, Sc=150),
    "smaller than one range": dict(B=2, Sc=SPLIT - 9),
    "one slot": dict(B=2, Sc=1, holes=False),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_edges(edge, dtype):
    kw = dict(EDGES[edge])
    window = kw.pop("window", 0)
    B, Sc = kw.pop("B"), kw.pop("Sc")
    _plain_case(*_cache(B, Sc, 2, 4, 64, dtype, seed=len(edge), **kw), window)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_cross_mode_and_a_row_with_no_slot(dtype):
    """Cross-attention's masks (every slot at 0, the query at 2^30) see the
    whole cache; a row whose slots are all masked averages v over every
    slot, as the plain softmax over NEG scores does, in both versions."""
    k, v, q, _, _ = _cache(3, 130, 2, 2, 64, dtype, seed=5)
    every = torch.zeros(3, 130, dtype=torch.int32)
    late = torch.full((3,), 2 ** 30, dtype=torch.int32)
    _plain_case(k, v, q, every, late)
    empty = torch.full((3, 130), -1, dtype=torch.int32)
    plain = ref.decode_attention_ref(k, v, q, empty, late)
    mean = v.float().mean(dim=1).repeat_interleave(2, dim=1)[:, None]
    torch.testing.assert_close(plain.float(), mean.to(dtype).float(), **TOL[dtype])
    split = ref.decode_attention_splits_ref(k, v, q, empty, late, 0, SPLIT)
    torch.testing.assert_close(split.float(), plain.float(), **TOL[dtype])


def test_soft_cap_runs_only_on_the_cpu():
    k, v, q, k_pos, pos = _cache(2, 40, 2, 2, 16, torch.float32, seed=3)
    capped = ops.decode_attention(k, v, q, k_pos, pos, 0, 5.0)
    assert not torch.equal(capped, ops.decode_attention(k, v, q, k_pos, pos))
    meta = [t.to("meta") for t in (k, v, q, k_pos, pos)]
    with pytest.raises(NotImplementedError, match="soft cap"):
        ops.decode_attention(*meta, 0, 5.0)
    assert ops.decode_attention(*meta).shape == q.shape  # the dry run's plain path


@pytest.mark.parametrize("blocks_per_sm", [1, 2, 4])
@pytest.mark.parametrize("columns, sc", [(32, 4168), (16, 32768), (384, 1500), (384, 240),
                                         (4, 96), (1, 1), (8, 2048), (4096, 32768),
                                         (1, 524288)])
def test_split_plan_covers_every_slot(columns, sc, blocks_per_sm):
    n, length = ops.split_plan(columns, sc, 132, blocks_per_sm)
    assert length % ops.SPLIT_STEP == 0 and length >= ops.MIN_SPLIT
    assert (n - 1) * length < sc <= n * length  # every range non-empty
    assert n <= ops.MAX_SPLIT
    if n > 1:  # the blocks fit the card at once
        assert columns * n <= blocks_per_sm * 132


@pytest.mark.parametrize("masked", [False, True], ids=["holes", "a range wholly masked"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_ranges_merged_by_their_lse(dtype, masked):
    """A cache's slots cut into three ranges, each attended apart with its
    log-sum-exp and merged (``merge_ranges``, the path of a cache sharded
    on its slots), against the whole; with a range wholly masked its
    weight is zero."""
    k, v, q, k_pos, pos = _cache(2, 150, 2, 4, 64, dtype, seed=21)
    if masked:
        k_pos[:, 50:100] = -1
    cuts = ((0, 50), (50, 100), (100, 150))
    parts = [ops.decode_attention(k[:, a:b], v[:, a:b], q, k_pos[:, a:b], pos, 7,
                                  with_lse=True) for a, b in cuts]
    o = torch.cat([out for out, _ in parts], dim=1)
    lse = torch.stack([lse for _, lse in parts], dim=1)
    got = ref.merge_ranges(o, lse, dim=1)
    want, want_lse = ref.decode_attention_ref(k, v, q, k_pos, pos, 7, with_lse=True)
    torch.testing.assert_close(torch.logsumexp(lse, dim=1), want_lse, **LSE_TOL)
    torch.testing.assert_close(got.to(dtype).float(), want.float(), **TOL[dtype])
    if masked:
        assert float(torch.softmax(lse, dim=1)[:, 1].max()) == 0.0


def test_the_bf16_decode_check_rejects_planted_faults(monkeypatch):
    """chip_smoke.py's bf16 decode check (``decode_forward_check``) at a
    small shape on the CPU: the plain version passes its limits; a slot
    range dropped and P rounded to fp8 (``decode_attention_splits_ref`` at
    the kernel's range length) are rejected."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    g = torch.Generator().manual_seed(4)
    k, v = ((torch.randn(2, 600, 2, 64, generator=g) * 0.5).to(torch.bfloat16)
            for _ in range(2))
    q = (torch.randn(2, 1, 14, 64, generator=g) * 0.5).to(torch.bfloat16)
    k_pos = torch.arange(600, dtype=torch.int32)[None].repeat(2, 1)
    k_pos[:, 580:] = -1
    pos = torch.full((2,), 579, dtype=torch.int32)
    args = [k, v, q, k_pos, pos, 0, 0.0]
    want = ref.decode_attention_ref(*args)
    out = chip_smoke.decode_forward_check("cpu", args, {}, want, want, 128, recorded=False)
    assert out["decode_bf16_share_of_limit"] == 0.0
    assert all(f["rejected"] for f in out["planted"].values()), out["planted"]
    assert set(out["planted"]) == {"a slot range dropped", "P in fp8"}


@pytest.mark.parametrize("group, max_group, want", [(1, 8, (1, 1)), (2, 8, (2, 1)),
                                                    (6, 8, (8, 1)), (7, 8, (8, 1)),
                                                    (16, 8, (8, 2)), (4, 2, (2, 2)),
                                                    (3, 4, (4, 1))])
def test_group_plan(group, max_group, want):
    assert ops.group_plan(group, max_group) == want


# (arch, heads, kv heads, dtype, cross): grouped 7:1 with qkv biases; the
# windowed MQA ring; the encoder-decoder's cross-attention; bf16
LAYERS = [("qwen2-7b", 14, 2, "float32", False), ("recurrentgemma-9b", 4, 1, "float32", False),
          ("whisper-small", 4, 4, "float32", True), ("mixtral-8x22b", 12, 2, "bfloat16", False)]


@pytest.mark.parametrize("arch, heads, kv, dtype, cross", LAYERS)
def test_attention_decode_matches_the_reference(arch, heads, kv, dtype, cross):
    """One decode layer call, the port's against the reference's, from the
    same weights, activations and cache: the ring write and the attention
    over slots in no order, some empty, positions past the cache's
    length.  The reference is imported here: the card's tests in this file
    run where JAX is not installed."""
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models import attention as ref_attention
    from repro.models.sharding import Sharder as RefSharder

    pcfg = port_config(arch).reduced().replace(n_heads=heads, n_kv_heads=kv, dtype=dtype)
    cfg = get_config(arch).reduced().replace(n_heads=heads, n_kv_heads=kv, dtype=dtype)
    dt = getattr(torch, dtype)
    p = attention.Attention(Init(torch.Generator().manual_seed(1), dt, torch.device("cpu")),
                            pcfg, cross=cross)
    params = {n: jnp.asarray(t.detach().float().numpy()).astype(dtype)
              for n, t in p.named_parameters()}
    B, Sc = 2, 48
    k, v, _, k_pos, _ = _cache(B, Sc, kv, 1, pcfg.resolved_head_dim, dt, seed=7)
    pos = k_pos.max(dim=1).values + 1 + torch.arange(B, dtype=torch.int32)
    x = torch.randn(B, 1, pcfg.d_model, generator=torch.Generator().manual_seed(8)).to(dt)
    cache = {"ck": k, "cv": v} if cross else {"k": k, "v": v, "k_pos": k_pos}
    np_cache = {n: jnp.asarray(t.float().numpy()).astype(dtype if t.is_floating_point()
                                                         else jnp.int32)
                for n, t in cache.items()}
    y, got = attention.attention_decode(p, x, {n: t.clone() for n, t in cache.items()}, pos,
                                        pcfg, cross=cross)
    want_y, want = ref_attention.attention_decode(
        params, jnp.asarray(x.float().numpy()).astype(dtype), np_cache,
        jnp.asarray(pos.numpy()), cfg, RefSharder(mesh=None), cross=cross)
    tol = TOL[dt]
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want_y, np.float32), **tol)
    for n in cache:
        np.testing.assert_allclose(got[n].float().numpy(), np.asarray(want[n], np.float32),
                                   err_msg=n, **tol)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: decode_attention is a CUDA kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (B, Sc, KV heads, group, hd, dtype, window): the decode cell's shape
# (qwen2-7b, 8 x 4,168 slots), the dense family at 32k, each family's
# decode shape as chip_smoke serves it, the reduced float32 configs
CARD_SHAPES = {
    "qwen2-7b decode-4k cell": (8, 4168, 4, 7, 128, torch.bfloat16, 0),
    "qwen2-7b 32k": (4, 32768, 4, 7, 128, torch.bfloat16, 0),
    "qwen3-1.7b 32k": (2, 32768, 8, 2, 128, torch.bfloat16, 0),
    "granite/minitron/phi3.5-moe": (4, 4120, 8, 4, 128, torch.bfloat16, 0),
    "mixtral window 4096": (4, 4096, 8, 6, 128, torch.bfloat16, 4096),
    "recurrentgemma MQA window 2048": (4, 2048, 1, 16, 256, torch.bfloat16, 2048),
    "phi-3-vision MHA hd 96": (4, 4696, 32, 1, 96, torch.bfloat16, 0),
    "whisper self hd 64": (32, 248, 12, 1, 64, torch.bfloat16, 0),
    "reduced f32 hd 16 grouped 7": (2, 96, 2, 7, 16, torch.float32, 0),
    "reduced f32 hd 16 MHA": (2, 96, 4, 1, 16, torch.float32, 32),
    "f32 hd 64 group 4": (3, 700, 2, 4, 64, torch.float32, 0),
    "f32 hd 96 group 2": (2, 333, 3, 2, 96, torch.float32, 100),
    "f32 hd 128 group 8": (2, 1000, 2, 8, 128, torch.float32, 0),
    "f32 hd 256 group 16": (2, 517, 1, 16, 256, torch.float32, 64),
    "bf16 hd 16 group 4": (2, 901, 2, 4, 16, torch.bfloat16, 0),
    "one sequence": (1, 4168, 4, 7, 128, torch.bfloat16, 0),
    "smaller than one range": (2, 37, 4, 7, 128, torch.bfloat16, 0),
    "not a multiple of a range": (5, 4168 + 71, 2, 2, 64, torch.bfloat16, 0),
}


def _card_limit(want) -> dict:
    if want.dtype == torch.float32:
        return TOL[torch.float32]
    return dict(atol=CARD_BF16_TOL["atol"] * float(want.float().abs().max()),
                rtol=CARD_BF16_TOL["rtol"])


def _card_case(card, k, v, q, k_pos, pos, window):
    args = [t.to(card) for t in (k, v, q, k_pos, pos)]
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(*args, window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    want = ref.decode_attention_ref(*args, window)
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **_card_limit(want))
    # the same bits whichever block merges a column; its counters left zero
    assert torch.equal(ops.decode_attention(*args, window), got)
    torch.cuda.synchronize()
    assert not any(bool(c.any()) for c in ops._COUNTERS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_kernel_matches_plain_on_card(card, shape):
    B, Sc, kv, group, hd, dtype, window = CARD_SHAPES[shape]
    _card_case(card, *_cache(B, Sc, kv, group, hd, dtype, seed=Sc), window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_kernel_edges_on_card(card, dtype):
    for edge in sorted(EDGES):
        kw = dict(EDGES[edge])
        window = kw.pop("window", 0)
        B, Sc = kw.pop("B"), kw.pop("Sc")
        _card_case(card, *_cache(B, Sc, 2, 4, 64, dtype, seed=len(edge), **kw), window)
    k, v, q, _, _ = _cache(3, 1500, 2, 2, 64, dtype, seed=5)
    late = torch.full((3,), 2 ** 30, dtype=torch.int32)
    _card_case(card, k, v, q, torch.zeros(3, 1500, dtype=torch.int32), late, 0)  # cross
    _card_case(card, k, v, q, torch.full((3, 1500), -1, dtype=torch.int32), late, 0)
    # layouts a caller may pass: a (B, Sc, KV, hd) slice of a wider cache, a
    # q viewed from (B, H, hd) with a gap between heads
    wide = torch.randn(3, 1500, 4, 64).to(dtype)
    qv = torch.randn(3, 1, 4, 80).to(dtype)[..., :64]
    _card_case(card, wide[:, :, 1:3], wide[:, :, 2:4], qv, *_cache(3, 1500, 2, 2, 64, dtype,
                                                                   seed=9)[3:], 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["qwen2-7b decode-4k cell", "recurrentgemma MQA window 2048",
                                   "f32 hd 96 group 2", "not a multiple of a range"])
def test_kernel_lse_and_merged_halves_on_card(card, shape):
    """The kernel's log-sum-exps against the plain version's, and the two
    halves of the cache's slots through the kernel, merged by them
    (``merge_ranges``, the path of a cache sharded on its slots), against
    the plain version over the whole; the first half of sequence 0 holds
    no allowed slot (its newest positions sit in the second)."""
    B, Sc, kv, group, hd, dtype, window = CARD_SHAPES[shape]
    k, v, q, k_pos, pos = (t.to(card) for t in _cache(B, Sc, kv, group, hd, dtype, seed=Sc))
    k_pos[0, :Sc // 2] = -1
    out, lse = ops.decode_attention(k, v, q, k_pos, pos, window, with_lse=True)
    want, want_lse = ref.decode_attention_ref(k, v, q, k_pos, pos, window, with_lse=True)
    torch.testing.assert_close(out.float(), want.float(), **_card_limit(want))
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)
    half = Sc // 2
    parts = [ops.decode_attention(k[:, a:b], v[:, a:b], q, k_pos[:, a:b], pos, window,
                                  with_lse=True) for a, b in ((0, half), (half, Sc))]
    merged = ref.merge_ranges(torch.cat([o for o, _ in parts], dim=1),
                              torch.stack([l for _, l in parts], dim=1), dim=1)
    torch.testing.assert_close(merged.to(dtype).float(), want.float(), **_card_limit(want))


@pytest.mark.cuda
def test_blocks_an_sm_holds_on_card(card):
    """The occupancy the split plan fills the card with: two bf16 blocks
    at hd 128 (105 KB of shared memory each), one at hd 256 (204 KB), and
    at least one of every float32 variant."""
    assert ops._blocks_per_sm(card, True, 128, 16) == 2
    assert ops._blocks_per_sm(card, True, 256, 16) == 1
    for hd in ops.HEAD_DIMS:
        gb = 1
        while gb <= ops._max_group(False, hd):
            assert ops._blocks_per_sm(card, False, hd, gb) >= 1
            gb *= 2


@pytest.mark.cuda
@pytest.mark.parametrize("cross", [False, True])
def test_one_layer_call_is_one_launch(card, cross):
    cfg = port_config("qwen2-7b").reduced().replace(n_heads=14, n_kv_heads=2)
    p = attention.Attention(Init(torch.Generator(device=card).manual_seed(1), torch.float32,
                                 card), cfg, cross=cross)
    k, v, _, k_pos, pos = (t.to(card) for t in _cache(2, 48, 2, 1, cfg.resolved_head_dim,
                                                      torch.float32, seed=2))
    cache = {"ck": k, "cv": v} if cross else {"k": k, "v": v, "k_pos": k_pos}
    x = torch.randn(2, 1, cfg.d_model, device=card)
    before = ops.LAUNCHES["decode_attention"]
    attention.attention_decode(p, x, cache, pos + 1, cfg, cross=cross)
    assert ops.LAUNCHES["decode_attention"] == before + 1
