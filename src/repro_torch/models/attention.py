"""Attention: GQA / MQA / MHA with full / sliding-window / local masking
(port of ``repro.models.attention``).

The full-sequence path (prefill, forward) runs the ``flash_attention``
kernel (``repro_torch.kernels.flash_attention``, the kernel the
reference wrote for the TPU but never calls from its model; its own test
holds it equal to ``blockwise_attention`` and ``direct_attention``):
causal self-attention in a decoder, non-causal in an encoder, and
cross-attention (``kv_x``: queries from the decoder, keys and values
from the encoder's output, Sq != Sk, no rope, no causal mask).
The projections stay in (B, S, H, hd); the kernel reads them through a
(B, H, S, hd) view, and MQA's one KV head through a stride-0 head axis,
so neither needs a copy.  A cross-attention layer's keys and values are
computed once, at prefill (``cross_cache_entries``: the cache's ``ck``
and ``cv``), and decode attends them all.  ``blockwise_attention`` and
``direct_attention`` are kept as plain functions of tensors.  Decode
keeps a per-sequence ``k_pos`` (B, Sc), which is not the kernel's shared
positions, and runs in plain torch, as the reference computes it outside
any Pallas kernel.  The decode cache is updated in place.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from repro_torch import obs
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ref import expand_kv, merge_ranges
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import position_mask
from repro_torch.models.common import Init, apply_rope, rms_norm, rope_tables, softcap
from repro_torch.models.sharding import NO_SHD, Sharder, flat_matmul, n_kv_virtual

NEG = -0.7 * torch.finfo(torch.float32).max


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """wq, wk, wv, wo (and biases); q_norm / k_norm under ``cfg.qk_norm``
    except in a cross-attention layer (``cross``), as the reference's
    ``init_attention``."""

    def __init__(self, ini: Init, cfg, cross: bool = False):
        super().__init__()
        D, hd = cfg.d_model, cfg.resolved_head_dim
        H, KV = cfg.n_heads_p, cfg.n_kv_p  # padded (== raw when padding is off)
        self.wq = ini.fan_in((D, H, hd), ("embed", "heads", "head_dim"), fan_axes=(0,))
        self.wk = ini.fan_in((D, KV, hd), ("embed", "kv_heads", "head_dim"), fan_axes=(0,))
        self.wv = ini.fan_in((D, KV, hd), ("embed", "kv_heads", "head_dim"), fan_axes=(0,))
        self.wo = ini.fan_in((H, hd, D), ("heads", "head_dim", "embed"), fan_axes=(0, 1))
        if H != cfg.n_heads and ini.generator is not None:
            # zero the padded heads' output rows: function-preserving padding
            self.wo.data[cfg.n_heads:] = 0
        self.bq = self.bk = self.bv = self.bo = None
        if cfg.qkv_bias:
            self.bq = ini.zeros((H, hd), ("heads", "head_dim"))
            self.bk = ini.zeros((KV, hd), ("kv_heads", "head_dim"))
            self.bv = ini.zeros((KV, hd), ("kv_heads", "head_dim"))
            self.bo = ini.zeros((D,), ("act_embed",))
        self.q_norm = self.k_norm = None
        if cfg.qk_norm and not cross:
            self.q_norm = ini.zeros((hd,), ("head_dim",))
            self.k_norm = ini.zeros((hd,), ("head_dim",))


def _proj(x, w, bias=None):
    """x: (B, S, D) @ w: (D, H, hd) -> (B, S, H, hd), one product over
    w's (H, hd) columns (``flat_matmul``: over (hd, H) columns where
    head_dim is sharded, the fallback where the heads do not divide the
    model axis)."""
    y = flat_matmul(x, w.to(x.dtype))
    return y if bias is None else y + bias.to(x.dtype)


def _out_proj(p: Attention, out):
    """out: (B, S, H, hd) -> (B, S, D) (over (hd, H) rows with head_dim
    sharded, as ``_proj``)."""
    if Sharder.shards(p.wo, 1):
        y = out.transpose(-1, -2).flatten(-2) @ p.wo.to(out.dtype).transpose(0, 1).flatten(0, 1)
    else:
        y = torch.einsum("bshk,hkd->bsd", out, p.wo.to(out.dtype))
    return y if p.bo is None else y + p.bo.to(out.dtype)


def _project_q(p: Attention, x, cfg, positions, use_rope: bool, shd: Sharder = NO_SHD):
    """q (B, S, H, hd) with q-norm and (``use_rope``) rope applied.  The
    sharding constraint comes before rope, as the reference's: the
    sequence gather then moves the projection, not rope's float32."""
    q = _proj(x, p.wq, p.bq)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
    q = shd.act(q, "batch", "seq", "act_heads", "head_dim")
    if use_rope:
        q = apply_rope(q, *rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta))
    return q


def _project_kv(p: Attention, x, cfg, positions, use_rope: bool, shd: Sharder = NO_SHD):
    """k, v (B, S, KV, hd) with k-norm and (``use_rope``) rope applied;
    constrained on batch and sequence only (the constraint after the KV
    expansion is the one on heads)."""
    k, v = _proj(x, p.wk, p.bk), _proj(x, p.wv, p.bv)
    if p.k_norm is not None:
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    k = shd.act(k, "batch", "kv_seq", None, None)
    v = shd.act(v, "batch", "kv_seq", None, None)
    if use_rope:
        k = apply_rope(k, *rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta))
    return k, v


def _repeat_virtual(k, v, cfg, model_axis: int = 1):
    """k, v repeated from the KV heads to the cache's virtual KV heads."""
    rep = n_kv_virtual(cfg.n_heads_p, cfg.n_kv_p, model_axis) // cfg.n_kv_p
    if rep > 1:
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    return k, v


def _expand_kv(k, v, n_heads: int, shd: Sharder = NO_SHD):
    """Repeat KV heads to n_heads (``expand_kv``: consecutive grouping, one
    KV head as a stride-0 view), constrained on heads."""
    k, v = expand_kv(k, v, n_heads)
    return (shd.act(k, "batch", "kv_seq", "act_heads", "head_dim"),
            shd.act(v, "batch", "kv_seq", "act_heads", "head_dim"))


def _window(cfg) -> int:
    return cfg.window if cfg.attn_kind in ("swa", "local") else 0


# ---------------------------------------------------------------------------
# Plain full-sequence attention (the reference's jnp paths)
# ---------------------------------------------------------------------------


def blockwise_attention(q, k, v, q_pos, k_pos, *, causal: bool = True, window: int = 0,
                        logit_cap: float = 0.0, blk_q: int = 512, blk_k: int = 1024):
    """Online-softmax attention over (q block, kv block) pairs.
    q: (B, Sq, H, hd); k, v: (B, Sk, H, hd) (KV expanded to H heads);
    q_pos (Sq,), k_pos (Sk,) with -1 a hole.  Returns (B, Sq, H, hd) in
    q's type.  Every pair of blocks is visited and masked."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    scale = hd ** -0.5
    blk_q, blk_k = min(blk_q, max(Sq, 1)), min(blk_k, max(Sk, 1))
    outs = []
    for i0 in range(0, Sq, blk_q):
        q_i, qpos_i = q[:, i0:i0 + blk_q], q_pos[i0:i0 + blk_q]
        n = q_i.shape[1]
        m = torch.full((B, H, n), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, n), dtype=torch.float32, device=q.device)
        o = torch.zeros((B, H, n, hd), dtype=torch.float32, device=q.device)
        for j0 in range(0, Sk, blk_k):
            k_j, v_j, kpos_j = k[:, j0:j0 + blk_k], v[:, j0:j0 + blk_k], k_pos[j0:j0 + blk_k]
            s = torch.einsum("bqhd,bkhd->bhqk", q_i.float(), k_j.float()) * scale
            if logit_cap > 0:
                s = softcap(s, logit_cap)
            s = torch.where(position_mask(qpos_i, kpos_j, causal=causal, window=window), s, NEG)
            m2 = torch.maximum(m, s.amax(dim=-1))
            pr = torch.exp(s - m2[..., None])
            alpha = torch.exp(m - m2)
            l = l * alpha + pr.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bhqd", pr.to(v_j.dtype).float(), v_j.float())
            o = o * alpha[..., None] + pv
            m = m2
        outs.append((o / l.clamp_min(1e-30)[..., None]).to(q.dtype).transpose(1, 2))
    return torch.cat(outs, dim=1)


def direct_attention(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
                     logit_cap: float):
    """Plain masked-softmax attention (materialises the Sq x Sk scores);
    the oracle of ``blockwise_attention``.  Layout as there."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (q.shape[-1] ** -0.5)
    if logit_cap > 0:
        s = softcap(s, logit_cap)
    s = torch.where(position_mask(q_pos, k_pos, causal=causal, window=window), s, NEG)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", pr.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Full-sequence block forward (prefill / forward)
# ---------------------------------------------------------------------------


def attention_forward(p: Attention, x, cfg, positions, *, causal: bool = True, kv_x=None,
                      shd: Sharder = NO_SHD):
    """Full-sequence attention sub-layer through the flash-attention
    kernel (pre-norm residual handled by the caller).  ``kv_x`` given
    means cross-attention: keys and values projected from ``kv_x`` at
    positions ``arange(kv_x.shape[1])``, no rope, no causal mask.  On a
    mesh the kernel runs on each rank's block of batch and heads
    (``Sharder.local``); a head_dim sharded where the heads do not divide
    the model axis is gathered first."""
    if cfg.attn_logit_softcap > 0:
        raise NotImplementedError("the flash_attention kernel has no logit soft cap; "
                                  "no configuration of the port's path uses one")
    cross = kv_x is not None
    if cross:
        kv_positions = torch.arange(kv_x.shape[1], dtype=torch.int32, device=kv_x.device)
    else:
        kv_x, kv_positions = x, positions
    use_rope = cfg.pos_kind == "rope" and not cross
    q = _project_q(p, x, cfg, positions, use_rope, shd)
    k, v = _expand_kv(*_project_kv(p, kv_x, cfg, kv_positions, use_rope, shd), cfg.n_heads_p,
                      shd)
    out = shd.local(fa_ops.flash_attention,
                    (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)), (0, 1),
                    positions, kv_positions, causal=causal and not cross, window=_window(cfg))
    out = shd.act(out.transpose(1, 2), "batch", "seq", "act_heads", "head_dim")
    return shd.act(_out_proj(p, out), "batch", "res_seq", "act_embed")


# ---------------------------------------------------------------------------
# Decode (one new token against a cache)
# ---------------------------------------------------------------------------


def cache_len(cfg, seq_len: int) -> int:
    """Ring-buffer length: window-bounded archs keep only `window` entries."""
    if cfg.attn_kind in ("swa", "local") and cfg.window > 0:
        return min(cfg.window, seq_len)
    return seq_len


def init_attn_cache(cfg, batch: int, seq_len: int, device, model_axis: int = 1,
                    cross_len: int = 0) -> dict:
    """k/v: (B, Sc, KVv, hd); k_pos: (B, Sc) absolute positions of the
    stored entries, -1 = empty; with ``cross_len``, also the
    cross-attention's ck/cv: (B, cross_len, KVv, hd), zeros."""
    hd = cfg.resolved_head_dim
    kvv = n_kv_virtual(cfg.n_heads_p, cfg.n_kv_p, model_axis)
    sc = cache_len(cfg, seq_len)
    dt = getattr(torch, cfg.dtype)
    c = {"k": torch.zeros((batch, sc, kvv, hd), dtype=dt, device=device),
         "v": torch.zeros((batch, sc, kvv, hd), dtype=dt, device=device),
         "k_pos": torch.full((batch, sc), -1, dtype=torch.int32, device=device)}
    if cross_len:
        c["ck"] = torch.zeros((batch, cross_len, kvv, hd), dtype=dt, device=device)
        c["cv"] = torch.zeros((batch, cross_len, kvv, hd), dtype=dt, device=device)
    return c


def _decode_mha(k, v, q, k_pos, pos, window: int, logit_cap: float):
    """k/v: (B, Sc, KVv, hd); q: (B, 1, H, hd); k_pos: (B, Sc) -> (B, 1, H, hd):
    the ``decode_attention`` kernel on a CUDA tensor, its plain version
    (``ref.decode_attention_ref``) on the CPU and on ``meta``."""
    with obs.span("decode_mha"):
        return dec_ops.decode_attention(k, v, q, k_pos, pos, window, logit_cap)


def _decode_range(k, v, q, k_pos, pos, window: int, logit_cap: float):
    """``_decode_mha`` over a range of the cache's slots, with each row's
    log-sum-exp after its output: (B, 1, H, hd + 1) float32."""
    with obs.span("decode_mha"):
        out, lse = dec_ops.decode_attention(k, v, q, k_pos, pos, window, logit_cap,
                                            with_lse=True)
    return torch.cat([out.float(), lse[:, None, :, None]], dim=-1)


def _merge_ranges(parts, dtype):
    """``_decode_range``'s results of every range, (B, R, H, hd + 1), merged
    into the output over all the slots, (B, 1, H, hd) in ``dtype``."""
    return merge_ranges(parts[..., :-1], parts[..., -1], dim=1).to(dtype)


def _decode_attend(q, k, v, k_pos, pos, window: int, logit_cap: float, shd: Sharder):
    """``_decode_mha`` on each rank's block (``Sharder.local``: decode
    attention is local over batch and KV heads), rather than through
    DTensor's products, whose merged (batch, head) dimensions the
    redistribute planner is slow over.  A cache sharded on its head dim is
    gathered on it first (a score sums the whole head dim); one sharded on
    its slots is attended a rank's range of slots at a time, each range's
    output with its log-sum-exp, and the ranges merged
    (``ref.merge_ranges``)."""
    if Sharder.shards(k, 3):
        k, v = (Sharder.like(t, k, (0, 1, 2)) for t in (k, v))
    if Sharder.shards(k, 1):
        parts = shd.local(_decode_range, (k, v, q, k_pos, pos),
                          ((0, 1, 2), (0, 1, 2), (0, 2), (0, 1), (0,)), window, logit_cap)
        return shd.local(_merge_ranges, (parts,), ((0, 2),), q.dtype)
    return shd.local(_decode_mha, (k, v, q, k_pos, pos), ((0, 2),) * 3 + ((0,),) * 2,
                     window, logit_cap)


def _ring_write(cache: dict, k, v, pos) -> None:
    """In place: each sequence's new k, v (B, 1, KVv, hd) and position
    into its ring slot ``pos % Sc``.  A sharded cache is written on each
    rank's block (its sequences, its KV heads and, where "kv_seq" is
    sharded, its range of slots), as the reference's partitioned
    ``.at[].set``."""
    ck, cv, kp = cache["k"], cache["v"], cache["k_pos"]
    sc, first = ck.shape[1], 0
    if isinstance(ck, DTensor):
        mesh, pl = ck.device_mesh, ck.placements
        k, v = (Sharder.like(t, ck, (0, 2, 3)).to_local() for t in (k, v))
        pos = Sharder.like(pos, ck, (0,)).to_local()
        block = 0  # this rank's block of slots, the mesh dims nested in order
        for i, q in enumerate(pl):
            if isinstance(q, Shard) and q.dim == 1:
                block = block * mesh.size(i) + mesh.get_local_rank(i)
        ck, cv, kp = ck.to_local(), cv.to_local(), kp.to_local()
        first = block * ck.shape[1]
    slot = (pos % sc).long() - first
    bidx = torch.arange(pos.shape[0], device=pos.device)
    k, v, new_pos = k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype), pos.to(torch.int32)
    if ck.shape[1] < sc:  # a slot on another rank keeps what this rank holds there
        mine = (slot >= 0) & (slot < ck.shape[1])
        slot = slot.clamp(0, ck.shape[1] - 1)
        k = torch.where(mine[:, None, None], k, ck[bidx, slot])
        v = torch.where(mine[:, None, None], v, cv[bidx, slot])
        new_pos = torch.where(mine, new_pos, kp[bidx, slot])
    ck[bidx, slot] = k
    cv[bidx, slot] = v
    kp[bidx, slot] = new_pos


def attention_decode(p: Attention, x, cache: dict, pos, cfg, cross: bool = False,
                     shd: Sharder = NO_SHD):
    """x: (B, 1, D) current token activations; pos: (B,) int positions.
    Self-attention writes the token's k/v into its ring slot (in place);
    ``cross`` attends every entry of the cache's ``ck``/``cv`` and leaves
    the cache as it is.  Returns (y (B, 1, D), cache)."""
    dt = x.dtype
    use_rope = cfg.pos_kind == "rope" and not cross
    q = _project_q(p, x, cfg, pos[:, None], use_rope)
    if cross:
        ck = cache["ck"]
        every = torch.zeros(ck.shape[:2], dtype=torch.int32, device=x.device)
        late = torch.full((x.shape[0],), 2 ** 30, dtype=torch.int32, device=x.device)
        out = _decode_attend(q, ck, cache["cv"], every, late, 0, cfg.attn_logit_softcap, shd)
        return _out_proj(p, out.to(dt)), cache
    k, v = _project_kv(p, x, cfg, pos[:, None], use_rope)
    kvv = cache["k"].shape[2]
    rep = kvv // cfg.n_kv_p
    if rep > 1:
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    _ring_write(cache, k, v, pos)
    out = _decode_attend(q, cache["k"], cache["v"], cache["k_pos"], pos, _window(cfg),
                         cfg.attn_logit_softcap, shd)
    return _out_proj(p, out.to(dt)), cache


def prefill_cache_entries(p: Attention, x, cfg, positions, seq_len: int,
                          shd: Sharder = NO_SHD) -> dict:
    """The k/v cache contents of a full-sequence pass (prefill): the last
    `cache_len` entries, in ring layout, over the virtual KV heads of
    ``shd``'s model axis."""
    dt = getattr(torch, cfg.dtype)
    k, v = _repeat_virtual(*_project_kv(p, x, cfg, positions, cfg.pos_kind == "rope", shd),
                           cfg, shd.model_axis)
    sc = cache_len(cfg, seq_len)
    B, S = x.shape[0], x.shape[1]
    if sc < S:
        # keep the trailing window; the ring slot of position p is p % sc,
        # so roll the entries into ring order
        shift = (S - sc) % sc
        k_r = torch.roll(k[:, S - sc:], shift, dims=1)
        v_r = torch.roll(v[:, S - sc:], shift, dims=1)
        pos_r = torch.roll(positions[S - sc:], shift)
        kpos = pos_r[None].expand(B, sc).to(torch.int32).contiguous()
        return {"k": k_r.to(dt), "v": v_r.to(dt), "k_pos": Sharder.like(kpos, k, (0,))}
    pad = sc - S
    kk = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vv = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    kpos = torch.nn.functional.pad(positions.to(torch.int32), (0, pad), value=-1)
    return {"k": kk.to(dt), "v": vv.to(dt),
            "k_pos": Sharder.like(kpos[None].expand(B, sc).contiguous(), k, (0,))}


def cross_cache_entries(p: Attention, enc_out, cfg, shd: Sharder = NO_SHD) -> dict:
    """A cross-attention layer's decode cache: the encoder output's keys
    and values (no rope), repeated to the virtual KV heads and cast to
    ``cfg.dtype``: ``{"ck", "cv"}``, each (B, S_enc, KVv, hd)."""
    dt = getattr(torch, cfg.dtype)
    ck, cv = _repeat_virtual(*_project_kv(p, enc_out, cfg, None, False, shd), cfg,
                             shd.model_axis)
    return {"ck": ck.to(dt), "cv": cv.to(dt)}
