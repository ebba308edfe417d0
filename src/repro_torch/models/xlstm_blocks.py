"""xLSTM blocks (port of ``repro.models.xlstm_blocks``): mLSTM (matrix
memory, chunkwise-parallel) and sLSTM (scalar memory, strictly
sequential).

mLSTM recurrence (per head, stabilized; xLSTM paper eq. 19-27):
    m_t = max(logsig(f_t) + m_{t-1}, i_t)
    C_t = exp(logsig(f_t)+m_{t-1}-m_t) C_{t-1} + exp(i_t - m_t) k_t v_t^T
    n_t = exp(logsig(f_t)+m_{t-1}-m_t) n_{t-1} + exp(i_t - m_t) k_t
    h_t = (q_t C_t) / max(|q_t . n_t|, exp(-m_t))
Full sequences use the chunkwise form (quadratic within a chunk, the
state carried from chunk to chunk by a Python loop); decode is one step
of the recurrence.  sLSTM mixes its memory through block-diagonal
recurrent weights, so it runs step by step (a Python loop over the
sequence).  Gates and states are float32.  The reference has no Pallas
kernel here, so the port computes both with torch calls.

Neither block has a separate FFN (d_ff = 0): mLSTM carries its own up
and down projections (factor 2), sLSTM a gated FFN (factor 4/3).  GELU
is the tanh approximation (``jax.nn.gelu``'s default).

Each block's full-sequence function also returns, when asked, the cache
its decode starts from: the same call on the same input, so the same
bits as the reference's second pass.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.common import Init, group_norm_heads
from repro_torch.models.recurrent import causal_conv1d
from repro_torch.models.sharding import NO_SHD, Sharder, flat_matmul, redistributed

F32 = torch.float32


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class MLSTMBlock(nn.Module):
    def __init__(self, ini: Init, cfg):
        super().__init__()
        D, H = cfg.d_model, cfg.n_heads
        Fd = 2 * D  # projection factor 2
        dk = Fd // H
        self.up = ini.fan_in((D, 2, Fd), ("embed", None, "mlp"), fan_axes=(0,))
        self.conv_w = ini.normal((cfg.conv_width, Fd), ("conv", "mlp"), scale=0.1)
        self.conv_b = ini.zeros((Fd,), ("mlp",))
        self.wq = ini.fan_in((Fd, H, dk), ("mlp", "heads", "head_dim"), fan_axes=(0,))
        self.wk = ini.fan_in((Fd, H, dk), ("mlp", "heads", "head_dim"), fan_axes=(0,))
        self.wv = ini.fan_in((Fd, H, dk), ("mlp", "heads", "head_dim"), fan_axes=(0,))
        self.w_i = ini.fan_in((Fd, H), ("mlp", "heads"))
        self.b_i = ini.zeros((H,), ("heads",))
        self.w_f = ini.fan_in((Fd, H), ("mlp", "heads"))
        self.b_f = ini.const((H,), ("heads",), 3.0)  # open forget gates at init
        self.gn_scale = ini.ones((H, dk), ("heads", "head_dim"))
        self.down = ini.fan_in((Fd, D), ("mlp", "embed"))


def _logsigmoid(x):
    """log(sigmoid(x)); a DTensor's as -softplus(-x), whose backward
    DTensor shards (it has no rule for ``log_sigmoid_backward``)."""
    return -F.softplus(-x) if isinstance(x, DTensor) else F.logsigmoid(x)


def _per_rank(fn, args, dims, out_dims, shd: Sharder):
    """``fn(*args)`` on each rank's blocks as plain tensors (``local_map``:
    the reference's recurrences run per device under GSPMD), or a direct
    call without a mesh.  ``args[0]``'s shards of the dimensions ``dims[0]``
    names (its batch and heads: the recurrences are local over both) are
    kept, every other mesh dimension gathered; ``dims[i]`` maps those
    dimensions of ``args[0]`` to ``args[i]``'s ({} for an argument with
    neither), ``out_dims`` to each output's.  An argument whole on a mesh
    dimension the work is split over gets a partial sum as its gradient
    there (a weight every batch row uses)."""
    ref = args[0]
    if shd.mesh is None or not isinstance(ref, DTensor):
        return fn(*args)

    def placed(d, split=Replicate()):
        return [Shard(d[pl.dim]) if isinstance(pl, Shard) and pl.dim in d
                else split if isinstance(pl, Shard) and pl.dim in dims[0] else Replicate()
                for pl in ref.placements]

    ins = tuple(placed(d) for d in dims)
    local = [redistributed(a, shd.mesh, pl) for a, pl in zip(args, ins)]
    return local_map(fn, out_placements=tuple(placed(d) for d in out_dims), in_placements=ins,
                     in_grad_placements=tuple(placed(d, Partial()) for d in dims),
                     device_mesh=shd.mesh)(*local)


def _mlstm_sequence(q, k, v, i_pre, f_pre, chunk: int, shd: Sharder = NO_SHD):
    """``mlstm_chunkwise`` from a zero state, flat: (h, C, n, m); on a mesh
    each rank runs its batch rows and heads (q, k, v (B, S, H, d); i, f
    (B, S, H); C (B, H, d, d), n (B, H, d), m (B, H))."""
    def run(*a):
        h, state = mlstm_chunkwise(*a, chunk)
        return (h, *state)

    bh = {0: 0, 2: 2}
    return _per_rank(run, (q, k, v, i_pre, f_pre), (bh,) * 5,
                     (bh,) + ({0: 0, 2: 1},) * 3, shd)


def mlstm_chunkwise(q, k, v, i_pre, f_pre, chunk: int, state=None):
    """q, k, v: (B, S, H, d); i_pre, f_pre: (B, S, H).  Returns (h (B, S,
    H, d) float32, state (C (B, H, d, d), n (B, H, d), m (B, H)))."""
    B, S, H, d = q.shape
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"mLSTM: sequence length {S} is no multiple of the chunk {L}")
    qT = q.transpose(1, 2).to(F32) * d ** -0.5  # (B, H, S, d)
    kT = k.transpose(1, 2).to(F32)
    vT = v.transpose(1, 2).to(F32)
    ig = i_pre.transpose(1, 2).to(F32)  # (B, H, S)
    lg = _logsigmoid(f_pre.transpose(1, 2).to(F32))
    if state is None:
        C = qT.new_zeros((B, H, d, d))
        n = qT.new_zeros((B, H, d))
        m = qT.new_zeros((B, H))
    else:
        C, n, m = state
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    hs = []
    for j in range(S // L):
        at = slice(j * L, (j + 1) * L)
        qj, kj, vj, ij = qT[:, :, at], kT[:, :, at], vT[:, :, at], ig[:, :, at]
        Fc = lg[:, :, at].cumsum(dim=-1)  # (B, H, L) inclusive log-decay
        A = torch.cummax(ij - Fc, dim=-1).values
        m_loc = Fc + torch.maximum(m[..., None], A)  # stabilizer per position
        inter_w = torch.exp(Fc + m[..., None] - m_loc)
        # intra-chunk decay-gate matrix W[t, s] = exp(F_t - F_s + i_s - m_t)
        lgm = Fc[..., :, None] - Fc[..., None, :] + ij[..., None, :] - m_loc[..., :, None]
        Wm = torch.where(tri, torch.exp(lgm), 0.0)  # (B, H, L, L)
        num = ((qj @ kj.transpose(-1, -2)) * Wm) @ vj + (qj @ C) * inter_w[..., None]
        n_loc = Wm @ kj + n[:, :, None] * inter_w[..., None]
        denom = torch.maximum((qj * n_loc).sum(dim=-1).abs(), torch.exp(-m_loc))
        hs.append(num / denom[..., None])
        # end-of-chunk state
        FL = Fc[..., -1]
        m_next = FL + torch.maximum(m, A[..., -1])
        decay = torch.exp(FL + m - m_next)
        wts = torch.exp(FL[..., None] - Fc + ij - m_next[..., None])  # (B, H, L)
        C = decay[..., None, None] * C + (kj * wts[..., None]).transpose(-1, -2) @ vj
        n = decay[..., None] * n + (wts[..., None] * kj).sum(dim=-2)
        m = m_next
    return torch.cat(hs, dim=2).transpose(1, 2), (C, n, m)


def mlstm_step(q, k, v, i_pre, f_pre, state):
    """One decode step. q, k, v: (B, H, d); i_pre, f_pre: (B, H)."""
    C, n, m = state
    d = q.shape[-1]
    qf = q.to(F32) * d ** -0.5
    kf, vf = k.to(F32), v.to(F32)
    lf = _logsigmoid(f_pre.to(F32))
    ii = i_pre.to(F32)
    m2 = torch.maximum(lf + m, ii)
    fw = torch.exp(lf + m - m2)
    iw = torch.exp(ii - m2)
    C2 = fw[..., None, None] * C + iw[..., None, None] * (kf[..., :, None] * vf[..., None, :])
    n2 = fw[..., None] * n + iw[..., None] * kf
    num = (qf[..., None, :] @ C2)[..., 0, :]
    qn = (qf * n2).sum(dim=-1)
    h = num / torch.maximum(qn.abs(), torch.exp(-m2))[..., None]
    return h, (C2, n2, m2)


def _heads(x, w):
    """x: (B, S, F) times w: (F, H, d) -> (B, S, H, d)."""
    return flat_matmul(x, w.to(x.dtype))


def _mlstm_qkvif(p: MLSTMBlock, x_in, conv_state=None):
    """The projections. x_in: (B, S, F), the pre-conv input.  With
    ``conv_state`` (B, cw-1, F) the conv runs one decode step over it.
    Returns (q, k, v (B, S, H, d), i, f (B, S, H), new conv state)."""
    dt = x_in.dtype
    if conv_state is None:
        c, new_state = causal_conv1d(x_in, p.conv_w, p.conv_b), None
    else:
        hist = torch.cat([conv_state, x_in], dim=1)
        c = (torch.einsum("bcw,cw->bw", hist, p.conv_w.to(dt))[:, None]
             + p.conv_b.to(dt))
        new_state = hist[:, 1:]
    c = F.silu(c)
    i_pre = c @ p.w_i.to(dt) + p.b_i.to(dt)
    f_pre = c @ p.w_f.to(dt) + p.b_f.to(dt)
    return (_heads(c, p.wq), _heads(c, p.wk), _heads(x_in, p.wv), i_pre, f_pre,
            new_state)


def _mlstm_up(p: MLSTMBlock, x):
    """(z, x_in), each (B, S, F): the up projection's two halves."""
    up = flat_matmul(x, p.up.to(x.dtype))
    return up[:, :, 0], up[:, :, 1]


def _merged_heads(h, scale):
    """Group-norm heads, then (B, S, H, dh) -> (B, S, H * dh).  On a mesh
    the merged tensor keeps its shards (a partial sum, from a norm over a
    sharded dh, is summed): backward, this brings the gradient to those
    placements before the merge's backward, which DTensor cannot take
    from a gradient sharded over more ranks than there are heads (4 heads
    on a 16-wide model axis)."""
    B, S = h.shape[:2]
    merged = group_norm_heads(h, scale).reshape(B, S, -1)
    return Sharder.like(merged, merged, range(merged.dim()))


def _mlstm_out(p: MLSTMBlock, h, z, dt):
    return (_merged_heads(h.to(dt), p.gn_scale) * F.silu(z)) @ p.down.to(dt)


def mlstm_forward(p: MLSTMBlock, x, cfg, with_cache: bool = False, shd: Sharder = NO_SHD):
    """Full-sequence mLSTM mixer. x: (B, S, D) -> (B, S, D), and with
    ``with_cache`` the decode cache {C, n, m, conv}: the final state and
    the last cw-1 pre-conv inputs."""
    dt = getattr(torch, cfg.dtype)
    z, x_in = _mlstm_up(p, x)
    x_in = shd.act(x_in, "batch", "seq", "act_mlp")
    q, k, v, i_pre, f_pre, _ = _mlstm_qkvif(p, x_in)
    h, C, n, m = _mlstm_sequence(q, k, v, i_pre, f_pre, cfg.mlstm_chunk, shd)
    y = shd.act(_mlstm_out(p, h, z, dt), "batch", "res_seq", "act_embed")
    if not with_cache:
        return y
    return y, {"C": C, "n": n, "m": m, "conv": x_in[:, -(cfg.conv_width - 1):].clone()}


def init_mlstm_cache(cfg, batch: int, device) -> dict:
    Fd, H = 2 * cfg.d_model, cfg.n_heads
    d = Fd // H
    return {"C": torch.zeros((batch, H, d, d), dtype=F32, device=device),
            "n": torch.zeros((batch, H, d), dtype=F32, device=device),
            "m": torch.zeros((batch, H), dtype=F32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, Fd),
                                dtype=getattr(torch, cfg.dtype), device=device)}


def mlstm_decode(p: MLSTMBlock, x, cache: dict, cfg):
    """x: (B, 1, D) -> (y (B, 1, D), the new cache)."""
    dt = getattr(torch, cfg.dtype)
    z, x_in = _mlstm_up(p, x)
    q, k, v, i_pre, f_pre, conv = _mlstm_qkvif(p, x_in, cache["conv"])
    h, (C, n, m) = mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0],
                              (cache["C"], cache["n"], cache["m"]))
    return _mlstm_out(p, h[:, None], z, dt), {"C": C, "n": n, "m": m, "conv": conv}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def _slstm_ffn_dim(D: int) -> int:
    f = (4 * D) // 3
    return (f + 127) // 128 * 128


class SLSTMBlock(nn.Module):
    def __init__(self, ini: Init, cfg):
        super().__init__()
        D, H = cfg.d_model, cfg.n_heads
        dh = D // H
        Fs = _slstm_ffn_dim(D)
        self.w = ini.fan_in((D, 4, H, dh), ("embed", None, "heads", "head_dim"),
                            fan_axes=(0,))
        self.r = ini.fan_in((4, H, dh, dh), (None, "heads", None, "head_dim"),
                            fan_axes=(2,))
        self.b = ini.zeros((4, H, dh), (None, "heads", "head_dim"))
        self.gn_scale = ini.ones((H, dh), ("heads", "head_dim"))
        self.ffn_up = ini.fan_in((D, 2, Fs), ("embed", None, "mlp"), fan_axes=(0,))
        self.ffn_down = ini.fan_in((Fs, D), ("mlp", "embed"))


def slstm_cell(wx, state, r):
    """One step in float32. wx: (B, 4, H, dh) input pre-activations; state:
    (c, n, h, m), each (B, H, dh)."""
    c, n, h, m = state
    pre = (wx + torch.einsum("bhd,ghde->bghe", h, r.to(h.dtype))).to(F32)
    z = torch.tanh(pre[:, 0])
    i_pre, f_pre = pre[:, 1], pre[:, 2]
    o = torch.sigmoid(pre[:, 3])
    lf = _logsigmoid(f_pre)
    m2 = torch.maximum(lf + m, i_pre)
    iw = torch.exp(i_pre - m2)
    fw = torch.exp(lf + m - m2)
    c2 = fw * c + iw * z
    n2 = fw * n + iw
    return c2, n2, o * c2 / n2.clamp_min(1e-6), m2


def _slstm_steps(wx, c, n, h, m, r):
    """The recurrence through wx's S steps from (c, n, h, m): (h (B, S, H,
    dh) in wx's type, c, n, h, m)."""
    state = (c, n, h, m)
    hs = []
    for t in range(wx.shape[1]):
        state = slstm_cell(wx[:, t], state, r)
        hs.append(state[2].to(wx.dtype))
    return (torch.stack(hs, dim=1), *state)


def slstm_sequence(p: SLSTMBlock, x, state, shd: Sharder = NO_SHD):
    """x: (B, S, D); state (c, n, h, m).  Steps through S; returns (h (B,
    S, H, dh) in x's type, the final state).  On a mesh each rank steps
    through its own batch rows and heads as plain tensors (the
    reference's ``lax.scan`` under GSPMD), its ``dh`` and sequence whole:
    the same operations, without DTensor's dispatch at each of the ~20
    a step."""
    dt = x.dtype
    wx = flat_matmul(x, p.w.to(dt)) + p.b.to(dt)
    # wx (B, S, 4, H, dh), each state (B, H, dh), r (4, H, dh, dh), hs (B, S, H, dh)
    hs, *state = _per_rank(_slstm_steps, (wx, *state, p.r),
                           ({0: 0, 3: 3},) + ({0: 0, 3: 1},) * 4 + ({3: 1},),
                           ({0: 0, 3: 2},) + ({0: 0, 3: 1},) * 4, shd)
    return hs, tuple(state)


def init_slstm_state(cfg, batch: int, device) -> dict:
    H = cfg.n_heads
    dh = cfg.d_model // H
    return {k: torch.zeros((batch, H, dh), dtype=F32, device=device) for k in "cnhm"}


def _slstm_out(p: SLSTMBlock, hs, cfg, shd: Sharder = NO_SHD):
    """Group-norm heads, gated FFN."""
    dt = getattr(torch, cfg.dtype)
    up = flat_matmul(_merged_heads(hs.to(dt), p.gn_scale), p.ffn_up.to(dt))
    g, u = up[:, :, 0], up[:, :, 1]
    y = (F.gelu(g, approximate="tanh") * u) @ p.ffn_down.to(dt)
    return shd.act(y, "batch", "res_seq", "act_embed")


def _slstm_run(p: SLSTMBlock, x, cache: dict, cfg, shd: Sharder = NO_SHD):
    hs, state = slstm_sequence(p, x, tuple(cache[k] for k in "cnhm"), shd)
    return _slstm_out(p, hs, cfg, shd), dict(zip("cnhm", state))


def slstm_forward(p: SLSTMBlock, x, cfg, with_cache: bool = False, shd: Sharder = NO_SHD):
    """Full-sequence sLSTM block from a zero state. x: (B, S, D) -> (B, S,
    D), and with ``with_cache`` the final state {c, n, h, m}."""
    y, cache = _slstm_run(p, x, init_slstm_state(cfg, x.shape[0], x.device), cfg, shd)
    return (y, cache) if with_cache else y


def slstm_decode(p: SLSTMBlock, x, cache: dict, cfg):
    """x: (B, 1, D) -> (y (B, 1, D), the new state)."""
    return _slstm_run(p, x, cache, cfg)
