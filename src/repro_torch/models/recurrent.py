"""Griffin / RecurrentGemma recurrent block (port of
``repro.models.recurrent``): temporal conv + RG-LRU.

The RG-LRU recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
a_t = exp(-c * softplus(Lambda) * r_t), is evaluated over the whole
sequence by the ``rglru_scan`` kernel (``repro_torch.kernels.rglru_scan``,
the RG-LRU kernel the reference wrote for the TPU but never calls from its
model); decode is one step in plain torch.  Gates are block-diagonal per
head, as in Griffin.  GELU is the tanh approximation (``jax.nn.gelu``'s
default).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.models.common import Init
from repro_torch.models.sharding import NO_SHD, Sharder

RGLRU_C = 8.0


class RecBlock(nn.Module):
    def __init__(self, ini: Init, cfg):
        super().__init__()
        D, W, H = cfg.d_model, cfg.resolved_rnn_width, cfg.n_heads
        bw = W // H  # block width of the block-diagonal gates
        self.n_heads = H
        self.w_x = ini.fan_in((D, W), ("embed", "rnn"))
        self.w_gate = ini.fan_in((D, W), ("embed", "rnn"))
        self.conv_w = ini.normal((cfg.conv_width, W), ("conv", "rnn"), scale=0.1)
        self.conv_b = ini.zeros((W,), ("rnn",))
        self.gate_a_w = ini.fan_in((H, bw, bw), ("heads", None, "rnn"), fan_axes=(1,))
        self.gate_a_b = ini.zeros((H, bw), ("heads", "rnn"))
        self.gate_x_w = ini.fan_in((H, bw, bw), ("heads", None, "rnn"), fan_axes=(1,))
        self.gate_x_b = ini.zeros((H, bw), ("heads", "rnn"))
        # Lambda, so a = sigmoid(Lambda) starts near 0.9..0.999
        self.lam = ini.const((W,), ("rnn",), 4.0)
        self.w_out = ini.fan_in((W, D), ("rnn", "embed"))


def causal_conv1d(x, w, b):
    """Depthwise causal conv. x: (B, S, W); w: (cw, W); the same shifted
    multiply-adds, in the same order, as the reference."""
    cw, S = w.shape[0], x.shape[1]
    y = torch.zeros_like(x)
    for j in range(cw):
        y = y + _shifted(x, cw - 1 - j) * w[j].to(x.dtype)
    return y + b.to(x.dtype)


def _shifted(x, shift: int):
    """x delayed by ``shift`` steps along the sequence, zeros first.  A
    DTensor's by concatenation: DTensor's ``constant_pad_nd`` backward in
    torch 2.11 returns the padded shape."""
    S = x.shape[1]
    if not isinstance(x, DTensor):
        return F.pad(x, (0, 0, shift, 0))[:, :S]
    if shift == 0:
        return x
    shift = min(shift, S)
    return torch.cat([torch.zeros_like(x[:, :shift]), x[:, :S - shift]], dim=1)


def _block_diag(u, w, b, H):
    """u: (B, S, W) -> per-head block-diagonal linear, w: (H, bw, bw)."""
    B, S, W = u.shape
    uh = u.reshape(B, S, H, W // H)
    y = torch.einsum("bshi,hij->bshj", uh, w.to(u.dtype)) + b.to(u.dtype)
    return y.reshape(B, S, W)


def _rglru_coeffs(p: RecBlock, u):
    """Returns (log_a (B, S, W) f32, b (B, S, W) f32)."""
    H = p.n_heads
    r = torch.sigmoid(_block_diag(u, p.gate_a_w, p.gate_a_b, H).to(torch.float32))
    gi = torch.sigmoid(_block_diag(u, p.gate_x_w, p.gate_x_b, H).to(torch.float32))
    log_a = -RGLRU_C * r * F.softplus(p.lam.to(torch.float32))
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return log_a, mult * gi * u.to(torch.float32)


def _gate(p: RecBlock, x):
    return F.gelu(x @ p.w_gate.to(x.dtype), approximate="tanh")


def _scan(log_a, b, shd: Sharder):
    """The ``rglru_scan`` kernel; on a mesh on each rank's block of batch
    and width ("rnn"), the sequence whole."""
    return shd.local(rg_ops.rglru, (log_a, b), (0, 2))


def rec_forward(p: RecBlock, x, shd: Sharder = NO_SHD):
    """Full-sequence recurrent mixer. x: (B, S, D) -> (B, S, D)."""
    dt = x.dtype
    u = shd.act(x @ p.w_x.to(dt), "batch", "seq", "rnn")
    u = causal_conv1d(u, p.conv_w, p.conv_b)
    h = shd.act(_scan(*_rglru_coeffs(p, u), shd).to(dt), "batch", "seq", "rnn")
    return shd.act((h * _gate(p, x)) @ p.w_out.to(dt), "batch", "res_seq", "act_embed")


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_rec_cache(cfg, batch: int, device) -> dict:
    W = cfg.resolved_rnn_width
    return {"h": torch.zeros((batch, W), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, W),
                                dtype=getattr(torch, cfg.dtype), device=device)}


def rec_decode(p: RecBlock, x, cache):
    """x: (B, 1, D); cache: {'h': (B, W) f32, 'conv': (B, cw-1, W)}."""
    dt = x.dtype
    u = x @ p.w_x.to(dt)  # (B, 1, W)
    hist = torch.cat([cache["conv"], u], dim=1)  # (B, cw, W)
    u_c = torch.einsum("bcw,cw->bw", hist, p.conv_w.to(dt))[:, None] + p.conv_b.to(dt)
    log_a, b = _rglru_coeffs(p, u_c)
    h = torch.exp(log_a[:, 0]) * cache["h"] + b[:, 0]  # (B, W) f32
    y = (h[:, None].to(dt) * _gate(p, x)) @ p.w_out.to(dt)
    return y, {"h": h, "conv": hist[:, 1:]}


def rec_prefill_cache(p: RecBlock, x, conv_width: int, shd: Sharder = NO_SHD):
    """Run the mixer's recurrence over the full sequence; return the final
    recurrent state and the conv tail for decode."""
    dt = x.dtype
    u = x @ p.w_x.to(dt)
    h = _scan(*_rglru_coeffs(p, causal_conv1d(u, p.conv_w, p.conv_b)), shd)
    return {"h": h[:, -1].clone(), "conv": u[:, -(conv_width - 1):].clone()}
