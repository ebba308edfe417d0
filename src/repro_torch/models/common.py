"""Common model building blocks (port of ``repro.models.common``): the
parameter factory, norms, rotary and sinusoidal positions, vocabulary
padding.  The reference's ``init_norm`` and
``apply_norm`` are ``Norm`` (its parameters and its ``forward``).

``Init`` draws every parameter from one explicit ``torch.Generator`` on
the target device, in float32, then casts to ``param_dtype`` (as the
reference's ``Init.normal`` does).  With ``generator=None`` it allocates
uninitialised tensors of the right shape and type, for parameters that
are about to be loaded (the reference's ``abstract`` mode).  The numbers
differ from the reference's ``jax.random`` draws; tests carry the
reference's parameters over (``repro_torch.carry.lm_params_from_arrays``).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn


class Init:
    """Parameter factory on one device; ``generator=None`` leaves the
    values uninitialised (for parameters that are loaded next).  Every
    parameter is tagged with the reference's logical ``axes`` (its
    ``ParamLeaf.axes``), one name or ``None`` a dimension, as the
    attribute ``axes``: ``sharding.param_axes`` collects them and
    ``sharding.Sharder`` places the parameter by them."""

    def __init__(self, generator: Optional[torch.Generator], param_dtype: torch.dtype,
                 device: torch.device):
        self.generator = generator
        self.param_dtype = param_dtype
        self.device = device

    def _param(self, value: torch.Tensor, axes) -> nn.Parameter:
        axes = tuple(axes)
        if len(axes) != value.dim():
            raise ValueError(f"axes {axes} for a parameter of shape {tuple(value.shape)}")
        p = nn.Parameter(value, requires_grad=False)
        p.axes = axes
        return p

    def _empty(self, shape, axes, dtype) -> nn.Parameter:
        return self._param(torch.empty(tuple(shape), dtype=dtype, device=self.device), axes)

    def normal(self, shape, axes, scale: float = 0.02, dtype=None) -> nn.Parameter:
        dtype = dtype or self.param_dtype
        if self.generator is None:
            return self._empty(shape, axes, dtype)
        v = torch.randn(tuple(shape), generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return self._param((v * scale).to(dtype), axes)

    def fan_in(self, shape, axes, fan_axes=None, dtype=None) -> nn.Parameter:
        """Normal with 1/sqrt(fan_in) scale (fan = product of the
        ``fan_axes`` dims, default all but the last)."""
        if fan_axes is None:
            fan = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
        else:
            fan = math.prod(shape[i] for i in fan_axes)
        return self.normal(shape, axes, scale=1.0 / math.sqrt(max(fan, 1)), dtype=dtype)

    def const(self, shape, axes, fill, dtype=None) -> nn.Parameter:
        dtype = dtype or self.param_dtype
        if self.generator is None:
            return self._empty(shape, axes, dtype)
        return self._param(torch.full(tuple(shape), fill, dtype=dtype, device=self.device),
                           axes)

    def zeros(self, shape, axes, dtype=None) -> nn.Parameter:
        return self.const(shape, axes, 0, dtype)

    def ones(self, shape, axes, dtype=None) -> nn.Parameter:
        return self.const(shape, axes, 1, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float):
    dt = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(dt)


def layer_norm(x, scale, bias, eps: float):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


def group_norm_heads(x, scale, eps: float = 1e-5):
    """Per-head group norm over the feature dim, in float32, returned in
    the input's type. x: (..., H, dh); scale: (H, dh)."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(dt)


class Norm(nn.Module):
    """RMSNorm (``scale`` only, applied as ``1 + scale``) or LayerNorm
    (``scale`` and ``bias``), as ``cfg.norm_kind`` says."""

    def __init__(self, ini: Init, cfg, width: Optional[int] = None):
        super().__init__()
        width = width or cfg.d_model
        self.eps = cfg.norm_eps
        if cfg.norm_kind == "rmsnorm":
            self.scale = ini.zeros((width,), ("act_embed",))
            self.bias = None
        else:
            self.scale = ini.ones((width,), ("act_embed",))
            self.bias = ini.zeros((width,), ("act_embed",))

    def forward(self, x):
        if self.bias is None:
            return rms_norm(x, self.scale, self.eps)
        return layer_norm(x, self.scale, self.bias, self.eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_tables(positions, head_dim: int, theta: float):
    """positions: int (..., S). Returns (sin, cos), each (..., S, head_dim/2),
    in float32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: (B, S, H, D); sin/cos: (B, S, half) or (S, half).  Split-half
    convention, computed in float32."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.dim() == 2:  # (S, half): broadcast over batch and heads
        s, c = sin[None, :, None, :], cos[None, :, None, :]
    else:  # (B, S, half)
        s, c = sin[:, :, None, :], cos[:, :, None, :]
    x1f, x2f = x1.to(torch.float32), x2.to(torch.float32)
    out = torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n_pos: int, dim: int) -> np.ndarray:
    """Whisper-style sinusoidal table (n_pos, dim), float32, computed on
    the host: sines of the first half, cosines of the second."""
    half = dim // 2
    log_timescale = np.log(10_000.0) / max(half - 1, 1)
    inv = np.exp(-log_timescale * np.arange(half))
    ang = np.arange(n_pos)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)


def padded_vocab(vocab_size: int, multiple: int = 128) -> int:
    return ((vocab_size + multiple - 1) // multiple) * multiple


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap > 0 else x
