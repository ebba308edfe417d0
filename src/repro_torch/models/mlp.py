"""Dense FFN variants (port of ``repro.models.mlp``): SwiGLU, squared
ReLU, GELU.  GELU is the tanh approximation, ``jax.nn.gelu``'s default
(``torch.nn.functional.gelu`` defaults to the exact erf form).
``MLP.forward`` is the reference's ``mlp_forward``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import Init
from repro_torch.models.sharding import NO_SHD, Sharder


class MLP(nn.Module):
    def __init__(self, ini: Init, cfg):
        super().__init__()
        D, Fd = cfg.d_model, cfg.d_ff
        self.kind = cfg.mlp_kind
        if self.kind == "swiglu":
            self.w_gate = ini.fan_in((D, Fd), ("embed", "mlp"))
        self.w_up = ini.fan_in((D, Fd), ("embed", "mlp"))
        self.w_down = ini.fan_in((Fd, D), ("mlp", "embed"))
        if cfg.mlp_bias:
            self.b_up = ini.zeros((Fd,), ("act_mlp",))
            self.b_down = ini.zeros((D,), ("act_embed",))
        else:
            self.b_up = self.b_down = None

    def forward(self, x, shd: Sharder = NO_SHD):
        dt = x.dtype
        x = shd.act(x, "ffn_batch", None, "ffn_embed")  # a no-op under the default rules
        if self.kind == "swiglu":
            g = x @ self.w_gate.to(dt)
            u = x @ self.w_up.to(dt)
            h = F.silu(g) * u
        else:
            h = x @ self.w_up.to(dt)
            if self.b_up is not None:
                h = h + self.b_up.to(dt)
            if self.kind == "relu2":
                h = torch.relu(h).square()
            else:  # gelu
                h = F.gelu(h, approximate="tanh")
        h = shd.act(h, "batch", "seq", "act_mlp")
        y = h @ self.w_down.to(dt)
        if self.b_down is not None:
            y = y + self.b_down.to(dt)
        return shd.act(y, "batch", "res_seq", "act_embed")
