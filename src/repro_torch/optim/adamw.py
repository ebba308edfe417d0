"""AdamW with decoupled weight decay, global-norm clipping and a warmup +
cosine learning-rate schedule (port of ``repro.optim.adamw``).

Parameters, gradients and the moments are dicts of tensors keyed by
parameter name; the state is ``{"m": {...}, "v": {...}, "count": int32
scalar tensor}`` on the parameters' device.  The arithmetic is the
reference's, in float32.  Unlike the reference, which is pure,
``update`` works in place: it scales the gradients by the clip factor
and overwrites the parameters and moments, so a step needs no second
copy of the model (the full-width training state is 16 bytes a
parameter).  No value leaves the device: the clip factor and the
learning rate stay tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 200
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(ocfg: AdamWConfig, count):
    """Linear warmup then cosine decay to min_lr_ratio; count: a tensor."""
    count = count.to(torch.float32)
    warm = count / max(ocfg.warmup_steps, 1)
    prog = torch.clamp((count - ocfg.warmup_steps)
                       / max(ocfg.decay_steps - ocfg.warmup_steps, 1), 0.0, 1.0)
    cos = ocfg.min_lr_ratio + (1 - ocfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return ocfg.lr * torch.where(count < ocfg.warmup_steps, warm, cos)


def init(params: Dict[str, torch.Tensor]) -> Dict:
    """Zero moments in float32 beside each parameter, and the step count."""
    dev = next(iter(params.values())).device
    return {"m": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads: Dict[str, torch.Tensor]):
    """sqrt of the sum of every gradient's sum of squares, in float32."""
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square() for g in grads.values()]
    return torch.stack(sq).sum().sqrt()


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """Scales the gradients in place by min(1, max_norm / norm); returns
    (grads, norm)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return grads, gnorm


def update(grads, state, params, ocfg: AdamWConfig):
    """One step in place; returns (params, state, metrics) with metrics
    ``{"grad_norm", "lr"}`` as tensors."""
    grads, gnorm = clip_by_global_norm(grads, ocfg.clip_norm)
    count = state["count"] + 1
    lr = schedule(ocfg, count)
    b1, b2 = ocfg.b1, ocfg.b2
    bc1 = 1 - b1 ** count.to(torch.float32)
    bc2 = 1 - b2 ** count.to(torch.float32)
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name].to(torch.float32)
            m, v = state["m"][name], state["v"][name]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            step = (m / bc1).div_((v / bc2).sqrt_().add_(ocfg.eps))
            pf = p.to(torch.float32)
            step.add_(ocfg.weight_decay * pf)
            p.copy_(pf - lr * step)
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}
