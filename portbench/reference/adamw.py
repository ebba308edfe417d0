"""Plain AdamW, as the training cells' optimizer settings describe it:
gradients clipped by their global norm, decoupled weight decay on every
parameter, bias-corrected moments, a linear warmup to ``lr`` and a
cosine decay to ``min_lr_ratio * lr`` after it.  All in float32."""
from __future__ import annotations

import math
from typing import Dict

import torch


def lr_at(o: dict, count: int) -> float:
    if count < o["warmup_steps"]:
        return o["lr"] * count / max(o["warmup_steps"], 1)
    prog = min(max((count - o["warmup_steps"]) / max(o["decay_steps"] - o["warmup_steps"], 1),
                   0.0), 1.0)
    cosine = 0.5 * (1 + math.cos(math.pi * prog))
    return o["lr"] * (o["min_lr_ratio"] + (1 - o["min_lr_ratio"]) * cosine)


class AdamW:
    def __init__(self, o: dict, params: Dict[str, torch.Tensor]):
        self.o, self.count = o, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    def clip_factor(self, grads: Dict[str, torch.Tensor]) -> float:
        """The factor that clips the gradients to their global norm."""
        total = math.sqrt(sum(float(torch.linalg.vector_norm(g)) ** 2 for g in grads.values()))
        return min(1.0, self.o["clip_norm"] / max(total, 1e-12))

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        """One update in place; returns each clipped gradient's norm (the
        gradients as the moments take them)."""
        o = self.o
        clip = self.clip_factor(grads)
        self.count += 1
        lr = lr_at(o, self.count)
        bc1, bc2 = 1 - o["b1"] ** self.count, 1 - o["b2"] ** self.count
        norms = {}
        for k, p in params.items():
            g = grads[k] * clip
            norms[k] = float(torch.linalg.vector_norm(g))
            self.m[k].mul_(o["b1"]).add_((1 - o["b1"]) * g)
            self.v[k].mul_(o["b2"]).add_((1 - o["b2"]) * g.square())
            upd = (self.m[k] / bc1) / ((self.v[k] / bc2).sqrt() + o["eps"])
            p.sub_(lr * (upd + o["weight_decay"] * p))
        return norms
