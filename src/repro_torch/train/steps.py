"""Prefill and serve step factories (port of ``repro.train.steps``).  The
train step is ported with the training slice (ROADMAP Queue 1, item 9b).
One card holds the whole model, so there is no model axis to shard over:
the KV cache keeps the reference's layout at ``model_axis=1``."""
from __future__ import annotations

import torch


def make_prefill_step(cache_len: int = 0):
    """(model, batch {'tokens': (B, S)}) -> (next_token (B,) int32, caches)."""

    def prefill_step(model, batch):
        logits, caches = model.prefill(batch["tokens"], cache_len=cache_len)
        return logits[:, -1].argmax(dim=-1).to(torch.int32), caches

    return prefill_step


def make_serve_step():
    """One greedy decode step: (model, caches, tokens (B, 1), pos (B,)) ->
    (next_token (B,) int32, logits, caches)."""

    def serve_step(model, caches, tokens, pos):
        logits, caches = model.decode_step(caches, tokens, pos)
        return logits[:, -1].argmax(dim=-1).to(torch.int32), logits, caches

    return serve_step
