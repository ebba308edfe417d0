"""Train, prefill and serve step factories (port of ``repro.train.steps``).

The train step differentiates through the port's kernels: on the card,
``flash_attention`` and ``rglru_scan`` run their backward kernels
(``autograd.Function``s in their ``ops.py``); on the CPU autograd
differentiates their plain versions.  One card holds the whole model,
so there is no model axis to shard over: the KV cache keeps the
reference's layout at ``model_axis=1``.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.optim import adamw

MOE_AUX_COEF = 0.01


def make_loss_fn(cfg):
    """(model, batch {'tokens', 'labels', optional 'weights',
    'img_embeds', 'frames'}) -> (total, {"loss", "aux_loss"}), with the
    reference's signature: the loss over the text positions (the first
    ``cfg.n_img_tokens`` logits, the image prefix's, are dropped) plus
    ``MOE_AUX_COEF`` times the MoE load-balancing loss (0 without an MoE
    layer)."""
    n_img = cfg.n_img_tokens or 0

    def loss_fn(model, batch):
        logits, aux = model.forward_with_aux(batch["tokens"], batch.get("img_embeds"),
                                             batch.get("frames"))
        loss = lm.lm_loss(logits[:, n_img:], batch["labels"], batch.get("weights"))
        total = loss + MOE_AUX_COEF * aux
        return total, {"loss": loss, "aux_loss": aux}

    return loss_fn


def make_train_step(cfg, ocfg: adamw.AdamWConfig = adamw.AdamWConfig()):
    """(model, opt_state, batch) -> (model, opt_state, metrics): the loss,
    its gradients by backpropagation, and one AdamW update in place.  The
    model's parameters must require gradients; after the step they hold
    this step's (clipped) gradients in ``.grad``."""
    loss_fn = make_loss_fn(cfg)

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        total, metrics = loss_fn(model, batch)
        total.backward()
        grads = {k: p.grad for k, p in params.items()}
        missing = [k for k, g in grads.items() if g is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing}")
        _, opt_state, opt_metrics = adamw.update(grads, opt_state, params, ocfg)
        metrics = dict({k: v.detach() for k, v in metrics.items()}, total_loss=total.detach(),
                       **opt_metrics)
        return model, opt_state, metrics

    return train_step


def make_prefill_step(cache_len: int = 0):
    """(model, batch {'tokens': (B, S), optional 'img_embeds', 'frames'})
    -> (next_token (B,) int32, caches)."""

    def prefill_step(model, batch):
        logits, caches = model.prefill(batch["tokens"], cache_len=cache_len,
                                       img_embeds=batch.get("img_embeds"),
                                       frames=batch.get("frames"))
        return logits[:, -1].argmax(dim=-1).to(torch.int32), caches

    return prefill_step


def make_serve_step():
    """One greedy decode step: (model, caches, tokens (B, 1), pos (B,)) ->
    (next_token (B,) int32, logits, caches)."""

    def serve_step(model, caches, tokens, pos):
        logits, caches = model.decode_step(caches, tokens, pos)
        return logits[:, -1].argmax(dim=-1).to(torch.int32), logits, caches

    return serve_step
