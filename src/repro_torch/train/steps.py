"""Train, prefill and serve step factories (port of ``repro.train.steps``).

The train step differentiates through the port's kernels: on the card,
``flash_attention`` and ``rglru_scan`` run their backward kernels
(``autograd.Function``s in their ``ops.py``); on the CPU autograd
differentiates their plain versions.

Each factory takes the reference's ``shd``: with a mesh, the model's
parameters are DTensors (``Sharder.distribute``), the batch is placed by
``launch.specs.batch_shardings``, every activation constraint of the
reference is a ``redistribute`` and the kernels run on each rank's
block; the step runs in ``shd.scope()`` (plain tensors count as
replicated) and its metrics come back whole on every rank.  Without a
mesh (``Sharder(None)``, the default) it is the one-device step.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.models import lm
from repro_torch.models.sharding import NO_SHD, Sharder
from repro_torch.optim import adamw

MOE_AUX_COEF = 0.01


def _next_token(logits, shd: Sharder):
    """The greedy token of the last position, (B,) int32.  On a mesh the
    logits are replicated first: DTensor's argmax over a sharded
    vocabulary fails on an unsharded batch of 1 (torch 2.13)."""
    return shd.replicated(logits[:, -1]).argmax(dim=-1).to(torch.int32)


def make_loss_fn(cfg, shd: Sharder = NO_SHD):
    """(model, batch {'tokens', 'labels', optional 'weights',
    'img_embeds', 'frames'}) -> (total, {"loss", "aux_loss"}), with the
    reference's signature: the loss over the text positions (the first
    ``cfg.n_img_tokens`` logits, the image prefix's, are dropped) plus
    ``MOE_AUX_COEF`` times the MoE load-balancing loss (0 without an MoE
    layer)."""
    n_img = cfg.n_img_tokens or 0

    def loss_fn(model, batch):
        logits, aux = model.forward_with_aux(batch["tokens"], batch.get("img_embeds"),
                                             batch.get("frames"), shd)
        loss = lm.lm_loss(logits[:, n_img:], batch["labels"], batch.get("weights"), shd=shd)
        total = loss + MOE_AUX_COEF * aux
        return total, {"loss": loss, "aux_loss": aux}

    return loss_fn


def make_train_step(cfg, ocfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    shd: Sharder = NO_SHD):
    """(model, opt_state, batch) -> (model, opt_state, metrics): the loss,
    its gradients by backpropagation, and one AdamW update in place.  The
    model's parameters must require gradients; after the step they hold
    this step's (clipped) gradients in ``.grad``."""
    loss_fn = make_loss_fn(cfg, shd)

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        with shd.scope():
            total, metrics = loss_fn(model, batch)
            total.backward()
            grads = {k: p.grad for k, p in params.items()}
            missing = [k for k, g in grads.items() if g is None]
            if missing:
                raise RuntimeError(f"no gradient reached {missing}")
            _, opt_state, opt_metrics = adamw.update(grads, opt_state, params, ocfg)
            metrics = dict(metrics, total_loss=total, **opt_metrics)
            metrics = {k: Sharder.whole(v.detach()) for k, v in metrics.items()}
        return model, opt_state, metrics

    return train_step


def make_prefill_step(cache_len: int = 0, shd: Sharder = NO_SHD):
    """(model, batch {'tokens': (B, S), optional 'img_embeds', 'frames'})
    -> (next_token (B,) int32, caches)."""

    def prefill_step(model, batch):
        with shd.scope():
            logits, caches = model.prefill(batch["tokens"], cache_len=cache_len,
                                           img_embeds=batch.get("img_embeds"),
                                           frames=batch.get("frames"), shd=shd)
            return _next_token(logits, shd), caches

    return prefill_step


def make_serve_step(shd: Sharder = NO_SHD):
    """One greedy decode step: (model, caches, tokens (B, 1), pos (B,)) ->
    (next_token (B,) int32, logits, caches)."""

    def serve_step(model, caches, tokens, pos):
        with obs.span("serve_step"), shd.scope():
            logits, caches = model.decode_step(caches, tokens, pos, shd)
            return _next_token(logits, shd), logits, caches

    return serve_step
