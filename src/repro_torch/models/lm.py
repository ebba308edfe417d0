"""Decoder-only language model (port of ``repro.models.lm``) as
``nn.Module``s:

    model = init(cfg, seed, device)                 # random weights from a seed
    model = from_state_dict(cfg, state, device)     # carried weights
    logits = model(tokens)                          # (B, S, Vp) float32
    loss = lm_loss(logits, labels)                  # the training loss
    logits, caches = model.prefill(tokens, cache_len)
    logits, caches = model.decode_step(caches, tokens, pos)

``init`` and ``from_state_dict`` return the model in eval mode with its
parameters frozen (serving); a trainer turns gradients on
(``model.requires_grad_(True)``).  ``model(tokens)`` is the training
forward's logits; ``model.forward_with_aux(tokens)`` also returns the
MoE load-balancing loss summed over the layers, as the reference's
``forward`` does (0 without an MoE layer).  ``cfg.remat`` wraps each
layer as the reference's ``_remat_wrap`` wraps each unit: "full" runs it
inside ``torch.utils.checkpoint`` (its activations are recomputed in the
backward pass); "dots" does too, but keeps the outputs of the products
with no batch dimension (``aten.mm``/``addmm``: the projections), as
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` does, and
recomputes the rest, batched products (``bmm``) included.

``model.layers`` is one ``nn.ModuleList`` in the order the reference's
``_run_units`` runs its layers: the remainder layers, then the units.
Parameter names are the reference's leaf names (``embed``,
``final_norm.scale``, ``layers.<i>.attn.wq``, ``layers.<i>.ffn.w_gate``,
``layers.<i>.mix.up``, ...; see ``repro_torch.carry.lm_params_from_arrays``).
``caches`` is a list with one dict per layer, ``{"attn": {...}}``,
``{"rec": {...}}`` or ``{"mix": {...}}``.

Blocks: attention (with a dense or, when ``cfg.is_moe``, an MoE FFN),
RG-LRU recurrent blocks with dense FFNs, and the xLSTM blocks (mLSTM,
sLSTM; no FFN).  Encoder-decoder cross-attention and image prefixes
(with learned or sinusoidal positions) raise ``NotImplementedError``:
they come with the next family (ROADMAP Queue 1, item 1).
"""
from __future__ import annotations

import functools
from typing import List

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.device import DeviceLike, resolve
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models import xlstm_blocks as xl_mod
from repro_torch.models.common import Init, Norm, padded_vocab
from repro_torch.models.mlp import MLP

_LATER = "is ported with the next model family (ROADMAP Queue 1, item 1)"

# block kind -> (module, full-sequence function, decode function)
_MIX = {"mlstm": (xl_mod.MLSTMBlock, xl_mod.mlstm_forward, xl_mod.mlstm_decode),
        "slstm": (xl_mod.SLSTMBlock, xl_mod.slstm_forward, xl_mod.slstm_decode)}

# remat="dots": keep what ``dots_with_no_batch_dims_saveable`` keeps, the
# products with no batch dimension; recompute everything else
_DOTS_SAVED = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]
_REMAT = {"full": {},
          "dots": {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                                   _DOTS_SAVED)}}


def layer_kinds(cfg) -> List[str]:
    """Block kind of every layer: the remainder layers, then the units."""
    pattern = cfg.resolved_pattern
    rem = [pattern[i % cfg.unit_len] for i in range(cfg.n_rem_layers)]
    return rem + list(pattern) * cfg.n_units


class Block(nn.Module):
    def __init__(self, ini: Init, cfg, kind: str):
        super().__init__()
        if kind not in ("attn", "rec", *_MIX):
            raise ValueError(f"block kind {kind!r}")
        self.cfg, self.kind = cfg, kind
        self.norm1 = Norm(ini, cfg)
        if kind == "attn":
            self.attn = attn_mod.Attention(ini, cfg)
        elif kind == "rec":
            self.rec = rec_mod.RecBlock(ini, cfg)
        else:  # the xLSTM blocks carry their own projections: no FFN
            self.mix = _MIX[kind][0](ini, cfg)
        self.moe = kind == "attn" and cfg.is_moe
        if cfg.d_ff > 0 and kind in ("attn", "rec"):
            self.norm2 = Norm(ini, cfg)
            self.ffn = moe_mod.MoE(ini, cfg) if self.moe else MLP(ini, cfg)

    def _ffn(self, x):
        """(x plus the FFN's output, the MoE loss or None)."""
        if not hasattr(self, "ffn"):
            return x, None
        h = self.norm2(x)
        if self.moe:
            y, aux = moe_mod.moe_forward(self.ffn, h, self.cfg)
            return x + y, aux
        return x + self.ffn(h), None

    def _mix(self, h, positions):
        if self.kind == "attn":
            return attn_mod.attention_forward(self.attn, h, self.cfg, positions)
        return rec_mod.rec_forward(self.rec, h)

    def forward(self, x, positions):
        """Full-sequence block: (x, the MoE loss of its FFN or None)."""
        h = self.norm1(x)
        if self.kind in _MIX:
            return x + _MIX[self.kind][1](self.mix, h, self.cfg), None
        return self._ffn(x + self._mix(h, positions))

    def prefill(self, x, positions, seq_len: int):
        """Full-sequence block and the cache its decode starts from.  The
        attention and recurrent caches come from a second pass over the
        same normed input (the reference's ``_block_prefill_cache``); the
        xLSTM blocks' from the forward pass itself (the same call on the
        same input as the reference's second pass)."""
        h = self.norm1(x)
        if self.kind in _MIX:
            y, cache = _MIX[self.kind][1](self.mix, h, self.cfg, with_cache=True)
            return x + y, {"mix": cache}
        if self.kind == "attn":
            cache = {"attn": attn_mod.prefill_cache_entries(self.attn, h, self.cfg, positions,
                                                            seq_len)}
        else:
            cache = {"rec": rec_mod.rec_prefill_cache(self.rec, h, self.cfg.conv_width)}
        return self._ffn(x + self._mix(h, positions))[0], cache

    def decode(self, x, cache: dict, pos):
        """One token per sequence; returns (x, cache)."""
        h = self.norm1(x)
        if self.kind in _MIX:
            y, c = _MIX[self.kind][2](self.mix, h, cache["mix"], self.cfg)
            return x + y, {"mix": c}
        if self.kind == "attn":
            y, c = attn_mod.attention_decode(self.attn, h, cache["attn"], pos, self.cfg)
            cache = {"attn": c}
        else:
            y, c = rec_mod.rec_decode(self.rec, h, cache["rec"])
            cache = {"rec": c}
        return self._ffn(x + y)[0], cache


class LM(nn.Module):
    def __init__(self, cfg, ini: Init):
        super().__init__()
        if cfg.is_encdec:
            raise NotImplementedError(f"encoder-decoder cross-attention {_LATER}")
        if cfg.n_img_tokens:
            raise NotImplementedError(f"the image prefix {_LATER}")
        if cfg.pos_kind not in ("rope", "none"):
            raise NotImplementedError(f"pos_kind {cfg.pos_kind!r} {_LATER}")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        D, Vp = cfg.d_model, padded_vocab(cfg.vocab_size)
        self.embed = ini.normal((Vp, D), scale=1.0)
        self.final_norm = Norm(ini, cfg)
        self.lm_head = None if cfg.tie_embeddings else ini.fan_in((D, Vp))
        self.layers = nn.ModuleList(Block(ini, cfg, kind) for kind in layer_kinds(cfg))

    def _embed(self, tokens):
        return self.embed[tokens].to(self.dtype)

    def _logits(self, x):
        w = self.embed.T if self.lm_head is None else self.lm_head
        return (self.final_norm(x) @ w.to(x.dtype)).to(torch.float32)

    def forward_with_aux(self, tokens):
        """tokens (B, S) -> (logits (B, S, Vp) float32, the MoE
        load-balancing loss summed over the layers, a float32 scalar)."""
        remat = self.cfg.remat
        if remat not in ("none", *_REMAT):
            raise ValueError(f"remat={remat!r}: one of 'none', 'full', 'dots'")
        x = self._embed(tokens)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.layers:
            if remat != "none" and torch.is_grad_enabled():
                x, a = checkpoint(layer, x, positions, use_reentrant=False, **_REMAT[remat])
            else:
                x, a = layer(x, positions)
            if a is not None:
                aux = aux + a
        return self._logits(x), aux

    def forward(self, tokens):
        """tokens (B, S) -> logits (B, S, Vp) float32."""
        return self.forward_with_aux(tokens)[0]

    def prefill(self, tokens, cache_len: int = 0):
        """Full-context pass: (last-token logits (B, 1, Vp), caches).
        cache_len: the KV-cache allocation (>= prompt + decode budget);
        defaults to the prompt length."""
        x = self._embed(tokens)
        S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        caches = []
        for layer in self.layers:
            x, cache = layer.prefill(x, positions, max(cache_len, S))
            caches.append(cache)
        return self._logits(x[:, -1:]), caches

    def decode_step(self, caches: list, tokens, pos):
        """tokens (B, 1) at absolute positions pos (B,) -> (logits
        (B, 1, Vp), caches); attention caches are updated in place."""
        x = self._embed(tokens)
        out = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer.decode(x, cache, pos)
            out.append(cache)
        return self._logits(x), out


def lm_loss(logits, labels, weights=None, z_loss: float = 1e-4):
    """Masked softmax cross-entropy over the (padded) vocabulary, plus
    ``z_loss * lse^2`` (the reference's ``lm_loss``).  logits (B, S, Vp),
    labels (B, S) int, weights (B, S) or None -> a float32 scalar.  The
    gold logit is gathered, not taken through a (B, S, V) one-hot."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    ce = lse - gold
    if z_loss:
        ce = ce + z_loss * lse.square()
    w = torch.ones_like(ce) if weights is None else weights.to(torch.float32)
    return (ce * w).sum() / w.sum().clamp_min(1.0)


def init(cfg, seed: int = 0, device: DeviceLike = None) -> LM:
    """The model with random weights drawn on ``device`` from ``seed``."""
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LM(cfg, Init(gen, getattr(torch, cfg.param_dtype), dev)).eval()


def from_state_dict(cfg, state: dict, device: DeviceLike = None) -> LM:
    """The model with the weights of ``state`` (cast to ``param_dtype``)."""
    dev = resolve(device)
    model = LM(cfg, Init(None, getattr(torch, cfg.param_dtype), dev))
    model.load_state_dict(state)
    return model.eval()
