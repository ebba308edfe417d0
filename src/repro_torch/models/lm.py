"""Language models (port of ``repro.models.lm``) as ``nn.Module``s:
decoder-only, encoder-decoder (whisper) and image-prefix (VLM).

    model = init(cfg, seed, device, max_seq)       # random weights from a seed
    model = from_state_dict(cfg, state, device)     # carried weights
    logits = model(tokens, img_embeds=, frames=)    # (B, S, Vp) float32
    loss = lm_loss(logits, labels)                  # the training loss
    logits, caches = model.prefill(tokens, cache_len, img_embeds=, frames=)
    logits, caches = model.decode_step(caches, tokens, pos)

``init`` and ``from_state_dict`` return the model in eval mode with its
parameters frozen (serving); a trainer turns gradients on
(``model.requires_grad_(True)``).  ``model(tokens)`` is the training
forward's logits; ``model.forward_with_aux(tokens)`` also returns the
MoE load-balancing loss summed over the layers, as the reference's
``forward`` does (0 without an MoE layer).  ``cfg.remat`` wraps each
layer (the encoder's too) as the reference's ``_remat_wrap`` wraps each
unit: "full" runs it inside ``torch.utils.checkpoint`` (its activations
are recomputed in the backward pass); "dots" does too, but keeps the
outputs of the products with no batch dimension (``aten.mm``/``addmm``:
the projections), as ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
does, and recomputes the rest, batched products (``bmm``) included.

Inputs, as the reference's ``_assemble_inputs`` builds them: a VLM
config (``cfg.n_img_tokens``) takes ``img_embeds`` (B, n_img, D), cast
to the activation type and put before the token embeddings, so
positions (and rope) run over the image prefix and decode positions
start after it; ``pos_kind="learned"`` adds ``pos[:S]`` (a table of
``max_seq`` rows) after that, and ``pos[pos]`` at decode;
``"sinusoidal"`` adds nothing to the decoder's input (the reference has
no branch for it).  An encoder-decoder config (``cfg.is_encdec``) takes
``frames`` (B, S_enc, D): the encoder adds the sinusoidal table (both in
the activation type), runs ``n_enc_layers`` non-causal attention blocks
and ``enc_norm``; every decoder block attends its output after its
self-attention (``norm_x``, ``xattn``), and the prefill caches that
cross-attention's keys and values (``ck``, ``cv``) for decode.

``model.layers`` is one ``nn.ModuleList`` in the order the reference's
``_run_units`` runs its layers: the remainder layers, then the units;
``model.enc_layers`` the encoder's.  Parameter names are the
reference's leaf names (``embed``, ``pos``, ``final_norm.scale``,
``layers.<i>.attn.wq``, ``layers.<i>.xattn.wq``, ``layers.<i>.ffn.w_gate``,
``layers.<i>.mix.up``, ``enc_layers.<u>.attn.wq``, ``enc_norm.scale``, ...;
see ``repro_torch.carry.lm_params_from_arrays``).  ``caches`` is a list
with one dict per layer, ``{"attn": {...}}`` (with ``ck``/``cv`` in a
decoder with cross-attention), ``{"rec": {...}}`` or ``{"mix": {...}}``.

Blocks: attention (with a dense or, when ``cfg.is_moe``, an MoE FFN),
RG-LRU recurrent blocks with dense FFNs, and the xLSTM blocks (mLSTM,
sLSTM; no FFN).
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
from repro_torch.models.common import Init, Norm, padded_vocab, sinusoidal_positions
from repro_torch.models.mlp import MLP
from repro_torch.models.sharding import NO_SHD, Sharder

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


def _rows(table, idx, shd: Sharder):
    """``table[idx]``; on a mesh the table and its indices replicated
    first (DTensor's own lookup replicates the table too), so the lookup's
    gradient comes back in the table's placements: torch 2.11's DTensor
    fails on sharded indices in the lookup's backward, and on adding a
    tied embedding's two gradients in the placements it picks."""
    return shd.replicated(table)[shd.replicated(idx)]


def _gathered(h, shd: Sharder):
    """A normed residual (B, S, D) with its sequence whole: the all-gather
    at each block's entry that the reference's sequence-sharded residual
    stream ("res_seq") implies and GSPMD inserts, made explicit, since
    DTensor (torch 2.11) cannot merge a sharded sequence into a product's
    rows.  A no-op without a mesh."""
    return shd.act(h, "batch", "seq", "act_embed")


class Block(nn.Module):
    """One layer.  An attention block of an encoder-decoder's decoder
    (``cross``) also attends the encoder's output; an encoder block is
    not ``causal``."""

    def __init__(self, ini: Init, cfg, kind: str, cross: bool = False, causal: bool = True):
        super().__init__()
        if kind not in ("attn", "rec", *_MIX):
            raise ValueError(f"block kind {kind!r}")
        self.cfg, self.kind, self.causal = cfg, kind, causal
        self.cross = cross and kind == "attn"
        self.norm1 = Norm(ini, cfg)
        if kind == "attn":
            self.attn = attn_mod.Attention(ini, cfg)
            if self.cross:
                self.norm_x = Norm(ini, cfg)
                self.xattn = attn_mod.Attention(ini, cfg, cross=True)
        elif kind == "rec":
            self.rec = rec_mod.RecBlock(ini, cfg)
        else:  # the xLSTM blocks carry their own projections: no FFN
            self.mix = _MIX[kind][0](ini, cfg)
        self.moe = kind == "attn" and cfg.is_moe
        if cfg.d_ff > 0 and kind in ("attn", "rec"):
            self.norm2 = Norm(ini, cfg)
            self.ffn = moe_mod.MoE(ini, cfg) if self.moe else MLP(ini, cfg)

    def _ffn(self, x, shd: Sharder):
        """(x plus the FFN's output, the MoE loss or None)."""
        if not hasattr(self, "ffn"):
            return x, None
        h = _gathered(self.norm2(x), shd)
        if self.moe:
            y, aux = moe_mod.moe_forward(self.ffn, h, self.cfg, shd=shd)
            return x + y, aux
        return x + self.ffn(h, shd), None

    def _mix_ffn(self, x, h, positions, enc_out, shd: Sharder):
        """The block after its first norm ``h``: its mixer, the
        cross-attention over ``enc_out`` and the FFN."""
        if self.kind == "rec":
            return self._ffn(x + rec_mod.rec_forward(self.rec, h, shd), shd)
        x = x + attn_mod.attention_forward(self.attn, h, self.cfg, positions, causal=self.causal,
                                           shd=shd)
        if self.cross:
            x = x + attn_mod.attention_forward(self.xattn, _gathered(self.norm_x(x), shd),
                                               self.cfg, positions,
                                               kv_x=enc_out, shd=shd)
        return self._ffn(x, shd)

    def forward(self, x, positions, enc_out=None, shd: Sharder = NO_SHD):
        """Full-sequence block: (x, the MoE loss of its FFN or None)."""
        h = _gathered(self.norm1(x), shd)
        if self.kind in _MIX:
            return x + _MIX[self.kind][1](self.mix, h, self.cfg, shd=shd), None
        return self._mix_ffn(x, h, positions, enc_out, shd)

    def prefill(self, x, positions, seq_len: int, enc_out=None, shd: Sharder = NO_SHD):
        """Full-sequence block and the cache its decode starts from.  The
        attention and recurrent caches come from a second pass over the
        same normed input (the reference's ``_block_prefill_cache``), the
        cross-attention's from the encoder's output; the xLSTM blocks'
        from the forward pass itself (the same call on the same input as
        the reference's second pass)."""
        h = _gathered(self.norm1(x), shd)
        if self.kind in _MIX:
            y, cache = _MIX[self.kind][1](self.mix, h, self.cfg, with_cache=True, shd=shd)
            return x + y, {"mix": cache}
        if self.kind == "attn":
            cache = {"attn": attn_mod.prefill_cache_entries(self.attn, h, self.cfg, positions,
                                                            seq_len, shd)}
            if self.cross:
                cache["attn"].update(attn_mod.cross_cache_entries(self.xattn, enc_out, self.cfg,
                                                                  shd))
        else:
            cache = {"rec": rec_mod.rec_prefill_cache(self.rec, h, self.cfg.conv_width, shd)}
        return self._mix_ffn(x, h, positions, enc_out, shd)[0], cache

    def decode(self, x, cache: dict, pos, shd: Sharder = NO_SHD):
        """One token per sequence; returns (x, cache)."""
        h = self.norm1(x)
        if self.kind in _MIX:
            y, c = _MIX[self.kind][2](self.mix, h, cache["mix"], self.cfg)
            return x + y, {"mix": c}
        if self.kind == "attn":
            y, c = attn_mod.attention_decode(self.attn, h, cache["attn"], pos, self.cfg,
                                             shd=shd)
            x = x + y
            if self.cross:
                y, _ = attn_mod.attention_decode(self.xattn, self.norm_x(x), c, pos, self.cfg,
                                                 cross=True, shd=shd)
                x = x + y
            cache = {"attn": c}
        else:
            y, c = rec_mod.rec_decode(self.rec, h, cache["rec"])
            x = x + y
            cache = {"rec": c}
        return self._ffn(x, shd)[0], cache


class LM(nn.Module):
    def __init__(self, cfg, ini: Init, max_seq: int = 0):
        super().__init__()
        if cfg.pos_kind == "learned" and max_seq <= 0:
            raise ValueError(f"{cfg.name} learns its positions: give the table's length "
                             "max_seq > 0")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        D, Vp = cfg.d_model, padded_vocab(cfg.vocab_size)
        self.embed = ini.normal((Vp, D), ("vocab", "embed"), scale=1.0)
        self.final_norm = Norm(ini, cfg)
        self.lm_head = (None if cfg.tie_embeddings
                        else ini.fan_in((D, Vp), ("embed", "vocab")))
        self.pos = (ini.normal((max_seq, D), ("pos", "embed"), scale=0.01)
                    if cfg.pos_kind == "learned" else None)
        self.layers = nn.ModuleList(Block(ini, cfg, kind, cross=cfg.is_encdec)
                                    for kind in layer_kinds(cfg))
        self.enc_layers = self.enc_norm = None
        if cfg.is_encdec:
            enc_cfg = cfg.replace(block_pattern=(), is_encdec=False, n_layers=cfg.n_enc_layers)
            self.enc_layers = nn.ModuleList(Block(ini, enc_cfg, "attn", causal=False)
                                            for _ in range(cfg.n_enc_layers))
            self.enc_norm = Norm(ini, cfg)

    def _embed(self, tokens, shd: Sharder):
        return shd.act(_rows(self.embed, tokens, shd).to(self.dtype), "batch", "res_seq", "act_embed")

    def _logits(self, x, shd: Sharder):
        """float32 logits, left sequence-sharded as the reference leaves
        them (the largest training activation otherwise)."""
        w = self.embed.T if self.lm_head is None else self.lm_head
        logits = (_gathered(self.final_norm(x), shd) @ w.to(x.dtype)).to(torch.float32)
        return shd.act(logits, "batch", "res_seq", None)

    def _layer(self, layer, x, positions, enc_out, shd: Sharder):
        """One full-sequence layer, under ``cfg.remat`` when a gradient is
        being recorded."""
        remat = self.cfg.remat
        if remat not in ("none", *_REMAT):
            raise ValueError(f"remat={remat!r}: one of 'none', 'full', 'dots'")
        if remat != "none" and torch.is_grad_enabled():
            return checkpoint(layer, x, positions, enc_out, shd, use_reentrant=False,
                              **_REMAT[remat])
        return layer(x, positions, enc_out, shd)

    def _encode(self, frames, shd: Sharder):
        """The encoder over the frame embeddings (B, S_enc, D): the
        sinusoidal table added in the activation type, the blocks run
        non-causal, ``enc_norm`` last."""
        S = frames.shape[1]
        table = torch.from_numpy(sinusoidal_positions(S, self.cfg.d_model))
        x = frames.to(self.dtype) + table.to(device=frames.device, dtype=self.dtype)[None]
        x = shd.act(x, "batch", "seq", "act_embed")
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        for layer in self.enc_layers:
            x = self._layer(layer, x, positions, None, shd)[0]
        return self.enc_norm(x)

    def _assemble(self, tokens, img_embeds, frames, shd: Sharder):
        """(x, positions, the encoder's output or None): the image prefix
        before the token embeddings, then the learned positions."""
        cfg = self.cfg
        if cfg.n_img_tokens and img_embeds is None:
            raise ValueError(f"{cfg.name} takes img_embeds (B, {cfg.n_img_tokens}, "
                             f"{cfg.d_model})")
        if cfg.is_encdec and frames is None:
            raise ValueError(f"{cfg.name} takes frames (B, {cfg.enc_seq}, {cfg.d_model})")
        x = self._embed(tokens, shd)
        if cfg.n_img_tokens:
            x = shd.act(torch.cat([img_embeds.to(x.dtype), x], dim=1),
                        "batch", "res_seq", "act_embed")
        enc_out = self._encode(frames, shd) if cfg.is_encdec else None
        S = x.shape[1]
        if self.pos is not None:
            x = x + self.pos[:S].to(x.dtype)[None]
        return x, torch.arange(S, dtype=torch.int32, device=x.device), enc_out

    def forward_with_aux(self, tokens, img_embeds=None, frames=None, shd: Sharder = NO_SHD):
        """tokens (B, S) -> (logits (B, n_img + S, Vp) float32, the MoE
        load-balancing loss summed over the layers, a float32 scalar).
        ``shd`` places the activations on its mesh (parameters placed by
        ``shd.distribute``)."""
        with shd.scope():
            x, positions, enc_out = self._assemble(tokens, img_embeds, frames, shd)
            aux = torch.zeros((), dtype=torch.float32, device=positions.device)
            for layer in self.layers:
                x, a = self._layer(layer, x, positions, enc_out, shd)
                if a is not None:
                    aux = aux + a
            return self._logits(x, shd), aux

    def forward(self, tokens, img_embeds=None, frames=None, shd: Sharder = NO_SHD):
        """tokens (B, S) -> logits (B, n_img + S, Vp) float32."""
        return self.forward_with_aux(tokens, img_embeds, frames, shd)[0]

    def prefill(self, tokens, cache_len: int = 0, img_embeds=None, frames=None,
                shd: Sharder = NO_SHD):
        """Full-context pass: (last-token logits (B, 1, Vp), caches).
        cache_len: the KV-cache allocation (>= image prefix + prompt +
        decode budget); defaults to the sequence's length.  On a mesh the
        attention caches hold the virtual KV heads of its model axis."""
        with shd.scope():
            x, positions, enc_out = self._assemble(tokens, img_embeds, frames, shd)
            S = x.shape[1]
            caches = []
            for layer in self.layers:
                x, cache = layer.prefill(x, positions, max(cache_len, S), enc_out, shd)
                caches.append(cache)
            return self._logits(x[:, -1:], shd), caches

    def decode_step(self, caches: list, tokens, pos, shd: Sharder = NO_SHD):
        """tokens (B, 1) at absolute positions pos (B,) (after the image
        prefix) -> (logits (B, 1, Vp), caches); attention caches are
        updated in place."""
        with shd.scope():
            x = shd.act(_rows(self.embed, tokens, shd).to(self.dtype), "batch", None, "act_embed")
            if self.pos is not None:
                x = x + _rows(self.pos, pos.long(), shd).to(x.dtype)[:, None]
            out = []
            for layer, cache in zip(self.layers, caches):
                x, cache = layer.decode(x, cache, pos, shd)
                out.append(cache)
            return self._logits(x, shd), out


def _take_gold(logits, idx):
    return torch.gather(logits, -1, idx)[..., 0]


def _gold(logits, idx, shd: Sharder):
    """Each position's logit of its label.  Sharded logits with the
    vocabulary whole on every rank are gathered on each rank's block
    (``Sharder.local``): DTensor's own gather backward allocates the
    global logits' zeros on every rank."""
    last = logits.dim() - 1
    if Sharder.shards(logits, last):
        return _take_gold(logits, idx)
    return shd.local(_take_gold, (logits, idx), tuple(range(last)))


def lm_loss(logits, labels, weights=None, z_loss: float = 1e-4, shd: Sharder = NO_SHD):
    """Masked softmax cross-entropy over the (padded) vocabulary, plus
    ``z_loss * lse^2`` (the reference's ``lm_loss``).  logits (B, S, Vp),
    labels (B, S) int, weights (B, S) or None -> a float32 scalar.  The
    gold logit is gathered, not taken through a (B, S, V) one-hot."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = _gold(logits, labels.to(torch.int64)[..., None], shd)
    ce = lse - gold
    if z_loss:
        ce = ce + z_loss * lse.square()
    w = torch.ones_like(ce) if weights is None else weights.to(torch.float32)
    return (ce * w).sum() / w.sum().clamp_min(1.0)


def init_cache(cfg, batch: int, seq_len: int, device: DeviceLike = None,
               model_axis: int = 1) -> list:
    """Empty decode caches for a ``seq_len``-token context, one dict a
    layer as ``prefill`` returns them (the reference's ``init_cache``;
    an encoder-decoder's attention caches also hold ``ck``/``cv`` over
    ``cfg.enc_seq`` frames)."""
    dev = resolve(device)
    cross_len = cfg.enc_seq if cfg.is_encdec else 0
    out = []
    for kind in layer_kinds(cfg):
        if kind == "attn":
            out.append({"attn": attn_mod.init_attn_cache(cfg, batch, seq_len, dev, model_axis,
                                                         cross_len)})
        elif kind == "rec":
            out.append({"rec": rec_mod.init_rec_cache(cfg, batch, dev)})
        elif kind == "mlstm":
            out.append({"mix": xl_mod.init_mlstm_cache(cfg, batch, dev)})
        else:
            out.append({"mix": xl_mod.init_slstm_state(cfg, batch, dev)})
    return out


def init(cfg, seed: int = 0, device: DeviceLike = None, max_seq: int = 0) -> LM:
    """The model with random weights drawn on ``device`` from ``seed``;
    ``max_seq`` rows of learned positions (``pos_kind="learned"``)."""
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LM(cfg, Init(gen, getattr(torch, cfg.param_dtype), dev), max_seq).eval()


def from_state_dict(cfg, state: dict, device: DeviceLike = None) -> LM:
    """The model with the weights of ``state`` (cast to ``param_dtype``);
    the learned position table as long as ``state["pos"]``."""
    dev = resolve(device)
    max_seq = state["pos"].shape[0] if "pos" in state else 0
    model = LM(cfg, Init(None, getattr(torch, cfg.param_dtype), dev), max_seq)
    model.load_state_dict(state)
    return model.eval()
