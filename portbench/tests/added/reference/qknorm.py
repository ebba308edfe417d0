"""A reference module that only a test's benchmark tree holds:
``reference.lm``'s decoder with q/k RMSNorm (qwen3's: each head's query
and key, after their projections, over head_dim to unit root mean
square, times 1 + a learnt scale of head_dim, before rope), for a
configuration that ``reference.lm`` refuses.  It takes ``lm``'s pieces
and adds the two leaves a layer, ``layers.<i>.attn.q_norm`` and
``layers.<i>.attn.k_norm``, at the end of the layer's draw.  Its counts
are ``harness.flops``'s: the norms are no product and add no operation
counted there."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from harness.flops import (  # noqa: F401 (interface)
    attn_bwd_least_seconds,
    attn_fwd_least_seconds,
    window_decode_bytes,
    window_flops,
)
from reference import lm
from reference import weights as W
from reference.lm import Routing, exact  # noqa: F401 (interface)
from reference.weights import layer_block, n_blocks  # noqa: F401 (interface)

PORT_FIELDS = {"qk_norm": "qk_norm"}


def unsupported(cfg) -> Optional[str]:
    if cfg.tie_embeddings or cfg.attn_kind != "full" or cfg.pos_kind != "rope":
        return "untied full attention with rope"
    return None


def blocks(m: dict):
    hd = m["head_dim"]
    out = W.blocks(m)
    return out[:2] + [(name, ls + [(f"layers.{i}.attn.q_norm", (hd,), "rms"),
                                   (f"layers.{i}.attn.k_norm", (hd,), "rms")])
                      for i, (name, ls) in enumerate(out[2:])]


def leaves(m: dict) -> Dict[str, tuple]:
    return {n: s for _, ls in blocks(m) for n, s, _ in ls}


def draw_block(m: dict, seed: int, index: int, dtype, device) -> Dict[str, torch.Tensor]:
    return W.draw_leaves(blocks(m)[index][1], m, seed, index, dtype, device)


def head_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def attention(x, w, i: int, m: dict, quant=None, remat: bool = False):
    B, S, D = x.shape
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    p = f"layers.{i}.attn"
    q = lm.mm(x, w[f"{p}.wq"].reshape(D, H * hd), quant).view(B, S, H, hd)
    k = lm.mm(x, w[f"{p}.wk"].reshape(D, KV * hd), quant).view(B, S, KV, hd)
    v = lm.mm(x, w[f"{p}.wv"].reshape(D, KV * hd), quant).view(B, S, KV, hd)
    q = head_norm(q, w[f"{p}.q_norm"], m["norm_eps"])
    k = head_norm(k, w[f"{p}.k_norm"], m["norm_eps"])
    pos = torch.arange(S, device=x.device)
    q, k = lm.rope(q, pos, m["rope_theta"]), lm.rope(k, pos, m["rope_theta"])
    q = q.view(B, S, KV, H // KV, hd)
    outs = []
    for i0 in range(0, S, lm.Q_BLOCK):
        qb = q[:, i0:i0 + lm.Q_BLOCK]
        if remat:
            outs.append(checkpoint(lm._attend_block, qb, k, v, i0, quant, use_reentrant=False))
        else:
            outs.append(lm._attend_block(qb, k, v, i0, quant))
    o = torch.cat(outs, dim=1).reshape(B, S, H * hd)
    return lm.mm(o, w[f"{p}.wo"].reshape(H * hd, D), quant)


def layer(x, w, i: int, m: dict, quant=None, remat: bool = False):
    x = x + attention(lm.norm(x, w, f"layers.{i}.norm1", m), w, i, m, quant, remat)
    h = lm.norm(x, w, f"layers.{i}.norm2", m)
    p = f"layers.{i}.ffn"
    return x + lm.swiglu(h, w[f"{p}.w_gate"], w[f"{p}.w_up"], w[f"{p}.w_down"], quant)


@torch.no_grad()
def logits_at(m: dict, get_block: Callable[[int], Dict[str, torch.Tensor]], tokens,
              at: Sequence[int], quant=None, routing=None):
    x = get_block(0)["embed"].to(torch.float32)[tokens.long()]
    for i in range(m["n_layers"]):
        x = layer(x, lm.as_f32(get_block(layer_block(i))), i, m, quant)
    head = lm.as_f32(get_block(1))
    return lm.mm(lm.norm(x[:, list(at)], head, "final_norm", m), head["lm_head"], quant)


def loss(m: dict, params: Dict[str, torch.Tensor], tokens, labels, quant=None,
         z_loss: float = 1e-4, remat: bool = True, routing=None):
    x = params["embed"][tokens.long()]
    for i in range(m["n_layers"]):
        x = layer(x, params, i, m, quant, remat)
    logits = lm.mm(lm.norm(x, params, "final_norm", m), params["lm_head"], quant)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    ce = (lse - gold + z_loss * lse.square()).mean()
    return ce, ce, x.new_zeros(())
