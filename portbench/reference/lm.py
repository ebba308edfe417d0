"""Plain PyTorch reference of the benchmark's decoders, in float32.

A straightforward implementation of the models the configuration files
describe (``cfg["model"]``), written from their equations and nothing of
the program: token embedding, pre-norm blocks (RMSNorm or LayerNorm),
rotary positions (split-half), grouped-query causal attention with
optional biases, a SwiGLU FFN or a top-k mixture of SwiGLU experts with
per-expert capacity in routing groups, the final norm and the output
head.  Training adds the loss (softmax cross-entropy, z-loss, the
experts' load-balancing loss) and AdamW (``reference.adamw``).

Every product runs in float32 with TF32 off (``exact``).  ``quant``
rounds both inputs of every product, the attention's included, to a
lower precision first, and in training the operands of the backward's
products too: ``"bf16"``, or ``"fp8"`` (e4m3 with one scale a tensor).
That is the control: the reference put in the program's place at the
precision below the one the configuration states.

A forward pass may follow given expert choices (``Routing``): the check
gives it the program's, so that a choice that rounding tips one way in
the program and the other way here does not read as an error in every
later product; the route gap then says how far each choice taken lies
below the reference's own cutoff.

Layers are taken one at a time from ``get_block(i)`` (name -> tensor),
so a forward over a served model holds one layer's weights at a time;
attention runs over blocks of queries.

This is the default reference of a configuration file (``harness.spec``):
with the weights of ``reference.weights`` and the counts of
``harness.flops`` it is the whole interface, and ``unsupported`` says
which of the program's configurations it cannot compute.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from harness.flops import (  # noqa: F401 (interface)
    attn_bwd_least_seconds,
    attn_fwd_least_seconds,
    window_decode_bytes,
    window_flops,
)
from reference import weights as W
from reference.weights import draw_block, layer_block, leaves, n_blocks  # noqa: F401 (interface)

NEG = -1e30
Q_BLOCK = 512  # queries a block in the attention


def exact() -> None:
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def unsupported(cfg) -> Optional[str]:
    """None where this reference computes the program's ``ModelConfig``
    ``cfg``; else what it does compute, the port check's refusal."""
    if cfg.tie_embeddings or cfg.attn_kind != "full" or cfg.pos_kind != "rope" or cfg.qk_norm:
        return "untied full attention with rope, no q/k norm"
    return None


def _round(x: torch.Tensor, quant: str) -> torch.Tensor:
    """x rounded to ``quant`` and back to float32, without a gradient."""
    x = x.detach()
    if quant == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if quant == "fp8":
        s = x.abs().amax().clamp_min(1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    raise ValueError(f"quant {quant!r}")


def rounded(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """x (float32) rounded to ``quant`` and back; unchanged for None.  The
    gradient passes the rounding unchanged (a cast's own backward would
    round the gradients to the narrow type unscaled, to zero); the
    backward's operands are rounded by ``grad_rounded`` instead."""
    if quant is None:
        return x
    r = _round(x, quant)
    return x + (r - x.detach()) if x.requires_grad else r


class _RoundGrad(torch.autograd.Function):
    """Identity; its backward rounds the incoming gradient (one scale a
    tensor, as ``rounded``)."""

    @staticmethod
    def forward(ctx, x, quant):
        ctx.quant = quant
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.quant), None


def grad_rounded(y: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """y unchanged; in the backward, the gradient of y, the operand that
    the backward's products take from the output side, is rounded to
    ``quant``.  With ``rounded`` on a product's inputs, every operand of
    its forward and backward products is rounded."""
    if quant is None or not (y.requires_grad and torch.is_grad_enabled()):
        return y
    return _RoundGrad.apply(y, quant)


def mm(a, b, quant=None):
    return grad_rounded(rounded(a, quant) @ rounded(b, quant), quant)


def norm(x, w: Dict[str, torch.Tensor], prefix: str, m: dict):
    eps = m["norm_eps"]
    if m["norm"] == "rmsnorm":
        inv = torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
        return x * inv * (1.0 + w[f"{prefix}.scale"])
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w[f"{prefix}.scale"] + w[f"{prefix}.bias"]


def rope(x, positions, theta: float):
    """x (B, S, heads, hd), positions (S,): rotary positions, split-half."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, device=x.device, dtype=torch.float32) / half)
    ang = positions.to(torch.float32)[:, None] * inv[None, :]
    s, c = torch.sin(ang)[None, :, None, :], torch.cos(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attend_block(qb, k, v, i0: int, quant):
    """Causal attention of the queries at positions i0 .. i0 + n - 1 over
    the keys at 0 .. i0 + n - 1.  qb (B, n, KV, rep, hd); k, v (B, Sk, KV, hd)."""
    n, hd = qb.shape[1], qb.shape[-1]
    kb, vb = k[:, :i0 + n], v[:, :i0 + n]
    s = torch.einsum("bqgrd,bkgd->bgrqk", rounded(qb, quant), rounded(kb, quant))
    s = grad_rounded(s, quant) / math.sqrt(hd)
    qpos = torch.arange(i0, i0 + n, device=qb.device)
    kpos = torch.arange(i0 + n, device=qb.device)
    s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", rounded(p, quant), rounded(vb, quant))
    return grad_rounded(o, quant)


def attention(x, w, i: int, m: dict, quant=None, remat: bool = False):
    """The attention sub-layer of layer ``i`` over a whole causal
    sequence: x (B, S, D) normed -> (B, S, D)."""
    B, S, D = x.shape
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    p = f"layers.{i}.attn"
    q = mm(x, w[f"{p}.wq"].reshape(D, H * hd), quant).view(B, S, H, hd)
    k = mm(x, w[f"{p}.wk"].reshape(D, KV * hd), quant).view(B, S, KV, hd)
    v = mm(x, w[f"{p}.wv"].reshape(D, KV * hd), quant).view(B, S, KV, hd)
    if m["qkv_bias"]:
        q, k, v = q + w[f"{p}.bq"], k + w[f"{p}.bk"], v + w[f"{p}.bv"]
    pos = torch.arange(S, device=x.device)
    q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
    q = q.view(B, S, KV, H // KV, hd)  # head h reads KV head h // (H / KV)
    outs = []
    for i0 in range(0, S, Q_BLOCK):
        qb = q[:, i0:i0 + Q_BLOCK]
        if remat:
            outs.append(checkpoint(_attend_block, qb, k, v, i0, quant, use_reentrant=False))
        else:
            outs.append(_attend_block(qb, k, v, i0, quant))
    o = torch.cat(outs, dim=1).reshape(B, S, H * hd)
    y = mm(o, w[f"{p}.wo"].reshape(H * hd, D), quant)
    if m["qkv_bias"]:
        y = y + w[f"{p}.bo"]
    return y


def swiglu(x, wg, wu, wd, quant=None):
    return mm(F.silu(mm(x, wg, quant)) * mm(x, wu, quant), wd, quant)


def capacity(m: dict, group: int) -> int:
    c = int(group * m["top_k"] * m["capacity_factor"] / m["n_experts"])
    return max(8, (c + 7) // 8 * 8)


def kept_choices(top_i, m: dict):
    """top_i (T, k) expert ids -> (T, k) bool: the choices that find a
    free slot.  Tokens route in groups of ``route_group`` consecutive
    tokens; in a group each expert takes its first ``capacity`` choices in
    token-major order (a token's first choice before its second)."""
    T, k = top_i.shape
    g = min(m["route_group"], T)
    if T % g:
        raise ValueError(f"{T} tokens in routing groups of {g}")
    choice = top_i.reshape(T // g, g * k)
    C = capacity(m, g)
    keep = torch.zeros_like(choice, dtype=torch.bool)
    for e in range(m["n_experts"]):
        hit = choice == e
        keep |= hit & (hit.cumsum(dim=1) <= C)
    return keep.reshape(T, k)


@dataclasses.dataclass
class Routing:
    """The expert choices of a forward pass, layer by layer.  With
    ``follow`` (one (T, k) tensor of expert ids a layer, in the order the
    choices fill the experts), each expert layer takes those choices in
    place of its own top k, its gates still its own softmax over its
    router logits at them, and ``gaps`` gets the widest route gap of the
    layer: over the tokens, the reference's k-th largest router logit less
    the least of its logits at the choices taken, over the standard
    deviation of its router logits there (0 where the choices are its
    own top k).  ``chosen`` gets the choices each layer took."""

    follow: Optional[List[torch.Tensor]] = None
    chosen: List[torch.Tensor] = dataclasses.field(default_factory=list)
    gaps: List[float] = dataclasses.field(default_factory=list)


def moe(x, w, i: int, m: dict, quant=None, routing: Optional[Routing] = None):
    """The expert layer of layer ``i``: x (B, S, D) normed -> (y, the
    load-balancing loss); ``routing`` as ``Routing`` says."""
    B, S, D = x.shape
    E, k = m["n_experts"], m["top_k"]
    p = f"layers.{i}.ffn"
    xt = x.reshape(B * S, D)
    logits = mm(xt, w[f"{p}.router"], quant)
    if routing is not None and routing.follow is not None:
        top_i = routing.follow[len(routing.chosen)].to(x.device).long()
        top_v = logits.gather(-1, top_i)
        with torch.no_grad():
            own = logits.detach()
            kth = own.topk(k, dim=-1).values[:, -1]
            gap = (kth - top_v.detach().amin(dim=-1)) / own.std(dim=-1)
            routing.gaps.append(float(gap.max()))
    else:
        top_v, top_i = logits.topk(k, dim=-1)
    if routing is not None:
        routing.chosen.append(top_i.detach())
    gates = torch.softmax(top_v, dim=-1)
    frac = F.one_hot(top_i, E).sum(dim=1).to(torch.float32).mean(dim=0) / k
    aux = E * (frac * torch.softmax(logits, dim=-1).mean(dim=0)).sum()
    keep = kept_choices(top_i, m)
    y = torch.zeros_like(xt)
    for e in range(E):
        tok, j = torch.nonzero((top_i == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        ye = swiglu(xt[tok], w[f"{p}.w_gate"][e], w[f"{p}.w_up"][e], w[f"{p}.w_down"][e], quant)
        y = y.index_add(0, tok, ye * gates[tok, j, None])
    return y.view(B, S, D), aux


def layer(x, w, i: int, m: dict, quant=None, remat: bool = False, routing=None):
    """Layer ``i``: (x, its load-balancing loss or 0)."""
    x = x + attention(norm(x, w, f"layers.{i}.norm1", m), w, i, m, quant, remat)
    h = norm(x, w, f"layers.{i}.norm2", m)
    if m.get("n_experts", 0):
        y, aux = moe(h, w, i, m, quant, routing)
        return x + y, aux
    p = f"layers.{i}.ffn"
    return x + swiglu(h, w[f"{p}.w_gate"], w[f"{p}.w_up"], w[f"{p}.w_down"], quant), x.new_zeros(())


def as_f32(block: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.to(torch.float32) for n, t in block.items()}


@torch.no_grad()
def logits_at(m: dict, get_block: Callable[[int], Dict[str, torch.Tensor]], tokens,
              at: Sequence[int], quant=None, routing: Optional[Routing] = None):
    """tokens (B, S) -> float32 logits (B, len(at), Vp) at positions
    ``at`` of a causal forward pass over the whole sequence.
    ``get_block(index)`` gives block ``index`` of ``weights.blocks(m)``;
    ``routing`` as ``moe``'s."""
    x = get_block(0)["embed"].to(torch.float32)[tokens.long()]
    for i in range(m["n_layers"]):
        w = as_f32(get_block(W.layer_block(i)))
        x = layer(x, w, i, m, quant, routing=routing)[0]
        del w
    head = as_f32(get_block(1))
    h = norm(x[:, list(at)], head, "final_norm", m)
    return mm(h, head["lm_head"], quant)


def loss(m: dict, params: Dict[str, torch.Tensor], tokens, labels, quant=None,
         z_loss: float = 1e-4, aux_coef: float = 0.01, remat: bool = True,
         routing: Optional[Routing] = None):
    """The training loss of a batch: (total, cross-entropy with z-loss,
    the load-balancing loss summed over the layers)."""
    x = params["embed"][tokens.long()]
    aux = x.new_zeros(())
    for i in range(m["n_layers"]):
        x, a = layer(x, params, i, m, quant, remat, routing)
        aux = aux + a
    logits = mm(norm(x, params, "final_norm", m), params["lm_head"], quant)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    ce = (lse - gold + z_loss * lse.square()).mean()
    return ce + aux_coef * aux, ce, aux
