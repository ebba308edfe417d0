"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k routing
over ``n_experts`` SwiGLU experts, with capacity-based token dropping.

Tokens are routed in groups of ``GROUP`` tokens.  In a group every
expert has ``_capacity`` slots, and each (token, choice) takes the next
free slot of its expert in token-major order: a token's first choice
before its second, earlier tokens before later ones.  A (token, choice)
that finds its expert full is dropped.  A token count that is no whole
number of groups raises: the reference's reshape fails there, and
padding would give capacity to tokens that do not exist.

Two dispatch paths, as in the reference:

* ``einsum`` (the default; no config sets ``moe_dispatch``): GShard's
  one-hot dispatch and combine products.  The combine weights are
  rounded to the activation type before the last product.
* ``scatter``: tokens scattered into their experts' slots and gathered
  back, combined in float32 and rounded once.

Every group's work is batched over a group axis.  The reference has no
Pallas kernel here (its products are ``jnp.einsum``s), so the port
computes them with torch products (cuBLAS on the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch import obs
from repro_torch.models.common import Init
from repro_torch.models.sharding import NO_SHD, Sharder

GROUP = 1024  # tokens per routing group (keeps the dispatch tensors bounded)


class MoE(nn.Module):
    def __init__(self, ini: Init, cfg):
        super().__init__()
        D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = ini.fan_in((D, E), ("embed", "act_expert"))
        self.w_gate = ini.fan_in((E, D, Fd), ("expert", "embed", "mlp"), fan_axes=(1,))
        self.w_up = ini.fan_in((E, D, Fd), ("expert", "embed", "mlp"), fan_axes=(1,))
        self.w_down = ini.fan_in((E, Fd, D), ("expert", "mlp", "embed"), fan_axes=(1,))


def _route(p: MoE, x2d, cfg):
    """x2d: (T, D). Returns (weights (T, k) f32, expert ids (T, k), the
    Switch load-balancing loss).  The router logits are float32 products
    of the activations and the router rounded to their type, as the
    reference's ``preferred_element_type=float32``: bf16 logits would
    round onto ties and pick other experts."""
    E, k = cfg.n_experts, cfg.top_k
    logits = x2d.to(torch.float32) @ p.router.to(x2d.dtype).to(torch.float32)
    top_logits, top_idx = torch.topk(logits, k, dim=-1)
    weights = torch.softmax(top_logits, dim=-1)  # softmax over the top k
    me = torch.softmax(logits, dim=-1).mean(dim=0)  # (E,)
    fe = F.one_hot(top_idx, E).sum(dim=1).to(torch.float32).mean(dim=0) / k
    return weights, top_idx, E * (fe * me).sum()


def _capacity(cfg, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, (c + 7) // 8 * 8)


def _positions_in_expert(top_idx, E: int):
    """top_idx: (..., g, k) expert ids -> the slot (..., g, k) each (token,
    choice) takes in its expert's buffer: its 0-based rank among the
    group's choices of that expert, counted over the token-major
    flattening of (g, k)."""
    *lead, g, k = top_idx.shape
    flat = top_idx.reshape(*lead, g * k)
    rank = F.one_hot(flat, E).cumsum(dim=-2) - 1
    return rank.gather(-1, flat[..., None])[..., 0].reshape(*lead, g, k)


def _experts(xs, p: MoE, dt):
    """The SwiGLU experts on their slots. xs: (G, E*C, D) -> (G, E*C, D),
    each expert's slots of every group in one batched product."""
    G, EC, D = xs.shape
    E = p.w_gate.shape[0]
    with obs.span("moe.experts"):
        xe = xs.reshape(G, E, EC // E, D).transpose(0, 1).reshape(E, -1, D)
        h = F.silu(torch.bmm(xe, p.w_gate.to(dt))) * torch.bmm(xe, p.w_up.to(dt))
        ys = torch.bmm(h, p.w_down.to(dt))
        return ys.reshape(E, G, EC // E, D).transpose(0, 1).reshape(G, EC, D)


def _einsum_group(x_g, w_g, idx_g, pos_g, p: MoE, cfg, dt):
    """GShard one-hot dispatch and combine over (G, g) groups. x_g (G, g,
    D); w_g, idx_g, pos_g (G, g, k).  Returns (G, g, D) in ``dt``."""
    E = cfg.n_experts
    G, g, D = x_g.shape
    C = _capacity(cfg, g)
    keep = (pos_g < C).to(torch.float32)
    oh_e = F.one_hot(idx_g, E).to(torch.float32)  # (G, g, k, E)
    oh_c = F.one_hot(pos_g.clamp(max=C - 1), C).to(torch.float32)  # (G, g, k, C)
    disp = torch.einsum("Ggke,Ggkc->Ggec", oh_e * keep[..., None], oh_c)
    # a token's k choices are k distinct experts, so each (e, c) sums one term
    comb = disp * torch.einsum("Ggke,Ggkc->Ggec", oh_e * w_g[..., None].to(torch.float32),
                               oh_c)
    xs = torch.bmm(disp.to(dt).reshape(G, g, E * C).transpose(1, 2), x_g.to(dt))
    ys = _experts(xs, p, dt)
    return torch.bmm(comb.to(dt).reshape(G, g, E * C), ys)


def _scatter_group(x_g, w_g, idx_g, pos_g, p: MoE, cfg, dt):
    """Scatter dispatch and gather combine over (G, g) groups: tokens are
    written to slot ``expert * C + position`` (a dropped one to a spare
    row past the last), the experts run, and each token sums its kept
    choices' outputs by weight in float32, rounded once to ``dt``."""
    E, k = cfg.n_experts, cfg.top_k
    G, g, D = x_g.shape
    C = _capacity(cfg, g)
    keep = pos_g < C
    slot = torch.where(keep, idx_g * C + pos_g, E * C)  # (G, g, k)
    x_g = x_g.to(dt)
    buf = x_g.new_zeros((G, E * C + 1, D))
    for j in range(k):  # no two kept choices share a slot
        buf = buf.scatter(1, slot[:, :, j, None].expand(G, g, D), x_g)
    ys = _experts(buf[:, :E * C], p, dt)
    out = torch.zeros((G, g, D), dtype=torch.float32, device=x_g.device)
    for j in range(k):
        rows = slot[:, :, j].clamp(max=E * C - 1)[..., None].expand(G, g, D)
        y_j = torch.where(keep[:, :, j, None], torch.gather(ys, 1, rows), 0.0)
        out = out + w_g[:, :, j, None].to(torch.float32) * y_j.to(torch.float32)
    return out.to(dt)


_DISPATCH = {"einsum": _einsum_group, "scatter": _scatter_group}


def _count_routing(idx, pos, cfg, g: int) -> None:
    """The routing counters (``repro_torch.obs``) of one call: the (token,
    choice) pairs routed, the slots computed, and per expert the pairs
    dropped at capacity, summed on the device.  idx, pos: (G, g, k)."""
    G, _, k = idx.shape
    E, C = cfg.n_experts, _capacity(cfg, g)
    obs.count("moe.routed", G * g * k)
    obs.count("moe.slots", G * E * C)
    dropped = torch.zeros(E, dtype=torch.int64, device=idx.device)
    obs.count("moe.dropped", dropped.scatter_add_(0, idx.reshape(-1),
                                                  (pos >= C).reshape(-1).long()))


def routed_tokens(x, shd: Sharder = NO_SHD):
    """x: (B, S, D) -> the tokens (B * S, D), placed by batch.  The second
    constraint is a no-op forward; backward, it brings the tokens'
    gradient to these placements before the reshape's backward: the
    router's and the dispatch's gradients otherwise meet sharded over
    every mesh axis, where DTensor's reshape back to (B, S, D) takes a
    wrong local shape (``tests/test_torch_mesh_repairs.py``)."""
    B, S, D = x.shape
    x2d = shd.act(x, "batch", None, None).reshape(B * S, D)
    return shd.act(x2d, "batch", None)


def moe_forward(p: MoE, x, cfg, impl: str = None, shd: Sharder = NO_SHD):
    """x: (B, S, D) -> ((B, S, D), the load-balancing loss, a float32
    scalar).  ``impl``: "einsum" (default) or "scatter".  On a mesh the
    sequence is gathered before (B, S) merge, as the reference's: a
    reshape across two differently sharded dims would replicate all."""
    impl = impl or getattr(cfg, "moe_dispatch", "einsum")
    if impl not in _DISPATCH:
        raise ValueError(f"MoE dispatch {impl!r}: the port has {sorted(_DISPATCH)}")
    dt = getattr(torch, cfg.dtype)
    x = shd.act(x, "ffn_batch", None, "ffn_embed")  # a no-op under the default rules
    B, S, D = x.shape
    T = B * S
    g = min(GROUP, T)
    if T % g:
        raise ValueError(f"MoE routes {T} tokens in groups of {g}: {T} is no multiple "
                         f"of {g} (the reference's reshape fails there too)")
    x2d = routed_tokens(x, shd)
    weights, top_idx, aux = _route(p, x2d, cfg)
    G, k = T // g, cfg.top_k
    idx = top_idx.view(G, g, k)
    xg = shd.act(x2d.view(G, g, D), "batch", None, "act_embed")
    # each group's slots on the rank that holds the group whole (the
    # reference's vmap over groups): DTensor's cumsum over a sharded
    # dimension scans each rank's shard alone
    pos = shd.local(_positions_in_expert, (idx,), (0,), cfg.n_experts)
    if obs.recording() and not isinstance(pos, DTensor):
        _count_routing(idx, pos, cfg, g)
    with obs.span("moe.dispatch"):
        out = _DISPATCH[impl](xg, weights.view(G, g, k), idx, pos, p, cfg, dt)
    out = shd.act(out, "batch", None, "act_embed")
    return out.reshape(B, S, D), aux
