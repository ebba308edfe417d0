"""The benchmark's weights, drawn from the seed.

Both sides get the same numbers: the harness copies them into the
program's parameters, and the reference draws them again, block by
block, when it needs them.  Each block (the embedding, the output head
with the final norm, each layer) is one ``torch.randn`` on the device
from a generator seeded with the run's seed and the block's index, in
the type the configuration serves or trains in; its leaves are views of
that draw, each scaled by its own rule (``SCALES``).

Leaf names and shapes are the program's parameter names, worked out here
from the configuration file alone (``leaves``); the harness checks that
the program's model has exactly these.  Norm scales follow the program's
conventions, which the reference computes with: an RMSNorm multiplies by
``1 + scale``, a LayerNorm by ``scale`` and adds ``bias``.  The rows of
the embedding and the columns of the head past the published vocabulary
(the program pads it to a multiple of 128) are zero, and so is the
output projection's bias of a model that has none.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str]  # (name, shape, scale rule)


def padded(vocab: int, multiple: int) -> int:
    return (vocab + multiple - 1) // multiple * multiple


def _norm(prefix: str, m: dict) -> List[Leaf]:
    D = m["d_model"]
    if m["norm"] == "rmsnorm":
        return [(f"{prefix}.scale", (D,), "rms")]
    return [(f"{prefix}.scale", (D,), "ln_scale"), (f"{prefix}.bias", (D,), "small")]


def layer_leaves(m: dict, i: int) -> List[Leaf]:
    D, H, KV, hd, F = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    p = f"layers.{i}"
    out = _norm(f"{p}.norm1", m) + [
        (f"{p}.attn.wq", (D, H, hd), f"fan:{D}"),
        (f"{p}.attn.wk", (D, KV, hd), f"fan:{D}"),
        (f"{p}.attn.wv", (D, KV, hd), f"fan:{D}"),
        (f"{p}.attn.wo", (H, hd, D), f"fan:{H * hd}"),
    ]
    if m["qkv_bias"]:
        out += [(f"{p}.attn.bq", (H, hd), "small"), (f"{p}.attn.bk", (KV, hd), "small"),
                (f"{p}.attn.bv", (KV, hd), "small"),
                (f"{p}.attn.bo", (D,), "small" if m["o_bias"] else "zero")]
    out += _norm(f"{p}.norm2", m)
    E = m.get("n_experts", 0)
    if E:
        out += [(f"{p}.ffn.router", (D, E), f"fan:{D}"),
                (f"{p}.ffn.w_gate", (E, D, F), f"fan:{D}"),
                (f"{p}.ffn.w_up", (E, D, F), f"fan:{D}"),
                (f"{p}.ffn.w_down", (E, F, D), f"fan:{F}")]
    else:
        out += [(f"{p}.ffn.w_gate", (D, F), f"fan:{D}"), (f"{p}.ffn.w_up", (D, F), f"fan:{D}"),
                (f"{p}.ffn.w_down", (F, D), f"fan:{F}")]
    return out


def blocks(m: dict) -> List[Tuple[str, List[Leaf]]]:
    """Every block of the model in draw order: (block name, its leaves)."""
    D, Vp = m["d_model"], padded(m["vocab_size"], m["vocab_multiple"])
    out = [("embed", [("embed", (Vp, D), "embed")]),
           ("head", _norm("final_norm", m) + [("lm_head", (D, Vp), f"head:{D}")])]
    out += [(f"layer.{i}", layer_leaves(m, i)) for i in range(m["n_layers"])]
    return out


def leaves(m: dict) -> Dict[str, Tuple[int, ...]]:
    """name -> shape of every parameter."""
    return {n: s for _, ls in blocks(m) for n, s, _ in ls}


def _block_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + index * 7_919 + 1) % (2 ** 63)


def _scale_(t: torch.Tensor, rule: str, m: dict) -> None:
    """Scales one leaf's draw in place by its rule."""
    V = m["vocab_size"]
    if rule == "embed":
        t[V:] = 0
    elif rule.startswith("head:"):
        t.mul_(1.0 / math.sqrt(int(rule[5:])))
        t[:, V:] = 0
    elif rule.startswith("fan:"):
        t.mul_(1.0 / math.sqrt(int(rule[4:])))
    elif rule == "rms":
        t.mul_(0.1)
    elif rule == "ln_scale":
        t.mul_(0.1).add_(1.0)
    elif rule == "small":
        t.mul_(0.1)
    elif rule == "zero":
        t.zero_()
    else:
        raise ValueError(f"scale rule {rule!r}")


def draw_block(m: dict, seed: int, index: int, dtype: torch.dtype,
               device) -> Dict[str, torch.Tensor]:
    """Block ``index`` of ``blocks(m)``: name -> tensor, views of one draw."""
    return draw_leaves(blocks(m)[index][1], m, seed, index, dtype, device)


def draw_leaves(ls: List[Leaf], m: dict, seed: int, index: int, dtype: torch.dtype,
                device) -> Dict[str, torch.Tensor]:
    """The leaves ``ls`` of block ``index``: name -> tensor, views of one
    draw (for a reference whose blocks hold other leaves)."""
    n = sum(math.prod(s) for _, s, _ in ls)
    gen = torch.Generator(device=device).manual_seed(_block_seed(seed, index))
    flat = torch.randn(n, generator=gen, dtype=dtype, device=device)
    out, off = {}, 0
    for name, shape, rule in ls:
        k = math.prod(shape)
        t = flat[off:off + k].view(shape)
        _scale_(t, rule, m)
        out[name] = t
        off += k
    return out


def n_blocks(m: dict) -> int:
    return 2 + m["n_layers"]


def layer_block(i: int) -> int:
    """The block index of layer ``i``."""
    return 2 + i
