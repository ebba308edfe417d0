"""Operations and bytes the model's work needs, from its shapes.

The arithmetic of the program's ``roofline/analytic.py``, with four
corrections: a bfloat16 weight is 2 bytes a pass; an embedding is a
lookup, never a product, and a tied table would be counted once; only
the key positions a causal query sees count as attention work; an expert
layer does top-k experts' work a token, not its capacity's.

One multiply-add is 2 operations.  ``m`` is a configuration file's
``model``.  Attention takes 4 * head_dim operations per head and visible
(query, key) pair forward (scores and values) and 10 * head_dim backward.

These are the counts of the default reference, ``reference.lm``, which
re-exports ``window_flops``, ``window_decode_bytes``,
``attn_fwd_least_seconds`` and ``attn_bwd_least_seconds`` for the metric
readers (``harness.spec``).  A configuration whose layers differ (a
sliding window, a shared expert) names a reference of its own that counts
them.
"""
from __future__ import annotations


def padded_vocab(m: dict) -> int:
    k = m["vocab_multiple"]
    return (m["vocab_size"] + k - 1) // k * k


def attn_weights(m: dict) -> int:
    """Weights of one attention sub-layer's projections."""
    D, H, KV, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    return D * hd * (H + 2 * KV) + H * hd * D


def ffn_weights_active(m: dict) -> int:
    """Weights one token multiplies in one FFN: the router and top-k
    experts, or the dense SwiGLU."""
    D, F = m["d_model"], m["d_ff"]
    if m.get("n_experts"):
        return D * m["n_experts"] + m["top_k"] * 3 * D * F
    return 3 * D * F


def ffn_weights(m: dict) -> int:
    D, F = m["d_model"], m["d_ff"]
    if m.get("n_experts"):
        return D * m["n_experts"] + m["n_experts"] * 3 * D * F
    return 3 * D * F


def layer_matmul_weights(m: dict) -> int:
    """Weights one token multiplies in one layer."""
    return attn_weights(m) + ffn_weights_active(m)


def head_weights(m: dict) -> int:
    return m["d_model"] * padded_vocab(m)


def causal_pairs(start: int, n: int) -> int:
    """Visible (query, key) pairs of ``n`` queries at positions start ..
    start + n - 1 over a causal cache holding every earlier position."""
    return n * start + n * (n + 1) // 2


def attn_flops(m: dict, pairs: int, backward: bool = False) -> float:
    """All heads of one layer over ``pairs`` visible pairs."""
    return (10 if backward else 4) * m["head_dim"] * m["n_heads"] * pairs


def prefill_flops(m: dict, B: int, S: int) -> float:
    """A prefill of B prompts of S tokens, the output head at the last
    position only (the program's prefill returns that one)."""
    L = m["n_layers"]
    return (2.0 * B * S * L * layer_matmul_weights(m) + 2.0 * B * head_weights(m)
            + L * B * attn_flops(m, causal_pairs(0, S)))


def decode_step_flops(m: dict, B: int, pos: int) -> float:
    """One token for each of B sequences at position ``pos``."""
    L = m["n_layers"]
    return (2.0 * B * (L * layer_matmul_weights(m) + head_weights(m))
            + L * B * attn_flops(m, pos + 1))


def train_step_flops(m: dict, B: int, S: int) -> float:
    """Forward and backward of B sequences of S tokens: the products
    three times over (the forward and two in the backward), attention's
    4 * hd forward and 10 * hd backward per pair.  Recomputation under
    remat is not model work and is not counted."""
    L = m["n_layers"]
    pairs = causal_pairs(0, S)
    return (3 * 2.0 * B * S * (L * layer_matmul_weights(m) + head_weights(m))
            + L * B * (attn_flops(m, pairs) + attn_flops(m, pairs, backward=True)))


def decode_step_bytes(m: dict, B: int, pos: int, wbytes: int = 2, cbytes: int = 2) -> float:
    """The least a decode step moves: every weight once (the experts that
    B tokens can reach, all of a dense FFN), B embedding rows, the cache of
    every earlier position read once and the new keys and values written."""
    L, D, KV, hd = m["n_layers"], m["d_model"], m["n_kv_heads"], m["head_dim"]
    if m.get("n_experts"):
        E = m["n_experts"]
        ffn = D * E + min(E, B * m["top_k"]) * 3 * D * m["d_ff"]
    else:
        ffn = ffn_weights(m)
    weights = L * (attn_weights(m) + ffn) + head_weights(m) + B * D
    cache = L * B * KV * hd * 2 * (pos * cbytes + cbytes)
    return wbytes * weights + cache


def attn_fwd_bytes(m: dict, B: int, S: int, abytes: int = 2) -> float:
    """q, k, v read and o written once (k and v at their KV heads)."""
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    return abytes * B * S * hd * (2 * H + 2 * KV)


def attn_bwd_bytes(m: dict, B: int, S: int, abytes: int = 2) -> float:
    """q, k, v, o, dO and each row's log-sum-exp (float32) read, dq, dk, dv
    written once."""
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    reads = abytes * B * S * hd * (3 * H + 2 * KV) + 4 * B * H * S
    writes = abytes * B * S * hd * (H + 2 * KV)
    return reads + writes


def least_seconds(flops: float, nbytes: float, peak: dict) -> float:
    """The larger of the operations at the peak rate and the bytes at the
    peak bandwidth."""
    return max(flops / peak["bf16_flops"], nbytes / peak["hbm_bytes_per_s"])


def window_flops(m: dict, traffic: dict, done: int) -> float:
    """Model operations of ``done`` requests (serving) or steps (training)
    of a traffic mix."""
    mode = traffic["mode"]
    if mode == "train":
        return done * train_step_flops(m, traffic["batch"], traffic["seq_len"])
    B, S, G = traffic["batch"], traffic["prompt_len"], traffic["gen_tokens"]
    per = prefill_flops(m, B, S) + sum(decode_step_flops(m, B, S + i) for i in range(G - 1))
    return done * per


def window_decode_bytes(m: dict, traffic: dict, done: int) -> float:
    """The least bytes the decode steps of ``done`` requests move."""
    B, S, G = traffic["batch"], traffic["prompt_len"], traffic["gen_tokens"]
    return done * sum(decode_step_bytes(m, B, S + i) for i in range(G - 1))


def attn_fwd_least_seconds(m: dict, traffic: dict, calls: int, peak: dict) -> float:
    """The least time of ``calls`` attention forward calls of a prefill mix,
    each over the batch's whole causal prompts at every head
    (``least_seconds`` of their operations and ``attn_fwd_bytes``)."""
    B, S = traffic["batch"], traffic["prompt_len"]
    return least_seconds(calls * B * attn_flops(m, causal_pairs(0, S)),
                         calls * attn_fwd_bytes(m, B, S), peak)


def attn_bwd_least_seconds(m: dict, traffic: dict, calls: int, peak: dict) -> float:
    """The least time of ``calls`` attention backward calls of a training
    mix, each over the batch's whole causal sequences at every head
    (``least_seconds`` of their operations and ``attn_bwd_bytes``)."""
    B, S = traffic["batch"], traffic["seq_len"]
    return least_seconds(calls * B * attn_flops(m, causal_pairs(0, S), backward=True),
                         calls * attn_bwd_bytes(m, B, S), peak)
