"""Analytic (napkin-math) FLOP model — independent cross-check of the
dry-run cost probe, and the source of corrections the probe cannot see
(the sLSTM per-timestep scan, whose while body XLA cost analysis counts
once).

Counting convention: 1 MAC = 2 FLOPs; matmul terms only (norms/gates/
rope are O(BSD) noise at these widths).  Forward counts; the caller
applies the train multiplier (3x for fwd+bwd, 4x for the scanned part
under full remat).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import padded_vocab


def _attn_layer_flops(cfg, B, S, Sk_eff, enc_S=0) -> float:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    f = 2 * B * S * D * hd * (H + 2 * KV)  # qkv
    f += 4 * B * H * S * Sk_eff * hd  # scores + pv
    f += 2 * B * S * D * H * hd  # out proj
    if enc_S:  # cross attention (whisper decoder)
        f += 2 * B * S * D * hd * H + 2 * B * enc_S * D * hd * 2 * KV
        f += 4 * B * H * S * enc_S * hd
        f += 2 * B * S * D * H * hd
    return f


def _ffn_flops(cfg, B, S) -> float:
    D, F = cfg.d_model, cfg.d_ff
    if F == 0:
        return 0.0
    if cfg.is_moe:
        slots = B * S * cfg.top_k * cfg.capacity_factor
        return 2 * B * S * D * cfg.n_experts + 3 * 2 * slots * D * F
    n_mat = 3 if cfg.mlp_kind == "swiglu" else 2
    return n_mat * 2 * B * S * D * F


def _rec_layer_flops(cfg, B, S) -> float:
    D, W, H = cfg.d_model, cfg.resolved_rnn_width, cfg.n_heads
    f = 4 * B * S * D * W  # w_x + w_gate
    f += 2 * cfg.conv_width * B * S * W
    f += 2 * 2 * B * S * W * (W // H)  # block-diag gates
    f += 10 * B * S * W  # scan elementwise
    f += 2 * B * S * W * D  # out
    return f


def _mlstm_layer_flops(cfg, B, S) -> float:
    D = cfg.d_model
    F = 2 * D
    H = cfg.n_heads
    L = min(cfg.mlstm_chunk, S)
    f = 2 * B * S * D * 2 * F  # up
    f += 6 * B * S * F * F  # q,k,v projections (F -> F)
    f += 6 * B * S * L * F  # intra-chunk qk/pv/n
    f += 6 * B * S * F * F / H  # inter + state outer products
    f += 2 * B * S * F * D  # down
    return f


def _slstm_layer_flops(cfg, B, S) -> float:
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    Fs = ((4 * D // 3) + 127) // 128 * 128
    f = 2 * B * S * D * 4 * D  # input projections
    f += 2 * B * S * 4 * D * dh  # recurrent block-diag (the scan part)
    f += 6 * B * S * D * Fs  # gated FFN
    return f


def slstm_scan_correction(cfg, B, S) -> float:
    """The part of the sLSTM that lives inside the per-timestep while body
    (invisible to the cost probe): recurrent matmul + cell update."""
    if "slstm" not in cfg.resolved_pattern:
        return 0.0
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    n_slstm = sum(
        1
        for i in range(cfg.n_layers)
        if cfg.resolved_pattern[i % cfg.unit_len] == "slstm"
    )
    per_layer = 2 * B * S * 4 * D * dh + 30 * B * S * D
    return n_slstm * per_layer


def forward_flops(cfg: ModelConfig, B: int, S: int, Sk_eff: int = 0,
                  decode_cache: int = 0) -> Dict[str, float]:
    """Returns {'stem': ..., 'layers': ...} forward FLOPs.

    decode_cache > 0 => single-token decode against a cache of that size
    (S should be 1)."""
    Vp = padded_vocab(cfg.vocab_size)
    D = cfg.d_model
    Sk = decode_cache if decode_cache else (Sk_eff or S)
    if cfg.attn_kind in ("swa", "local") and cfg.window:
        Sk = min(Sk, cfg.window if decode_cache else S)
    stem = 2 * B * S * D * Vp  # logits
    layers = 0.0
    pattern = cfg.resolved_pattern
    for i in range(cfg.n_layers):
        kind = pattern[i % cfg.unit_len]
        if kind == "attn":
            layers += _attn_layer_flops(cfg, B, S, Sk, cfg.enc_seq if cfg.is_encdec else 0)
            layers += _ffn_flops(cfg, B, S)
        elif kind == "rec":
            layers += _rec_layer_flops(cfg, B, S)
            layers += _ffn_flops(cfg, B, S)
        elif kind == "mlstm":
            layers += _mlstm_layer_flops(cfg, B, S)
        elif kind == "slstm":
            layers += _slstm_layer_flops(cfg, B, S)
    if cfg.is_encdec:
        enc_cfg = cfg
        for _ in range(cfg.n_enc_layers):
            layers += _attn_layer_flops(enc_cfg, B, cfg.enc_seq, cfg.enc_seq)
            layers += _ffn_flops(enc_cfg, B, cfg.enc_seq)
    return {"stem": stem, "layers": layers}


def param_counts(cfg: ModelConfig) -> Dict[str, float]:
    """Analytic parameter counts: {'stem': embed(+head), 'layers': rest}."""
    Vp = padded_vocab(cfg.vocab_size)
    D, H, KV, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)
    stem = Vp * D * (1 if cfg.tie_embeddings else 2)
    if cfg.pos_kind == "learned":
        stem += 0  # shape-dependent; negligible vs embed

    def ffn_p():
        if F == 0:
            return 0
        if cfg.is_moe:
            return cfg.n_experts * 3 * D * F + D * cfg.n_experts
        return (3 if cfg.mlp_kind == "swiglu" else 2) * D * F

    W = cfg.resolved_rnn_width
    Fm = 2 * D
    dh = D // H
    Fs = ((4 * D // 3) + 127) // 128 * 128
    per = {
        "attn": D * hd * (H + 2 * KV) + H * hd * D + ffn_p(),
        "rec": 2 * D * W + cfg.conv_width * W + 2 * (W // H) * W + W * D
        + (0 if F == 0 else (3 if cfg.mlp_kind == "swiglu" else 2) * D * F),
        "mlstm": D * 2 * Fm + cfg.conv_width * Fm + 3 * Fm * Fm + 2 * Fm * H + Fm * D,
        "slstm": 4 * D * D + 4 * H * dh * dh + 3 * D * Fs,
    }
    layers = sum(per[cfg.resolved_pattern[i % cfg.unit_len]] for i in range(cfg.n_layers))
    if cfg.is_encdec:
        layers += cfg.n_enc_layers * (D * hd * (H + 2 * KV) + H * hd * D
                                      + (3 if cfg.mlp_kind == "swiglu" else 2) * D * F)
        layers += cfg.n_layers * (D * hd * (H + 2 * KV) + H * hd * D)  # cross attn
    return {"stem": stem, "layers": layers}


def step_bytes(cfg: ModelConfig, kind: str, B: int, S: int,
               dp: int = 16, tp: int = 16, chips: int = 256,
               fsdp: bool = True) -> Dict[str, float]:
    """Modeled per-device HBM traffic (bytes/step).

    Assumptions (documented in EXPERIMENTS.md §Roofline): TPU fusion keeps
    intra-layer temporaries in VMEM except the itemized majors; FSDP
    all-gathers materialize full bf16 weights per device per pass (3
    passes under full remat: fwd, remat-fwd, bwd); optimizer state is f32
    and fully sharded; the layer-scan carry is saved per unit.
    """
    P = param_counts(cfg)
    D = cfg.d_model
    Vp = padded_vocab(cfg.vocab_size)
    dp_total = max(chips // tp, 1)  # data-parallel degree incl. pod axis
    B_loc = max(B // dp_total, 1)
    D_loc = max(D // tp, 1)
    H_hd = cfg.n_heads * cfg.resolved_head_dim
    items: Dict[str, float] = {}
    if kind == "train":
        passes = 3 if cfg.remat == "full" else 2
        w_bf16 = 2 * (P["layers"] + P["stem"] / tp)
        items["weights"] = 2 * passes * w_bf16 if fsdp else 2 * passes * w_bf16 / dp
        # read p,m,v,g (4x4B) + write p,m,v (3x4B) + grad reduce-scatter r/w (~8B)
        items["optimizer"] = 36.0 * (P["layers"] + P["stem"]) / chips
        items["carry"] = 3 * 2 * B_loc * S * D_loc * 2  # save + bwd read + remat read
        per_layer_act = (4 * B_loc * S * H_hd / tp + 3 * B_loc * S * max(cfg.d_ff, 2 * D) / tp
                         + 2 * B_loc * S * D_loc) * 2
        items["layer_acts"] = passes * per_layer_act * cfg.n_layers
        items["logits"] = 4 * B_loc * S * (Vp / tp) * 4
    elif kind == "prefill":
        w_bf16 = 2 * (P["layers"] + P["stem"] / tp)
        items["weights"] = 2 * w_bf16 if fsdp else 2 * w_bf16 / dp
        per_layer_act = (4 * B_loc * S * H_hd / tp + 3 * B_loc * S * max(cfg.d_ff, 2 * D) / tp
                         + 2 * B_loc * S * D_loc) * 2
        items["layer_acts"] = per_layer_act * cfg.n_layers
        items["cache_write"] = 0.0  # counted in layer_acts kv terms
        items["logits"] = B_loc * 1 * (Vp / tp) * 4
    else:  # decode
        w_bf16 = 2 * (P["layers"] + P["stem"] / tp)
        items["weights"] = 2 * w_bf16 if fsdp else 2 * w_bf16 / dp
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if cfg.resolved_pattern[i % cfg.unit_len] == "attn")
        sc = min(cfg.window, S) if (cfg.attn_kind in ("swa", "local") and cfg.window) else S
        from repro_torch.models.sharding import n_kv_virtual

        kvv = n_kv_virtual(cfg.n_heads, cfg.n_kv_heads, tp)
        cache_dev = 2 * B * sc * max(kvv // tp, 1) * cfg.resolved_head_dim * 2 * n_attn / dp
        items["cache_read"] = cache_dev
        items["logits"] = B_loc * (Vp / tp) * 4
    items["total"] = sum(items.values())
    return items


def step_flops(cfg: ModelConfig, kind: str, B: int, S: int) -> float:
    """Total per-step FLOPs for a cell (train includes bwd + remat)."""
    if kind == "train":
        f = forward_flops(cfg, B, S)
        layer_mult = 4.0 if cfg.remat == "full" else 3.0
        return 3.0 * f["stem"] + layer_mult * f["layers"]
    if kind == "prefill":
        f = forward_flops(cfg, B, S)
        return f["stem"] + f["layers"]
    # decode
    f = forward_flops(cfg, B, 1, decode_cache=S)
    return f["stem"] + f["layers"]
