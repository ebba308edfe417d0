"""How far bf16 serving moves the last-token logits of the port's LM, and
how far faults of the decode handoff move them: the evidence behind
``chip_smoke.py``'s bounds on prefill + decode_step against a longer
prefill.

For each family the card checks, at its served depth but narrow widths
(random weights from a seed), on the CPU with the plain versions, one
JSON line per width:

- ``bf16_vs_f32``: relative L2 of the bf16 prefill against the same
  weights in f32;
- ``consistency``: relative L2 of bf16 prefill(P) + decode steps against
  bf16 prefill of the whole sequence;
- the same with a fault planted in the handoff.

Families and their handoffs (as ``chip_smoke.py`` runs them):

- ``recurrentgemma``: 38 layers, S = 96 > window 32, one decode step;
  faults: the ring roll dropped, the conv tail zeroed, the sliding window
  ignored;
- ``moe``: ``phi3.5-moe`` at 24 layers, 16 experts top 2, one routing
  group (prefill(1023) + one step against prefill(1024)) with
  capacity_factor = n_experts / top_k (no token dropped); also the
  layers whose experts for the last token differ between the two paths
  (``routing_flips``: bf16 rounding can reorder near-tied router
  logits); faults: the prompt's KV entries lost, the layers' caches
  handed to the wrong layers, the first KV entry lost, the decode
  position one off, the decode token's MoE FFN dropped;
- ``xlstm``: ``xlstm-350m`` at 24 layers, prefill(4096) + 256 steps,
  each step against the forward's logits at its position (the first
  step, the largest and the last); faults: the mLSTM stabilizer ``m``
  zeroed, the conv tail dropped, the sLSTM ``h`` reset;
- ``whisper``: ``whisper-small`` at 12 encoder + 12 decoder layers over
  1,500 seeded frames, prefill(223) + one step against prefill(224);
  faults: the learned position one off at decode, the cross-attention
  cache (``ck``/``cv``) zeroed, the cache's ``ck``/``cv`` taken from an
  encoder run without its sinusoidal table;
- ``vlm``: ``phi-3-vision-4.2b`` at 32 layers, 576 seeded image
  embeddings before 512 text tokens, prefill(511) + one step against
  prefill(512); faults: decode positions not offset by the image prefix,
  the image prefix's KV entries lost, the decode position one off;
- ``dense``: ``qwen3-1.7b``, ``qwen2-7b``, ``granite-3-8b`` and
  ``minitron-8b`` at their depths (28, 28, 40, 32) with their own query
  and KV head counts (16/8, 28/4, 32/8, 32/8: grouped heads), S = 1024,
  prefill(1023) + one step against prefill(1024); faults
  (``dense_decode_faults``, which ``chip_smoke.py`` plants too): the
  decode position one off, the newest KV entry dropped (the prompt's
  last token hidden from the decode), KV heads grouped ``h % KV`` at
  decode instead of ``h // (H / KV)``.

    PYTHONPATH=src python tools/lm_bf16_consistency.py [--family NAME] [--width W]
    # recurrentgemma ~1 min, moe ~3 min, xlstm ~4 min, whisper ~1 min, vlm ~2 min,
    # dense ~6 min
"""
from __future__ import annotations

import argparse
import contextlib
import json
from unittest import mock

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import attention, lm, moe, recurrent

S = 96


def _rel(got, want) -> float:
    return float((got - want).norm() / want.norm())


def handoff(model, tokens, prefill_len: int, pos_shift: int = 0, mutate=None, inputs=None,
            prefix_fault=None, decode=None) -> float:
    """bf16 prefill(prefill_len) + teacher-forced decode steps against
    prefill of all of ``tokens``: relative L2 of the last logits.
    ``inputs``: the image embeddings or frames both prefills take; decode
    positions start after the image prefix.  ``mutate`` plants a fault in
    the caches the decode starts from, ``prefix_fault`` (a context
    manager) one in the shorter prefill alone, ``decode`` (a faulty
    ``decode_step``) one in the decode."""
    decode = decode or model.decode_step
    n = tokens.shape[1]
    inputs = inputs or {}
    n_img = model.cfg.n_img_tokens
    cache_len = n_img + n + 8
    with torch.inference_mode():
        full, _ = model.prefill(tokens, cache_len=cache_len, **inputs)
        with prefix_fault or contextlib.nullcontext():
            _, caches = model.prefill(tokens[:, :prefill_len], cache_len=cache_len, **inputs)
        if mutate is not None:
            caches = mutate(caches)
        for t in range(prefill_len, n):
            pos = torch.tensor([n_img + t + pos_shift], dtype=torch.int32)
            step, caches = decode(caches, tokens[:, t:t + 1], pos)
    return _rel(step[0, -1], full[0, -1])


def consistency(model, tokens) -> float:
    """prefill(S-1) + one decode step against prefill(S)."""
    return handoff(model, tokens, tokens.shape[1] - 1)


_REC_PREFILL_CACHE = recurrent.rec_prefill_cache


def _conv_lost(p, x, conv_width, *a):
    cache = _REC_PREFILL_CACHE(p, x, conv_width, *a)
    cache["conv"] = torch.zeros_like(cache["conv"])
    return cache


def _models(cfg, max_seq: int = 0):
    """The bf16 model and the same weights in f32."""
    model = lm.init(cfg, seed=0, device="cpu", max_seq=max_seq)
    f32 = cfg.replace(dtype="float32", param_dtype="float32")
    ref = lm.from_state_dict(f32, {k: v.float() for k, v in model.state_dict().items()},
                             device="cpu")
    return model, ref


def _tokens(cfg, n):
    return torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(1, n)).astype(np.int32))


def _drift(model, ref, tokens, inputs=None) -> float:
    inputs = inputs or {}
    with torch.inference_mode():
        bf, _ = model.prefill(tokens, **inputs)
        fp, _ = ref.prefill(tokens, **inputs)
    return _rel(bf[0, -1], fp[0, -1])


def frontend_inputs(cfg, batch: int = 1, device="cpu", seed: int = 2) -> dict:
    """Seeded non-zero image embeddings or frames (N(0, 1), as the token
    embeddings are) for ``batch`` sequences on ``device``: what this
    tool's handoffs and ``chip_smoke.py``'s (batch 1) and its reduced
    card-vs-CPU check (batch 2) give the model."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    if cfg.n_img_tokens:
        out["img_embeds"] = torch.randn(batch, cfg.n_img_tokens, cfg.d_model, generator=g)
    if cfg.is_encdec:
        out["frames"] = torch.randn(batch, cfg.enc_seq, cfg.d_model, generator=g)
    return {k: v.to(device) for k, v in out.items()}


def _cross_cache_zeroed(caches):
    for c in caches:
        c["attn"]["ck"].zero_()
        c["attn"]["cv"].zero_()
    return caches


def _image_kv_lost(n_img):
    def mutate(caches):
        for c in caches:
            c["attn"]["k_pos"][:, :n_img] = -1
        return caches
    return mutate


def whisper_family(width, head_dim, prompt=224):
    cfg = get_config("whisper-small").reduced().replace(
        n_layers=12, n_enc_layers=12, enc_seq=1500, d_model=width, head_dim=head_dim,
        n_heads=width // head_dim, n_kv_heads=width // head_dim, d_ff=4 * width,
        dtype="bfloat16", param_dtype="bfloat16")
    model, ref = _models(cfg, max_seq=prompt + 24)
    tokens, inputs = _tokens(cfg, prompt), frontend_inputs(cfg)
    row = dict(family="whisper", width=width, layers=cfg.n_layers,
               enc_layers=cfg.n_enc_layers, enc_seq=cfg.enc_seq, S=prompt,
               bf16_vs_f32=_drift(model, ref, tokens, inputs),
               consistency=handoff(model, tokens, prompt - 1, inputs=inputs))
    row["learned_position_one_off"] = handoff(model, tokens, prompt - 1, pos_shift=1,
                                              inputs=inputs)
    row["cross_cache_zeroed"] = handoff(model, tokens, prompt - 1, inputs=inputs,
                                        mutate=_cross_cache_zeroed)
    no_table = mock.patch.object(lm, "sinusoidal_positions",
                                 lambda n, d: np.zeros((n, d), np.float32))
    row["cross_cache_without_sinusoidal_table"] = handoff(
        model, tokens, prompt - 1, inputs=inputs, prefix_fault=no_table)
    return row


def vlm_family(width, head_dim, text=512):
    cfg = get_config("phi-3-vision-4.2b").reduced().replace(
        n_layers=32, n_img_tokens=576, d_model=width, head_dim=head_dim,
        n_heads=width // head_dim, n_kv_heads=width // head_dim, d_ff=2 * width,
        dtype="bfloat16", param_dtype="bfloat16")
    model, ref = _models(cfg)
    tokens, inputs = _tokens(cfg, text), frontend_inputs(cfg)
    row = dict(family="vlm", width=width, layers=cfg.n_layers, n_img=cfg.n_img_tokens,
               S=cfg.n_img_tokens + text, bf16_vs_f32=_drift(model, ref, tokens, inputs),
               consistency=handoff(model, tokens, text - 1, inputs=inputs))
    row["decode_positions_not_offset"] = handoff(model, tokens, text - 1, inputs=inputs,
                                                 pos_shift=-cfg.n_img_tokens)
    row["image_kv_lost"] = handoff(model, tokens, text - 1, inputs=inputs,
                                   mutate=_image_kv_lost(cfg.n_img_tokens))
    row["decode_position_one_off"] = handoff(model, tokens, text - 1, inputs=inputs,
                                             pos_shift=1)
    return row


def _grouped_mod_kv(k, v, q, *rest):
    """``attention._decode_mha`` with the groups wrong: query head h reads
    KV head h % KV instead of h // (H / KV).  q's heads go in the order
    the consecutive grouping reads them so, and the output comes back in
    theirs, so the fault holds on the card's kernel and its plain version
    alike."""
    kvh, H = k.shape[2], q.shape[2]
    if kvh in (1, H):
        return _DECODE_MHA(k, v, q, *rest)
    h = torch.arange(H, device=q.device)
    slot = (h % kvh) * (H // kvh) + h // kvh  # where head h sits for the grouping
    moved = torch.empty_like(q)
    moved[:, :, slot] = q
    return _DECODE_MHA(k, v, moved, *rest)[:, :, slot]


_DECODE_MHA = attention._decode_mha


def dense_decode_faults(model) -> dict:
    """Faults of the dense family's decode, each a ``decode_step`` with the
    model's signature: the decode position one off; the newest KV entry
    dropped (every self-attention cache's entry at position pos - 1, the
    prompt's last token, hidden); the KV heads grouped h % KV in the
    decode's attention alone (``attention._decode_mha``; the prefill
    keeps its grouping, which wrote the cache)."""
    decode = model.decode_step

    def position_one_off(caches, tokens, pos):
        return decode(caches, tokens, pos + 1)

    def newest_kv_dropped(caches, tokens, pos):
        for c in caches:
            kp = c["attn"]["k_pos"]
            kp[kp == pos[:, None] - 1] = -1
        return decode(caches, tokens, pos)

    def grouped_mod_kv(caches, tokens, pos):
        with mock.patch.object(attention, "_decode_mha", _grouped_mod_kv):
            return decode(caches, tokens, pos)

    return {"decode position one off": position_one_off,
            "newest KV entry dropped": newest_kv_dropped,
            "grouped heads mapped h % KV": grouped_mod_kv}


DENSE_ARCHS = ("qwen3-1.7b", "qwen2-7b", "granite-3-8b", "minitron-8b")


def dense_family(width, head_dim, n=1024):
    rows = []
    for arch in DENSE_ARCHS:
        full = get_config(arch)
        cfg = full.reduced().replace(
            n_layers=full.n_layers, d_model=width, head_dim=head_dim, n_heads=full.n_heads,
            n_kv_heads=full.n_kv_heads, d_ff=2 * width, dtype="bfloat16",
            param_dtype="bfloat16")
        model, ref = _models(cfg)
        tokens = _tokens(cfg, n)
        row = dict(family="dense", arch=arch, width=width, layers=cfg.n_layers,
                   heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, S=n,
                   bf16_vs_f32=_drift(model, ref, tokens),
                   consistency=handoff(model, tokens, n - 1))
        for fault, step in dense_decode_faults(model).items():
            row[fault.replace(" ", "_").replace("%", "mod")] = handoff(model, tokens, n - 1,
                                                                        decode=step)
        rows.append(row)
    return rows


def recurrentgemma(width, head_dim):
    cfg = get_config("recurrentgemma-9b").reduced().replace(
        n_layers=38, d_model=width, rnn_width=width, d_ff=3 * width, head_dim=head_dim,
        dtype="bfloat16", param_dtype="bfloat16")
    model, ref = _models(cfg)
    tokens = _tokens(cfg, S)
    row = dict(family="recurrentgemma", width=width, layers=cfg.n_layers, S=S,
               window=cfg.window, bf16_vs_f32=_drift(model, ref, tokens),
               consistency=consistency(model, tokens))
    with mock.patch.object(attention.torch, "roll", lambda t, shift, dims=0: t):
        row["ring_roll_dropped"] = consistency(model, tokens)
    with mock.patch.object(recurrent, "rec_prefill_cache", _conv_lost):
        row["conv_tail_lost"] = consistency(model, tokens)
    with mock.patch.object(attention, "_window", lambda cfg: 0):
        row["window_ignored"] = consistency(model, tokens)
    return row


_PREFILL_CACHE_ENTRIES = attention.prefill_cache_entries
_MOE_FORWARD = moe.moe_forward


def _first_kv_lost(*a, **k):
    cache = _PREFILL_CACHE_ENTRIES(*a, **k)
    cache["k_pos"][:, 0] = -1
    return cache


def _decode_ffn_dropped(p, x, cfg, impl=None, **kw):
    y, aux = _MOE_FORWARD(p, x, cfg, impl, **kw)
    return (torch.zeros_like(y) if x.shape[1] == 1 else y), aux


def _prompt_kv_lost(caches):
    for c in caches:
        c["attn"]["k_pos"].fill_(-1)
    return caches


def _layer_caches_rotated(caches):
    return caches[1:] + caches[:1]


def routing_flips(model, tokens) -> int:
    """Layers whose experts for the last token differ between prefill of
    all of ``tokens`` and prefill of all but it + one decode step."""
    picks = []
    route = moe._route

    def recording(p, x2d, cfg):
        out = route(p, x2d, cfg)
        picks.append(set(out[1][-1].tolist()))
        return out

    n = tokens.shape[1]
    with mock.patch.object(moe, "_route", recording), torch.inference_mode():
        model.prefill(tokens, cache_len=n + 8)
        full = picks[:]
        picks.clear()
        _, caches = model.prefill(tokens[:, :-1], cache_len=n + 8)
        picks.clear()
        model.decode_step(caches, tokens[:, -1:], torch.tensor([n - 1], dtype=torch.int32))
    return sum(a != b for a, b in zip(full, picks))


def moe_family(width, head_dim):
    base = get_config("phi3.5-moe-42b-a6.6b")
    heads = width // head_dim
    cfg = base.reduced().replace(
        n_layers=24, d_model=width, head_dim=head_dim, n_heads=heads,
        n_kv_heads=max(1, heads // 4), d_ff=2 * width, n_experts=base.n_experts,
        top_k=base.top_k, capacity_factor=base.n_experts / base.top_k,
        dtype="bfloat16", param_dtype="bfloat16")
    model, ref = _models(cfg)
    n = moe.GROUP
    tokens = _tokens(cfg, n)
    row = dict(family="moe", width=width, layers=cfg.n_layers, experts=cfg.n_experts,
               S=n, bf16_vs_f32=_drift(model, ref, tokens),
               consistency=handoff(model, tokens, n - 1),
               routing_flips=routing_flips(model, tokens))
    row["prompt_kv_lost"] = handoff(model, tokens, n - 1, mutate=_prompt_kv_lost)
    row["layer_caches_rotated"] = handoff(model, tokens, n - 1, mutate=_layer_caches_rotated)
    with mock.patch.object(attention, "prefill_cache_entries", _first_kv_lost):
        row["first_kv_entry_lost"] = handoff(model, tokens, n - 1)
    row["decode_position_one_off"] = handoff(model, tokens, n - 1, pos_shift=1)
    with mock.patch.object(moe, "moe_forward", _decode_ffn_dropped):
        row["decode_moe_ffn_dropped"] = handoff(model, tokens, n - 1)
    return row


def _mix_fault(kind, key):
    """lm's full-sequence function for ``kind`` with ``key`` of the cache
    it returns zeroed."""
    module, forward, decode = lm._MIX[kind]

    def faulty(p, x, cfg, with_cache=False, **kw):
        out = forward(p, x, cfg, with_cache, **kw)
        if with_cache:
            out[1][key] = torch.zeros_like(out[1][key])
        return out

    return {kind: (module, faulty, decode)}


def handoff_steps(model, tokens, prefill_len: int) -> dict:
    """bf16 prefill(prefill_len), then teacher-forced decode steps, each
    step's logits against the bf16 forward's logits at its position:
    relative L2 at the first step (the handoff), the largest, and the
    last."""
    n = tokens.shape[1]
    with torch.inference_mode():
        full = model(tokens)[0]
        _, caches = model.prefill(tokens[:, :prefill_len], cache_len=n + 8)
        rels = []
        for t in range(prefill_len, n):
            step, caches = model.decode_step(caches, tokens[:, t:t + 1],
                                             torch.tensor([t], dtype=torch.int32))
            rels.append(_rel(step[0, -1], full[t]))
    return dict(first=rels[0], max=max(rels), last=rels[-1])


def xlstm_family(width, _head_dim, prefill_len=4096, steps=256):
    cfg = get_config("xlstm-350m").reduced().replace(
        n_layers=24, d_model=width, mlstm_chunk=256, dtype="bfloat16", param_dtype="bfloat16")
    model, ref = _models(cfg)
    tokens = _tokens(cfg, prefill_len + steps)
    row = dict(family="xlstm", width=width, layers=cfg.n_layers, S=prefill_len + steps,
               prefill_len=prefill_len, decode_steps=steps,
               bf16_vs_f32=_drift(model, ref, tokens),
               consistency=handoff_steps(model, tokens, prefill_len))
    for name, kind, key in (("mlstm_m_zeroed", "mlstm", "m"),
                            ("mlstm_conv_tail_dropped", "mlstm", "conv"),
                            ("slstm_h_reset", "slstm", "h")):
        with mock.patch.dict(lm._MIX, _mix_fault(kind, key)):
            row[name] = handoff_steps(model, tokens, prefill_len)
    return row


WIDTHS = {64: 16, 256: 64}  # width: head dim
FAMILIES = {"recurrentgemma": recurrentgemma, "moe": moe_family, "xlstm": xlstm_family,
            "whisper": whisper_family, "vlm": vlm_family, "dense": dense_family}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", choices=[*FAMILIES, "all"], default="all")
    ap.add_argument("--width", type=int, choices=sorted(WIDTHS), action="append",
                    help="default: both")
    args = ap.parse_args()
    for name, fn in FAMILIES.items():
        if args.family in (name, "all"):
            for width in args.width or sorted(WIDTHS):
                rows = fn(width, WIDTHS[width])
                for row in rows if isinstance(rows, list) else [rows]:
                    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
