"""How far bf16 serving moves the last-token logits of the port's LM, and
how far faults of the decode handoff move them: the evidence behind
``chip_smoke.py``'s bound on prefill(S-1) + decode_step against
prefill(S).

For ``recurrentgemma-9b`` at its full depth of 38 layers but narrow
widths (random weights from a seed, S = 96 > window 32), on the CPU with
the plain versions, prints one JSON line per width:

- ``bf16_vs_f32``: relative L2 of bf16 prefill(S) against the same
  weights in f32;
- ``consistency``: relative L2 of bf16 prefill(S-1) + decode_step
  against bf16 prefill(S);
- the same with a fault injected: the ring roll dropped, the conv tail
  zeroed, the sliding window ignored.

    PYTHONPATH=src python tools/lm_bf16_consistency.py   # ~1 min
"""
from __future__ import annotations

import json
from unittest import mock

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import attention, lm, recurrent

S = 96


def _rel(got, want) -> float:
    return float((got - want).norm() / want.norm())


def consistency(model, tokens) -> float:
    with torch.inference_mode():
        full, _ = model.prefill(tokens, cache_len=S + 8)
        _, caches = model.prefill(tokens[:, :-1], cache_len=S + 8)
        step, _ = model.decode_step(caches, tokens[:, -1:],
                                    torch.tensor([S - 1], dtype=torch.int32))
    return _rel(step[0, -1], full[0, -1])


_REC_PREFILL_CACHE = recurrent.rec_prefill_cache


def _conv_lost(p, x, conv_width):
    cache = _REC_PREFILL_CACHE(p, x, conv_width)
    cache["conv"] = torch.zeros_like(cache["conv"])
    return cache


def main() -> None:
    for width, head_dim in ((64, 16), (256, 64)):
        cfg = get_config("recurrentgemma-9b").reduced().replace(
            n_layers=38, d_model=width, rnn_width=width, d_ff=3 * width, head_dim=head_dim,
            dtype="bfloat16", param_dtype="bfloat16")
        model = lm.init(cfg, seed=0, device="cpu")
        f32 = cfg.replace(dtype="float32", param_dtype="float32")
        ref = lm.from_state_dict(f32, {k: v.float() for k, v in model.state_dict().items()},
                                 device="cpu")
        tokens = torch.from_numpy(np.random.RandomState(1).randint(
            0, cfg.vocab_size, size=(1, S)).astype(np.int32))
        with torch.inference_mode():
            bf, _ = model.prefill(tokens, cache_len=S + 8)
            fp, _ = ref.prefill(tokens, cache_len=S + 8)
        row = dict(width=width, layers=cfg.n_layers, S=S, window=cfg.window,
                   bf16_vs_f32=_rel(bf[0, -1], fp[0, -1]),
                   consistency=consistency(model, tokens))
        with mock.patch.object(attention.torch, "roll", lambda t, shift, dims=0: t):
            row["ring_roll_dropped"] = consistency(model, tokens)
        with mock.patch.object(recurrent, "rec_prefill_cache", _conv_lost):
            row["conv_tail_lost"] = consistency(model, tokens)
        with mock.patch.object(attention, "_window", lambda cfg: 0):
            row["window_ignored"] = consistency(model, tokens)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
