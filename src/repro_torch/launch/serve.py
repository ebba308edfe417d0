"""Batched serving (port of ``repro.launch.serve``): prefill a
batch of prompts, then decode greedily one token at a time.

Serving precision is the config's activation type (bfloat16 at full
width; the reduced configs are float32).  Weights are random, drawn on
the device from ``seed``, unless ``params`` carries them.  The inputs
come from ``np.random.RandomState(seed)`` in the reference's order: the
prompts, then (encoder-decoder) the audio frames as ``randn * 0.02``; a
VLM's image embeddings are zeros (the reference's stub frontend).

The KV cache holds ``n_img_tokens + prompt_len + gen_tokens + 8`` slots:
the image prefix, the prompt and the generated tokens all stay in it.
The reference sizes it without the image prefix
(``repro/launch/serve.py:30,41``: ``prompt_len + gen_tokens + 8``), so
once the prefix is longer than ``gen_tokens + 8`` (576 image tokens at
full width) its prefill allocates exactly the sequence's slots and
every decode step overwrites ring slot ``pos % S``: image token 0, 1,
2, ... drop out of attention, one a generated token.  The learned
position table has the reference's ``prompt_len + gen_tokens + 8`` rows.

  python -m repro_torch.launch.serve --arch recurrentgemma-9b --full
  python -m repro_torch.launch.serve --device cpu        # reduced config
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import lm
from repro_torch.train import make_prefill_step, make_serve_step


def serving_config(arch: str, reduced: bool = True):
    """The config ``serve`` runs: reduced or full, parameters stored in
    the activation type."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    return cfg.replace(param_dtype=cfg.dtype)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str = "recurrentgemma-9b", batch: int = 4, prompt_len: int = 32,
          gen_tokens: int = 16, reduced: bool = True, seed: int = 0,
          device: DeviceLike = None, params=None):
    """Generate ``gen_tokens`` tokens for each of ``batch`` random prompts
    (after the image prefix of a VLM, over the audio frames of an
    encoder-decoder).

    ``device=None`` means the CUDA card and raises without one.
    ``params``: an ``lm.LM`` of ``serving_config(arch, reduced)``, or of
    that config with fewer layers (a depth cut), to run; or a state dict
    of one of the config (``repro_torch.carry.lm_params_from_arrays``).
    Returns (tokens (batch, gen_tokens) int32, stats)."""
    dev = resolve(device)
    cfg = serving_config(arch, reduced)
    max_seq = prompt_len + gen_tokens + 8
    cache_len = cfg.n_img_tokens + max_seq
    if params is None:
        model = lm.init(cfg, seed=seed, device=dev, max_seq=max_seq)
    elif isinstance(params, lm.LM):
        if params.cfg.replace(n_layers=cfg.n_layers) != cfg:
            raise ValueError(f"params are a model of {params.cfg.name} that differs from "
                             f"the serving config of {arch} in more than its depth")
        model, cfg = params, params.cfg
    else:
        model = lm.from_state_dict(cfg, params, device=dev)

    rng = np.random.RandomState(seed)
    inputs = {"tokens": rng.randint(0, cfg.vocab_size, size=(batch, prompt_len))
              .astype(np.int32)}
    if cfg.n_img_tokens:
        inputs["img_embeds"] = np.zeros((batch, cfg.n_img_tokens, cfg.d_model), np.float32)
    if cfg.is_encdec:
        inputs["frames"] = rng.randn(batch, cfg.enc_seq, cfg.d_model).astype(np.float32) * 0.02
    prefill = make_prefill_step(cache_len=cache_len)
    step = make_serve_step()
    pos0 = cfg.n_img_tokens + prompt_len

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        tok, caches = prefill(model, {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()})
        out = [tok.cpu().numpy()]
        t_prefill = time.perf_counter() - t0
        finite = True
        t0 = time.perf_counter()
        for i in range(gen_tokens - 1):
            pos = torch.full((batch,), pos0 + i, dtype=torch.int32, device=dev)
            tok, logits, caches = step(model, caches, tok[:, None], pos)
            finite &= bool(torch.isfinite(logits).all())
            out.append(tok.cpu().numpy())
        t_decode = time.perf_counter() - t0
    return np.stack(out, 1), {
        "prefill_s": t_prefill, "decode_s": t_decode,
        "tok_per_s": batch * (gen_tokens - 1) / max(t_decode, 1e-9),
        "logits_finite": finite, "cache_len": cache_len}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="recurrentgemma-9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true", help="full width and depth")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    gen, stats = serve(args.arch, args.batch, args.prompt_len, args.tokens,
                       reduced=not args.full, seed=args.seed, device=args.device)
    print(f"generated {gen.shape} tokens; prefill {stats['prefill_s']:.2f}s, "
          f"decode {stats['decode_s']:.2f}s ({stats['tok_per_s']:.1f} tok/s)")


if __name__ == "__main__":
    main()
