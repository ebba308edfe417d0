"""Batched serving (port of ``repro.launch.serve``): prefill a
batch of prompts, then decode greedily one token at a time.

Serving precision is the config's activation type (bfloat16 at full
width; the reduced configs are float32).  Weights are random, drawn on
the device from ``seed``, unless ``params`` carries them.  Prompts come
from ``np.random.RandomState(seed)``, as in the reference.

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
    """Generate ``gen_tokens`` tokens for each of ``batch`` random prompts.

    ``device=None`` means the CUDA card and raises without one.
    ``params``: an ``lm.LM`` of ``serving_config(arch, reduced)``, or of
    that config with fewer layers (a depth cut), to run; or a state dict
    of one of the config (``repro_torch.carry.lm_params_from_arrays``).
    Returns (tokens (batch, gen_tokens) int32, stats)."""
    dev = resolve(device)
    cfg = serving_config(arch, reduced)
    max_seq = prompt_len + gen_tokens + 8
    if params is None:
        model = lm.init(cfg, seed=seed, device=dev)
    elif isinstance(params, lm.LM):
        if params.cfg.replace(n_layers=cfg.n_layers) != cfg:
            raise ValueError(f"params are a model of {params.cfg.name} that differs from "
                             f"the serving config of {arch} in more than its depth")
        model, cfg = params, params.cfg
    else:
        model = lm.from_state_dict(cfg, params, device=dev)

    rng = np.random.RandomState(seed)
    prompts = rng.randint(0, cfg.vocab_size, size=(batch, prompt_len)).astype(np.int32)
    prefill = make_prefill_step(cache_len=max_seq)
    step = make_serve_step()

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        tok, caches = prefill(model, {"tokens": torch.from_numpy(prompts).to(dev)})
        out = [tok.cpu().numpy()]
        t_prefill = time.perf_counter() - t0
        finite = True
        t0 = time.perf_counter()
        for i in range(gen_tokens - 1):
            pos = torch.full((batch,), prompt_len + i, dtype=torch.int32, device=dev)
            tok, logits, caches = step(model, caches, tok[:, None], pos)
            finite &= bool(torch.isfinite(logits).all())
            out.append(tok.cpu().numpy())
        t_decode = time.perf_counter() - t0
    return np.stack(out, 1), {
        "prefill_s": t_prefill, "decode_s": t_decode,
        "tok_per_s": batch * (gen_tokens - 1) / max(t_decode, 1e-9),
        "logits_finite": finite}


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
