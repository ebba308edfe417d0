#!/usr/bin/env python3
"""Split the dense analytics kernels' time (``temporal_pagerank``,
``temporal_cc``) into the pack pass with its set-up and a cost per
iteration, on one CUDA card: each kernel is timed (``chip_smoke.py``'s
``device_ms``) at iters = 0, 1, 10, 20 and 40 on a seeded symmetric 0/1
stack shaped like the main path's (T=16 N=1295, 2% dense; the cluster
regime) and on ``chip_smoke.py``'s T=4 N=4096 headline stack (the stream
regime).  iters = 0 is the pack and set-up; (ms[40] - ms[20]) / 20 is an
iteration.  Prints one JSON line per kernel and stack, then the card's
``nvidia-smi`` name and power limit.

    python3 tools/dense_kernels.py
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("dense_kernels: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.temporal_cc import ops as cc_ops
    from repro_torch.kernels.temporal_pagerank import ops as pr_ops

    _build.build(["temporal_pagerank", "temporal_cc"])
    dev = torch.device("cuda")
    gd = torch.Generator(device=dev).manual_seed(5)
    a = torch.triu(torch.rand(16, 1295, 1295, generator=gd, device=dev) < 0.02, 1).float()
    a += a.transpose(1, 2).clone()
    act = (torch.rand(16, 1295, generator=gd, device=dev) < 0.8).float()
    stacks = [("T=16 N=1295 like the main path", a, act)] + [
        (tag, *x) for k, tag, x, _, _ in chip_smoke.headline_inputs(dev)
        if k == "temporal_pagerank.pagerank" and tag == "T=4 N=4096"]
    for tag, adj, act in stacks:
        for name, fn in (("temporal_pagerank", pr_ops.temporal_pagerank),
                         ("temporal_cc", cc_ops.temporal_cc)):
            ms = {it: chip_smoke.device_ms(lambda: fn(adj, act, iters=it))
                  for it in (0, 1, 10, 20, 40)}
            print(json.dumps({"iters_sweep": name, "inputs": tag, "regime": pr_ops.regime(
                adj.shape[1]), "ms": ms, "ms_per_iter_20_40": (ms[40] - ms[20]) / 20}),
                flush=True)
    print(chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
