#!/usr/bin/env python3
"""Split the bf16 attention backward's device time by kernel, on one CUDA
card: ``flash_attention_bwd`` at the training path's shape (B=2 H=16
S=4096 D=256 bf16, causal, window 2048, one KV head expanded at stride
0; seeded inputs, o and lse from the forward kernel) under
``torch.profiler``, a few calls after a warm-up.  Prints one JSON line
with each kernel's device time per call (``prep_kernel``: rowsum(dO·O)
and the tiles' position ranges; ``dkdv_wgmma``; ``dq_wgmma``), their
sum, the whole call timed by ``chip_smoke.py``'s ``device_ms`` (CUDA
events), the work each kernel does at the rate it reached, and the
card's ``nvidia-smi`` name and power limit.

    python3 tools/attention_bwd_profile.py
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

B, H, S, D, WINDOW, CALLS = 2, 16, 4096, 256, 2048, 5


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_bwd_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops, ref

    _build.build(["flash_attention"])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q = (torch.randn(B, H, S, D, generator=g, device=dev) * 0.5).bfloat16()
    k, v = ((torch.randn(B, 1, S, D, generator=g, device=dev) * 0.5).bfloat16()
            .expand(B, H, S, D) for _ in range(2))
    do = (torch.randn(B, H, S, D, generator=g, device=dev) * 0.5).bfloat16()
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    o, lse = ops.flash_attention_lse(q, k, v, pos, pos, causal=True, window=WINDOW)

    def call():
        return ops.flash_attention_bwd(q, k, v, pos, pos, o, lse, do, causal=True,
                                       window=WINDOW)

    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(CALLS):
            call()
        torch.cuda.synchronize()
    per_call = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        for name in ("prep_kernel", "dkdv_wgmma", "dq_wgmma"):
            if name in ev.key and us:
                per_call[name] = per_call.get(name, 0.0) + us / 1e3 / CALLS
    # the tile pairs the kernels visit: (64-query, 64-key) pairs neither hides
    hidden, _ = ref.tile_pairs(pos, pos, True, WINDOW)
    tiles = int((~hidden).sum()) * B * H
    flops = {"dkdv_wgmma": 4 * 2 * 64 * 64 * D * tiles, "dq_wgmma": 3 * 2 * 64 * 64 * D * tiles}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(
        shape=dict(B=B, H=H, S=S, D=D, window=WINDOW, kv_head_stride=0), calls=CALLS,
        kernel_ms=per_call, kernels_sum_ms=sum(per_call.values()),
        call_ms=chip_smoke.device_ms(call), tile_pairs=tiles,
        tflops={n: f / (per_call[n] * 1e-3) / 1e12 for n, f in flops.items() if per_call.get(n)},
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
