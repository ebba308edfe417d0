#!/usr/bin/env python3
"""Time the float32 attention kernels on one CUDA card, beside SDPA.

For each float32 shape that ``chip_smoke.py`` runs the forward or the
backward on (the reduced train step's, the reference's kernel-test grid,
B=1 H=2 S=300 D=256 window 128 and the B=1 H=4 S=2048 D=256 window 1024
headline with one KV head at stride 0), seeded inputs: the device time of
one ``flash_attention`` / ``flash_attention_bwd`` call (``chip_smoke``'s
``device_ms``: CUDA events, median of 15) and of SDPA on the same inputs
with the boolean mask (its forward; its backward through autograd).  Then,
at the headline shape, ``torch.profiler`` names every kernel each call
ran with its device time per call.  One JSON line per shape, then one
with the profile, the card's name and ``nvidia-smi`` power limit.

    python3 tools/attention_f32_profile.py [--src DIR] [--tag NAME]

``--src`` imports ``repro_torch`` from another tree (a parent checkout
unpacked with ``git archive``), so two trees compare in one run.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CALLS = 5

# (what, B, H, Sq, Sk, D, causal, window, one KV head at stride 0)
FWD = [("reduced train step", 4, 4, 64, 64, 16, True, 32, True),
       ("grid", 1, 2, 64, 64, 32, True, 0, False),
       ("grid", 1, 2, 96, 160, 32, True, 48, False),
       ("grid", 1, 1, 64, 256, 64, False, 0, False),
       ("grid", 2, 2, 1, 96, 32, True, 0, False),
       ("headline", 1, 4, 2048, 2048, 256, True, 1024, True)]
BWD = [("reduced train step", 4, 4, 64, 64, 16, True, 32, True),
       ("S=300", 1, 2, 300, 300, 256, True, 128, False),
       ("headline", 1, 4, 2048, 2048, 256, True, 1024, True)]


def inputs(B, H, Sq, Sk, D, causal, window, shared, dev):
    g = torch.Generator(device=dev).manual_seed(Sq * 131 + D)
    q = torch.randn(B, H, Sq, D, generator=g, device=dev) * 0.5
    k, v = (torch.randn(B, 1 if shared else H, Sk, D, generator=g, device=dev).mul(0.5)
            .expand(B, H, Sk, D) for _ in range(2))
    do = torch.randn(B, H, Sq, D, generator=g, device=dev) * 0.5
    k_pos = torch.arange(Sk, dtype=torch.int32, device=dev)
    q_pos = k_pos[Sk - Sq:] if causal else k_pos[:Sq]
    return q, k, v, q_pos.contiguous(), k_pos, do


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_f32_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, args.src)
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops, ref

    _build.build(["flash_attention"])
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    calls = {}
    for kind, cases in (("forward", FWD), ("backward", BWD)):
        for what, B, H, Sq, Sk, D, causal, window, shared in cases:
            q, k, v, q_pos, k_pos, do = inputs(B, H, Sq, Sk, D, causal, window, shared, dev)
            kw = dict(causal=causal, window=window)
            mask = ref.position_mask(q_pos, k_pos, **kw)
            if kind == "forward":
                def kern():
                    return ops.flash_attention(q, k, v, q_pos, k_pos, **kw)

                def sdpa():
                    return torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask)
            else:
                o, lse = ops.flash_attention_lse(q, k, v, q_pos, k_pos, **kw)
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                out = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=mask)

                def kern():
                    return ops.flash_attention_bwd(q, k, v, q_pos, k_pos, o, lse, do, **kw)

                def sdpa():
                    return torch.autograd.grad(out, leaves, do, retain_graph=True)
            shape = dict(B=B, H=H, Sq=Sq, Sk=Sk, D=D, causal=causal, window=window,
                         kv_head_stride=k.stride(1))
            print(json.dumps(dict(tag=args.tag, kind=kind, what=what, shape=shape,
                                  ms=chip_smoke.device_ms(kern),
                                  sdpa_ms=chip_smoke.device_ms(sdpa))), flush=True)
            if what == "headline":
                calls[kind] = (kern, sdpa)
    profile = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for kind, pair in calls.items():
        for who, fn in zip(("kernel", "sdpa"), pair):
            fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(CALLS):
                    fn()
                torch.cuda.synchronize()
            per = {}
            for ev in prof.key_averages():
                us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
                if us and ev.device_type == torch.autograd.DeviceType.CUDA:
                    per[ev.key[:160]] = us / 1e3 / CALLS
            profile[f"{kind} {who}"] = per
    print(json.dumps(dict(tag=args.tag, profile_ms_per_call=profile,
                          device=torch.cuda.get_device_name(0), nvidia_smi=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
