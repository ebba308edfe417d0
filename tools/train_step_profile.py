#!/usr/bin/env python3
"""Trace the last step of ``chip_smoke.py``'s ``lm train`` path under
``torch.profiler`` on one CUDA card, and split its device time by kernel.

Runs ``chip_smoke.lm_train`` itself (``launch.train.run`` on
``recurrentgemma-9b`` at full width cut to ``TRAIN_LAYERS`` layers, seeded
weights, ``TRAIN_STEPS`` AdamW steps on ``TRAIN_BATCH`` x ``TRAIN_SEQ``
tokens of ``SyntheticLM(seed=0)``, with every check of that phase), with
the step function that ``run`` makes wrapped so that its last call runs
under the profiler (CPU and CUDA activities) and ends in a synchronize.
The run's losses are ``chip_smoke.TRAIN_LOSSES``, and step 0's is held to
the smoke's 3047.7 as there.  Prints one JSON line: the losses, the
profiled step's host seconds, the span from its first device activity to
its last, the device's busy time (the union of every device activity's
interval) and idle share of that span, the device time by kind of kernel
(``KINDS``, by name), the kernels by summed device time (the first
``--top``, with launch counts), every RG-LRU backward launch's device
time, and the card's ``nvidia-smi`` name and power limit.  With ``--trace
FILE`` it also writes the step's Chrome trace there, gzipped.

    python3 tools/train_step_profile.py [--top 20] [--trace FILE]
"""
from __future__ import annotations

import argparse
import gzip
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

# kernel name -> kind: the first kind one of whose parts is in the name, else
# "other" (elementwise ops, reductions, norms, the loss, the optimizer)
KINDS = {"products (cuBLAS)": ("nvjet", "gemm"),
         "attention kernels": ("fa_wgmma", "dkdv_wgmma", "dq_wgmma", "prep_kernel",
                               "fa_kernel", "dq_kernel", "dkdv_kernel"),
         "RG-LRU kernels": ("rglru_kernel", "rglru_bwd_kernel"),
         "copies and fills": ("Memcpy", "Memset", "copy_kernel", "Fill")}


def kind(name: str) -> str:
    return next((k for k, parts in KINDS.items() if any(p in name for p in parts)), "other")


def busy_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--trace", type=Path, help="write the gzipped Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_step_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.launch import train as train_mod

    _build.build()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    made = train_mod.make_train_step
    profiled = {}

    def make_profiled_step(*a, **kw):
        step_fn, calls = made(*a, **kw), [0]

        def step(*args):
            calls[0] += 1
            if calls[0] < chip_smoke.TRAIN_STEPS:
                return step_fn(*args)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                out = step_fn(*args)
                torch.cuda.synchronize()
                profiled.update(prof=prof, host_s=time.perf_counter() - t0, step=calls[0] - 1)
            return out

        return step

    train_mod.make_train_step = make_profiled_step
    try:
        chip_smoke.lm_train(torch.device("cuda"))
    finally:
        train_mod.make_train_step = made
    prof, host_s = profiled["prof"], profiled["host_s"]
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in on_device]
    span_us = max(e for _, e in spans) - min(s for s, _ in spans)
    busy = busy_us(spans)
    by_kernel = {}
    for e in on_device:
        n, us = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:args.top]
    by_kind = {}
    for name, (n, us) in by_kernel.items():
        k = by_kind.setdefault(kind(name), dict(launches=0, ms=0.0))
        k["launches"] += n
        k["ms"] += us / 1e3
    rglru_bwd = [e.time_range.elapsed_us() / 1e3 for e in on_device
                 if "rglru_bwd_kernel" in e.name]
    if args.trace is not None:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=args.trace.parent) as tmp:
            raw = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(raw))
            with raw.open("rb") as src, gzip.open(args.trace, "wb") as dst:
                shutil.copyfileobj(src, dst)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(
        arch=chip_smoke.LM_ARCH, layers=chip_smoke.TRAIN_LAYERS, batch=chip_smoke.TRAIN_BATCH,
        seq=chip_smoke.TRAIN_SEQ, profiled_step=profiled["step"], losses=chip_smoke.TRAIN_LOSSES,
        host_seconds=host_s,
        device_span_ms=span_us / 1e3, device_busy_ms=busy / 1e3,
        device_idle_share=1 - busy / span_us, device_activities=len(on_device),
        by_kind=by_kind,
        kernels_by_device_ms=[dict(name=k, launches=n, ms=us / 1e3) for k, (n, us) in top],
        rglru_bwd_launches=len(rglru_bwd), rglru_bwd_ms=rglru_bwd,
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
