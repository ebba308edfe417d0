#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 3j alone on one CUDA card: the four
families trained at full width (``chip_smoke.train_families``: each path's
line, its layer-0 attention held against the plain version, the reduced
float32 runs card against CPU), then phase 4's timed rows for the
attention inputs those paths recorded (``chip_smoke.kernel_case``, the
plain versions a few heads at a time).

``--vlm-layers N ...`` first probes the VLM path at each depth N (32, 24,
16: the choice behind ``chip_smoke.VLM_TRAIN_LAYERS``) and prints, for
each, its peak memory and whether its step-0 gradients stayed finite, or
the failure the path reported; a probe's failure does not stop the tool.
``--paths`` runs only the named paths of phase 3j (no reduced runs;
none named: the probes alone).
Prints JSON lines, the card's ``nvidia-smi`` name and power limit first,
and the seconds of each part.

    python3 tools/train_families.py [--vlm-layers 32 24 16] [--paths "train vlm"]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def probe_vlm(dev, layers: int) -> None:
    """The VLM path at ``layers`` layers, its outcome printed."""
    arch, batch, seq, _ = chip_smoke.TRAIN_FAMILIES["train vlm"]
    chip_smoke.TRAIN_FAMILIES["train vlm"] = (arch, batch, seq, layers)
    t0 = time.perf_counter()
    try:
        chip_smoke.train_family(dev, "train vlm")
        outcome = "passed"
    except SystemExit as e:  # the path's own check failed: report it
        outcome = str(e)
    except torch.OutOfMemoryError as e:
        outcome = f"out of memory: {str(e).splitlines()[0]}"
    print(json.dumps(dict(probe="train vlm depth", layers=layers, outcome=outcome,
                          peak_memory_bytes=torch.cuda.max_memory_allocated(),
                          seconds=time.perf_counter() - t0)), flush=True)
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vlm-layers", type=int, nargs="*", default=[])
    ap.add_argument("--paths", nargs="*", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_families: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    print(json.dumps(dict(part="build", seconds=time.perf_counter() - t0)), flush=True)
    dev = torch.device("cuda")
    depth = chip_smoke.TRAIN_FAMILIES["train vlm"]
    for layers in args.vlm_layers:
        probe_vlm(dev, layers)
    chip_smoke.TRAIN_FAMILIES["train vlm"] = depth
    recorder = chip_smoke.Recorder()
    t0 = time.perf_counter()
    if args.paths is None:
        chip_smoke.train_families(dev, recorder)
    else:
        for path in args.paths:
            chip_smoke.train_family(dev, path, recorder)
            chip_smoke.train_attention(path, recorder, dev, chip_smoke.train_family_shape(
                path, False)[0].n_img_tokens)
            torch.cuda.empty_cache()
    print(json.dumps(dict(part="phase 3j", seconds=time.perf_counter() - t0)), flush=True)
    t0 = time.perf_counter()
    for (name, tag), (a, kw) in list(recorder.inputs.items()):
        chip_smoke.kernel_case(name, a, kw, tag, recorded=True, by_head=True)
    print(json.dumps(dict(part="phase 4 rows", seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
