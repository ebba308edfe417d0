#!/usr/bin/env python3
"""Rerun the CPU side of a failed RG-LRU gradient comparison.

``tests/test_torch_lm_bwd_cuda.py::test_rglru_function_gradients`` holds
the card's gradients of the scan against autograd through the plain scan
on the CPU.  When it fails it saves its inputs, the card's gradients and
the CPU's under ``build/rglru_failures/`` and names the file.  This
script loads that file in a fresh process, runs the CPU side again
(``rg_ops.rglru`` on CPU tensors, ``torch.autograd.grad``, the test's
own call) and prints one JSON line: whether each gradient repeats the
saved CPU bits, how far the rerun and the saved CPU gradients lie from
the card's and from the float64 recurrence.  A rerun that repeats the
saved bits puts the fault on the card's side; one that does not, on the
CPU's.  Exits 1 when the bits did not repeat.

    python3 tools/rglru_replay.py build/rglru_failures/<file>.pt
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.rglru_scan import ops as rg_ops  # noqa: E402
from rglru_cpu_threads import _exact  # noqa: E402  (this directory: the float64 recurrence)


def replay(saved: dict) -> dict:
    la = saved["log_a"].clone().requires_grad_()
    b = saved["b"].clone().requires_grad_()
    again = torch.autograd.grad(rg_ops.rglru(la, b), (la, b), saved["dh"])
    x = _exact(saved["log_a"], saved["b"], saved["dh"])[1:]
    out = {}
    for i, name in enumerate(("dlog_a", "db")):
        rerun, cpu, card = again[i], saved["cpu"][i], saved["card"][i]
        out[name] = dict(
            cpu_bits_repeat=bool(torch.equal(rerun, cpu)),
            rerun_vs_saved_cpu=float((rerun - cpu).abs().max()),
            rerun_vs_card=float((rerun - card).abs().max()),
            saved_cpu_vs_card=float((cpu - card).abs().max()),
            float64_distance=dict(card=float((card.double() - x[i]).abs().max()),
                                  saved_cpu=float((cpu.double() - x[i]).abs().max()),
                                  rerun=float((rerun.double() - x[i]).abs().max())))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("file", type=Path, help="a file the test saved under build/rglru_failures/")
    args = ap.parse_args()
    saved = torch.load(args.file)
    out = replay(saved)
    repeat = all(v["cpu_bits_repeat"] for v in out.values())
    print(json.dumps(dict(file=str(args.file), shape=list(saved["log_a"].shape),
                          saved_torch=saved.get("torch"), saved_threads=saved.get("threads"),
                          torch=torch.__version__, threads=torch.get_num_threads(),
                          cpu_bits_repeat=repeat, **out)))
    return 0 if repeat else 1


if __name__ == "__main__":
    sys.exit(main())
