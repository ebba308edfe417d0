#!/usr/bin/env python3
"""Host seconds a step of xlstm-350m's recurrences in the mesh dry run.

Dry-runs ``xlstm-350m``'s prefill (batch 32) on the reference's 16 x 16
mesh over a fake process group (``repro_torch.launch.dryrun.lower_cell``,
meta tensors, no card) at two sequence lengths, each in a child process
of its own (a fake group has one size a process), and prints one JSON
line: the seconds of each run and their difference over the difference
in steps, the cost of one step of the 6 sLSTM layers' loop (the mLSTM's
chunks add little).  ``--src`` points at another tree's ``src`` (a
parent checkout) to time its code the same way.  These are host times of
this machine's CPU, not device metrics.

    python3 tools/xlstm_mesh_steps.py [--src DIR] [--lengths 256 512]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELL = """
import sys, time
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
t0 = time.perf_counter()
rec = dryrun.lower_cell("xlstm-350m", ShapeConfig("steps", int(sys.argv[1]), 32, "prefill"),
                        False)
print(rec["status"], time.perf_counter() - t0)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--lengths", type=int, nargs=2, default=(256, 512))
    args = ap.parse_args()
    env = dict(os.environ, PYTHONPATH=args.src, OMP_NUM_THREADS="1")
    seconds = []
    for n in args.lengths:
        out = subprocess.run([sys.executable, "-c", CELL, str(n)], env=env, capture_output=True,
                             text=True, timeout=3600)
        status, s = out.stdout.split()[-2:]
        if out.returncode or status != "OK":
            print(out.stderr[-2000:], file=sys.stderr)
            return 1
        seconds.append(float(s))
    a, b = args.lengths
    print(json.dumps(dict(src=args.src, lengths=list(args.lengths), seconds=seconds,
                          seconds_a_step=(seconds[1] - seconds[0]) / (b - a))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
