"""Readings of a cell's output check over many seeds in one process.

    python3 portbench/tools/readings.py --workload <cell> --seeds 1,2,3 --seconds 5 \
        [--control fp8] [--fault token|one_row|half_batch|frozen]

For each seed: the program set up as a run sets it up, a short window at
the cell's own load, the program's state freed, then the numbers that
decide ``correct``; with ``--control``, also the same numbers for the
reference computed in that lower precision in the program's place; with
``--fault``, the program runs with that fault planted.  One JSON line a
seed, on the CUDA card (it exits with 2 without one).  The limits in
``portbench/cells/<cell>.json`` are set from these readings; the
benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent
sys.path[:0] = [str(ROOT / "src"), str(PORTBENCH)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", default=None, help="fp8 or bf16")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    import torch

    from harness import spec
    from harness.cell import CELLS, sync

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        runner = CELLS[cell.mode](cell, seed, dev, args.fault)
        runner.setup()
        sync(dev)
        t_setup = time.perf_counter() - t0
        win = runner.window(args.seconds)
        peak = torch.cuda.max_memory_allocated(dev)
        runner.release()
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        probe = []
        numbers = runner.check(probe=probe)
        t_check = time.perf_counter() - t1
        line = {"device": kind, "workload": args.workload, "seed": seed, "fault": args.fault,
                "numbers": numbers, "setup_s": t_setup, "window_s": win.seconds,
                "done": win.requests, "failed": win.failed, "check_s": t_check,
                "peak_bytes": peak}
        if probe:
            line["probe"] = probe
        if args.control:
            t1 = time.perf_counter()
            line["control"] = args.control
            line["control_probe"] = []
            line["control_numbers"] = runner.check(control=args.control,
                                                   probe=line["control_probe"])
            line["control_s"] = time.perf_counter() - t1
        print(json.dumps(line), flush=True)
        del runner
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
