"""The port's benchmark: one cell, one run, one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's files (``harness.spec``), sets the program up on the
CUDA card (the benchmark's weights, one warm request or the first
training steps), measures for ``--seconds`` seconds, frees the program's
state and checks a sample of what the window produced against the plain
reference (``reference/``).  The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, the cell's end-to-end
metrics (``--trace 0``) or its per-layer metrics read from a profiler
trace of the window, reduced by the harness's spans and by the program's
(``--trace 1``, with ``breakdown``), ``device``, and
last ``checks``: each number compared with its limit.  The last lines of
standard error give the same numbers and limits.

Without a CUDA card, or with fewer cards than the cell asks for, it
exits with 2 and prints no result.  It never falls back to the CPU.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PORTBENCH = Path(__file__).resolve().parent
ROOT = PORTBENCH.parent
for p in (str(ROOT / "src"), str(PORTBENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level names, compared whole


def forbidden_modules(names=None):
    """The forbidden top-level names among loaded modules (or ``names``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _caches(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout (the program's
    nvcc builds already go to ``build/repro_torch_ext``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(root / "build" / "portbench" / sub)


def end_to_end(name: str, win, setup_s: float):
    import numpy as np

    if name == "setup_s":
        return setup_s
    if name in ("prefill_tokens_per_s", "train_tokens_per_s"):
        return win.tokens_in / win.seconds
    if name == "decode_tokens_per_s":
        return win.tokens_out / win.seconds
    if name == "tpot_p95_ms":
        return float(np.percentile(win.gaps, 95)) * 1e3 if win.gaps else None
    raise KeyError(f"no end-to-end metric {name!r}")


class Run:
    """What a per-layer metric's reader sees: the cell, its window, the
    trace reduced by the harness's spans (``harness.trace``) and by the
    program's (``program``, ``harness.program``; both None untraced), the
    card's peaks, and the configuration's reference module, whose counts
    the readers call, as ``flops``."""

    def __init__(self, cell, win, trace, peak, window_peak_bytes, program=None):
        self.cell, self.m, self.traffic = cell, cell.model, cell.traffic
        self.win, self.trace, self.peak = win, trace, peak
        self.program = program
        self.window_peak_bytes = window_peak_bytes
        self.flops = cell.reference


def run(argv=None, *, root: Path = ROOT, device=None, fault=None, log=None, kept=None):
    """One run; returns the result (printed last on standard output), or
    None without a card.  ``device`` other than None runs on that device
    without looking for a card (the tests).  ``log`` defaults to the
    standard error of the moment of the call.  A dict ``kept`` receives
    the window (``win``) and, traced, the program's reduction
    (``program``)."""
    log = sys.stderr if log is None else log
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import spec

    _caches(root)
    cell = spec.load_cell(args.workload, root)
    import torch

    from harness.cell import CELLS, sync

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"[no CUDA device] portbench: {args.workload} needs {cell.chips} CUDA card(s), "
                  f"this machine has {n}; no result", file=log)
            return None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"

    def say(msg):
        print(f"[{kind}] {msg}", file=log, flush=True)

    runner = CELLS[cell.mode](cell, args.seed, device, fault)
    runner.setup()
    sync(device)
    setup_s = time.perf_counter() - T0
    say(f"{args.workload} seed {args.seed}: set up in {setup_s:.3f} s")
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    trace = program_trace = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        from harness import program, spans
        from harness import trace as tr

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with spans.installed(), profile(activities=acts) as prof:
            win = runner.window(args.seconds)
        raw = tr.raw_events(prof)
        trace, program_trace = tr.reduce(raw), program.reduce(raw)
        del prof, raw
    else:
        win = runner.window(args.seconds)
    if kept is not None:
        kept.update(win=win, program=program_trace)
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    say(f"window {win.seconds:.3f} s, {win.requests} done, {win.failed} failed")
    runner.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = runner.check()
    limits = cell.limits["limits"]
    correct = win.failed == 0 and win.requests > 0 and all(
        numbers[k] == numbers[k] and numbers[k] <= lim for k, lim in limits.items())

    metrics = {}
    if args.trace:
        # the program's peak: the logits the harness keeps for the check
        # are on the card all through the window's last kept request
        run_ = Run(cell, win, trace, spec.peaks(kind), window_peak - runner.kept_bytes,
                   program_trace)
        for m in cell.per_layer:
            value = spec.reader(m["name"], root)(run_)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = end_to_end(m["name"], win, setup_s)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": win.requests,
              "failed": win.failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
                         "memory_peak_bytes": max(setup_peak, window_peak)}}
    if trace is not None:
        result["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": [[n[:160], s] for n, s in trace.top_ops(10)],
                               "idle_gaps": [[n[:160], s] for n, s in trace.idle_gaps[:10]]}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    for k in limits:
        say(f"check {k}: {numbers[k]!r} (limit {limits[k]!r})")
    return result


def main(argv=None) -> int:
    result = run(argv)
    if result is None:
        return 2
    bad = forbidden_modules()  # after the window and the check, before the result
    if bad:
        print(f"[{result['device']['kind']}] the run loaded {bad}: the benchmark runs the port "
              "alone; no result", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
