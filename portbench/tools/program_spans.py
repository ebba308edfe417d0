"""A traced run of one cell, with the program's own spans read beside it.

    python3 portbench/tools/program_spans.py --workload <cell> --seed <n> --seconds <s> \
        [--sync-debug]

Runs ``run.py``'s traced run (``--trace 1``: set-up, the profiled window,
the output check, the per-layer metrics, the trace reduced by the
harness's spans and by the program's ``hgs:`` spans, ``harness.program``)
and keeps the program's reduction.  The last line of standard output is
one JSON object: the run's ``result``, ``traced`` (the window's
end-to-end rates, measured under the profiler), ``program`` (the span
metrics of ``PROGRAM``, read by their own readers in
``portbench/metrics/`` whatever the cell, None where their span did not
fire), ``spans`` (every program span's share of device time, operations
launched inside it, and of the window's idle time, the main thread
inside it) and ``counters`` (the program's counters after the window).

``--sync-debug`` runs the window under
``torch.cuda.set_sync_debug_mode("warn")`` and adds ``sync_warnings``:
the synchronising calls, counted by the file and line that made them.
Exits with 2 without a CUDA card, as ``run.py`` does.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import types
import warnings
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent
sys.path[:0] = [str(ROOT / "src"), str(PORTBENCH)]

import run as pbrun  # noqa: E402

PROGRAM = ("decode_mha_share.decode", "decode_issue_idle_pct.decode",
           "moe_dispatch_share.prefill")


def _pct(part: float, whole: float):
    return 100.0 * part / whole if part > 0 and whole > 0 else None


def main(argv=None, *, root: Path = ROOT, device=None) -> int:
    """``root`` and ``device`` as ``run.run`` takes them (the tests)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sync-debug", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from harness import cell as hcell
    from harness import program, spec

    kept: dict = {}
    syncs: collections.Counter = collections.Counter()
    windows = {cls: cls.window for cls in set(hcell.CELLS.values())} if args.sync_debug else {}

    def warned(window):
        def warned_window(self, seconds):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    win = window(self, seconds)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            for w in caught:
                if "synchroniz" in str(w.message):
                    syncs[f"{os.path.relpath(w.filename, root)}:{w.lineno}"] += 1
            return win

        return warned_window

    for cls, window in windows.items():
        cls.window = warned(window)
    try:
        result = pbrun.run(["--workload", args.workload, "--seed", str(args.seed),
                            "--seconds", str(args.seconds), "--trace", "1"],
                           root=root, device=device, kept=kept)
    finally:
        for cls, window in windows.items():
            cls.window = window
    if result is None:
        return 2
    cell = spec.load_cell(args.workload, root)
    traced = {m["name"]: pbrun.end_to_end(m["name"], kept["win"], 0.0)
              for m in cell.end_to_end if m["name"] != "setup_s"}
    pt = kept["program"]
    names = sorted({n for k in pt.device for n in k} | {n for k in pt.idle for n in k})
    seen = types.SimpleNamespace(program=pt)  # all that these readers read of a run
    out = {"result": result, "traced": traced,
           "program": {n: spec.reader(n, root)(seen) for n in PROGRAM},
           "spans": {n: {"device_pct": _pct(pt.seconds_under(n), pt.device_s),
                         "idle_pct": _pct(pt.idle_under(n), pt.window_s)} for n in names},
           "counters": program.counters()}
    if args.sync_debug:
        out["sync_warnings"] = dict(syncs.most_common())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
