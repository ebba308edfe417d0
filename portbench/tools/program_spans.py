"""A traced run of one cell, with the program's own spans read beside it.

    python3 portbench/tools/program_spans.py --workload <cell> --seed <n> --seconds <s> \
        [--sync-debug]

Runs ``run.py``'s traced run (``--trace 1``: set-up, the profiled window,
the output check, the per-layer metrics) and reduces the same trace a
second time for the program's ``hgs:`` spans (``harness.program``).  The
last line of standard output is one JSON object: the run's ``result``,
``traced`` (the window's end-to-end rates, measured under the profiler),
``program`` (the three span metrics below, None where their span did not
fire), ``spans`` (every program span's share of device time, operations
launched inside it, and of the window's idle time, the main thread
inside it) and ``counters`` (the program's counters after the window).

* ``decode_mha_share.decode``: device time of the operations launched
  with ``hgs:decode_mha`` open, over all device time.
* ``decode_issue_idle_pct.decode``: seconds of the window when the
  device was idle and the main thread was inside ``hgs:serve_step``,
  over the window's seconds.
* ``moe_dispatch_share.prefill``: device time of the operations whose
  innermost program span is ``hgs:moe.dispatch`` (dispatch and combine,
  the experts left out), over all device time.

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
import warnings
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent
sys.path[:0] = [str(ROOT / "src"), str(PORTBENCH)]

import run as pbrun  # noqa: E402


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
    from harness import trace as tr

    got: dict = {}
    syncs: collections.Counter = collections.Counter()
    reduce = tr.reduce
    windows = {cls: cls.window for cls in set(hcell.CELLS.values())}

    def reduce_both(raw, main_tid=None):
        got["program"] = program.reduce(raw, main_tid)
        return reduce(raw, main_tid)

    def kept(window):
        def kept_window(self, seconds):
            if not args.sync_debug:
                got["win"] = window(self, seconds)
                return got["win"]
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    got["win"] = window(self, seconds)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            for w in caught:
                if "synchroniz" in str(w.message):
                    syncs[f"{os.path.relpath(w.filename, root)}:{w.lineno}"] += 1
            return got["win"]

        return kept_window

    tr.reduce = reduce_both
    for cls, window in windows.items():
        cls.window = kept(window)
    try:
        result = pbrun.run(["--workload", args.workload, "--seed", str(args.seed),
                            "--seconds", str(args.seconds), "--trace", "1"],
                           root=root, device=device)
    finally:
        tr.reduce = reduce
        for cls, window in windows.items():
            cls.window = window
    if result is None:
        return 2
    cell = spec.load_cell(args.workload, root)
    traced = {m["name"]: pbrun.end_to_end(m["name"], got["win"], 0.0)
              for m in cell.end_to_end if m["name"] != "setup_s"}
    pt = got["program"]
    names = sorted({n for k in pt.device for n in k} | {n for k in pt.idle for n in k})
    out = {"result": result, "traced": traced,
           "program": {
               "decode_mha_share.decode": _pct(pt.seconds_under("hgs:decode_mha"), pt.device_s),
               "decode_issue_idle_pct.decode": _pct(pt.idle_under("hgs:serve_step"), pt.window_s),
               "moe_dispatch_share.prefill": _pct(pt.seconds_under("hgs:moe.dispatch", True),
                                                  pt.device_s)},
           "spans": {n: {"device_pct": _pct(pt.seconds_under(n), pt.device_s),
                         "idle_pct": _pct(pt.idle_under(n), pt.window_s)} for n in names},
           "counters": program.counters()}
    if args.sync_debug:
        out["sync_warnings"] = dict(syncs.most_common())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
