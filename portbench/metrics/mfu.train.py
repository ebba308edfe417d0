"""Model operations of the window (`harness.flops`) over the seconds in
which an operation ran on the card in the traced window, at the card's
bfloat16 peak, in percent: the whole step's share of the chip while it
works.  The rest of the window, which the profiler's own host overhead
lengthens, is the idle share (`idle_pct.*`)."""


def read(run):
    peak = run.peak.get("bf16_flops")
    if not peak or run.trace is None or run.trace.busy_s <= 0:
        return None
    work = run.flops.window_flops(run.m, run.traffic, run.win.requests)
    return 100.0 * work / (run.trace.busy_s * peak)
