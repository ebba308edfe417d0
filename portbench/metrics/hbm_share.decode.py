"""The least bytes the window's decode steps must move (bf16 weights at
2 bytes, the cache read once, the new keys and values written) over the
seconds in which an operation launched by those steps ran on the card,
at the card's HBM bandwidth, in percent."""


def read(run):
    bw = run.peak.get("hbm_bytes_per_s")
    if not bw or run.trace is None or not run.win.gaps:
        return None
    busy = run.trace.busy_under("pb:decode_step")
    if busy <= 0:
        return None
    nbytes = run.flops.window_decode_bytes(run.m, run.traffic, run.win.requests)
    return 100.0 * nbytes / (busy * bw)
