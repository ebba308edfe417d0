"""Device operations launched inside the harness's decode-step spans, per
decode step (one token for every sequence of the batch)."""


def read(run):
    if run.trace is None or not run.win.gaps:
        return None
    n = run.trace.count_under("pb:decode_step")
    return n / len(run.win.gaps) if n else None
