"""Seconds of the window in which no operation ran on the device while
the main thread was inside the program's own ``hgs:serve_step`` span (a
decode step of ``train/steps.py``'s ``make_serve_step``: the host issuing
it), over the window's seconds, in percent (``run.program``,
``harness.program``)."""


def read(run):
    pt = run.program
    if pt is None or pt.window_s <= 0:
        return None
    s = pt.idle_under("hgs:serve_step")
    return 100.0 * s / pt.window_s if s > 0 else None
