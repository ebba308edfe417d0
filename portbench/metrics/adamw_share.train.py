"""Device time of the operations launched inside `optim.adamw.update`
(the harness's `pb:adamw` spans), over all device time in the window,
in percent."""


def read(run):
    if run.trace is None or run.trace.device_s <= 0:
        return None
    s = run.trace.seconds_under("pb:adamw", innermost=True)
    return 100.0 * s / run.trace.device_s if s > 0 else None
