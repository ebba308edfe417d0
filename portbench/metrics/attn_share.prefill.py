"""Device time of the operations launched inside `attention_forward`
(the harness's `pb:attn` spans), over all device time in the window,
in percent."""


def read(run):
    if run.trace is None or run.trace.device_s <= 0:
        return None
    s = run.trace.seconds_under("pb:attn", innermost=True)
    return 100.0 * s / run.trace.device_s if s > 0 else None
