"""Device time of the operations launched while the program's own
``hgs:decode_mha`` span was open (``models/attention.py``'s decode
attention: on the card the ``decode_attention`` kernel's launch and its
scratch), over all device time in the window, in percent
(``run.program``, ``harness.program``)."""


def read(run):
    pt = run.program
    if pt is None or pt.device_s <= 0:
        return None
    s = pt.seconds_under("hgs:decode_mha")
    return 100.0 * s / pt.device_s if s > 0 else None
