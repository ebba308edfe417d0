"""Device time of the operations whose innermost program span is
``hgs:moe.dispatch`` (``models/moe.py``'s one-hot dispatch and combine,
the experts' products, under ``hgs:moe.experts``, left out), over all
device time in the window, in percent (``run.program``,
``harness.program``)."""


def read(run):
    pt = run.program
    if pt is None or pt.device_s <= 0:
        return None
    s = pt.seconds_under("hgs:moe.dispatch", innermost=True)
    return 100.0 * s / pt.device_s if s > 0 else None
