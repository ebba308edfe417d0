"""Shared pytest plumbing.

``@pytest.mark.timeout(seconds)`` — hard wall-clock bound on a single
test, enforced with SIGALRM (no external plugin).  Socket and
concurrency tests carry it so a wedged storage cell or deadlocked
maintenance thread fails the test instead of hanging CI: the alarm
interrupts any blocking recv/accept/join in the main thread with a
``TimeoutError``.  On platforms without SIGALRM the marker is a no-op.

When the alarm fires, two things happen beyond the raise:

* every thread's stack is dumped to stderr (``faulthandler``), so a CI
  log shows WHERE the reader/ingester/compactor threads were stuck —
  a bare TimeoutError from the main thread says nothing about a
  deadlock between the other three;
* worker threads the test spawned (anything alive now that wasn't
  alive before the test body ran) are joined briefly and then
  abandoned with a loud stderr note.  Without this, a timed-out stress
  test leaked its still-running readers into the next test, where they
  kept mutating the (garbage-collected) store and produced unrelated
  downstream failures.
"""
import faulthandler
import signal
import sys
import threading

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "timeout(seconds): fail (not hang) if the test runs longer — "
        "SIGALRM-based, main thread only; dumps all thread stacks and "
        "reaps leaked worker threads on expiry",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's hand-written kernels); skips "
        "without one",
    )


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    marker = item.get_closest_marker("timeout")
    if marker is None or not hasattr(signal, "SIGALRM"):
        yield
        return
    seconds = int(marker.args[0]) if marker.args else 60
    before = set(threading.enumerate())

    def _alarm(signum, frame):
        sys.stderr.write(
            f"\n=== {item.nodeid}: {seconds}s timeout — all-thread dump "
            f"===\n")
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        raise TimeoutError(
            f"{item.nodeid} exceeded its {seconds}s timeout marker")

    old = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(seconds)
    timed_out = False
    try:
        outcome = yield
        exc = outcome.excinfo
        timed_out = exc is not None and issubclass(exc[0], TimeoutError)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        if timed_out:
            _reap_leaked_threads(item, before)


def _reap_leaked_threads(item, before):
    """Join (briefly) then abandon threads the timed-out test spawned.

    Stress tests signal their workers through ``threading.Event``; once
    the test body unwound, nothing sets that event, so a worker blocked
    on a queue or socket would otherwise outlive the test and corrupt
    later ones.  A short join gives cooperative workers a chance to
    notice the unwind; anything still alive after that is daemon (the
    suite's convention) and is reported, not waited for — CI must not
    hang a second time on the cleanup of a hang.
    """
    leaked = [t for t in threading.enumerate()
              if t not in before and t is not threading.current_thread()]
    for t in leaked:
        t.join(timeout=1.0)
    alive = [t for t in leaked if t.is_alive()]
    if alive:
        names = ", ".join(t.name for t in alive)
        sys.stderr.write(
            f"\n=== {item.nodeid}: abandoned {len(alive)} still-running "
            f"worker thread(s) after timeout: {names} ===\n")
