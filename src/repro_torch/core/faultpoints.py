"""Deterministic fault injection for the MVCC maintenance path.

Named crash points (``compact.shadow_build``, ``compact.pre_swap``,
``compact.post_swap``, ``compact.mid_gc``, ``cell.apply``,
``cell.lease_expire`` — a cell's sweeper just detected an expired
writer lease, before reconciliation starts — and ``cell.reconcile`` —
mid orphan-seq reconciliation, after anti-entropy but before the lane
seal persists, ...) are
compiled into the maintenance and service code as ``fire(name)`` calls —
free when disarmed (one dict probe).  Tests arm a point with a hit
countdown and an action:

* ``raise`` — the Nth ``fire`` raises :class:`FaultError` in whatever
  thread hit it (a "clean" crash: the maintenance pass dies mid-flight
  but the process survives, so the test can assert the store is still
  readable and a retried pass converges);
* ``kill``  — the Nth ``fire`` SIGKILLs the *process* (used inside
  subprocess storage cells to prove a hard crash during a compaction
  write storm leaves the cluster serving).

Arming surfaces, in precedence order at ``fire`` time:

1. a :class:`contextvars.ContextVar` overlay (``local()``) — visible to
   the arming thread/task only; use it to scope a fault to one code path
   without races against unrelated threads;
2. the process-global registry (``arm()`` / ``scoped()``) — visible to
   every thread, which is what you want when the *maintenance thread*
   must crash while the test's main thread arms and observes;
3. the ``REPRO_FAULTPOINTS`` environment variable, parsed at import (and
   re-parsed by ``reset()``): ``name=hits[:action],name2=hits`` — e.g.
   ``REPRO_FAULTPOINTS="cell.apply=3:kill"`` makes a spawned storage
   cell SIGKILL itself on its 3rd apply.  Names therefore must not
   contain ``=``, ``:`` or ``,`` (use dots).

Countdown semantics: ``hits=N`` means fires N-1 times silently, then
acts on the Nth.  A fired entry disarms itself, so a retried maintenance
pass runs clean — exactly the "killed pass converges on retry" shape the
concurrency suite asserts.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import signal
import threading
from typing import Dict, Optional, Tuple

__all__ = ["FaultError", "fire", "arm", "disarm", "reset", "scoped",
           "local", "armed_points", "fired_counts"]

ENV_VAR = "REPRO_FAULTPOINTS"
ACTIONS = ("raise", "kill")


class FaultError(RuntimeError):
    """Raised by an armed fault point with action='raise'."""


# name -> [hits_remaining, action]; mutated under _lock
_registry: Dict[str, list] = {}
_fired: Dict[str, int] = {}  # total fires per name (armed or not)
_lock = threading.Lock()

# same-thread overlay: {name: [hits_remaining, action]} — list cells are
# shared with whatever context copied them, which is fine: the overlay is
# explicitly same-thread scoping
_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "repro_faultpoints", default=None)


def _parse_env(val: str) -> Dict[str, list]:
    out: Dict[str, list] = {}
    for item in val.split(","):
        item = item.strip()
        if not item or "=" not in item:
            continue
        name, spec = item.split("=", 1)
        action = "raise"
        if ":" in spec:
            spec, action = spec.split(":", 1)
        if action not in ACTIONS:
            raise ValueError(f"unknown fault action {action!r} in {ENV_VAR}")
        out[name.strip()] = [max(int(spec), 1), action]
    return out


def reset() -> None:
    """Drop every armed point and re-parse ``REPRO_FAULTPOINTS``."""
    with _lock:
        _registry.clear()
        _fired.clear()
        _registry.update(_parse_env(os.environ.get(ENV_VAR, "")))
    ctx = _ctx.get()
    if ctx:
        ctx.clear()


def arm(name: str, hits: int = 1, action: str = "raise") -> None:
    """Arm ``name`` globally: the ``hits``-th fire acts, then disarms."""
    assert action in ACTIONS, action
    with _lock:
        _registry[name] = [max(int(hits), 1), action]


def disarm(name: str) -> None:
    with _lock:
        _registry.pop(name, None)
    ctx = _ctx.get()
    if ctx:
        ctx.pop(name, None)


@contextlib.contextmanager
def scoped(name: str, hits: int = 1, action: str = "raise"):
    """Globally arm ``name`` for the duration of the block (any thread —
    including a background maintenance thread — can trip it)."""
    arm(name, hits, action)
    try:
        yield
    finally:
        disarm(name)


@contextlib.contextmanager
def local(name: str, hits: int = 1, action: str = "raise"):
    """Arm ``name`` in the current context only (same thread/task);
    threads spawned inside the block do NOT inherit it."""
    assert action in ACTIONS, action
    ctx = _ctx.get()
    if ctx is None:
        ctx = {}
        _ctx.set(ctx)
    ctx[name] = [max(int(hits), 1), action]
    try:
        yield
    finally:
        ctx.pop(name, None)


def _act(name: str, action: str) -> None:
    if action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    raise FaultError(f"fault point {name!r} fired")


def fire(name: str) -> None:
    """Trip ``name``: no-op unless armed; countdown then act + disarm."""
    ctx = _ctx.get()
    if ctx is not None:
        cell = ctx.get(name)
        if cell is not None:
            cell[0] -= 1
            if cell[0] <= 0:
                ctx.pop(name, None)
                _act(name, cell[1])
            return
    action: Optional[str] = None
    with _lock:
        _fired[name] = _fired.get(name, 0) + 1
        cell = _registry.get(name)
        if cell is not None:
            cell[0] -= 1
            if cell[0] <= 0:
                _registry.pop(name, None)
                action = cell[1]
    if action is not None:
        _act(name, action)


def armed_points() -> Dict[str, Tuple[int, str]]:
    with _lock:
        return {k: (v[0], v[1]) for k, v in _registry.items()}


def fired_counts() -> Dict[str, int]:
    with _lock:
        return dict(_fired)


reset()  # pick up REPRO_FAULTPOINTS at import (subprocess cells rely on it)
