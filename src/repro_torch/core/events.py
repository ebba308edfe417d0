"""Event encoding: the atomic unit of graph history (paper §3.1, Ex. 1-2).

Events are held as a structure-of-arrays (SoA) — int32/int8 columns — the
TPU-native replacement for the paper's pickled event objects.  The host
``EventLog`` is the ingest/index-construction view (numpy); query
execution converts padded slices to jnp.

Kinds:
  NODE_ADD/NODE_DEL        — src = node id
  EDGE_ADD/EDGE_DEL        — (src, dst); undirected edges are stored once
                             with src < dst and mirrored at query time
  NATTR_SET                — (src, key, val): node attribute write
  EATTR_SET                — (src, dst, key, val): edge attribute write
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Iterable, Optional, Tuple

import numpy as np

NODE_ADD, NODE_DEL, EDGE_ADD, EDGE_DEL, NATTR_SET, EATTR_SET = range(6)
KIND_NAMES = ("NODE_ADD", "NODE_DEL", "EDGE_ADD", "EDGE_DEL", "NATTR_SET", "EATTR_SET")

COLUMNS = ("t", "kind", "src", "dst", "key", "val")
DTYPES = dict(t=np.int64, kind=np.int8, src=np.int32, dst=np.int32,
              key=np.int16, val=np.int32)


@dataclasses.dataclass
class EventLog:
    """Chronologically sorted event columns (stable order within a t)."""

    t: np.ndarray
    kind: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    key: np.ndarray
    val: np.ndarray

    # ---- construction ----
    @classmethod
    def empty(cls) -> "EventLog":
        return cls(**{c: np.empty(0, DTYPES[c]) for c in COLUMNS})

    @classmethod
    def from_arrays(cls, t, kind, src, dst=None, key=None, val=None,
                    sort: bool = True) -> "EventLog":
        n = len(t)
        mk = lambda a, c, fill: (
            np.asarray(a, DTYPES[c]) if a is not None else np.full(n, fill, DTYPES[c])
        )
        ev = cls(
            t=np.asarray(t, DTYPES["t"]),
            kind=np.asarray(kind, DTYPES["kind"]),
            src=np.asarray(src, DTYPES["src"]),
            dst=mk(dst, "dst", -1),
            key=mk(key, "key", -1),
            val=mk(val, "val", -1),
        )
        if sort:
            order = np.argsort(ev.t, kind="stable")
            ev = ev.take(order)
        return ev

    # ---- basics ----
    def __len__(self) -> int:
        return len(self.t)

    def take(self, idx) -> "EventLog":
        return EventLog(**{c: getattr(self, c)[idx] for c in COLUMNS})

    def concat(self, other: "EventLog", sort: bool = True) -> "EventLog":
        ev = EventLog(
            **{c: np.concatenate([getattr(self, c), getattr(other, c)]) for c in COLUMNS}
        )
        if sort:
            ev = ev.take(np.argsort(ev.t, kind="stable"))
        return ev

    def slice_time(self, t0: int, t1: int) -> "EventLog":
        """Events with t in (t0, t1] — the paper's eventlist scope."""
        lo = np.searchsorted(self.t, t0, side="right")
        hi = np.searchsorted(self.t, t1, side="right")
        return self.take(slice(lo, hi))

    def up_to(self, t: int) -> "EventLog":
        return self.take(slice(0, int(np.searchsorted(self.t, t, side="right"))))

    def filter_nodes(self, nids: np.ndarray) -> "EventLog":
        """Events touching any node in `nids` (as src or dst)."""
        s = np.isin(self.src, nids)
        s |= np.isin(self.dst, nids)
        return self.take(np.nonzero(s)[0])

    @property
    def n_nodes(self) -> int:
        m = -1
        if len(self.src):
            m = max(m, int(self.src.max()))
        if len(self.dst):
            m = max(m, int(self.dst.max()))
        return m + 1

    def time_range(self) -> Tuple[int, int]:
        if not len(self.t):
            return (0, 0)
        return int(self.t[0]), int(self.t[-1])

    def to_dict(self):
        return {c: getattr(self, c) for c in COLUMNS}


def normalize_edges(src, dst):
    """Undirected canonical order: src < dst."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    return lo, hi


class ChunkedEventLog:
    """Append-only event log held as a list of column segments.

    ``TGI._events`` used to be one flat ``EventLog`` extended by
    ``concat`` per ingest batch — an O(total-history) memcpy every time.
    This holds the log as segments instead: ``append`` is O(1) (the
    segment list grows; nothing is copied), and readers go through
    ``flat()`` — or the ``t`` / ``take`` / ``time_range`` conveniences —
    which concatenates lazily, at most once per read-after-append burst.
    ``TGI.compact()`` calls ``fold()`` explicitly, so steady-state reads
    between compactions are zero-copy."""

    def __init__(self, base: Optional[EventLog] = None):
        self._flat = base if base is not None else EventLog.empty()
        self._tail: list = []
        self._tail_len = 0
        # fold/append are internally locked so the background
        # maintenance thread may fold outside TGI's _mvcc lock while
        # readers capture views under it
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._flat) + self._tail_len

    def append(self, ev: EventLog) -> None:
        """O(1): queue a segment; no bytes move until the next read."""
        if not len(ev):
            return
        with self._lock:
            self._tail.append(ev)
            self._tail_len += len(ev)

    def fold(self) -> EventLog:
        """Concatenate pending segments into the flat log (idempotent)."""
        with self._lock:
            if self._tail:
                logs = [self._flat] + self._tail
                self._flat = EventLog(**{
                    c: np.concatenate([getattr(log, c) for log in logs])
                    for c in COLUMNS
                })
                self._tail = []
                self._tail_len = 0
            return self._flat

    # readers (EventLog-compatible views used by TGI/son/pipeline)
    flat = fold

    @property
    def t(self) -> np.ndarray:
        return self.fold().t

    def take(self, idx) -> EventLog:
        return self.fold().take(idx)

    def time_range(self) -> Tuple[int, int]:
        """First/last event time — segment bounds only, never folds."""
        with self._lock:
            if len(self._flat) + self._tail_len == 0:
                return (0, 0)
            first = self._flat if len(self._flat) else self._tail[0]
            last = self._tail[-1] if self._tail else self._flat
            return int(first.t[0]), int(last.t[-1])

    @property
    def n_segments(self) -> int:
        with self._lock:
            return (1 if len(self._flat) else 0) + len(self._tail)
