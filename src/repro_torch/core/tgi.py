"""Temporal Graph Index (paper §4): build + retrieval.

Index anatomy per timespan (all stored in the DeltaStore under
``{tsid, sid, did, pid}`` keys, placement-keyed by ``(tsid, sid)``):

* ``E:<bucket>``            partitioned micro-eventlists (paper §4.3a) —
                            event columns, replicated to both endpoints'
                            shards, carrying a pid column for micro reads;
* ``S:<level>:<idx>``       the derived-partitioned-snapshot hierarchy
                            (§4.3b): leaf idx at level 0 = checkpoint
                            state diffs vs. their parent; one root per
                            span stored fully; parents are intersections
                            and are NOT stored (paper Fig. 3a);
* ``X:<bucket>``            auxiliary 1-hop replication micro-deltas
                            (§4.5, Fig. 5d) when enabled — read only by
                            neighborhood queries;
* version chains + slot maps + span table: index metadata (``META``).

Retrieval implements Algorithms 1-5.  Fetch cost accounting (deltas
fetched, bytes) is recorded per query for the Table-1 benchmarks.

The write path lives in ``repro.core.ingest``: one ``SpanBuilder``
serves batch ``build``, incremental ``update``, the streaming
``append``/``flush`` front-end (open-span reads overlay the not-yet-
sealed buffer), and ``compact`` (micro-span merging + store GC).

The read path layers caches with truthful accounting: the snapshot LRU
(whole states; hits replay logical FetchCost), the store's decoded-
block pool (columns; pool bytes reported separately from physical
decodes), and byte-grounded cost estimators (``estimate_fetch_cost``,
``explain_k_hop``) that the query planner uses for snapshot-vs-expand
and pruning decisions.

Concurrency (MVCC, see docs/api.md "Concurrency model"): readers pin
the epoch they started under via ``read_guard()`` and resolve every
lookup through an immutable :class:`ReadView`; writers and the
background maintenance thread publish layout changes under one lock
(``_mvcc``) with a single atomic swap + epoch bump; superseded store
keys are epoch-tagged and GC'd only after the last reader pinned at an
older epoch drains, so an in-flight query never sees a torn span list
or a vanished chunk.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import math
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as dev
from repro_torch.core import delta as delta_mod
from repro_torch.core import faultpoints
from repro_torch.core import ingest as ingest_mod
from repro_torch.core.delta import (
    FIELDS as DELTA_FIELDS,
    SENTINEL,
    Delta,
    delta_sum,
)
from repro_torch.core.events import ChunkedEventLog, EventLog
from repro_torch.core.slots import SlotMap
from repro_torch.core.snapshot import (
    GraphState,
    delta_to_graph,
    events_to_delta,
    overlay_fold,
    pack_edge_key,
)
from repro_torch.core.timespan import TimeSpan, split_timespans
from repro_torch.core.version_chain import VersionChains
from repro_torch.storage.kvstore import DeltaKey, DeltaStore, ReadSizes


@dataclasses.dataclass
class TGIConfig:
    n_shards: int = 4  # horizontal partitions (sid) — placement width
    parts_per_shard: int = 4  # micro-delta partitions per shard (pid)
    events_per_span: int = 4096  # timespan length (in events)
    eventlist_size: int = 256  # micro-eventlist bucket size l
    checkpoints_per_span: int = 4  # leaves of the derived hierarchy (r)
    n_attrs: int = 4  # node-attribute slots K
    partition_strategy: str = "hash"  # hash | locality
    omega: str = "union_max"  # time-collapse for locality partitioning
    replicate_1hop: bool = False  # auxiliary edge-cut replication
    pad_multiple: int = 128
    # streaming ingest: also seal a span once the buffered events cover
    # this many time units (None = cut on events_per_span alone)
    span_seal_time: Optional[int] = None

    @property
    def n_parts(self) -> int:
        return self.n_shards * self.parts_per_shard


@dataclasses.dataclass
class SpanIndex:
    span: TimeSpan
    smap: SlotMap
    checkpoint_ts: List[int]  # state times of hierarchy leaves
    bucket_bounds: List[Tuple[int, int]]  # event-index ranges per bucket


@dataclasses.dataclass
class FetchCost:
    n_deltas: int = 0
    n_bytes: int = 0  # encoded bytes physically read off storage
    sum_cardinality: int = 0
    n_bytes_decompressed: int = 0  # raw bytes physically decoded
    n_bytes_pool: int = 0  # raw bytes served from the decoded-block pool
    n_pool_hits: int = 0  # pooled columns served (never physical decodes)

    def add(self, n=1, b=0, card=0, raw=0, pool=0, pool_hits=0):
        self.n_deltas += n
        self.n_bytes += b
        self.sum_cardinality += card
        self.n_bytes_decompressed += raw
        self.n_bytes_pool += pool
        self.n_pool_hits += pool_hits

    def copy(self) -> "FetchCost":
        return dataclasses.replace(self)

    @property
    def n_bytes_raw_total(self) -> int:
        """Logical raw bytes the query touched, however they were served
        (physical decode + pool).  Invariant: identical with the pool on
        or off — the pool moves bytes between the two buckets, it never
        changes what a query logically reads."""
        return self.n_bytes_decompressed + self.n_bytes_pool


@dataclasses.dataclass(frozen=True)
class ReadView:
    """One reader's frozen view of the index, captured atomically under
    the MVCC lock when its ``read_guard()`` opened.  Every structure is
    either immutable or an owned shallow copy: published arrays are
    never mutated in place (writers rebind), so the view stays
    bit-stable for the guard's whole lifetime no matter what ingest or
    background compaction publishes meanwhile."""
    epoch: int
    spans: Tuple[SpanIndex, ...]
    span_by_tsid: Dict[int, SpanIndex]
    vc: Optional[VersionChains]
    events: EventLog  # folded flat log as of the capture
    pending: EventLog  # streaming buffer (rebound, never mutated)
    n_nodes: int


class TGI:
    """Build with ``TGI.build(events, cfg, store)``; query with
    get_snapshot / get_node_history / get_k_hop / get_node_1hop_history."""

    SNAP_CACHE_MAX = 16  # LRU entries of (t, pids, projection) snapshots

    def __init__(self, cfg: TGIConfig, store: DeltaStore, device=None):
        self.cfg = cfg
        self.store = store
        # where the kernel folds run (None: the CUDA card, raising if absent)
        self.device = dev.resolve(device)
        self.spans: List[SpanIndex] = []  # chronological
        self._span_by_tsid: Dict[int, SpanIndex] = {}
        self._next_tsid = 0  # monotonic — compaction rewrites under fresh ids
        self.vc: Optional[VersionChains] = None
        self.n_nodes = 0
        # chunked: ingest appends O(1) segments, reads concat lazily
        self._events = ChunkedEventLog()
        self._pending = EventLog.empty()  # streaming ingest buffer
        self._final_state = GraphState.empty(0, cfg.n_attrs)
        # MVCC: _mvcc guards every published structure (spans,
        # _span_by_tsid, vc, _events, _pending, n_nodes, read_epoch, the
        # snapshot LRU, pins, deferred GC); _ingest_lock serializes
        # writers (update/append/flush and the compaction publish step);
        # _maint_lock admits one maintenance pass at a time.  Lock order:
        # _maint_lock -> _ingest_lock -> _mvcc.
        self._mvcc = threading.RLock()
        self._ingest_lock = threading.RLock()
        self._maint_lock = threading.Lock()
        self._pinned: Dict[int, int] = {}  # epoch -> open read guards
        self._tls = threading.local()  # per-thread view + cost accounting
        self.last_cost = FetchCost()
        # reconstructed-snapshot LRU: key -> (GraphState, logical FetchCost)
        self._snap_cache: "collections.OrderedDict" = collections.OrderedDict()
        # bumped by every cache invalidation (ingest, compaction, manual):
        # the plan layer's cross-plan fetch cache keys on it, so a shared
        # operand can never outlive the index state it was fetched from
        self.read_epoch = 0
        self._mean_degree_cache: Optional[Tuple[int, float]] = None
        self.maintenance_stats = {"passes": 0, "failed_passes": 0,
                                  "gc_deferred_keys": 0}

    # ------------------------------------------------------------------
    # MVCC read guards (epoch pinning)
    # ------------------------------------------------------------------

    def _capture_view_locked(self) -> ReadView:
        # caller holds _mvcc; fold() is internally locked (the
        # maintenance thread folds outside _mvcc) and amortized O(1)
        # per capture
        return ReadView(
            epoch=self.read_epoch,
            spans=tuple(self.spans),
            span_by_tsid=dict(self._span_by_tsid),
            vc=self.vc.snapshot() if self.vc is not None else None,
            events=self._events.fold(),
            pending=self._pending,
            n_nodes=self.n_nodes,
        )

    @contextlib.contextmanager
    def read_guard(self) -> Iterator[ReadView]:
        """Pin the current epoch and yield its :class:`ReadView`.  Every
        retrieval issued inside resolves against the view, so a
        multi-call read (a batched fetch, a 1-hop history, a plan) is
        consistent to one instant even while ingest appends and
        background compaction swaps the layout.  Nested guards on the
        same thread reuse the outer view (one pin, one epoch).  Store
        keys superseded while any guard pins an older epoch are parked
        in the deferred-GC queue and deleted only after the last such
        guard exits."""
        tls = self._tls
        view = getattr(tls, "view", None)
        if view is not None:
            yield view
            return
        with self._mvcc:
            view = self._capture_view_locked()
            self._pinned[view.epoch] = self._pinned.get(view.epoch, 0) + 1
        tls.view = view
        try:
            yield view
        finally:
            tls.view = None
            with self._mvcc:
                n = self._pinned.get(view.epoch, 1) - 1
                if n <= 0:
                    self._pinned.pop(view.epoch, None)
                else:
                    self._pinned[view.epoch] = n
            self._gc_drain()

    def _tls_view(self) -> Optional[ReadView]:
        return getattr(self._tls, "view", None)

    def pinned_epochs(self) -> List[int]:
        with self._mvcc:
            return sorted(self._pinned)

    def _gc_drain(self) -> Tuple[int, int]:
        """Delete deferred keys whose tag epoch is no longer protected by
        any pinned reader.  Returns (keys deleted, bytes deleted)."""
        with self._mvcc:
            floor = min(self._pinned) if self._pinned else None
        return self.store.gc_drain(min_pinned_epoch=floor)

    # ------------------------------------------------------------------
    # Query-planner hooks (used by repro.taf.plan / repro.taf.query)
    # ------------------------------------------------------------------

    @property
    def last_cost(self) -> FetchCost:
        """Fetch cost of this *thread's* most recent retrieval — thread-
        local so concurrent queries (and the background maintenance
        pass) never clobber each other's accounting."""
        lc = getattr(self._tls, "last_cost", None)
        if lc is None:
            lc = FetchCost()
            self._tls.last_cost = lc
        return lc

    @last_cost.setter
    def last_cost(self, value: FetchCost) -> None:
        self._tls.last_cost = value

    @property
    def _cost_accum(self) -> Optional[FetchCost]:
        return getattr(self._tls, "cost_accum", None)

    @_cost_accum.setter
    def _cost_accum(self, value: Optional[FetchCost]) -> None:
        self._tls.cost_accum = value

    def _record_cost(self, n=1, b=0, card=0, raw=0, pool=0, pool_hits=0):
        self.last_cost.add(n, b, card, raw, pool, pool_hits)
        if self._cost_accum is not None:
            self._cost_accum.add(n, b, card, raw, pool, pool_hits)

    @contextlib.contextmanager
    def cost_scope(self) -> Iterator[FetchCost]:
        """Accumulate fetch cost across every retrieval issued inside the
        scope — one FetchCost per compiled query plan, even when the plan
        runs several get_* calls (each of which resets ``last_cost``).
        Thread-local: a scope only sees its own thread's retrievals."""
        prev = self._cost_accum
        acc = FetchCost()
        self._cost_accum = acc
        try:
            yield acc
        finally:
            self._cost_accum = prev
            if prev is not None:  # nested scopes roll up
                prev.add(acc.n_deltas, acc.n_bytes, acc.sum_cardinality,
                         acc.n_bytes_decompressed, acc.n_bytes_pool,
                         acc.n_pool_hits)

    def pids_for_nodes(self, node_ids: np.ndarray, t: int) -> List[int]:
        """Partition-pruning pushdown: the micro-partitions that cover
        ``node_ids`` in the timespan containing t.  A selection over a
        known node set fetches only these pids instead of all n_parts."""
        with self.read_guard() as view:
            si = self._span_index(t, view)
            pid, _, found = si.smap.lookup(np.asarray(node_ids, np.int32))
            return sorted(set(int(p) for p in pid[found]))

    def has_cached_snapshot(self, t: int, projection=None, c: int = 1) -> bool:
        """Non-destructive snapshot-LRU probe (planner hook): a warm
        *full* snapshot at t makes an unpruned fetch cheaper than a cold
        pruned one — the executor asks before committing to pruning."""
        with self._mvcc:
            return self._snap_key(int(t), None, projection, c) in self._snap_cache

    def _span_fetch_keys(self, t: int, pids: Optional[Sequence[int]] = None,
                         ) -> Tuple[List[DeltaKey], List[DeltaKey]]:
        """The store keys Algorithm 1 would touch for a snapshot at ``t``:
        ``(hierarchy path keys, eventlist keys)`` for the covering span,
        leaf, and partition subset — the cost model's key enumeration
        (shares the exact logic of ``get_snapshot``'s fetch)."""
        with self.read_guard() as view:
            if not view.spans:
                return [], []
            si = self._span_index(t, view)
            leaf = self._leaf_for(si, t)
            plist = list(range(self.cfg.n_parts)) if pids is None else list(pids)
            hier = [
                k for did in self._hierarchy_path(si, leaf)
                for k in self._delta_keys(si.span.tsid, did, plist)
            ]
            t_ck = si.checkpoint_ts[leaf]
            sids = sorted({self._sid_of_pid(int(p)) for p in plist})
            ev_keys = []
            bs = self._ev_buckets(si, t_ck, t, view)
            if bs:  # the real fetch reads the contiguous [min, max] range
                for b in range(min(bs), max(bs) + 1):
                    for sid in sids:
                        ev_keys.append(DeltaKey(si.span.tsid, sid, f"E:{b}", 0))
            return hier, ev_keys

    def estimate_fetch_cost(self, t: int,
                            pids: Optional[Sequence[int]] = None,
                            ) -> Dict[str, float]:
        """Planner estimate of one snapshot fetch at ``t``: encoded and
        raw bytes of every key the fetch would touch — real write-time
        sizes from ``store.key_sizes``, not guesses — split by component
        and discounted by the decoded-block pool's residency.  The
        ``physical_raw_bytes`` dimension is what cost-based plan
        selection compares: it is the ``FetchCost.n_bytes_decompressed``
        the fetch would actually pay, given what the pool already holds."""
        with self.read_guard():
            return self._estimate_fetch_cost_guarded(t, pids)

    def _estimate_fetch_cost_guarded(self, t, pids):
        hier, ev_keys = self._span_fetch_keys(t, pids)
        out = {"enc_bytes": 0.0, "raw_bytes": 0.0, "physical_raw_bytes": 0.0,
               "hier_raw_bytes": 0.0, "ev_raw_bytes": 0.0,
               "hier_physical_bytes": 0.0, "ev_physical_bytes": 0.0}
        for comp, keys in (("hier", hier), ("ev", ev_keys)):
            for k in keys:
                raw, enc = self.store.key_sizes.get(k, (0, 0))
                phys = raw * (1.0 - self.store.pool_residency(k))
                out["enc_bytes"] += enc
                out["raw_bytes"] += raw
                out["physical_raw_bytes"] += phys
                out[f"{comp}_raw_bytes"] += raw
                out[f"{comp}_physical_bytes"] += phys
        return out

    def _mean_degree(self) -> float:
        """Mean degree of the final state (cached per read_epoch) — the
        k-hop cost model's frontier-growth rate.  Probe, compute, and
        store all happen under the MVCC lock so the cached value can
        never pair a bumped epoch with a stale degree."""
        with self._mvcc:
            cached = self._mean_degree_cache
            if cached is not None and cached[0] == self.read_epoch:
                return cached[1]
            g = self._final_state
            n_alive = int((g.present == 1).sum())
            dbar = (2.0 * len(g.edge_key)) / max(n_alive, 1)
            self._mean_degree_cache = (self.read_epoch, dbar)
            return dbar

    def explain_k_hop(self, nid: int, t: int, k: int) -> Dict[str, float]:
        """The cost model behind ``get_k_hop(method="auto")``.

        * ``snapshot_bytes`` — physical raw bytes of a full-span fetch
          (pool-discounted ``estimate_fetch_cost``).
        * ``expand_bytes`` — hierarchy bytes scaled by the expected
          fraction of partitions a k-hop frontier touches (balls-into-
          bins over the expected frontier size under the mean degree),
          plus eventlist bytes for the covering shards (fetched once
          physically: the pool absorbs the per-hop re-reads).

        Grounded in ``FetchCost.n_bytes_decompressed`` units: both
        estimates are the raw bytes the method would physically decode,
        given current pool residency.  Ties fall back to the paper's
        ``k <= 2 -> expand`` heuristic."""
        with self.read_guard() as view:
            return self._explain_k_hop_guarded(view, t, k)

    def _explain_k_hop_guarded(self, view: ReadView, t: int, k: int):
        full = self.estimate_fetch_cost(t)
        n_parts, n_shards = self.cfg.n_parts, self.cfg.n_shards
        dbar = self._mean_degree()
        m = 1.0
        fr = 1.0
        for _ in range(k):
            fr *= max(dbar, 1e-9)
            m += fr
        m = min(m, float(max(view.n_nodes, 1)))
        # expected distinct partitions/shards hit by m uniform nodes
        part_frac = 1.0 - (1.0 - 1.0 / max(n_parts, 1)) ** m
        shard_frac = 1.0 - (1.0 - 1.0 / max(n_shards, 1)) ** m
        snapshot_bytes = full["physical_raw_bytes"]
        expand_bytes = (full["hier_physical_bytes"] * part_frac
                        + full["ev_physical_bytes"] * shard_frac)
        if expand_bytes < snapshot_bytes:
            method = "expand"
        elif expand_bytes > snapshot_bytes:
            method = "snapshot"
        else:
            method = "expand" if k <= 2 else "snapshot"
        return {
            "snapshot_bytes": snapshot_bytes,
            "expand_bytes": expand_bytes,
            "mean_degree": dbar,
            "expected_frontier": m,
            "partition_fraction": part_frac,
            "shard_fraction": shard_frac,
            "method": method,
        }

    # ------------------------------------------------------------------
    # Construction (paper §4.4 'Construction and Update')
    # ------------------------------------------------------------------

    @classmethod
    def build(cls, events: EventLog, cfg: TGIConfig, store: DeltaStore,
              device=None) -> "TGI":
        tgi = cls(cfg, store, device=device)
        tgi._build_from(events, GraphState.empty(events.n_nodes, cfg.n_attrs))
        return tgi

    def _alloc_tsid(self) -> int:
        """Allocate a fresh timespan id — the one writer/maintenance
        counter races on, so it hands out ids under the MVCC lock."""
        with self._mvcc:
            tsid = self._next_tsid
            self._next_tsid += 1
            return tsid

    def _build_from(self, events: EventLog, state: GraphState):
        with self._ingest_lock:
            with self._mvcc:
                self.spans = []
                self._span_by_tsid = {}
                self._next_tsid = 0
                self._events = ChunkedEventLog()
                self._pending = EventLog.empty()
                self._final_state = state
                self.n_nodes = max(events.n_nodes, len(state.present))
                z = np.empty(0, np.int32)
                self.vc = VersionChains.build(EventLog.empty(), z, z, 0)
            self._ingest_spans(events)
            with self._mvcc:
                self.vc.consolidate()  # a bulk build lands as one base CSR
                self.invalidate_caches()

    def _ingest_spans(self, new_events: EventLog,
                      pending_after: Optional[EventLog] = None) -> None:
        """Seal append-only events into spans via the shared SpanBuilder
        (one write path for build/update/flush) and extend the version
        chains incrementally — O(batch), not O(total history).

        Store writes happen first (new tsids: invisible to readers until
        published); the layout then publishes in one short ``_mvcc``
        critical section — span list, tsid map, event log, version
        chains, epoch bump, and (when sealing from the streaming buffer)
        the trimmed ``_pending`` all swap atomically, so a concurrent
        ``read_guard()`` sees each event exactly once: either still
        buffered or sealed, never both, never neither."""
        assert self._ingest_lock._is_owned()  # writers are serialized
        base = len(self._events)
        state = self._final_state
        builder = ingest_mod.SpanBuilder(self.cfg, self.store)
        spans = split_timespans(new_events, self.cfg.events_per_span)
        span_of = np.empty(len(new_events), np.int32)
        bucket_of = np.empty(len(new_events), np.int32)
        new_sis: List[SpanIndex] = []
        for sp in spans:
            sp2 = TimeSpan(self._alloc_tsid(), sp.t_start, sp.t_end,
                           base + sp.ev_lo, base + sp.ev_hi)
            ev_span = new_events.take(slice(sp.ev_lo, sp.ev_hi))
            si, b_of = builder.build_span(sp2, ev_span, state)
            span_of[sp.ev_lo:sp.ev_hi] = sp2.tsid
            bucket_of[sp.ev_lo:sp.ev_hi] = b_of
            new_sis.append(si)
        with self._mvcc:
            self.spans = self.spans + new_sis  # rebind: views keep the old list
            m = dict(self._span_by_tsid)
            m.update({si.span.tsid: si for si in new_sis})
            self._span_by_tsid = m
            # O(1) segment append — the flat view folds lazily on next read
            self._events.append(new_events)
            self.n_nodes = max(self.n_nodes, new_events.n_nodes,
                               len(state.present))
            if pending_after is not None:
                self._pending = pending_after
            if len(new_events):
                self.vc.append(new_events, span_of, bucket_of, self.n_nodes)
                # snapshots strictly before the new events are untouched
                self.invalidate_caches(t_from=int(new_events.t[0]))

    def update(self, new_events: EventLog):
        """Batch update (paper: 'accepts updates in batches of timespan
        length').  Spans for the new events are cut by the shared
        SpanBuilder on the running state — the same layout policy as
        ``build`` (locality partitioning and 1-hop replication included)
        — and the version chains extend incrementally instead of being
        re-derived from the full log."""
        assert len(new_events)
        with self._ingest_lock:
            self.flush()  # seal any streaming buffer first: global order
            # time_range() reads segment bounds only — no fold on ingest
            t_last = (self._events.time_range()[1] if len(self._events)
                      else -(2**62))
            assert new_events.t[0] >= t_last, "updates must be append-only"
            self._ingest_spans(new_events)

    # ------------------------------------------------------------------
    # Streaming ingest (buffered append + span sealing + flush)
    # ------------------------------------------------------------------

    def append(self, new_events: EventLog) -> None:
        """Streaming front-end: buffer events, cutting spans whenever the
        buffer holds ``events_per_span`` events (and/or covers
        ``cfg.span_seal_time`` time units).  Queries remain correct while
        ingest is mid-flight: reads at t past the sealed history overlay
        the buffer's live events (open-span reads); ``flush()`` seals the
        remainder into a final (possibly short) span."""
        if not len(new_events):
            return
        with self._ingest_lock:
            t_tail = self._pending.t[-1] if len(self._pending) else (
                self._events.time_range()[1] if len(self._events) else None)
            assert t_tail is None or new_events.t[0] >= t_tail, \
                "appends must be append-only"
            with self._mvcc:
                self._pending = self._pending.concat(new_events, sort=False)
                # buffered events shadow cached snapshots at t >= their start
                self.invalidate_caches(t_from=int(new_events.t[0]))
            self._seal_ready(force=False)

    def flush(self) -> None:
        """Seal every buffered event into spans."""
        with self._ingest_lock:
            self._seal_ready(force=True)

    def _seal_ready(self, force: bool) -> None:
        epb = self.cfg.events_per_span
        window = self.cfg.span_seal_time
        while True:
            n = len(self._pending)
            if n == 0:
                return
            timed_out = (window is not None and
                         int(self._pending.t[-1]) - int(self._pending.t[0])
                         >= window)
            if not force and n < epb and not timed_out:
                return
            if force and n <= epb:
                hi = n
            elif n < epb:  # timed_out: close the window [t0, t0 + window)
                hi = max(int(np.searchsorted(
                    self._pending.t,
                    int(self._pending.t[0]) + window, side="left")), 1)
            else:
                hi = epb
            if hi < n:  # span boundaries never split a timestamp
                t_edge = int(self._pending.t[hi - 1])
                hi = int(np.searchsorted(self._pending.t, t_edge, side="right"))
            # the sealed spans and the trimmed buffer publish in ONE
            # atomic step: no reader view can see the head events both
            # sealed and still pending
            self._ingest_spans(self._pending.take(slice(0, hi)),
                               pending_after=self._pending.take(slice(hi, n)))

    def _pending_floor(self, view: Optional[ReadView] = None) -> Optional[int]:
        """First buffered (unsealed) timestamp, or None when fully sealed.
        Reads at t >= this floor are open-span reads."""
        pend = view.pending if view is not None else self._pending
        return int(pend.t[0]) if len(pend) else None

    def _overlay_pending(self, g: GraphState, t: int, si: SpanIndex,
                         pids: Optional[Sequence[int]],
                         view: Optional[ReadView] = None) -> GraphState:
        """Open-span read: apply the buffered events with t' <= t on top
        of the sealed-index state.  With a pid subset, only events with an
        endpoint in the subset are applied (mirroring the sealed eventlist
        filter); events touching nodes the sealed SlotMap has never seen
        (brand-new nodes, not yet in any partition) are kept
        conservatively so histories and k-hop expansion stay complete."""
        pend = (view.pending if view is not None else self._pending).up_to(t)
        if not len(pend):
            return g
        if pids is not None:
            sel = np.asarray(pids)
            pid_s, _, found_s = si.smap.lookup(pend.src)
            keep = (found_s & np.isin(pid_s, sel)) | ~found_s
            has_dst = pend.dst >= 0
            if has_dst.any():
                pid_d, _, found_d = si.smap.lookup(pend.dst)
                keep |= has_dst & ((found_d & np.isin(pid_d, sel)) | ~found_d)
            pend = pend.take(np.nonzero(keep)[0])
        g.apply_bucket(pend)
        return g

    # ------------------------------------------------------------------
    # Compaction (micro-span merging + store GC)
    # ------------------------------------------------------------------

    def compact(self, min_run: int = 2, wait: bool = True):
        """Merge runs of adjacent micro-spans (spans shorter than
        ``events_per_span``, as accreted by small update/append batches)
        into full-size spans, on a background maintenance thread.

        The pass pins a read epoch, shadow-builds the merged spans'
        SlotMaps, eventlist buckets, and hierarchy through the shared
        SpanBuilder under fresh tsids (invisible to readers until
        published), then publishes the new layout in one atomic swap +
        epoch bump; superseded store keys are epoch-tagged in the
        deferred-GC queue and deleted only after the last reader pinned
        at an older epoch drains — queries and ingest run concurrently
        throughout and never see a torn layout or a vanished chunk.

        With ``wait=True`` (default) blocks for the pass and returns its
        :class:`CompactionStats` (re-raising any maintenance failure);
        with ``wait=False`` returns a ``concurrent.futures.Future``
        resolving to the stats.  One pass runs at a time.  A run is only
        rewritten when it actually reduces the span count (``min_run``
        adjacent micro-spans merging into fewer full spans)."""
        fut: "concurrent.futures.Future" = concurrent.futures.Future()

        def _run():
            try:
                fut.set_result(self._compact_pass(min_run))
            except BaseException as e:  # surfaced via fut.result()
                with self._mvcc:
                    self.maintenance_stats["failed_passes"] += 1
                fut.set_exception(e)

        threading.Thread(target=_run, name="tgi-maintenance",
                         daemon=True).start()
        return fut.result() if wait else fut

    def _compact_runs(self, spans: Sequence[SpanIndex],
                      min_run: int) -> List[Tuple[int, int]]:
        sizes = [s.span.ev_hi - s.span.ev_lo for s in spans]
        runs: List[Tuple[int, int]] = []
        i = 0
        while i < len(spans):
            if sizes[i] >= self.cfg.events_per_span:
                i += 1
                continue
            j = i
            while j < len(spans) and sizes[j] < self.cfg.events_per_span:
                j += 1
            total = sum(sizes[i:j])
            if (j - i >= min_run
                    and j - i > math.ceil(total / self.cfg.events_per_span)):
                runs.append((i, j))
            i = j
        return runs

    def _discard_shadow(self, shadow: Sequence[SpanIndex]) -> None:
        """Delete never-published shadow spans' store keys (crash before
        the swap): no reader can reach their fresh tsids, so a direct
        delete is safe and a retried pass starts clean."""
        for si in shadow:
            for sid in range(self.cfg.n_shards):
                for k in self.store.keys_for_placement(si.span.tsid, sid):
                    self.store.delete(k)

    def _compact_pass(self, min_run: int) -> "ingest_mod.CompactionStats":
        with self._maint_lock:
            self.flush()
            cfg = self.cfg
            bytes_w0 = self.store.stats.bytes_written
            builder = ingest_mod.SpanBuilder(cfg, self.store)
            shadow: List[SpanIndex] = []
            # pin the pass's own epoch: the shadow build (including its
            # seed-state get_snapshot calls, which nest under this
            # guard) sees one frozen layout even while ingest publishes
            with self.read_guard() as view:
                spans0 = view.spans
                stats = ingest_mod.CompactionStats(spans_before=len(spans0))
                runs = self._compact_runs(spans0, min_run)
                if not runs:
                    stats.spans_after = len(spans0)
                    stats.cost = FetchCost()
                    # still drain: a pass retried after a post-swap crash
                    # finds no runs but must finish the interrupted GC
                    d, b = self._gc_drain()
                    stats.keys_deleted += d
                    stats.bytes_deleted += b
                    with self._mvcc:
                        self.maintenance_stats["passes"] += 1
                    return stats
                built: List[Tuple[int, int, List[SpanIndex]]] = []
                try:
                    with self.cost_scope() as acc:
                        for (i, j) in runs:
                            faultpoints.fire("compact.shadow_build")
                            first, last = spans0[i], spans0[j - 1]
                            ev_lo, ev_hi = first.span.ev_lo, last.span.ev_hi
                            ev_run = view.events.take(slice(ev_lo, ev_hi))
                            # starting state = reconstructed state just
                            # before the run (earlier spans untouched)
                            if i == 0:
                                state = GraphState.empty(0, cfg.n_attrs)
                            else:
                                state = self.get_snapshot(
                                    spans0[i - 1].span.t_end)
                            replacement = []
                            for sp in split_timespans(ev_run,
                                                      cfg.events_per_span):
                                sp2 = TimeSpan(self._alloc_tsid(),
                                               sp.t_start, sp.t_end,
                                               ev_lo + sp.ev_lo,
                                               ev_lo + sp.ev_hi)
                                t_b = time.perf_counter()
                                si, _ = builder.build_span(
                                    sp2,
                                    ev_run.take(slice(sp.ev_lo, sp.ev_hi)),
                                    state)
                                replacement.append(si)
                                shadow.append(si)
                                # throttle: the shadow build is CPU-bound
                                # and invisible to readers, so its latency
                                # is free — cap the pass at a ~50% duty
                                # cycle (sleep as long as each span build
                                # took) so foreground queries keep the
                                # GIL at least half the time instead of
                                # stalling behind a whole run rewrite
                                time.sleep(
                                    min(time.perf_counter() - t_b, 0.02))
                            built.append((i, j, replacement))
                            stats.events_rewritten += ev_hi - ev_lo
                            stats.runs_merged += 1
                    faultpoints.fire("compact.pre_swap")
                except BaseException:
                    self._discard_shadow(shadow)
                    raise
            # guard released: the pass's own pin must not defer the GC it
            # is about to queue.  Enumerate superseded keys before the
            # swap (the old chunks are immutable until deleted).
            replaced = {spans0[x].span.tsid
                        for (i, j, _) in built for x in range(i, j)}
            head = {spans0[i].span.tsid: rep for (i, j, rep) in built}
            gc_keys = [
                k for tsid in sorted(replaced)
                for sid in range(cfg.n_shards)
                for k in self.store.keys_for_placement(tsid, sid)
            ]
            with self._ingest_lock:
                # _ingest_lock freezes the span list and the log (ingest
                # publishes only under it), so the heavy part of the
                # publish — splice + version-chain re-derivation over the
                # whole log — runs BEFORE touching _mvcc.  Readers only
                # ever wait on the O(1) reference swap below, never on
                # the O(n) rebuild.
                #
                # splice by tsid into the CURRENT span list: spans sealed
                # by concurrent ingest since the view was pinned stay in
                # place (the log is append-only, so they sort after every
                # rewritten run)
                new_spans: List[SpanIndex] = []
                for s in self.spans:
                    tsid = s.span.tsid
                    if tsid in head:
                        new_spans.extend(head[tsid])
                    elif tsid not in replaced:
                        new_spans.append(s)
                new_map = {s.span.tsid: s for s in new_spans}
                span_of, bucket_of = ingest_mod.span_bucket_arrays(
                    new_spans)
                new_vc = VersionChains.build(self._events.fold(),
                                             span_of, bucket_of,
                                             self.n_nodes)
                affected = [(spans0[i].span.t_start,
                             spans0[j - 1].span.t_end)
                            for (i, j, _) in built]
                with self._mvcc:
                    self.spans = new_spans
                    self._span_by_tsid = new_map
                    self.vc = new_vc
                    self.invalidate_caches(t_ranges=affected)
                    # epoch-tagged deferral: deletable once no reader
                    # pins an epoch older than the published layout's
                    self.store.delete_deferred(gc_keys, self.read_epoch)
                    self.maintenance_stats["passes"] += 1
                    self.maintenance_stats["gc_deferred_keys"] += len(gc_keys)
            faultpoints.fire("compact.post_swap")
            d, b = self._gc_drain()
            stats.keys_deleted += d
            stats.bytes_deleted += b
            stats.spans_after = len(self.spans)
            stats.bytes_written = self.store.stats.bytes_written - bytes_w0
            stats.cost = acc
            return stats

    def _bucket_of_old(self, old_spans) -> np.ndarray:
        # shim over the vectorized helper (was a per-event Python loop)
        return ingest_mod.span_bucket_arrays(old_spans)[1]

    # ---- storage helpers ----
    def _sid_of_pid(self, pid: int) -> int:
        return pid // self.cfg.parts_per_shard

    def _delta_keys(self, tsid: int, did: str,
                    pids: Sequence[int]) -> List[DeltaKey]:
        """Store keys of one delta restricted to a partition subset —
        THE key layout of the fetch path; the cost model enumerates
        through this same helper so estimates can't drift from reads."""
        return [
            DeltaKey(tsid, self._sid_of_pid(p), did,
                     p % self.cfg.parts_per_shard)
            for p in pids
        ]

    def _ev_buckets(self, si: SpanIndex, t_ck: int, t_hi: int,
                    view: Optional[ReadView] = None) -> List[int]:
        """Micro-eventlist buckets of ``si`` whose events intersect
        (t_ck, t_hi] — shared by the real fetch (``_span_events_until``)
        and the cost model (``_span_fetch_keys``)."""
        ev_t = (view.events if view is not None else self._events).t
        return [
            b for b, (lo, hi) in enumerate(si.bucket_bounds)
            if hi > lo and ev_t[lo] <= t_hi and ev_t[hi - 1] > t_ck
        ]

    # ------------------------------------------------------------------
    # Retrieval
    # ------------------------------------------------------------------

    def _span_index(self, t: int,
                    view: Optional[ReadView] = None) -> SpanIndex:
        spans = view.spans if view is not None else self.spans
        for si in reversed(spans):
            if t >= si.span.t_start:
                return si
        return spans[0]

    def _hierarchy_path(self, si: SpanIndex, leaf: int) -> List[str]:
        """did names root->leaf for a given leaf index."""
        n_leaves = len(si.checkpoint_ts)
        # reconstruct the tree shape
        names = []
        level = 0
        idx = leaf
        width = n_leaves
        while width > 1:
            names.append(f"S:{level}:{idx}")
            idx //= 2
            width = (width + 1) // 2
            level += 1
        names.append(f"S:{level}:0")
        return list(reversed(names))

    def _fetch_delta(self, tsid: int, did: str, pids: Optional[Sequence[int]],
                     si: SpanIndex, c: int = 1,
                     projection: Optional[Sequence[str]] = None) -> Delta:
        cfg = self.cfg
        pids = list(range(cfg.n_parts)) if pids is None else list(pids)
        keys = self._delta_keys(tsid, did, pids)
        fields = None
        if projection is not None and "attrs" not in projection:
            # attribute-projection pushdown: the attrs tile (the widest
            # column) is never read off storage
            fields = tuple(f for f in DELTA_FIELDS if f != "attrs")
        sizes: Dict[DeltaKey, ReadSizes] = {}
        got = self.store.multiget(keys, c=c, fields=fields, sizes=sizes)
        psize = si.smap.psize
        d = Delta.empty(cfg.n_parts, psize, cfg.n_attrs, ecap=1)
        e_parts = []
        for p, k in zip(pids, keys):
            a = got[k]
            d.valid[p] = a["valid"]
            d.present[p] = a["present"]
            if "attrs" in a:
                d.attrs[p] = a["attrs"]
            ne = int((a["e_src"] != SENTINEL).sum())
            e_parts.append((a["e_src"][:ne], a["e_dst"][:ne], a["e_op"][:ne], a["e_val"][:ne]))
            s = sizes[k]
            self._record_cost(1, s.enc, int(a["valid"].sum()) + ne, s.raw,
                              s.pool, s.pool_cols)
        if e_parts:
            d.e_src = np.concatenate([e[0] for e in e_parts])
            d.e_dst = np.concatenate([e[1] for e in e_parts])
            d.e_op = np.concatenate([e[2] for e in e_parts])
            d.e_val = np.concatenate([e[3] for e in e_parts])
            if len(d.e_src) == 0:
                d.e_src = np.full(1, SENTINEL, np.int32)
                d.e_dst = np.full(1, SENTINEL, np.int32)
                d.e_op = np.zeros(1, np.int8)
                d.e_val = np.full(1, -1, np.int32)
        return d

    def _fetch_eventlists(self, si: SpanIndex, b_lo: int, b_hi: int,
                          c: int = 1,
                          sids: Optional[Sequence[int]] = None) -> EventLog:
        """Micro-eventlists for buckets [b_lo, b_hi).  Events are
        replicated to both endpoints' shards, so a fetch restricted to
        the shards covering a partition subset still sees every event
        with >=1 endpoint there (planner shard pruning)."""
        keys = []
        for b in range(b_lo, b_hi):
            for sid in (range(self.cfg.n_shards) if sids is None else sids):
                keys.append(DeltaKey(si.span.tsid, sid, f"E:{b}", 0))
        out = EventLog.empty()
        # a bucket may have no events on a given shard -> key absent;
        # the stored pid column is for micro reads only — project it
        # away so it is seeked over, never decoded
        sizes: Dict[DeltaKey, ReadSizes] = {}
        got = self.store.multiget(keys, c=c, missing_ok=True, sizes=sizes,
                                  fields=("t", "kind", "src", "dst", "key", "val"))
        logs = []
        for k in keys:
            if k not in got:
                continue
            a = got[k]
            s = sizes[k]
            self._record_cost(1, s.enc, len(a["t"]), s.raw, s.pool, s.pool_cols)
            logs.append(a)
        if not logs:
            return out
        cat = {c2: np.concatenate([l[c2] for l in logs]) for c2 in
               ("t", "kind", "src", "dst", "key", "val")}
        ev = EventLog(**cat)
        # events were replicated across shards: dedup identical rows
        rows = np.stack([ev.t, ev.kind.astype(np.int64), ev.src.astype(np.int64),
                         ev.dst.astype(np.int64), ev.key.astype(np.int64),
                         ev.val.astype(np.int64)], 1)
        _, uniq = np.unique(rows, axis=0, return_index=True)
        ev = ev.take(np.sort(uniq))
        return ev.take(np.argsort(ev.t, kind="stable"))

    def _leaf_for(self, si: SpanIndex, t: int) -> int:
        """Nearest derived-hierarchy checkpoint at or before t."""
        return max(
            i for i, ct in enumerate(si.checkpoint_ts) if ct <= t
        ) if any(ct <= t for ct in si.checkpoint_ts) else 0

    def _span_events_until(self, si: SpanIndex, t_ck: int, t_hi: int, c: int,
                           pids: Optional[Sequence[int]],
                           view: Optional[ReadView] = None) -> EventLog:
        """Eventlists of the span covering (t_ck, t_hi], pid-filtered —
        fetched ONCE and re-filtered per timepoint by the batched path."""
        ev_buckets = self._ev_buckets(si, t_ck, t_hi, view)
        if not ev_buckets:
            return EventLog.empty()
        sids = None
        if pids is not None:
            sids = sorted({self._sid_of_pid(int(p)) for p in pids})
        ev = self._fetch_eventlists(si, min(ev_buckets), max(ev_buckets) + 1, c,
                                    sids=sids)
        ev = ev.take(np.nonzero((ev.t > t_ck) & (ev.t <= t_hi))[0])
        if pids is not None and len(ev):
            # keep events with EITHER endpoint in the fetched pids — a
            # deletion whose src lives elsewhere must still clear the
            # mirrored copy, or the edge resurrects
            pid_s, _, found_s = si.smap.lookup(ev.src)
            keep = found_s & np.isin(pid_s, np.asarray(pids))
            has_dst = ev.dst >= 0
            if has_dst.any():
                pid_d, _, found_d = si.smap.lookup(ev.dst)
                keep |= has_dst & found_d & np.isin(pid_d, np.asarray(pids))
            ev = ev.take(np.nonzero(keep)[0])
        return ev

    def _restrict_pids(self, state: Delta, si: SpanIndex,
                       pids: Sequence[int]) -> Delta:
        """Materialize only the fetched partitions: unfetched ones hold
        partial (event-only) state and must not leak into the result."""
        mask = np.zeros(self.cfg.n_parts, bool)
        mask[np.asarray(pids, np.int64)] = True  # stays valid for pids=[]
        state.valid &= mask[:, None]
        psize = si.smap.psize
        e_pid = (state.e_src.astype(np.int64) // psize)
        bad = (state.e_src != SENTINEL) & ~mask[np.clip(e_pid, 0, self.cfg.n_parts - 1)]
        keep = ~bad  # keeps trailing SENTINEL pads -> prefix invariant holds
        state.e_src = state.e_src[keep]
        state.e_dst = state.e_dst[keep]
        state.e_op = state.e_op[keep]
        state.e_val = state.e_val[keep]
        return state

    def _snap_key(self, t: int, pids, projection, c: int):
        # c is part of the key: it cannot change the result, but a
        # caller asking for a c>1 replicated read expects to exercise
        # real storage reads (failover), not a c=1 cache entry
        return (
            int(t),
            None if pids is None else tuple(int(p) for p in pids),
            None if projection is None else tuple(projection),
            int(c),
        )

    def _snap_cache_get(self, key,
                        epoch: Optional[int] = None) -> Optional[GraphState]:
        with self._mvcc:
            if epoch is not None and epoch != self.read_epoch:
                # pinned behind a published epoch: the shared LRU may
                # already hold newer-epoch entries under the same key —
                # bypass it and rebuild from the pinned view instead
                return None
            hit = self._snap_cache.get(key)
            if hit is None:
                return None
            self._snap_cache.move_to_end(key)
            g, cost = hit
        # replay the logical fetch cost: the LRU changes wall time, not
        # the planner's accounting (cost invariants stay deterministic).
        # The replay preserves the fill-time physical-vs-pool split, so
        # bytes the block pool served are never re-counted as decodes
        # (accounting parity with the fill-time read).
        self._record_cost(cost.n_deltas, cost.n_bytes, cost.sum_cardinality,
                          cost.n_bytes_decompressed, cost.n_bytes_pool,
                          cost.n_pool_hits)
        return g.copy()

    def _snap_cache_put(self, key, g: GraphState, cost: FetchCost,
                        epoch: Optional[int] = None) -> None:
        with self._mvcc:
            if epoch is not None and epoch != self.read_epoch:
                return  # built from an older pinned view: never published
            self._snap_cache[key] = (g.copy(), cost.copy())
            self._snap_cache.move_to_end(key)
            while len(self._snap_cache) > self.SNAP_CACHE_MAX:
                self._snap_cache.popitem(last=False)

    def invalidate_caches(self, t_from: Optional[int] = None,
                          t_ranges: Optional[Sequence[Tuple[int, int]]] = None,
                          drop_pool: bool = True) -> None:
        """Cache invalidation, scoped when possible.  With no arguments
        everything is dropped — the snapshot LRU AND the store's
        decoded-block pool (pass ``drop_pool=False`` to keep warm blocks,
        e.g. when benchmarking the pool itself).  ``t_from`` drops LRU
        entries at t >= t_from (append/update: snapshots strictly before
        the new events stay valid); ``t_ranges`` drops entries whose t
        falls inside any inclusive [lo, hi] range (compaction: only the
        rewritten spans' windows are touched).  Scoped invalidation
        leaves the block pool alone: stored blocks are immutable per
        tsid, and the write paths invalidate per key through
        ``DeltaStore.put``/``delete``.  Every call bumps ``read_epoch``
        (the plan-layer fetch cache keys on it).

        The epoch bump, the snapshot-LRU drop, the pool clear, and the
        ``_mean_degree`` cache reset are one atomic step under the MVCC
        lock: no concurrent reader can observe the new epoch paired with
        stale cache contents."""
        with self._mvcc:
            self.read_epoch += 1
            self._mean_degree_cache = None
            if t_from is None and t_ranges is None:
                self._snap_cache.clear()
                if drop_pool:
                    self.store.clear_pool()
                return
            stale = [
                k for k in self._snap_cache
                if (t_from is not None and k[0] >= t_from)
                or (t_ranges is not None
                    and any(lo <= k[0] <= hi for lo, hi in t_ranges))
            ]
            for k in stale:
                del self._snap_cache[k]

    def get_snapshot(self, t: int, c: int = 1, pids: Optional[Sequence[int]] = None,
                     use_kernel: bool = False,
                     projection: Optional[Sequence[str]] = None) -> GraphState:
        """Algorithm 1.  pids restricts to a partition subset (used by the
        k-hop and partition-parallel TAF fetch paths); ``projection``
        (planner hook) lists the optional payload fields to fetch —
        passing one without "attrs" skips the attribute tiles entirely
        (the returned attrs are then -1/unset).  Results go through a
        small LRU keyed on (t, pids, projection); hits skip storage but
        re-record the logical fetch cost.  Reads at t past the sealed
        history (mid-stream ``append``) overlay the ingest buffer's live
        events and bypass the LRU."""
        self.last_cost = FetchCost()
        with self.read_guard() as view:
            p0 = self._pending_floor(view)
            open_read = p0 is not None and t >= p0
            key = self._snap_key(t, pids, projection, c)
            if not open_read:
                hit = self._snap_cache_get(key, epoch=view.epoch)
                if hit is not None:
                    return hit
            with self.cost_scope() as acc:
                si = self._span_index(t, view)
                leaf = self._leaf_for(si, t)
                path = self._hierarchy_path(si, leaf)
                deltas = [self._fetch_delta(si.span.tsid, did, pids, si, c,
                                            projection)
                          for did in path]
                state = overlay_fold(deltas, use_kernel=use_kernel,
                                     device=self.device)
                t_ck = si.checkpoint_ts[leaf]
                ev = self._span_events_until(si, t_ck, t, c, pids, view)
                if len(ev):
                    state = overlay_fold(
                        [state, events_to_delta(ev, si.smap, self.cfg.n_attrs)],
                        use_kernel=use_kernel, device=self.device,
                    )
                if pids is not None:
                    state = self._restrict_pids(state, si, pids)
                g = delta_to_graph(state, si.smap)
                if open_read:
                    g = self._overlay_pending(g, t, si, pids, view)
            if not open_read:
                self._snap_cache_put(key, g, acc, epoch=view.epoch)
            return g

    def get_snapshots(self, ts: Sequence[int], c: int = 1,
                      pids: Optional[Sequence[int]] = None,
                      use_kernel: bool = False,
                      projection: Optional[Sequence[str]] = None) -> List[GraphState]:
        """Batched Algorithm 1: snapshots at every t in ``ts``, sharing
        one hierarchy-path fetch and one eventlist fetch per (span, leaf)
        group instead of re-reading them per timepoint.  With
        ``use_kernel`` the node payloads of a whole group fold in one
        time-batched ``delta_overlay`` kernel launch (per-timepoint
        validity masks select each t's eventlist layer).

        ``last_cost`` totals the whole batch.  Bit-identical to
        ``[get_snapshot(t) for t in ts]`` (property-tested)."""
        ts_list = [int(t) for t in np.asarray(ts, np.int64).ravel()]
        out: List[Optional[GraphState]] = [None] * len(ts_list)
        self.last_cost = FetchCost()
        with self.read_guard() as view:
            p0 = self._pending_floor(view)
            groups: Dict[Tuple[int, int], List[int]] = {}
            for j, t in enumerate(ts_list):
                if p0 is None or t < p0:  # open reads bypass the LRU
                    hit = self._snap_cache_get(
                        self._snap_key(t, pids, projection, c),
                        epoch=view.epoch)
                    if hit is not None:
                        out[j] = hit
                        continue
                si = self._span_index(t, view)
                groups.setdefault((si.span.tsid, self._leaf_for(si, t)),
                                  []).append(j)
            for (tsid, leaf), members in groups.items():
                si = view.span_by_tsid[tsid]
                t_ck = si.checkpoint_ts[leaf]
                t_hi = max(ts_list[j] for j in members)
                path = self._hierarchy_path(si, leaf)
                path_deltas = [
                    self._fetch_delta(tsid, did, pids, si, c, projection)
                    for did in path
                ]
                ev = self._span_events_until(si, t_ck, t_hi, c, pids, view)
                ev_deltas = []
                for j in members:
                    ev_j = ev.take(np.nonzero(ev.t <= ts_list[j])[0])
                    ev_deltas.append(
                        events_to_delta(ev_j, si.smap, self.cfg.n_attrs)
                        if len(ev_j) else None
                    )
                states = self._fold_group(path_deltas, ev_deltas, use_kernel)
                for j, state in zip(members, states):
                    if pids is not None:
                        state = self._restrict_pids(state, si, pids)
                    g = delta_to_graph(state, si.smap)
                    if p0 is not None and ts_list[j] >= p0:
                        g = self._overlay_pending(g, ts_list[j], si, pids, view)
                    out[j] = g
                # NOT inserted into the snapshot LRU: the group's fetch cost
                # is shared across members, so a per-t entry would over-
                # report the logical cost on later single-t cache hits
        return out  # type: ignore[return-value]

    def _fold_group(self, path_deltas: List[Delta],
                    ev_deltas: List[Optional[Delta]],
                    use_kernel: bool) -> List[Delta]:
        """Fold one (span, leaf) group's shared hierarchy path with each
        timepoint's eventlist delta."""
        T = len(ev_deltas)
        base = overlay_fold(path_deltas) if len(path_deltas) > 1 else path_deltas[0]
        if use_kernel and T > 1 and any(d is not None for d in ev_deltas):
            from repro_torch.kernels.delta_overlay import ops as ov_ops

            h0 = len(path_deltas)
            layers = path_deltas + [d for d in ev_deltas if d is not None]
            tmask = np.zeros((len(layers), T), np.int8)
            tmask[:h0, :] = 1  # the shared path applies to every timepoint
            li = h0
            for j, d in enumerate(ev_deltas):
                if d is not None:
                    tmask[li, j] = 1  # each eventlist layer to its own t
                    li += 1
            v, p, a = ov_ops.overlay_batch(*(
                torch.from_numpy(x).to(self.device) for x in (
                    np.stack([d.valid for d in layers]),
                    np.stack([d.present for d in layers]),
                    np.stack([d.attrs for d in layers]),
                    tmask,
                )))
            v, p, a = v.cpu().numpy(), p.cpu().numpy(), a.cpu().numpy()
            states = []
            for j, d in enumerate(ev_deltas):
                st = base.copy()
                st.valid = v[..., j] != 0
                st.present = p[..., j]
                st.attrs = a[:, :, j]  # (P, S, T, K): t is axis 2, not last
                if d is not None:
                    st.e_src, st.e_dst, st.e_op, st.e_val = delta_mod._edge_sum(
                        base, d)
                states.append(st)
            return states
        return [
            base.copy() if d is None else delta_sum(base, d)
            for d in ev_deltas
        ]

    def get_node_history(self, nid: int, t0: int, t1: int, c: int = 1):
        """Algorithm 2: (initial state at t0, EventLog of changes (t0,t1]).
        Buffered (unsealed) events in the window ride along from memory —
        they are not yet referenced by the version chains."""
        self.last_cost = FetchCost()
        with self.read_guard() as view:
            si = self._span_index(t0, view)
            pid, slot, found = si.smap.lookup(np.asarray([nid]))
            p0 = self._pending_floor(view)
            pend_has_nid = False
            if p0 is not None and t0 >= p0:
                pend0 = view.pending.up_to(t0)
                pend_has_nid = bool(
                    ((pend0.src == nid) | (pend0.dst == nid)).any())
            init = None
            if found[0] or pend_has_nid:
                # a node only the buffer knows has no sealed partition
                # yet — fall back to the unrestricted overlay read
                snap = self.get_snapshot(
                    t0, c=c, pids=[int(pid[0])] if found[0] else None)
                if nid < len(snap.present) and snap.present[nid]:
                    init = {
                        "present": 1,
                        "attrs": snap.attrs[nid].copy(),
                        "neighbors": self._neighbors_of(snap, nid),
                    }
            ts, tsids, buckets = view.vc.get(nid, t0, t1)
            ev = EventLog.empty()
            for tsid in np.unique(tsids):
                si2 = view.span_by_tsid[int(tsid)]
                bks = np.unique(buckets[tsids == tsid])
                # events touching nid replicate to nid's shard: read it alone
                pid2, _, found2 = si2.smap.lookup(np.asarray([nid]))
                sids = [self._sid_of_pid(int(pid2[0]))] if found2[0] else None
                got = self._fetch_eventlists(si2, int(bks.min()),
                                             int(bks.max()) + 1, c, sids=sids)
                ev = ev.concat(got, sort=False)
            if p0 is not None and t1 >= p0:
                ev = ev.concat(view.pending.slice_time(t0, t1), sort=False)
            ev = ev.take(np.argsort(ev.t, kind="stable"))
            sel = (((ev.src == nid) | (ev.dst == nid))
                   & (ev.t > t0) & (ev.t <= t1))
            return init, ev.take(np.nonzero(sel)[0])

    def _neighbors_of(self, g: GraphState, nid: int) -> np.ndarray:
        src, dst, _ = g.edges()
        return np.unique(np.concatenate([dst[src == nid], src[dst == nid]]))

    def get_k_hop(self, nid: int, t: int, k: int, c: int = 1,
                  method: str = "auto") -> GraphState:
        """Algorithms 3/4.  'snapshot' filters a full snapshot; 'expand'
        fetches partitions on demand.  'auto' is cost-based: it compares
        the physical raw bytes each method would decode — real stored
        sizes discounted by decoded-block-pool residency (see
        ``explain_k_hop``) — instead of the paper's fixed k<=2 rule
        (which remains the tie-break)."""
        with self.read_guard() as view:
            if method == "auto":
                method = self.explain_k_hop(nid, t, k)["method"]
            if method == "snapshot":
                g = self.get_snapshot(t, c=c)
                return self._filter_k_hop(g, nid, k)
            # expand: fetch the node's partition, then neighbors' ones
            self.last_cost = FetchCost()
            si = self._span_index(t, view)
            frontier = np.asarray([nid], np.int32)
            fetched_pids: set = set()
            g_acc: Optional[GraphState] = None
            nodes_seen = set([int(nid)])
            for _ in range(k + 1):
                pid, _, found = si.smap.lookup(frontier)
                need = sorted(set(int(p) for p in pid[found]) - fetched_pids)
                if need:
                    g_new = self.get_snapshot(t, c=c, pids=need)
                    fetched_pids |= set(need)
                    g_acc = (g_new if g_acc is None
                             else _merge_states(g_acc, g_new))
                if g_acc is None:
                    break
                nxt = []
                src, dst, _ = g_acc.edges()
                for n in frontier:
                    nxt.append(dst[src == n])
                    nxt.append(src[dst == n])
                nxt = (np.unique(np.concatenate(nxt)) if nxt
                       else np.empty(0, np.int32))
                frontier = np.asarray(
                    [x for x in nxt if int(x) not in nodes_seen], np.int32)
                nodes_seen |= set(int(x) for x in nxt)
                if not len(frontier):
                    break
            return self._filter_k_hop(
                g_acc if g_acc is not None
                else GraphState.empty(view.n_nodes, self.cfg.n_attrs), nid, k)

    def _filter_k_hop(self, g: GraphState, nid: int, k: int) -> GraphState:
        keep = {int(nid)}
        frontier = {int(nid)}
        src, dst, _ = g.edges()
        for _ in range(k):
            nxt = set()
            for n in frontier:
                nxt |= set(dst[src == n].tolist())
                nxt |= set(src[dst == n].tolist())
            nxt -= keep
            keep |= nxt
            frontier = nxt
        out = GraphState.empty(len(g.present), g.attrs.shape[1])
        ids = np.asarray(sorted(keep), np.int64)
        ids = ids[ids < len(g.present)]
        out.present[ids] = g.present[ids]
        out.attrs[ids] = g.attrs[ids]
        m = np.isin(src, ids) & np.isin(dst, ids)
        key = pack_edge_key(src[m], dst[m])
        order = np.argsort(key)
        out.edge_key = key[order]
        out.edge_val = g.edge_val[m][order] if len(g.edge_val) else np.empty(0, np.int32)
        return out

    def get_node_1hop_history(self, nid: int, t0: int, t1: int, c: int = 1):
        """Algorithm 5: initial 1-hop state + per-neighbor change events.
        The whole multi-call retrieval runs under one read guard, so the
        center history, the hood, and every neighbor history resolve
        against the same pinned epoch."""
        with self.read_guard():
            init, ev = self.get_node_history(nid, t0, t1, c=c)
            hood = self.get_k_hop(nid, t0, 1, c=c)
            neigh_ids = hood.node_ids()
            neigh_events = {}
            for m in neigh_ids:
                if int(m) == int(nid):
                    continue
                _, ev_m = self.get_node_history(int(m), t0, t1, c=c)
                neigh_events[int(m)] = ev_m
            return {"center_init": init, "center_events": ev,
                    "hood": hood, "neighbor_events": neigh_events}

    # ---- stats ----
    def time_range(self) -> Tuple[int, int]:
        """Ingested time range, including still-buffered (pending) events."""
        with self._mvcc:
            if len(self._pending):
                t0 = (self._events.time_range()[0] if len(self._events)
                      else int(self._pending.t[0]))
                return int(t0), int(self._pending.t[-1])
            return self._events.time_range()

    def index_size_bytes(self) -> int:
        """Live encoded bytes on the store (x replication) — shrinks when
        compaction GCs superseded spans."""
        return self.store.report_snapshot()["live_bytes"]

    COMPONENT_NAMES = {"E": "eventlists", "S": "hierarchy", "X": "aux_replicas"}

    def storage_report(self) -> Dict[str, Dict]:
        """Index size broken down by component (the paper's Fig. 10
        storage analysis): raw vs. encoded bytes and blob count for the
        eventlists (``E:*``), the derived snapshot hierarchy (``S:*``),
        the auxiliary 1-hop replicas (``X:*``), and anything else stored
        under this index's DeltaStore.  ``totals`` adds the aggregate and
        the compression ratio (encoded/raw); sizes are per logical key —
        multiply by ``replication`` for on-disk bytes.

        Internally consistent mid-compaction: the component breakdown,
        the totals, and the per-node status all derive from ONE key-size
        snapshot taken under the store lock (``report_snapshot``), so a
        report sampled while the maintenance thread publishes never
        mixes pre- and post-GC views of the store."""
        snap = self.store.report_snapshot()
        by_comp = snap["size_report"]
        components: Dict[str, Dict] = {}
        raw_total = enc_total = count_total = 0
        for comp, row in sorted(by_comp.items()):
            name = self.COMPONENT_NAMES.get(comp, comp)
            components[name] = dict(row)
            raw_total += row["raw"]
            enc_total += row["encoded"]
            count_total += row["count"]
        return {
            "format": self.store.fmt,
            "replication": self.store.r,
            "components": components,
            "totals": {
                "raw": raw_total,
                "encoded": enc_total,
                "count": count_total,
                "ratio": (enc_total / raw_total) if raw_total else 1.0,
            },
            # per-node health and live-data placement — the same shape
            # whether the store is the in-process DeltaStore or a
            # RemoteDeltaStore over storage cells, so chaos tests assert
            # cluster health through one report
            "nodes": snap["node_status"],
            "gc": {"pending_keys": snap["gc_pending_keys"]},
        }


def _merge_states(a: GraphState, b: GraphState) -> GraphState:
    n = max(len(a.present), len(b.present))
    a.grow(n)
    b.grow(n)
    out = GraphState.empty(n, a.attrs.shape[1])
    on_b = b.present == 1
    out.present = np.where(on_b, b.present, a.present)
    out.attrs = np.where(on_b[:, None], b.attrs, a.attrs)
    keys = np.concatenate([a.edge_key, b.edge_key])
    vals = np.concatenate([a.edge_val, b.edge_val])
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    keep = np.ones(len(keys), bool)
    if len(keys) > 1:
        keep[1:] = keys[1:] != keys[:-1]
    out.edge_key, out.edge_val = keys[keep], vals[keep]
    return out
