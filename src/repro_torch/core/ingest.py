"""Ingest subsystem (paper §4.4 'Construction and Update').

One write path for everything between the event log and the read path:

* ``SpanBuilder`` — cuts one timespan into micro-eventlist buckets and
  derived-hierarchy checkpoints, owns the SlotMap / locality
  partitioning, and emits every store key (``E:*`` eventlists, ``S:*``
  hierarchy deltas, ``X:*`` aux replicas).  ``TGI.build``, ``TGI.update``,
  the streaming ``TGI.append`` front-end, and ``TGI.compact`` all go
  through it, so batch construction, incremental update, and compaction
  can never diverge (the old ``update`` was a hand-copied ``_build_from``
  that silently dropped locality partitioning and 1-hop replication).
* ``span_bucket_arrays`` — vectorized per-event (tsid, bucket) placement
  for a span list (replaces the per-event Python loop the old
  ``_bucket_of_old`` ran on every update).
* ``CompactionStats`` — the result record of ``TGI.compact()``: span
  counts, deleted/rewritten store bytes, and the fetch cost of the reads
  compaction issued (surfaced as ``HistoricalGraphStore.last_cost``).

Read-cache coherence: every write this subsystem emits goes through
``DeltaStore.put`` and every GC through ``DeltaStore.delete``, both of
which invalidate the store's decoded-block buffer pool per key — so
build/update/append/compact can never leave stale decoded columns
behind, and scoped snapshot-LRU invalidation (``t_from``/``t_ranges``)
never needs to touch the pool.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

from repro_torch.core import partition as part_mod
from repro_torch.core.delta import Delta
from repro_torch.core.events import EventLog
from repro_torch.core.slots import SlotMap, hash32
from repro_torch.core.snapshot import GraphState
from repro_torch.core.timespan import TimeSpan
from repro_torch.storage.kvstore import DeltaKey, DeltaStore


@dataclasses.dataclass
class CompactionStats:
    """What one ``TGI.compact()`` pass did.  ``cost`` is the fetch cost of
    the snapshot reads compaction issued to seed each merged run's
    starting state (its write/delete I/O is in the byte counters)."""

    spans_before: int = 0
    spans_after: int = 0
    runs_merged: int = 0
    events_rewritten: int = 0
    keys_deleted: int = 0
    bytes_deleted: int = 0  # encoded bytes GC'd off the store (x r)
    bytes_written: int = 0  # encoded bytes of the rewritten spans (x r)
    cost: object = None  # FetchCost of compaction's own reads

    @property
    def span_reduction(self) -> float:
        return self.spans_before / max(self.spans_after, 1)


def span_bucket_arrays(spans) -> Tuple[np.ndarray, np.ndarray]:
    """Per-event ``(span_of_event, bucket_of_event)`` for a list of
    ``SpanIndex`` — pure bounds arithmetic (``np.repeat`` over the bucket
    ranges), no per-event Python loop."""
    tsids, buckets = [], []
    for s in spans:
        bounds = np.asarray(s.bucket_bounds, np.int64).reshape(-1, 2)
        sizes = bounds[:, 1] - bounds[:, 0]
        n_ev = int(sizes.sum())
        tsids.append(np.full(n_ev, s.span.tsid, np.int32))
        buckets.append(np.repeat(np.arange(len(bounds), dtype=np.int32), sizes))
    if not tsids:
        z = np.empty(0, np.int32)
        return z, z.copy()
    return np.concatenate(tsids), np.concatenate(buckets)


class SpanBuilder:
    """Shared span write path.  ``build_span`` consumes one timespan's
    events, mutates the running ``GraphState`` forward, and writes the
    span's eventlists, hierarchy, and aux replicas to the store."""

    def __init__(self, cfg, store: DeltaStore):
        self.cfg = cfg
        self.store = store

    def _sid_of_pid(self, pid: int) -> int:
        return pid // self.cfg.parts_per_shard

    # ------------------------------------------------------------------
    # Partitioning (hash | locality), frozen per span
    # ------------------------------------------------------------------

    def partition_span(self, tsid: int, ev_span: EventLog,
                       state: GraphState) -> SlotMap:
        """SlotMap for one span: nodes alive at span start plus nodes the
        span's events touch; ``cfg.partition_strategy`` decides layout
        (the locality path applies to update/append spans too — the old
        ``TGI.update`` silently fell back to hash)."""
        cfg = self.cfg
        if len(ev_span):
            touched = np.unique(np.concatenate([
                ev_span.src, ev_span.dst[ev_span.dst >= 0], state.node_ids(),
            ]))
        else:
            touched = state.node_ids()
        touched = touched[touched >= 0]
        assignment = None
        if cfg.partition_strategy == "locality" and len(ev_span):
            nids_l, assignment = part_mod.partition_timespan(
                ev_span, cfg.n_parts, "locality", cfg.omega, seed=tsid
            )
            # locality assigns only nodes touched by edges; extend to the
            # full touched set with hash placement
            if len(nids_l) < len(touched):
                assign_full = (hash32(touched) % np.uint32(cfg.n_parts)).astype(np.int32)
                pos = np.searchsorted(touched, nids_l)
                assign_full[pos] = assignment
                assignment = assign_full
        return SlotMap.build(touched, cfg.n_parts, assignment, cfg.pad_multiple)

    # ------------------------------------------------------------------
    # Span construction
    # ------------------------------------------------------------------

    def build_span(self, sp: TimeSpan, ev_span: EventLog,
                   state: GraphState):
        """Build one span.  ``sp.ev_lo/ev_hi`` are *global* event-log
        offsets; ``ev_span`` is the span-local slice (``ev_hi - ev_lo``
        events).  Returns ``(SpanIndex, bucket_of_event)`` with
        ``bucket_of_event`` aligned to ``ev_span``; ``state`` is advanced
        to the span end in place."""
        from repro_torch.core.tgi import SpanIndex  # cycle: tgi imports ingest

        cfg = self.cfg
        n_ev = sp.ev_hi - sp.ev_lo
        assert n_ev == len(ev_span)
        smap = self.partition_span(sp.tsid, ev_span, state)
        n_buckets = max(math.ceil(n_ev / cfg.eventlist_size), 1)
        ckpt_every = max(math.ceil(n_buckets / cfg.checkpoints_per_span), 1)
        checkpoint_ts: List[int] = [sp.t_start - 1]
        leaves: List[Delta] = [state.to_delta(smap, cfg.n_attrs)]
        # aux replicas are derived from the state at the LAST checkpoint
        aux_state = state.copy() if cfg.replicate_1hop else None
        bucket_bounds: List[Tuple[int, int]] = []
        bucket_of = np.zeros(n_ev, np.int32)
        for b in range(n_buckets):
            lo = b * cfg.eventlist_size
            hi = min((b + 1) * cfg.eventlist_size, n_ev)
            bucket_bounds.append((sp.ev_lo + lo, sp.ev_lo + hi))
            bucket_of[lo:hi] = b
            ev_b = ev_span.take(slice(lo, hi))
            self._store_eventlist(sp.tsid, b, ev_b, smap)
            state.apply_bucket(ev_b)
            # checkpoints only at bucket boundaries that don't split a
            # timestamp — otherwise later same-t events would be in
            # neither the checkpoint nor the (t > t_ck) replay filter
            if ((b + 1) % ckpt_every == 0 and b + 1 < n_buckets
                    and ev_span.t[hi - 1] != ev_span.t[hi]):
                checkpoint_ts.append(int(ev_span.t[hi - 1]))
                leaves.append(state.to_delta(smap, cfg.n_attrs))
                if aux_state is not None:
                    aux_state = state.copy()
        self._store_hierarchy(sp.tsid, leaves, smap)
        if aux_state is not None:
            self._store_aux_replication(sp.tsid, aux_state, smap)
        return (
            SpanIndex(span=sp, smap=smap, checkpoint_ts=checkpoint_ts,
                      bucket_bounds=bucket_bounds),
            bucket_of,
        )

    # ------------------------------------------------------------------
    # Store emission (moved verbatim from the old TGI write path)
    # ------------------------------------------------------------------

    def _store_eventlist(self, tsid: int, bucket: int, ev: EventLog,
                         smap: SlotMap) -> None:
        """Partitioned eventlists: events replicated to both endpoints'
        shards, pid column included for micro-partition filtering."""
        if not len(ev):
            return
        pid_src, _, _ = smap.lookup(ev.src)
        pid_dst = np.full(len(ev), -1, np.int32)
        has_dst = ev.dst >= 0
        if has_dst.any():
            pid_dst[has_dst] = smap.lookup(ev.dst[has_dst])[0]
        ppl = self.cfg.parts_per_shard
        for sid in range(self.cfg.n_shards):
            in_shard = (pid_src // ppl == sid) | ((pid_dst >= 0) & (pid_dst // ppl == sid))
            idx = np.nonzero(in_shard)[0]
            if not len(idx):
                continue
            sub = ev.take(idx)
            arrays = sub.to_dict()
            arrays["pid"] = pid_src[idx] % ppl
            self.store.put(DeltaKey(tsid, sid, f"E:{bucket}", 0), arrays)

    def _delta_arrays(self, d: Delta, p: int):
        """Micro-delta = one partition slice of a Delta.  Edge runs are
        keyed by global slot, so partition p's run is a contiguous
        [p*psize, (p+1)*psize) range of the sorted e_src."""
        psize = d.valid.shape[1]
        lo = np.searchsorted(d.e_src, p * psize)
        hi = np.searchsorted(d.e_src, (p + 1) * psize)
        return {
            "valid": d.valid[p],
            "present": d.present[p],
            "attrs": d.attrs[p],
            "e_src": d.e_src[lo:hi],
            "e_dst": d.e_dst[lo:hi],
            "e_op": d.e_op[lo:hi],
            "e_val": d.e_val[lo:hi],
        }

    def _store_delta(self, tsid: int, did: str, d: Delta) -> None:
        for p in range(self.cfg.n_parts):
            sid = self._sid_of_pid(p)
            self.store.put(
                DeltaKey(tsid, sid, did, p % self.cfg.parts_per_shard),
                self._delta_arrays(d, p),
            )

    def _store_hierarchy(self, tsid: int, leaves: List[Delta],
                         smap: SlotMap) -> None:
        """DeltaGraph-style binary intersection tree; store root + all
        parent->child differences (paper §4.3b)."""
        from repro_torch.core.delta import delta_difference, delta_intersection

        level = 0
        nodes = leaves
        while len(nodes) > 1:
            parents = []
            for i in range(0, len(nodes), 2):
                if i + 1 < len(nodes):
                    parent = delta_intersection(nodes[i], nodes[i + 1])
                    self._store_delta(tsid, f"S:{level}:{i}",
                                      delta_difference(nodes[i], parent))
                    self._store_delta(tsid, f"S:{level}:{i+1}",
                                      delta_difference(nodes[i + 1], parent))
                else:
                    # odd tail: node is its own parent; store an empty diff
                    # so the root->leaf path naming stays uniform
                    parent = nodes[i]
                    self._store_delta(tsid, f"S:{level}:{i}",
                                      delta_difference(nodes[i], nodes[i]))
                parents.append(parent)
            nodes = parents
            level += 1
        self._store_delta(tsid, f"S:{level}:0", nodes[0])  # root, stored fully

    def _store_aux_replication(self, tsid: int, g: GraphState,
                               smap: SlotMap) -> None:
        """Aux micro-deltas with 1-hop external neighbors per partition."""
        src, dst, val = g.edges()
        pid_s, _, _ = smap.lookup(src)
        pid_d, _, _ = smap.lookup(dst)
        cut = pid_s != pid_d
        for p in range(self.cfg.n_parts):
            sel = cut & ((pid_s == p) | (pid_d == p))
            if not sel.any():
                continue
            self.store.put(
                DeltaKey(tsid, self._sid_of_pid(p), "X:0",
                         p % self.cfg.parts_per_shard),
                {"src": src[sel], "dst": dst[sel], "val": val[sel]},
            )
