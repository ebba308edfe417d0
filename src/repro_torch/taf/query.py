"""Unified query surface: ``HistoricalGraphStore`` + lazy ``TemporalQuery``.

One object wraps the whole stack (DeltaStore -> TGI -> TAF) and one
builder expresses every workload:

    store = HistoricalGraphStore.build(events, n_shards=4)
    ts, deg = (store.nodes(t0, t1)
                    .filter(lambda s: s.init_attrs[:, 0] == 0)
                    .node_compute(f, style="delta", f_delta=f_d)
                    .execute())

Nothing runs until ``execute()``: the chain compiles to a ``Plan``
(repro.taf.plan) whose Fetch stage carries the pushdowns — a node-set
``filter`` prunes the partitions read from storage, ``project`` drops
attribute tiles — so unneeded shards and columns are never pulled.  The
fetch cost of the last executed plan is on ``store.last_cost``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Optional, Tuple

import numpy as np

from repro_torch.core.events import EventLog
from repro_torch.core.tgi import TGI, TGIConfig, FetchCost
from repro_torch.storage.kvstore import DeltaStore
from repro_torch.taf.plan import (
    Aggregate,
    Compute,
    Evolution,
    Fetch,
    Materialize,
    Plan,
    PlanExecutor,
    PlanResult,
    Select,
    Slice,
)
from repro_torch.taf.son import SoN, SoTS


def _compile_cache_stats() -> dict:
    from repro_torch.taf import compile as taf_compile  # deferred

    return taf_compile.cache_stats()


class HistoricalGraphStore:
    """Facade over DeltaStore + TGI + TAF.

    Construction:  ``build(events, ...)`` indexes an event history into a
    fresh (or supplied) DeltaStore; ``from_tgi(tgi)`` wraps an existing
    index.  Retrieval primitives (Algorithms 1-5) pass through; temporal
    analytics start from ``nodes()`` / ``subgraphs()`` which return lazy
    TemporalQuery builders.
    """

    def __init__(self, tgi: TGI):
        self.tgi = tgi
        self.last_cost = FetchCost()  # cost of the last executed plan

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @classmethod
    def build(cls, events: EventLog, cfg: Optional[TGIConfig] = None,
              store: Optional[DeltaStore] = None, device=None,
              **cfg_kw) -> "HistoricalGraphStore":
        """Index ``events``; kernel folds and fused plans run on ``device``
        (None: the CUDA card, raising if there is none)."""
        if cfg is None:
            cfg = TGIConfig(**cfg_kw)
        elif cfg_kw:  # kwargs override fields of the supplied config
            cfg = dataclasses.replace(cfg, **cfg_kw)
        store = store or DeltaStore(m=cfg.n_shards, r=1, backend="mem")
        return cls(TGI.build(events, cfg, store, device=device))

    @classmethod
    def from_tgi(cls, tgi: TGI) -> "HistoricalGraphStore":
        return cls(tgi)

    @property
    def cfg(self) -> TGIConfig:
        return self.tgi.cfg

    @property
    def store(self) -> DeltaStore:
        return self.tgi.store

    def update(self, new_events: EventLog) -> None:
        """Append a batch of new events to the index (synchronous: every
        event is sealed into spans before this returns)."""
        self.tgi.update(new_events)

    def append(self, new_events: EventLog) -> None:
        """Streaming ingest: buffer events, sealing spans as thresholds
        are crossed (``events_per_span`` / ``cfg.span_seal_time``).
        Queries issued mid-stream stay correct — reads past the sealed
        history overlay the buffer's live events."""
        self.tgi.append(new_events)

    def flush(self) -> None:
        """Seal every buffered (appended) event into spans."""
        self.tgi.flush()

    def compact(self, min_run: int = 2, wait: bool = True):
        """Merge runs of adjacent micro-spans accreted by small
        update/append batches and GC the superseded store keys.  Runs on
        the background maintenance thread; queries and ingest keep
        serving concurrently (readers pin their epoch, the new layout
        lands in one atomic publish).  With ``wait=True`` (default)
        blocks and returns ``CompactionStats`` — the fetch cost of
        compaction's own reads lands on ``last_cost`` (its write/delete
        I/O is in the stats' byte counters); with ``wait=False`` returns
        a ``concurrent.futures.Future`` of the stats immediately."""
        out = self.tgi.compact(min_run=min_run, wait=wait)
        if wait:
            self.last_cost = out.cost
        return out

    def read_guard(self):
        """Pin the current read epoch for a block of multiple reads (see
        ``TGI.read_guard``): every query inside observes one immutable
        layout, regardless of concurrent ingest or compaction."""
        return self.tgi.read_guard()

    def time_range(self) -> Tuple[int, int]:
        return self.tgi.time_range()

    def index_size_bytes(self) -> int:
        return self.tgi.index_size_bytes()

    def storage_report(self) -> dict:
        """Index size by component (eventlists / hierarchy / aux
        replicas), raw vs. encoded — see ``TGI.storage_report``."""
        return self.tgi.storage_report()

    # ------------------------------------------------------------------
    # Retrieval primitives (paper Algorithms 1-5)
    # ------------------------------------------------------------------

    def snapshot(self, t: int, c: int = 1, **kw):
        with self.tgi.cost_scope() as acc:
            g = self.tgi.get_snapshot(t, c=c, **kw)
        self.last_cost = acc
        return g

    def snapshots(self, ts, c: int = 1, **kw):
        """Batched Algorithm 1: snapshots at every t in ``ts``, sharing
        the hierarchy-path and eventlist fetches per (span, checkpoint)
        group (see ``TGI.get_snapshots``)."""
        with self.tgi.cost_scope() as acc:
            gs = self.tgi.get_snapshots(ts, c=c, **kw)
        self.last_cost = acc
        return gs

    def node_history(self, nid: int, t0: int, t1: int, c: int = 1):
        # cost_scope: these retrievals issue several get_* calls, each of
        # which resets tgi.last_cost — the scope totals the whole query
        with self.tgi.cost_scope() as acc:
            out = self.tgi.get_node_history(nid, t0, t1, c=c)
        self.last_cost = acc
        return out

    def k_hop(self, nid: int, t: int, k: int, c: int = 1, method: str = "auto"):
        """Algorithms 3/4.  ``method="auto"`` is cost-based: it compares
        the physical raw bytes a full-snapshot fetch vs an expanding
        partition fetch would decode (real stored sizes, discounted by
        decoded-block-pool residency) — see ``explain_k_hop``."""
        with self.tgi.cost_scope() as acc:
            g = self.tgi.get_k_hop(nid, t, k, c=c, method=method)
        self.last_cost = acc
        return g

    def explain_k_hop(self, nid: int, t: int, k: int) -> dict:
        """The byte estimates behind ``k_hop(method="auto")``."""
        return self.tgi.explain_k_hop(nid, t, k)

    def cache_stats(self) -> dict:
        """Caching-layers overview (see docs/api.md): the snapshot LRU
        (whole reconstructed snapshots), the plan-layer fetch cache
        (operands shared across plans), the executor's replay cache
        (timeslices of one operand), and the storage-layer decoded-block
        pool (columns shared across everything above)."""
        return {
            "snapshot_lru_entries": len(self.tgi._snap_cache),
            "fetch_cache_entries": len(PlanExecutor._fetch_cache),
            "replay_cache_entries": len(PlanExecutor._replay_cache),
            "block_pool": self.store.pool_stats(),
            # replica-level resilience counters (nonzero only when a
            # storage node was down or unreachable during reads)
            "failovers": self.store.stats.failovers,
            "hedged_reads": self.store.stats.hedged_reads,
            # wire-transport view: mux in-flight depth + pipelined/
            # serial round-trip counters ({} for local backends)
            "transport": self.store.transport_stats(),
            "plan_compile": _compile_cache_stats(),
            # MVCC observability: the published epoch, who's pinned
            # below it, and how many superseded keys await GC
            "read_epoch": self.tgi.read_epoch,
            "pinned_epochs": self.tgi.pinned_epochs(),
            "gc_pending_keys": self.store.gc_pending(),
        }

    def node_1hop_history(self, nid: int, t0: int, t1: int, c: int = 1):
        with self.tgi.cost_scope() as acc:
            out = self.tgi.get_node_1hop_history(nid, t0, t1, c=c)
        self.last_cost = acc
        return out

    # ------------------------------------------------------------------
    # Lazy query surface
    # ------------------------------------------------------------------

    def nodes(self, t0: int, t1: int, c: int = 1) -> "TemporalQuery":
        """Lazy SoN query over the interval [t0, t1)."""
        return TemporalQuery(store=self, t0=t0, t1=t1, c=c)

    def subgraphs(self, t0: int, t1: int, c: int = 1) -> "TemporalQuery":
        """Lazy SoTS query (1-hop star subgraphs) — ``nodes().khop(1)``."""
        return self.nodes(t0, t1, c=c).khop(1)

    # ------------------------------------------------------------------
    # Analytics conveniences (the paper's worked examples)
    # ------------------------------------------------------------------

    def max_lcc(self, t0: int, t1: int, t: Optional[int] = None):
        from repro_torch.taf import analytics

        sots = self.subgraphs(t0, t1).materialize().operand
        return analytics.max_lcc(sots, t)

    def density_evolution(self, t0: int, t1: int, n_samples: int = 10):
        from repro_torch.taf import analytics

        sots = self.subgraphs(t0, t1).materialize().operand
        return analytics.density_evolution(sots, n_samples=n_samples,
                                           device=self.tgi.device)

    def pagerank_over_time(self, t0: int, t1: int, points, **kw):
        from repro_torch.taf import analytics

        sots = self.subgraphs(t0, t1).materialize().operand
        return analytics.pagerank_over_time(sots, points, **kw)


@dataclasses.dataclass(frozen=True)
class TemporalQuery:
    """Lazy, composable temporal query.

    Built from ``store.nodes()/subgraphs()`` (fetched at execute time,
    with pushdown) or ``TemporalQuery.over(operand)`` (already-fetched
    SoN/SoTS).  Fused stages run on ``device`` (None: the store's
    device, else the CUDA card).  Builder methods return new queries;
    ``plan()`` compiles the chain; ``execute()`` runs it and returns the
    value; ``run()`` additionally returns fetch cost + operand
    (PlanResult).
    """

    store: Optional[HistoricalGraphStore] = None
    t0: int = 0
    t1: int = 0
    c: int = 1
    subgraph: bool = False
    node_ids: Optional[Tuple[int, ...]] = None  # pushdown selection
    projection: Optional[Tuple[str, ...]] = None  # pushdown projection
    operand: Optional[SoN] = None  # materialized source (no fetch)
    stages: Tuple[Any, ...] = ()  # post-source stages
    device: Any = None  # where fused stages run

    # ------------------------------------------------------------------
    # Sources
    # ------------------------------------------------------------------

    @classmethod
    def over(cls, operand: SoN, device=None) -> "TemporalQuery":
        """Query over an in-memory operand (zero fetch cost)."""
        return cls(operand=operand, t0=operand.t0, t1=operand.t1,
                   subgraph=isinstance(operand, SoTS), device=device)

    # ------------------------------------------------------------------
    # Builder methods (each returns a new query)
    # ------------------------------------------------------------------

    def _with(self, **kw) -> "TemporalQuery":
        return dataclasses.replace(self, **kw)

    def _append(self, stage) -> "TemporalQuery":
        return self._with(stages=self.stages + (stage,))

    def filter(self, pred: Optional[Callable[[SoN], np.ndarray]] = None, *,
               node_ids: Optional[Iterable[int]] = None,
               label: str = "λ") -> "TemporalQuery":
        """Selection (operator 1).  ``pred`` is a vectorized callable
        son -> bool mask; ``node_ids`` is a structured node-set predicate
        that the compiler pushes down into the fetch (partition pruning),
        so unneeded shards are never read."""
        q = self
        if node_ids is not None:
            ids = tuple(int(i) for i in np.asarray(list(node_ids)).ravel())
            if q.operand is not None or q.stages:
                # too late to push below the fetch — apply as a Select
                arr = np.asarray(ids, np.int32)
                q = q._append(Select(
                    lambda s, _a=arr: np.isin(s.node_ids, _a),
                    label=f"node_ids({len(ids)})"))
            else:
                merged = ids if q.node_ids is None else tuple(
                    sorted(set(q.node_ids) & set(ids)))
                q = q._with(node_ids=merged)
        if pred is not None:
            q = q._append(Select(pred, label=label))
        return q

    def khop(self, k: int = 1) -> "TemporalQuery":
        """Expand the operand to k-hop star subgraphs (SoTS).  Must come
        before any timeslice/compute — adjacency is part of the fetch."""
        if k != 1:
            raise ValueError("k-hop SoTS composes 1-hop stars (paper §5.1)")
        if self.operand is not None:
            if not isinstance(self.operand, SoTS):
                raise ValueError("operand-backed query cannot add adjacency; "
                                 "fetch with subgraphs()/build_sots instead")
            return self
        if any(s.kind != "select" for s in self.stages):
            raise ValueError("khop() must precede timeslice/compute stages")
        return self._with(subgraph=True)

    def project(self, attrs: bool = True) -> "TemporalQuery":
        """Attribute projection pushdown: ``project(attrs=False)`` skips
        the attrs tiles at fetch time (init_attrs will read as unset)."""
        proj = ("attrs",) if attrs else ()
        return self._with(projection=proj)

    def timeslice(self, ts) -> "TemporalQuery":
        """Operator 2.  Standalone it yields the sliced state dict; before
        a node_compute it pins the compute's evaluation point(s)."""
        return self._append(Slice(ts))

    def node_compute(self, fn: Callable, style: str = "static",
                     f_delta: Optional[Callable] = None, points=None,
                     t: Optional[int] = None, mesh=None,
                     label: Optional[str] = None) -> "TemporalQuery":
        """Operators 4-6 (style = static | temporal | delta) or a torch
        kernel over the padded operand on the query's device, sharded over
        the workers of ``mesh`` when one is given (style = kernel,
        ``taf/exec.py``)."""
        return self._append(Compute(fn=fn, style=style, f_delta=f_delta,
                                    points=points, t=t, mesh=mesh, label=label))

    def evolution(self, fn: Callable, points=None,
                  n_samples: int = 10) -> "TemporalQuery":
        """Operator 8: scalar fn(son, t) sampled over time."""
        return self._append(Evolution(fn=fn, points=points, n_samples=n_samples))

    def aggregate(self, op: str) -> "TemporalQuery":
        """Operator 9 over the preceding stage's series."""
        return self._append(Aggregate(op))

    # ------------------------------------------------------------------
    # Compile & run
    # ------------------------------------------------------------------

    def plan(self) -> Plan:
        """Compile the chain into a validated Plan.  Pushdowns (node-set
        selection, projection) are already on the source; a Slice that
        only pins evaluation points is fused into the following Compute."""
        if self.operand is not None:
            source: Any = Materialize(self.operand)
        else:
            source = Fetch(t0=self.t0, t1=self.t1, subgraph=self.subgraph,
                           node_ids=self.node_ids, projection=self.projection,
                           c=self.c)
        stages = [source]
        pending = list(self.stages)
        i = 0
        while i < len(pending):
            s = pending[i]
            nxt = pending[i + 1] if i + 1 < len(pending) else None
            if (s.kind == "slice" and nxt is not None and nxt.kind == "compute"
                    and nxt.points is None and nxt.t is None):
                # fuse: the slice's timepoint(s) become the compute's
                # evaluation points (one pass instead of two)
                ts = np.atleast_1d(np.asarray(s.ts)).astype(np.int64)
                if nxt.style == "kernel":
                    raise ValueError(
                        "timeslice cannot pin evaluation points for a "
                        'style="kernel" compute; bake t into the kernel')
                if nxt.style == "static":
                    if ts.size != 1:
                        raise ValueError(
                            "timeslice with multiple points needs "
                            'style="temporal" or "delta", not "static"')
                    fused = dataclasses.replace(nxt, t=int(ts[0]))
                else:
                    fused = dataclasses.replace(nxt, points=ts)
                stages.append(fused)
                i += 2
                continue
            stages.append(s)
            i += 1
        return Plan(tuple(stages)).validate()

    def explain(self) -> str:
        return self.plan().describe()

    def run(self) -> PlanResult:
        """Compile + execute; returns PlanResult (value, cost, operand)."""
        tgi = self.store.tgi if self.store is not None else None
        result = PlanExecutor(tgi, device=self.device).run(self.plan())
        if self.store is not None:
            self.store.last_cost = result.cost
        return result

    def execute(self) -> Any:
        """Compile + execute; returns the result value."""
        return self.run().value

    def materialize(self) -> "TemporalQuery":
        """Execute the fetch/select prefix now and return a query over the
        materialized operand — reuse one fetch across many computes."""
        n_prefix = 0
        for s in self.stages:
            if s.kind != "select":
                break
            n_prefix += 1
        prefix = self._with(stages=self.stages[:n_prefix])
        result = prefix.run()
        device = self.device
        if device is None and self.store is not None:
            device = self.store.tgi.device
        return dataclasses.replace(
            TemporalQuery.over(result.operand, device=device),
            stages=self.stages[n_prefix:], store=self.store)
