"""Compiled query plans over the TAF (the Kairos-style plan seam).

A lazy ``TemporalQuery`` (repro.taf.query) compiles into a ``Plan`` — a
linear chain of typed stages — and one ``PlanExecutor`` runs it:

* ``Fetch``       — SoN/SoTS retrieval from the TGI with the planner's
                    pushdowns applied: partition pruning (a node-set
                    selection fetches only the covering pids) and
                    attribute projection (attrs tiles skipped when no
                    stage reads them).  Cost is accounted per plan via
                    ``TGI.cost_scope``.
* ``Materialize`` — start from an operand already in memory (the shim
                    path for the legacy free functions).
* ``Select``      — entity-centric filter (operator 1).
* ``Slice``       — timeslice (operator 2); folded into a following
                    Compute when it only pins the evaluation points.
* ``Compute``     — NodeCompute/NodeComputeTemporal/NodeComputeDelta
                    (operators 4-6) on the vectorized numpy path, or a
                    torch kernel over the padded operand on the
                    executor's device (style="kernel", ``taf/exec.py``).
* ``Evolution``   — aggregate quantity over time (operator 8).
* ``Aggregate``   — temporal aggregation (operator 9).

Keeping the chain declarative until ``execute()`` is what lets fetch see
the whole query: selection and projection push below the storage reads,
and later PRs can fuse/cache/re-target stages without touching callers.

Multi-timepoint stages (a Slice with several ts, Compute(points=...),
Evolution) execute on the batched replay engine (repro.taf.replay): one
sorted-event pass over the operand serves every timepoint.  The executor
additionally keeps a small LRU of replayed timeslices keyed on
(operand identity, timepoints), so repeated slices of one operand cost
one replay total.

Plan selection is cost-based at run time: the Fetch stage re-decides
partition pruning against the TGI's byte estimates (real stored sizes
discounted by decoded-block-pool residency) and the snapshot LRU, and a
cross-plan fetch cache shares one fetched operand between plans over
the same interval/pushdowns (invalidated by ``TGI.read_epoch`` bumps).
``PlanResult.notes`` records every runtime decision.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import weakref
from typing import Any, Callable, Optional, Tuple

import numpy as np

from repro_torch import device as dev
from repro_torch.core.tgi import FetchCost
from repro_torch.taf import exec as taf_exec
from repro_torch.taf import operators as ops
from repro_torch.taf import replay
from repro_torch.taf.son import SoN, build_son, build_sots


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Fetch:
    """Pull the operand from the TGI.  ``node_ids`` is the pushed-down
    node selection (None = all nodes at t0); ``projection`` the optional
    payload fields to read (None = everything)."""

    t0: int
    t1: int
    subgraph: bool = False
    node_ids: Optional[Tuple[int, ...]] = None
    projection: Optional[Tuple[str, ...]] = None
    c: int = 1
    kind = "fetch"

    def describe(self) -> str:
        bits = [f"t0={self.t0}", f"t1={self.t1}",
                "operand=SoTS" if self.subgraph else "operand=SoN"]
        if self.node_ids is not None:
            bits.append(f"nodes={len(self.node_ids)} (pruned)")
        if self.projection is not None:
            bits.append(f"projection={list(self.projection)}")
        if self.c != 1:
            bits.append(f"c={self.c}")
        return f"Fetch[{', '.join(bits)}]"


@dataclasses.dataclass(frozen=True)
class Materialize:
    """Operand already in memory (no storage reads, zero fetch cost)."""

    operand: SoN
    kind = "materialize"

    def describe(self) -> str:
        name = type(self.operand).__name__
        return f"Materialize[{name}, n={len(self.operand)}]"


@dataclasses.dataclass(frozen=True)
class Select:
    """Operator 1: pred(son) -> bool mask over nodes."""

    pred: Callable[[SoN], np.ndarray]
    label: str = "λ"
    kind = "select"

    def describe(self) -> str:
        return f"Select[{self.label}]"


@dataclasses.dataclass(frozen=True)
class Slice:
    """Operator 2: state at time(s) ts."""

    ts: Any
    kind = "slice"

    def describe(self) -> str:
        return f"Slice[ts={self.ts}]"


@dataclasses.dataclass(frozen=True)
class Compute:
    """Operators 4-6 / device kernels.

    style: "static" (one timepoint) | "temporal" (O(N·T) re-eval) |
    "delta" (O(N+T) incremental; needs f_delta) | "kernel" (vectorized
    torch kernel run on the executor's device, or over the ranks of a
    ``("workers",)`` DeviceMesh, ``mesh``: see ``taf/exec.py``).
    """

    fn: Callable
    style: str = "static"
    f_delta: Optional[Callable] = None
    points: Any = None
    t: Optional[int] = None
    mesh: Any = None
    label: Optional[str] = None
    kind = "compute"

    def describe(self) -> str:
        backend = "torch" if self.style == "kernel" else "numpy"
        name = self.label or getattr(self.fn, "__name__", "f")
        return f"Compute[{name}, style={self.style}, backend={backend}]"


@dataclasses.dataclass(frozen=True)
class Evolution:
    """Operator 8: scalar f(son, t) sampled over time."""

    fn: Callable
    points: Any = None
    n_samples: int = 10
    kind = "evolution"

    def describe(self) -> str:
        name = getattr(self.fn, "__name__", "f")
        return f"Evolution[{name}, n_samples={self.n_samples}]"


@dataclasses.dataclass(frozen=True)
class Aggregate:
    """Operator 9 over the preceding stage's timeseries."""

    op: str
    kind = "aggregate"

    def describe(self) -> str:
        return f"Aggregate[{self.op}]"


SOURCE_KINDS = ("fetch", "materialize")
TERMINAL_KINDS = ("slice", "compute", "evolution")


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Plan:
    stages: Tuple[Any, ...]

    @property
    def kinds(self) -> Tuple[str, ...]:
        return tuple(s.kind for s in self.stages)

    def validate(self) -> "Plan":
        kinds = self.kinds
        if not kinds or kinds[0] not in SOURCE_KINDS:
            raise ValueError("plan must start with a Fetch/Materialize stage")
        if sum(k in SOURCE_KINDS for k in kinds) != 1:
            raise ValueError("plan must have exactly one source stage")
        seen_terminal = False
        seen_series = False  # compute/evolution produce an aggregatable series
        for k in kinds[1:]:
            if k in SOURCE_KINDS:
                raise ValueError("source stage must come first")
            if k == "select" and seen_terminal:
                raise ValueError("Select must precede Slice/Compute/Evolution")
            if k in TERMINAL_KINDS:
                if seen_terminal:
                    raise ValueError("only one Slice/Compute/Evolution per plan")
                seen_terminal = True
                seen_series = k in ("compute", "evolution")
            if k == "aggregate" and not seen_series:
                raise ValueError("Aggregate needs a preceding Compute/Evolution "
                                 "(a bare Slice yields a state dict, not a series)")
        return self

    def describe(self) -> str:
        return "Plan\n" + "\n".join(f"  {s.describe()}" for s in self.stages)


@dataclasses.dataclass
class PlanResult:
    value: Any
    cost: FetchCost
    operand: Optional[SoN]
    plan: Plan
    # runtime plan-selection decisions (cost-based fetch choices, fetch-
    # cache hits) — what ``explain()`` could not know at compile time
    notes: Tuple[str, ...] = ()


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


class PlanExecutor:
    """Runs a Plan: one fetch (pushdowns applied + runtime cost-based
    source selection), then vectorized host operators or one fused
    device program over the operand, on ``device`` (None: the TGI's
    device, else the CUDA card)."""

    # shared across executors: TemporalQuery.run() builds a fresh
    # executor per plan, but repeated slices of one materialized operand
    # should still hit the cache
    _replay_cache = replay.ReplayCache(maxsize=32)

    # cross-plan fetch sharing: plans over the same (tgi, interval,
    # pushdowns) reuse one fetched operand — multi-timepoint plans that
    # hit the same (span, leaf) groups pay one fetch total (finer
    # cross-plan sharing, different t in the same span, is the decoded-
    # block pool's job one layer down).  Entries key on TGI.read_epoch,
    # so any ingest/compaction invalidates them; the weakref guards
    # against id() recycling.  Logical FetchCost is replayed on hits.
    FETCH_CACHE_MAX = 8
    _fetch_cache: "collections.OrderedDict" = collections.OrderedDict()
    # the cache is class-level and executors run on arbitrary query
    # threads: every probe/insert holds this lock (entries are immutable
    # once inserted, so readers only need the dict ops protected)
    _fetch_lock = threading.Lock()

    def __init__(self, tgi=None, device=None):
        self.tgi = tgi
        if device is None and tgi is not None:
            device = tgi.device
        self.device = dev.resolve(device)

    @classmethod
    def clear_fetch_cache(cls) -> None:
        with cls._fetch_lock:
            cls._fetch_cache.clear()

    def run(self, plan: Plan) -> PlanResult:
        plan.validate()
        operand: Optional[SoN] = None
        value: Any = None
        cost = FetchCost()
        notes: Tuple[str, ...] = ()
        for stage in plan.stages:
            k = stage.kind
            if k == "fetch":
                operand, cost, notes = self._fetch(stage)
                value = operand
            elif k == "materialize":
                operand = stage.operand
                value = operand
            elif k == "select":
                operand = ops.selection(operand, stage.pred)
                value = operand
            elif k in TERMINAL_KINDS:
                value, tnotes = self._terminal(operand, stage)
                notes = notes + tnotes
            elif k == "aggregate":
                value = self._aggregate(value, stage.op)
            else:  # pragma: no cover
                raise ValueError(f"unknown stage kind {k!r}")
        return PlanResult(value=value, cost=cost, operand=operand, plan=plan,
                          notes=notes)

    # ---- stage implementations ----

    def _terminal(self, operand: SoN, stage) -> Tuple[Any, Tuple[str, ...]]:
        """Run the terminal stage: whole-plan-compiled when the shape is
        covered (repro_torch.taf.compile, one device program), staged
        otherwise.  Notes record which path ran and why."""
        from repro_torch.taf import compile as taf_compile  # deferred: light plans

        value, cnotes = taf_compile.try_fused(
            operand, stage, replay_cache=self._replay_cache,
            device=self.device)
        if value is not taf_compile.MISS:
            return value, cnotes
        taf_compile.STATS["fallback_runs"] += 1
        if stage.kind == "slice":
            return self._timeslice_cached(operand, stage.ts), cnotes
        if stage.kind == "compute":
            return self._compute(operand, stage), cnotes
        return ops.evolution(operand, stage.fn, points=stage.points,
                             n_samples=stage.n_samples), cnotes

    def _timeslice_cached(self, son: SoN, ts) -> Any:
        """Operator 2 through the executor's LRU: a repeated slice of the
        same operand at the same timepoint(s) replays zero events."""
        if np.isscalar(ts):
            tkey: Tuple = ("scalar", int(ts))
        else:
            tkey = ("multi", tuple(int(x) for x in np.asarray(ts).ravel()))
        key = (replay.operand_key(son), tkey)
        hit = self._replay_cache.get(key, owner=son)
        if hit is None:
            hit = ops.timeslice(son, ts)
            self._replay_cache.put(key, hit, owner=son)
        # hand out copies: callers may mutate their result in place, and
        # that must not poison the cached arrays
        return {k: (v.copy() if isinstance(v, np.ndarray) else v)
                for k, v in hit.items()}

    def _fetch(self, stage: Fetch) -> Tuple[SoN, FetchCost, Tuple[str, ...]]:
        if self.tgi is None:
            raise ValueError("Fetch stage requires a TGI-backed executor")
        # one read guard around source selection + cache probe + build:
        # every read (cost estimate, snapshot, event replay) sees the
        # same pinned epoch, and the cache key carries that epoch — a
        # concurrent maintenance publish can neither tear the operand
        # nor serve it to a reader of a different epoch
        with self.tgi.read_guard() as _view:
            return self._fetch_guarded(stage, _view)

    def _fetch_guarded(self, stage: Fetch, view,
                       ) -> Tuple[SoN, FetchCost, Tuple[str, ...]]:
        node_ids = None
        pids = None
        notes = []
        if stage.node_ids is not None:
            node_ids = np.unique(np.asarray(stage.node_ids, np.int32))
            pids = self.tgi.pids_for_nodes(node_ids, stage.t0)
            # cost-based source selection: compile-time pushdown said
            # "prune", but runtime state can beat it —
            # (a) the selection covers every partition: pruning buys
            #     nothing and costs the eventlist re-filter;
            # (b) a warm full snapshot sits in the snapshot LRU and the
            #     pruned keys are mostly cold (pool-discounted byte
            #     estimate): the LRU hit costs zero storage bytes while
            #     the pruned read would pay real decodes.
            if len(pids) >= self.tgi.cfg.n_parts:
                pids = None
                notes.append("fetch: pruned->full (selection covers "
                             "every partition)")
            elif self.tgi.has_cached_snapshot(stage.t0, stage.projection,
                                              stage.c):
                est = self.tgi.estimate_fetch_cost(stage.t0, pids)
                if est["physical_raw_bytes"] > 0.5 * max(est["raw_bytes"], 1):
                    pids = None
                    notes.append(
                        "fetch: pruned->full (warm snapshot LRU beats a "
                        f"mostly-cold pruned read of "
                        f"~{int(est['physical_raw_bytes'])}B)")
        notes.append(f"fetch: pinned read epoch {view.epoch}")
        ck = (id(self.tgi), view.epoch, stage.t0, stage.t1,
              stage.subgraph, stage.node_ids, stage.projection, stage.c,
              None if pids is None else tuple(pids))
        with self._fetch_lock:
            hit = self._fetch_cache.get(ck)
            if hit is not None and hit[0]() is self.tgi:
                self._fetch_cache.move_to_end(ck)
                hit_operand, hit_cost = hit[1], hit[2].copy()
            else:
                hit = None
        if hit is not None:
            notes.append("fetch: shared across plans (fetch-cache hit, "
                         "logical cost replayed)")
            return hit_operand, hit_cost, tuple(notes)
        build = build_sots if stage.subgraph else build_son
        with self.tgi.cost_scope() as acc:
            operand = build(self.tgi, stage.t0, stage.t1, node_ids=node_ids,
                            c=stage.c, pids=pids, projection=stage.projection)
        if node_ids is not None:
            # parity with the post-fetch Select spelling: the query's node
            # universe is the t0 snapshot, so drop requested ids that are
            # not alive at t0 (build_son materializes them regardless)
            operand = operand.subset(np.nonzero(operand.init_present == 1)[0])
        with self._fetch_lock:
            self._fetch_cache[ck] = (weakref.ref(self.tgi), operand,
                                     acc.copy())
            while len(self._fetch_cache) > self.FETCH_CACHE_MAX:
                self._fetch_cache.popitem(last=False)
        return operand, acc, tuple(notes)

    def _compute(self, son: SoN, stage: Compute) -> Any:
        if stage.style == "static":
            return ops.node_compute(son, stage.fn, t=stage.t)
        if stage.style == "temporal":
            return ops.node_compute_temporal(son, stage.fn, points=stage.points)
        if stage.style == "delta":
            if stage.f_delta is None:
                raise ValueError('style="delta" requires f_delta')
            return ops.node_compute_delta(son, stage.fn, stage.f_delta,
                                          points=stage.points)
        if stage.style == "kernel":
            return taf_exec.sharded_node_compute(son, stage.fn, mesh=stage.mesh,
                                                 device=self.device)
        raise ValueError(f"unknown compute style {stage.style!r}")

    @staticmethod
    def _aggregate(value: Any, op: str) -> Any:
        if isinstance(value, tuple) and len(value) == 2:
            ts, series = value
            series = np.asarray(series)
            if series.ndim == 2:  # (N, T) node series -> per-node reduction
                if op not in ("max", "min", "mean", "sum", "std"):
                    raise ValueError(
                        f"aggregate {op!r} needs a scalar timeseries; "
                        "got per-node series")
                return getattr(series, op)(axis=1)
            return ops.temp_aggregate(series, op, t=np.asarray(ts))
        return ops.temp_aggregate(np.asarray(value), op)
