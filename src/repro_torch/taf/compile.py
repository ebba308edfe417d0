"""Whole-plan compilation: one device program per temporal query.

The staged ``PlanExecutor`` crosses the host/device boundary per stage; a
T-point temporal query pays a Python loop (or at best one numpy pass)
per operator.  This module lowers the terminal stage of a validated Plan
— ``Slice`` / ``Compute`` / ``Evolution`` — into ONE PyTorch device program
over the batched-replay arrays:

* ``Slice([t1..tT])``                — the device ``state_at_many``: per-
  node presence/attrs at every timepoint from ``SoN.padded_events()``
  (searchsorted + cumulative last-write index per row), bit-identical to
  the host replay engine;
* ``Compute(style="temporal", fn=<FusedOp>)`` — the temporal-analytics
  kernel family (``pagerank``/``components``/``triangles``) over
  ``EdgeReplay``'s pair table, exported once per operand via
  ``EdgeReplay.device_export()`` and kept device-resident;
* ``Evolution(fn=<FusedScalarOp>)``  — the same per-node programs with a
  per-timepoint reduction folded into the program.

Programs are cached keyed on plan *shape* — stage kind, op identity and
static params, operand array shapes/dtypes, device, and T — so repeated
queries re-trace zero times (``STATS["traces"]`` counts program builds;
tests assert cache hits).  Uncovered plan shapes fall
back transparently to the staged executor; ``PlanResult.notes`` records
which path ran and why.

Every ``FusedOp`` carries a numpy ``host`` implementation with identical
semantics — it IS the staged path for the same plan (the op is a
vectorized temporal compute fn), which is what the randomized parity
tests compare against: bit-identical for the integer-valued ops
(components, triangles, slice), float32-vs-float64 tolerance for
PageRank (documented in docs/api.md).

Aggregate runs as a host epilogue over the device series (the staged
``_aggregate`` code verbatim), keeping aggregated results bit-identical
between paths; the T-point temporal body is the single device dispatch.

Every program runs on the executor's device: the CUDA card by default
(the triangle program through the hand-written ``temporal_motif`` kernel,
the rest as PyTorch ops), or the CPU when the caller asks for it.
Timestamps stay int64 on the device; the pad slots carry int64-max, which
sorts after every real timestamp as the reference's re-sentineled pads do.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import device as dev
from repro_torch.core.events import NATTR_SET, NODE_ADD, NODE_DEL
from repro_torch.kernels.temporal_motif import ops as motif_ops
from repro_torch.taf import operators as ops
from repro_torch.taf import replay
from repro_torch.taf.son import SoN, SoTS

# sentinel distinguishing "not covered -> run staged" from a fused value
MISS = object()

# fuse a terminal Slice only past this many timepoints: below it the host
# numpy replay wins and the executor's replay LRU already dedups repeats
MIN_FUSE_T = 16

# dense-adjacency budget (elements) for the triangle program: T*N^2 above
# this falls back to the staged path rather than materializing the stack
DENSE_BUDGET = 64_000_000

ENABLED = True

STATS: Dict[str, int] = {
    "traces": 0,           # program builds (cache misses)
    "compile_hits": 0,     # program served from the compile cache
    "compile_misses": 0,
    "fused_runs": 0,
    "fallback_runs": 0,
    "operand_uploads": 0,  # device-resident operand exports built
}

_PROGRAM_CACHE_MAX = 64
_programs: "OrderedDict[Tuple, Any]" = OrderedDict()

# device-resident operand arrays, keyed (operand_key(son), flavor, device) and
# weakref-guarded against id() recycling like the executor's ReplayCache
_operands = replay.ReplayCache(maxsize=16)


def clear_cache() -> None:
    _programs.clear()
    _operands.clear()


def cache_stats() -> Dict[str, int]:
    return dict(STATS, programs=len(_programs), operands=len(_operands))


@contextlib.contextmanager
def disabled():
    """Force the staged executor path (tests / staged-vs-fused benches)."""
    global ENABLED
    prev, ENABLED = ENABLED, False
    try:
        yield
    finally:
        ENABLED = prev


# ---------------------------------------------------------------------------
# Fused ops: host semantics + device lowering under one object
# ---------------------------------------------------------------------------


def _host_edges(sots: SoTS, ts, present) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
    """Canonical undirected edge list + per-timepoint liveness (host).

    Edges join member *rows* (non-member neighbors drop out, self-loops
    drop out); the two directed pair rows of one undirected edge are
    OR-folded.  An edge is live at t iff its pair exists and BOTH
    endpoints are present.  The device programs implement the identical
    semantics from ``EdgeReplay.device_export()``.
    """
    N, T = present.shape
    er = replay.edge_replay(sots)
    exist = er.exist_matrix(ts)  # (P, T)
    v = replay.member_rows(er.pair_other, sots.node_ids)
    u = er.pair_center.astype(np.int64)
    valid = (v >= 0) & (u != v)
    cu = np.minimum(u[valid], v[valid].astype(np.int64))
    cv = np.maximum(u[valid], v[valid].astype(np.int64))
    key = cu * max(N, 1) + cv
    uniq, inv = (np.unique(key, return_inverse=True) if len(key)
                 else (np.empty(0, np.int64), np.empty(0, np.int64)))
    live = np.zeros((len(uniq), T), bool)
    if len(uniq):
        np.logical_or.at(live, inv, exist[valid] == 1)
    eu = (uniq // max(N, 1)).astype(np.int64)
    ev = (uniq % max(N, 1)).astype(np.int64)
    live &= (present[eu] == 1) & (present[ev] == 1)
    return eu, ev, live


class FusedOp:
    """A temporal-analytics op the plan compiler can lower.

    Doubles as a vectorized temporal compute fn: the staged executor
    calls ``__call__(present, attrs, son, t)`` (numpy, the reference
    semantics); the compiler recognizes the instance and runs
    ``device()`` inside one device program instead.
    """

    vectorized = True
    name = "fused"

    def params(self) -> Tuple:
        return ()

    def __call__(self, present, attrs, son, t, **kw):
        ts = np.atleast_1d(np.asarray(t, np.int64))
        present = np.asarray(present).reshape(len(son), len(ts))
        return self.host(son, ts, present)

    def host(self, sots: SoTS, ts, present) -> np.ndarray:
        raise NotImplementedError

    def device(self, arrs, act, live):
        """(N, T) series from device tensors: ``act (N, T)`` f32 presence,
        ``live (E, T)`` f32 edge liveness, ``arrs`` the operand export."""
        raise NotImplementedError


class PageRankOp(FusedOp):
    """Temporal PageRank: damped power iteration (fixed ``iters``,
    uniform dangling-mass redistribution, inactive nodes pinned to 0)
    per timepoint.  Host math runs in float64, the device program in
    float32 — parity within documented tolerance."""

    name = "pagerank"

    def __init__(self, damping: float = 0.85, iters: int = 20):
        self.damping = float(damping)
        self.iters = int(iters)

    def params(self):
        return (self.damping, self.iters)

    def host(self, sots, ts, present):
        u, v, live = _host_edges(sots, ts, present)
        N, T = present.shape
        out = np.zeros((N, T))
        for j in range(T):
            m = live[:, j]
            uj, vj = u[m], v[m]
            act = (present[:, j] == 1).astype(np.float64)
            n = max(act.sum(), 1.0)
            deg = np.zeros(N)
            np.add.at(deg, uj, 1.0)
            np.add.at(deg, vj, 1.0)
            r = act / n
            dmask = act * (deg == 0)
            for _ in range(self.iters):
                contrib = np.where(deg > 0, r / np.maximum(deg, 1.0), 0.0)
                nxt = np.zeros(N)
                np.add.at(nxt, vj, contrib[uj])
                np.add.at(nxt, uj, contrib[vj])
                dangling = float((r * dmask).sum())
                r = act * ((1.0 - self.damping) / n
                           + self.damping * (nxt + dangling / n))
            out[:, j] = r
        return out

    def device(self, arrs, act, live):
        frow, fcol, feid = arrs["frow"], arrs["fcol"], arrs["feid"]
        live2 = live[feid]  # (2E, T) contiguous rows
        deg = torch.zeros_like(act).index_add_(0, frow, live2)
        n = act.sum(dim=0, keepdim=True).clamp_min(1.0)
        r = act / n
        dmask = act * (deg == 0).to(torch.float32)
        for _ in range(self.iters):
            contrib = torch.where(deg > 0, r / deg.clamp_min(1.0), 0.0)
            nxt = torch.zeros_like(act).index_add_(0, frow,
                                                   contrib[fcol] * live2)
            dangling = (r * dmask).sum(dim=0, keepdim=True)
            r = act * ((1.0 - self.damping) / n
                       + self.damping * (nxt + dangling / n))
        return r  # (N, T) f32


class ComponentsOp(FusedOp):
    """Temporal connected components: bounded min-label propagation
    (``iters`` rounds; exact for components of diameter <= iters).
    Labels are min member-row indices, -1 on absent nodes — integer, so
    host and device are bit-identical."""

    name = "components"

    def __init__(self, iters: int = 32):
        self.iters = int(iters)

    def params(self):
        return (self.iters,)

    def host(self, sots, ts, present):
        u, v, live = _host_edges(sots, ts, present)
        N, T = present.shape
        act = present == 1
        labels = np.where(act, np.arange(N, dtype=np.int64)[:, None], N)
        for _ in range(self.iters):
            lu = np.where(live, labels[u], N)
            lv = np.where(live, labels[v], N)
            new = labels.copy()
            if len(u):
                np.minimum.at(new, u, lv)
                np.minimum.at(new, v, lu)
            labels = new
        return np.where(act, labels, -1).astype(np.float64)

    def device(self, arrs, act, live):
        frow, fcol, feid = arrs["frow"], arrs["fcol"], arrs["feid"]
        N, T = act.shape
        on = act > 0
        labels = torch.where(on, _row_iota(N, T, act.device), N)
        alive = live[feid] > 0  # (2E, T)
        rows = frow[:, None].expand(-1, T)
        for _ in range(self.iters):
            msgs = torch.where(alive, labels[fcol], N)
            labels = labels.scatter_reduce(0, rows, msgs, reduce="amin")
        return torch.where(on, labels, -1)  # (N, T) int32


class TrianglesOp(FusedOp):
    """Temporal triangle participation per node (diag(A^3)/2), over the
    packed pair table's live edges.  Integer counts — host and device
    are bit-identical (f32 accumulation is exact below 2^24)."""

    name = "triangles"

    def host(self, sots, ts, present):
        u, v, live = _host_edges(sots, ts, present)
        N, T = present.shape
        out = np.zeros((N, T))
        for j in range(T):
            m = live[:, j]
            a = np.zeros((N, N), np.float32)
            a[u[m], v[m]] = 1.0
            a[v[m], u[m]] = 1.0
            a2 = a @ a
            out[:, j] = np.round((a2 * a).sum(0) * 0.5)
        return out

    def device(self, arrs, act, live):
        # the CUDA kernel on a card, its plain version on the CPU
        tri = motif_ops.temporal_motif(dense_adjacency(arrs, live, act.shape[0]))
        return tri.T  # (N, T) int32


def dense_adjacency(edge, live, N: int) -> torch.Tensor:
    """(T, N, N) float32 symmetric 0/1 adjacency from the operand export's
    canonical edges and their ``live (E, T)`` liveness: the dense stack
    the triangle program and the dense analytics kernels read."""
    u, v = edge["edge_u"], edge["edge_v"]
    T = live.shape[1]
    live_t = live.T.contiguous()  # (T, E)
    adj = torch.zeros((T, N * N), dtype=torch.float32, device=live.device)
    for flat in (u * N + v, v * N + u):
        adj.scatter_reduce_(1, flat[None, :].expand(T, -1), live_t, "amax")
    return adj.view(T, N, N)


def dense_stack(sots: SoTS, ts, device=None):
    """``(adj (T, N, N), active (T, N))`` float32 of ``sots`` at ``ts`` on
    ``device`` (None: the CUDA card): the fused programs' presence and
    live edges (both endpoints present), laid out for the dense kernels
    ``temporal_pagerank`` / ``temporal_cc`` / ``temporal_motif``."""
    device = dev.resolve(device)
    tsv = _tsv(np.asarray(ts, np.int64).ravel(), device)
    edge = _edge_arrays(sots, device)
    act = _dev_presence(_node_arrays(sots, device), tsv).to(torch.float32)
    live = _dev_edge_live(edge, act, tsv)
    return dense_adjacency(edge, live, len(sots)), act.T.contiguous()


class FusedScalarOp:
    """Evolution-stage wrapper: a FusedOp's per-node series reduced to a
    scalar per timepoint, on both paths.  Usable directly as a
    vectorized evolution fn (the staged host path)."""

    vectorized = True

    def __init__(self, base: FusedOp, reduce: str):
        self.base = base
        self.reduce = reduce
        self.name = f"{base.name}.{reduce}"

    def params(self):
        return (self.reduce,) + tuple(self.base.params())

    def __call__(self, son, ts):
        ts = np.asarray(ts, np.int64).ravel()
        present, _ = replay.state_at_many(son, ts)
        series = self.base.host(son, ts, present)
        return self._reduce_host(series, present)

    def _reduce_host(self, series, present):
        N, T = series.shape
        if self.reduce == "sum3":  # per-node triangle counts -> totals
            return series.sum(axis=0) / 3.0
        if self.reduce == "count_components":
            own = series == np.arange(N, dtype=np.float64)[:, None]
            return (own & (present == 1)).sum(axis=0).astype(np.float64)
        if self.reduce == "max":
            return series.max(axis=0, initial=0.0)
        raise ValueError(self.reduce)

    def reduce_device(self, series_nt, act):
        """(T,) device reduction; integer reducers stay exact and finish
        their float math on the host (``epilogue``)."""
        if self.reduce == "sum3":
            return series_nt.to(torch.int32).sum(dim=0, dtype=torch.int32)
        if self.reduce == "count_components":
            N, T = act.shape
            own = (series_nt == _row_iota(N, T, act.device)) & (act > 0)
            return own.sum(dim=0, dtype=torch.int32)
        if self.reduce == "max":
            return series_nt.amax(dim=0).clamp_min(0.0)
        raise ValueError(self.reduce)

    def epilogue(self, reduced: np.ndarray) -> np.ndarray:
        if self.reduce == "sum3":
            return reduced.astype(np.float64) / 3.0
        return reduced.astype(np.float64)


def pagerank(damping: float = 0.85, iters: int = 20) -> PageRankOp:
    return PageRankOp(damping=damping, iters=iters)


def components(iters: int = 32) -> ComponentsOp:
    return ComponentsOp(iters=iters)


def triangles() -> TrianglesOp:
    return TrianglesOp()


def triangle_count() -> FusedScalarOp:
    """Evolution fn: total triangles per timepoint."""
    return FusedScalarOp(TrianglesOp(), "sum3")


def component_count(iters: int = 32) -> FusedScalarOp:
    """Evolution fn: number of connected components per timepoint."""
    return FusedScalarOp(ComponentsOp(iters=iters), "count_components")


def max_pagerank(damping: float = 0.85, iters: int = 20) -> FusedScalarOp:
    """Evolution fn: the top PageRank score per timepoint."""
    return FusedScalarOp(PageRankOp(damping=damping, iters=iters), "max")


# ---------------------------------------------------------------------------
# Device operand export (uploaded once per operand, weakref-guarded)
# ---------------------------------------------------------------------------


def _up(x: np.ndarray, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x, dtype), device=device)


def _node_arrays(son: SoN, device):
    key = (replay.operand_key(son), "node", str(device))
    hit = _operands.get(key, owner=son)
    if hit is not None:
        return hit
    STATS["operand_uploads"] += 1
    pads = son.padded_events()
    arrs = {
        "ev_t": _up(pads["t"], device),
        "ev_kind": _up(pads["kind"], device, np.int32),
        "ev_key": _up(pads["key"], device, np.int32),
        "ev_val": _up(pads["val"], device),
        "init_present": _up(son.init_present, device, np.int32),
        "init_attrs": _up(son.init_attrs, device),
    }
    _operands.put(key, arrs, owner=son)
    return arrs


def _edge_arrays(sots: SoTS, device):
    key = (replay.operand_key(sots), "edge", str(device))
    hit = _operands.get(key, owner=sots)
    if hit is not None:
        return hit
    STATS["operand_uploads"] += 1
    N = len(sots)
    er = replay.edge_replay(sots)
    exp = er.device_export()
    flip_t, flip_s, base = exp["flip_t"], exp["flip_s"], exp["base"]
    if er.n_pairs == 0:  # dummy never-existing pair keeps gathers in-bounds
        flip_t = np.zeros((1, 1), np.int64)
        flip_s = np.full((1, 1), -1, np.int8)
        base = np.zeros(1, np.int8)
    v = replay.member_rows(exp["pair_other"], sots.node_ids).astype(np.int64)
    u = exp["pair_center"].astype(np.int64)
    valid = (v >= 0) & (u != v)
    cu = np.minimum(u[valid], v[valid])
    cv = np.maximum(u[valid], v[valid])
    ekey = cu * max(N, 1) + cv
    uniq = np.unique(ekey) if len(ekey) else np.empty(0, np.int64)
    E = max(len(uniq), 1)
    eu = np.zeros(E, np.int32)
    ev_ = np.zeros(E, np.int32)
    eu[: len(uniq)] = uniq // max(N, 1)
    ev_[: len(uniq)] = uniq % max(N, 1)
    # the <=2 directed pair rows per canonical edge (OR-folded by gather,
    # not scatter: contiguous T-rows are cheap, scatters are not)
    pair_a = np.zeros(E, np.int32)
    pair_b = np.zeros(E, np.int32)
    edge_valid = np.zeros(E, np.float32)
    if len(uniq):
        rows = np.nonzero(valid)[0]
        order = np.argsort(ekey, kind="stable")
        srt_keys, srt_rows = ekey[order], rows[order]
        first = np.searchsorted(srt_keys, uniq, side="left")
        last = np.searchsorted(srt_keys, uniq, side="right") - 1
        pair_a[: len(uniq)] = srt_rows[first]
        pair_b[: len(uniq)] = srt_rows[last]
        edge_valid[: len(uniq)] = 1.0
    # flat incidence (2E,) sorted by node: one contiguous-row scatter per
    # propagation step instead of two scalar-indexed ones
    frow = np.concatenate([eu, ev_]).astype(np.int64)
    fcol = np.concatenate([ev_, eu])
    feid = np.concatenate([np.arange(E), np.arange(E)]).astype(np.int32)
    o = np.argsort(frow, kind="stable")
    # index tensors are int64: torch's gather/scatter/index_add take no other
    arrs = {
        "flip_t": _up(flip_t, device),
        "flip_s": _up(flip_s, device, np.int32),
        "base": _up(base, device, np.int32),
        "edge_u": _up(eu, device, np.int64),
        "edge_v": _up(ev_, device, np.int64),
        "pair_a": _up(pair_a, device, np.int64),
        "pair_b": _up(pair_b, device, np.int64),
        "edge_valid": _up(edge_valid, device),
        "frow": _up(frow[o], device, np.int64),
        "fcol": _up(fcol[o], device, np.int64),
        "feid": _up(feid[o], device, np.int64),
        "n_real_edges": len(uniq),
    }
    _operands.put(key, arrs, owner=sots)
    return arrs


# ---------------------------------------------------------------------------
# Device programs (torch; shared by every covered plan shape)
# ---------------------------------------------------------------------------


def _row_iota(N: int, T: int, device) -> torch.Tensor:
    """(N, T) int32 row index."""
    return torch.arange(N, dtype=torch.int32, device=device)[:, None].expand(N, T)


def _counts_at(rows_t: torch.Tensor, pad: torch.Tensor, tsv: torch.Tensor):
    """(R, T) number of entries <= each timepoint per sorted row of
    ``rows_t`` (R, E), with the ``pad`` slots re-sentineled to int64-max
    so they sort after every real timestamp."""
    rows_s = torch.where(pad, torch.iinfo(rows_t.dtype).max, rows_t)
    return torch.searchsorted(rows_s, tsv.expand(rows_s.shape[0], -1).contiguous(),
                              right=True)


def _last_at(mask: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """(R, T) index of the last entry with ``mask`` set among each row's
    first ``cnt`` entries, -1 where there is none."""
    rank = torch.arange(mask.shape[1], device=mask.device).expand_as(mask)
    last = torch.cummax(torch.where(mask, rank, -1), dim=1).values
    idx = torch.gather(last, 1, (cnt - 1).clamp_min(0))
    return torch.where(cnt > 0, idx, -1)


def _dev_presence(node, tsv):
    """(N, T) int32 presence — the device ``state_at_many`` presence
    half."""
    kind = node["ev_kind"]
    cnt = _counts_at(node["ev_t"], kind < 0, tsv)
    pmask = (kind == NODE_ADD) | (kind == NODE_DEL) | (kind == NATTR_SET)
    pidx = _last_at(pmask, cnt)
    kind_at = torch.gather(kind, 1, pidx.clamp_min(0))
    return torch.where(pidx >= 0, (kind_at != NODE_DEL).to(torch.int32),
                       node["init_present"][:, None])


def _dev_attrs(node, tsv):
    """(N, T, K) int32 attrs — last write per (node, key) with NODE_DEL
    clearing every key, exactly the host replay semantics."""
    kind, ekey, eval_ = node["ev_kind"], node["ev_key"], node["ev_val"]
    cnt = _counts_at(node["ev_t"], kind < 0, tsv)
    cols = []
    for k in range(node["init_attrs"].shape[1]):  # K is small and static
        wmask = ((kind == NATTR_SET) & (ekey == k)) | (kind == NODE_DEL)
        widx = _last_at(wmask, cnt)
        at = widx.clamp_min(0)
        kind_at = torch.gather(kind, 1, at)
        val_at = torch.gather(eval_, 1, at)
        cols.append(torch.where(widx >= 0,
                                torch.where(kind_at == NODE_DEL, -1, val_at),
                                node["init_attrs"][:, k][:, None]))
    return torch.stack(cols, dim=-1)


def _dev_edge_live(edge, act, tsv):
    """(E, T) f32 edge liveness from the padded flip table: pair state at
    each timepoint (searchsorted per row), the <=2 directed pair rows
    OR-folded by contiguous-row gather, masked by both endpoints'
    presence.  ``act`` is (N, T) f32 — everything stays (entity, T)-major
    so propagation scatters move whole contiguous T-rows."""
    flip_s = edge["flip_s"]
    cnt = _counts_at(edge["flip_t"], flip_s < 0, tsv)  # (P, T)
    st_at = torch.gather(flip_s, 1, (cnt - 1).clamp_min(0))
    exist = torch.where(cnt > 0, st_at, edge["base"][:, None])  # (P, T)
    pair_live = (exist == 1).to(torch.float32)
    el = torch.maximum(pair_live[edge["pair_a"]], pair_live[edge["pair_b"]])
    el = el * edge["edge_valid"][:, None]
    return el * act[edge["edge_u"]] * act[edge["edge_v"]]


# ---------------------------------------------------------------------------
# Program cache + lowering
# ---------------------------------------------------------------------------


def _shape_sig(arrs) -> Tuple:
    return tuple(sorted(
        (k, tuple(v.shape), str(v.dtype))
        for k, v in arrs.items() if hasattr(v, "shape")))


def _get_program(key, builder):
    prog = _programs.get(key)
    if prog is None:
        STATS["compile_misses"] += 1
        prog = builder()
        _programs[key] = prog
        while len(_programs) > _PROGRAM_CACHE_MAX:
            _programs.popitem(last=False)
    else:
        STATS["compile_hits"] += 1
        _programs.move_to_end(key)
    return prog


def _build_slice_program():
    STATS["traces"] += 1

    def prog(node, tsv):
        return _dev_presence(node, tsv), _dev_attrs(node, tsv)

    return prog


def _build_series_program(op: FusedOp):
    STATS["traces"] += 1

    def prog(node, edge, tsv):
        act = _dev_presence(node, tsv).to(torch.float32)  # (N, T)
        live = _dev_edge_live(edge, act, tsv)
        return op.device(edge, act, live)

    return prog


def _build_evolution_program(sop: FusedScalarOp):
    STATS["traces"] += 1

    def prog(node, edge, tsv):
        act = _dev_presence(node, tsv).to(torch.float32)
        live = _dev_edge_live(edge, act, tsv)
        series = sop.base.device(edge, act, live)
        return sop.reduce_device(series, act)

    return prog


def _tsv(ts, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ts, np.int64), device=device)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


# ---------------------------------------------------------------------------
# Entry point (called by PlanExecutor for every terminal stage)
# ---------------------------------------------------------------------------


def try_fused(operand, stage, replay_cache=None, device=None):
    """Run one terminal stage fused if its shape is covered, on
    ``device`` (None: the CUDA card).

    Returns ``(value, notes)``; ``value is MISS`` means "not covered,
    run the staged path" with notes carrying the reason.
    """
    if not ENABLED:
        return MISS, ("compile: staged (fusion disabled)",)
    if operand is None or len(operand) == 0:
        return MISS, ("compile: staged (empty operand)",)
    k = stage.kind
    if k == "slice":
        return _fused_slice(operand, stage, replay_cache, dev.resolve(device))
    if k == "compute":
        if stage.style == "temporal" and isinstance(stage.fn, FusedOp):
            return _fused_compute(operand, stage, dev.resolve(device))
        return MISS, (f"compile: staged compute (style={stage.style!r}, "
                      "fn is not a FusedOp)",)
    if k == "evolution":
        if isinstance(stage.fn, FusedScalarOp):
            return _fused_evolution(operand, stage, dev.resolve(device))
        return MISS, ("compile: staged evolution (fn is not a "
                      "FusedScalarOp)",)
    return MISS, (f"compile: staged ({k})",)


def _fused_slice(operand, stage, replay_cache, device):
    if np.isscalar(stage.ts):
        return MISS, ("compile: staged slice (scalar timepoint)",)
    ts = np.asarray(list(stage.ts), np.int64).ravel()
    T = len(ts)
    if T < MIN_FUSE_T:
        return MISS, (f"compile: staged slice (T={T} < MIN_FUSE_T="
                      f"{MIN_FUSE_T})",)
    # share the executor's replay LRU: a repeated fused slice re-dispatches
    # nothing, and a fused slice never poisons the staged cache (values are
    # bit-identical by construction)
    ckey = (replay.operand_key(operand),
            ("multi", tuple(int(x) for x in ts)))
    if replay_cache is not None:
        hit = replay_cache.get(ckey, owner=operand)
        if hit is not None:
            value = {kk: (vv.copy() if isinstance(vv, np.ndarray) else vv)
                     for kk, vv in hit.items()}
            return value, ("compile: fused slice (replay-LRU hit)",)
    node = _node_arrays(operand, device)
    key = ("slice", _shape_sig(node), str(device), T)
    hit_before = key in _programs
    prog = _get_program(key, _build_slice_program)
    pres, attrs = prog(node, _tsv(ts, device))
    value = {
        "present": _host(pres).astype(operand.init_present.dtype),
        "attrs": _host(attrs).astype(operand.init_attrs.dtype),
        "t": ts,
    }
    if replay_cache is not None:
        replay_cache.put(ckey, value, owner=operand)
        value = {kk: (vv.copy() if isinstance(vv, np.ndarray) else vv)
                 for kk, vv in value.items()}
    STATS["fused_runs"] += 1
    note = (f"compile: fused slice (T={T}, "
            f"{'cache hit' if hit_before else 'traced'})")
    return value, (note,)


def _check_sots(operand):
    if not isinstance(operand, SoTS):
        raise ValueError(
            "fused temporal-analytics ops need a SoTS operand (adjacency); "
            "fetch with subgraphs()/build_sots")


def _fused_compute(operand, stage, device):
    _check_sots(operand)
    op: FusedOp = stage.fn
    ts = ops.eval_points(operand, stage.points).astype(np.int64)
    T = len(ts)
    miss = _budget_miss(op, operand, T)
    if miss is not None:
        return miss
    node = _node_arrays(operand, device)
    edge = _edge_arrays(operand, device)
    key = ("compute", op.name, op.params(), _shape_sig(node),
           _shape_sig(edge), str(device), T)
    hit_before = key in _programs
    prog = _get_program(key, lambda: _build_series_program(op))
    series = prog(node, edge, _tsv(ts, device))
    out = _host(series).astype(np.float64).reshape(len(operand), T)
    STATS["fused_runs"] += 1
    note = (f"compile: fused compute[{op.name}] (T={T}, "
            f"{'cache hit' if hit_before else 'traced'})")
    return (ts, out), (note,)


def _fused_evolution(operand, stage, device):
    _check_sots(operand)
    sop: FusedScalarOp = stage.fn
    if stage.points is None:
        ts = np.linspace(operand.t0, operand.t1,
                         stage.n_samples).astype(np.int64)
    else:
        ts = ops.eval_points(operand, stage.points).astype(np.int64)
    T = len(ts)
    miss = _budget_miss(sop.base, operand, T)
    if miss is not None:
        return miss
    node = _node_arrays(operand, device)
    edge = _edge_arrays(operand, device)
    key = ("evolution", sop.name, sop.params(), _shape_sig(node),
           _shape_sig(edge), str(device), T)
    hit_before = key in _programs
    prog = _get_program(key, lambda: _build_evolution_program(sop))
    reduced = prog(node, edge, _tsv(ts, device))
    series = sop.epilogue(_host(reduced))
    STATS["fused_runs"] += 1
    note = (f"compile: fused evolution[{sop.name}] (T={T}, "
            f"{'cache hit' if hit_before else 'traced'})")
    return (ts, series), (note,)


def _budget_miss(op: FusedOp, operand, T: int):
    """Dense-adjacency programs refuse shapes whose (T, N, N) stack
    would blow the budget — the staged path handles them instead."""
    if isinstance(op, TrianglesOp) and T * len(operand) ** 2 > DENSE_BUDGET:
        return MISS, (f"compile: staged compute[{op.name}] (dense stack "
                      f"T*N^2={T * len(operand) ** 2} exceeds budget)",)
    return None
