#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

Run from a checkout: ``python3 chip_smoke.py``.  Phases, each printed as
one JSON line; any failure exits non-zero:

1. device   — the card's name and ``nvidia-smi`` name and power limit;
2. build    — every kernel source compiled with nvcc, in parallel;
3. main path — ``generate(200_000, seed=7)`` indexed by
   ``HistoricalGraphStore.build`` on the card, then Algorithm 1
   (64 batched snapshots, 320 batched snapshots inside one checkpoint
   window — one fold of some 330 layers — and one single snapshot,
   kernel fold against host fold, one snapshot against the full-replay
   oracle), fused
   plans (slice T=128, components T=128, pagerank T=32, triangles T=16)
   against the staged executor, ``style="kernel"`` degree (the series at
   the components step's 128 points and one point, against the host
   replay; a repeated run served from the device-operand cache), and the
   dense analytics kernels ``temporal_pagerank`` / ``temporal_cc`` on
   the triangles step's dense stack against the fused ``pagerank`` /
   ``components`` plans.  Kernel launch counts are zeroed just before
   and read just after; a kernel of the path that never launched fails
   the run;
4. kernels  — each kernel against its plain PyTorch version (bit for
   bit; PageRank within atol=1e-6, rtol=1e-5), on the inputs each step
   of the main path gave it and at headline shapes; device times from
   CUDA events, beside the plain version's, one library call's where
   there is one, and the bound: the larger of the bytes the function
   must move over the memory rate and the operations these inputs need
   over the peak rate for their type, both counted from the data.

Phase 1 also prints ``nvidia-smi``'s own line.  The line before the
last is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.  ``--device cpu --events N`` rehearses
phase 3 on the CPU with the plain versions and prints no result.
"""
from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
TF32_OPS_PER_S = 495e12  # H100 SXM dense TF32 tensor-core peak (data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM FP32 CUDA-core peak, no tensor cores (data sheet)
INT32_OPS_PER_S = 33.5e12  # H100 SXM5 INT32 peak (Hopper architecture white paper)
PAGERANK_ATOL = 1e-5  # f32 device vs f64 host (taf/compile.py PageRankOp)
DENSE_PR_TOL = dict(atol=1e-6, rtol=1e-5)  # f32 sums in another order


def emit(**obj):
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------


def same_state(a, b, what: str) -> None:
    n = max(len(a.present), len(b.present))
    a.grow(n)
    b.grow(n)
    on = a.present == 1
    if not ((a.present == b.present).all() and (a.attrs[on] == b.attrs[on]).all()
            and np.array_equal(a.edge_key, b.edge_key)
            and np.array_equal(a.edge_val, b.edge_val)):
        fail(f"{what}: snapshots differ")


def fused_and_staged(q, what: str, exact: bool = True):
    from repro_torch.taf import compile as tc
    from repro_torch.taf.plan import PlanExecutor

    with tc.disabled():
        staged = q.run()
    PlanExecutor._replay_cache.clear()  # the fused run must not hit it
    t0 = time.perf_counter()
    fused = q.run()  # values come back to the host: the run has ended
    seconds = time.perf_counter() - t0
    if not any("compile: fused" in n for n in fused.notes):
        fail(f"{what}: not fused: {fused.notes}")
    if isinstance(staged.value, dict):
        pairs = [(fused.value[k], staged.value[k]) for k in ("present", "attrs")]
    else:
        pairs = [(fused.value[0], staged.value[0]), (fused.value[1], staged.value[1])]
    err = 0.0
    for got, want in pairs:
        got, want = np.asarray(got), np.asarray(want)
        if got.shape != want.shape or not np.isfinite(got.astype(np.float64)).all():
            fail(f"{what}: shape {got.shape} vs {want.shape} or non-finite")
        if exact and (got.dtype != want.dtype or not np.array_equal(got, want)):
            fail(f"{what}: fused != staged")
        err = max(err, float(np.abs(got.astype(np.float64) - want).max(initial=0)))
    if not exact and err > PAGERANK_ATOL:
        fail(f"{what}: max |fused - staged| {err} > {PAGERANK_ATOL}")
    emit(phase="main_path", check=what, fused_seconds=seconds,
         shape=list(np.shape(pairs[-1][0])), max_abs_err=err,
         notes=[n for n in fused.notes if n.startswith("compile")])


class Recorder:
    """Keeps the first inputs each kernel wrapper is given in each step
    (``tag``) of the main path, so phase 4 can hold the kernel against its
    plain version on exactly those inputs."""

    def __init__(self):
        self.inputs = {}  # (kernel name, tag) -> args
        self.tag = "main path"
        self._undo = []

    def wrap(self, mod, fn: str, name: str):
        orig = getattr(mod, fn)

        def shim(*args):
            self.inputs.setdefault((name, self.tag), [a.clone() for a in args])
            return orig(*args)

        setattr(mod, fn, shim)
        self._undo.append((mod, fn, orig))

    def restore(self):
        for mod, fn, orig in self._undo:
            setattr(mod, fn, orig)


def main_path(device, n_events: int, recorder=None):
    from repro_torch.data.temporal_graph_gen import generate, naive_state_at
    from repro_torch.kernels.delta_overlay import ops as ov_ops
    from repro_torch.kernels.temporal_cc import ops as cc_ops
    from repro_torch.kernels.temporal_motif import ops as motif_ops
    from repro_torch.kernels.temporal_pagerank import ops as pr_ops
    from repro_torch.taf import HistoricalGraphStore
    from repro_torch.taf import compile as tc

    t0 = time.perf_counter()
    events = generate(n_events, seed=7)
    t_gen = time.perf_counter() - t0
    store = HistoricalGraphStore.build(events, device=device)
    lo, hi = store.time_range()
    emit(phase="main_path", check="build", events=len(events),
         nodes=int(events.n_nodes), time_range=[int(lo), int(hi)],
         generate_seconds=t_gen, build_seconds=time.perf_counter() - t0 - t_gen,
         config=dict(vars(store.cfg)), device=str(store.tgi.device))
    kernel_ops = {"delta_overlay": ov_ops, "temporal_motif": motif_ops,
                  "temporal_pagerank": pr_ops, "temporal_cc": cc_ops}
    for mod in kernel_ops.values():
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    if recorder is not None:
        recorder.wrap(ov_ops, "overlay", "delta_overlay.overlay")
        recorder.wrap(ov_ops, "overlay_batch", "delta_overlay.overlay_batch")
        recorder.wrap(motif_ops, "temporal_motif", "temporal_motif.motif")
        recorder.wrap(pr_ops, "temporal_pagerank", "temporal_pagerank.pagerank")
        recorder.wrap(cc_ops, "temporal_cc", "temporal_cc.cc")

    # Algorithm 1: 4 windows of 16 timepoints, so checkpoint groups batch
    span = hi - lo
    ts = np.concatenate([np.linspace(lo + f * span, lo + f * span + 240, 16)
                         for f in (0.2, 0.4, 0.6, 0.8)]).astype(np.int64)
    t1 = time.perf_counter()
    host = store.snapshots(ts, use_kernel=False)
    t2 = time.perf_counter()
    kern = store.snapshots(ts, use_kernel=True)
    t3 = time.perf_counter()
    for j, (a, b) in enumerate(zip(kern, host)):
        same_state(a, b, f"snapshots[{j}] t={ts[j]}")
    t_one = int(ts[5])
    one_host = store.snapshot(t_one, use_kernel=False)
    store.tgi.invalidate_caches()  # the snapshot LRU ignores use_kernel
    one_kern = store.snapshot(t_one, use_kernel=True)
    same_state(one_kern, one_host, f"snapshot t={t_one}")
    same_state(one_kern, naive_state_at(events, t_one, store.cfg.n_attrs),
               f"snapshot t={t_one} vs full replay")
    emit(phase="main_path", check="snapshots", T=len(ts),
         host_fold_seconds=t2 - t1, kernel_fold_seconds=t3 - t2,
         nodes_present=[int(g.present.sum()) for g in kern[::16]])

    # one (span, checkpoint) group of 320 timepoints: one batched fold of
    # the group's hierarchy path plus one eventlist layer per timepoint
    si = store.tgi.spans[len(store.tgi.spans) // 2]
    w0, w1 = si.checkpoint_ts[1], si.checkpoint_ts[2] - 1
    wide = np.unique(np.linspace(w0, w1, 320).astype(np.int64))
    if len(wide) < 256:
        fail(f"checkpoint window [{w0}, {w1}] too narrow for a wide group")
    t1 = time.perf_counter()
    host = store.snapshots(wide, use_kernel=False)
    t2 = time.perf_counter()
    if recorder is not None:
        recorder.tag = "main path, one wide group"
    kern = store.snapshots(wide, use_kernel=True)
    t3 = time.perf_counter()
    if recorder is not None:
        recorder.tag = "main path"
    for j, (a, b) in enumerate(zip(kern, host)):
        same_state(a, b, f"wide group snapshots[{j}] t={wide[j]}")
    emit(phase="main_path", check="snapshots one group", T=len(wide),
         window=[int(w0), int(w1)], host_fold_seconds=t2 - t1,
         kernel_fold_seconds=t3 - t2)

    # fused plans over the last eighth of the history
    q0, q1 = lo + 7 * span // 8, hi
    fused_and_staged(store.nodes(q0, q1).timeslice(
        list(np.linspace(q0, q1 - 1, 128).astype(np.int64))), "slice T=128")
    sub = store.subgraphs(q0, q1)
    fused_and_staged(sub.node_compute(
        tc.components(), style="temporal",
        points=np.linspace(q0, q1 - 1, 128).astype(np.int64)), "components T=128")
    fused_and_staged(sub.node_compute(
        tc.pagerank(), style="temporal",
        points=np.linspace(q0, q1 - 1, 32).astype(np.int64)), "pagerank T=32",
        exact=False)
    sub16 = sub.filter(node_ids=range(1500))
    ts16 = np.linspace(q0, q1 - 1, 16).astype(np.int64)
    fused_and_staged(sub16.node_compute(tc.triangles(), style="temporal",
                                        points=ts16), "triangles T=16")
    kernel_style_degree(device, sub.materialize().operand,
                        np.linspace(q0, q1 - 1, 128).astype(np.int64))
    dense_analytics(device, sub16.materialize().operand, ts16)

    if recorder is not None:
        recorder.restore()
    launches = {f"{name}.{k}": v for name, mod in kernel_ops.items()
                for k, v in mod.LAUNCHES.items()}
    emit(phase="main_path", check="launches", launches=launches,
         plan_compile=store.cache_stats()["plan_compile"])
    return launches


def kernel_style_degree(device, sots, ts):
    """``style="kernel"`` degree on the card: the series at every point
    and the degree at one point, bit for bit against the host replay on
    the members present at t0 (the kernels give 0 elsewhere, as the
    reference's do); then one plan run twice over one operand, the second
    served from the device-operand cache."""
    from repro_torch.taf import TemporalQuery, replay
    from repro_torch.taf import exec as taf_exec

    t0 = time.perf_counter()
    series = taf_exec.sharded_degree_series(sots, ts, device=device)
    t1 = time.perf_counter()
    one = taf_exec.sharded_degree_at(sots, int(ts[64]), device=device)
    t2 = time.perf_counter()
    host = replay.degree_series(sots, ts)
    t3 = time.perf_counter()
    on = sots.init_present == 1
    if series.shape != (len(sots), len(ts)) or series.dtype != np.int32:
        fail(f"kernel-style degree series: {series.dtype}{series.shape}")
    if not np.array_equal(series[on], host[on]):
        fail("kernel-style degree series != host replay")
    if not (np.array_equal(one, series[:, 64]) and np.array_equal(one[on], host[on, 64])):
        fail("kernel-style degree at one point != series / host replay")
    q = TemporalQuery.over(taf_exec.with_init_degree(sots), device=device) \
        .node_compute(taf_exec.degree_at_kernel(int(ts[64])), style="kernel")
    before = dict(taf_exec.STATS)
    t4 = time.perf_counter()
    first = q.execute()
    t5 = time.perf_counter()
    again = q.execute()
    t6 = time.perf_counter()
    stats = {k: taf_exec.STATS[k] - before[k] for k in before}
    if stats != {"operand_transfers": 1, "operand_cache_hits": 1}:
        fail(f"kernel-style operand cache: {stats}")
    if not (np.array_equal(first, one) and np.array_equal(again, one)):
        fail("kernel-style plan != sharded_degree_at")
    emit(phase="main_path", check="kernel-style degree", members=len(sots),
         T=len(ts), series_seconds=t1 - t0, one_point_seconds=t2 - t1,
         host_replay_seconds=t3 - t2, plan_seconds=[t5 - t4, t6 - t5],
         stats=dict(taf_exec.STATS), stats_delta=stats)


def dense_analytics(device, sots, ts):
    """The dense kernels on the dense stack of ``sots`` at ``ts`` (the
    live edges the fused programs see): PageRank within 1e-5 of the fused
    ``pagerank()`` plan, components bit for bit equal to ``components()``."""
    from repro_torch.kernels.temporal_cc import ops as cc_ops
    from repro_torch.kernels.temporal_pagerank import ops as pr_ops
    from repro_torch.taf import TemporalQuery
    from repro_torch.taf import compile as tc

    t0 = time.perf_counter()
    adj, active = tc.dense_stack(sots, ts, device=device)
    sync(device)
    t1 = time.perf_counter()
    ranks = pr_ops.temporal_pagerank(adj, active)
    labels = cc_ops.temporal_cc(adj, active)
    sync(device)
    t2 = time.perf_counter()

    def fused(op):
        return TemporalQuery.over(sots, device=device).node_compute(
            op, style="temporal", points=ts).execute()[1]

    pr_err = float(np.abs(ranks.cpu().numpy().T - fused(tc.pagerank())).max())
    if not pr_err <= PAGERANK_ATOL:
        fail(f"dense PageRank vs fused pagerank(): max err {pr_err}")
    want = fused(tc.components()).astype(np.int32)
    if not np.array_equal(labels.cpu().numpy().T, want):
        fail("dense components != fused components()")
    emit(phase="main_path", check="dense analytics T=16", members=len(sots),
         T=len(ts), adjacency_bytes=adj.numel() * 4,
         edges=int((adj != 0).sum()) // 2, dense_stack_seconds=t1 - t0,
         kernels_seconds=t2 - t1, pagerank_vs_fused_max_abs_err=pr_err,
         components_first_last=[int(np.unique(c[c >= 0]).size) for c in want.T[[0, -1]]])


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------


def device_ms(fn, reps: int = 15) -> float:
    """Median device time of one call: each rep first parks the stream on
    a sleep long enough to cover the call's host-side enqueue, so the
    events bracket device work only."""
    fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - h0
    torch.cuda.synchronize()
    cycles = int(_sleep_cycles_per_s() * (2 * host_s + 1e-3))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@functools.lru_cache(maxsize=None)
def _sleep_cycles_per_s() -> float:
    """Clock cycles per second of ``torch.cuda._sleep`` on this card."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(50_000_000)
    end.record()
    end.synchronize()
    return 50_000_000 / (start.elapsed_time(end) / 1e3)


def max_err(got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"kernel output {g.dtype}{tuple(g.shape)} vs plain "
                 f"{w.dtype}{tuple(w.shape)}")
        if g.numel():
            err = max(err, float((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def overlay_bytes(args, batch: bool) -> int:
    """Bytes the fold must move on these inputs: every valid byte (and
    the tmask), a layer's present byte and K attrs only where its valid
    byte is set and some timepoint uses the layer (the single fold starts
    from layer 0, so all of layer 0), and every output once."""
    valid, _, attrs = args[:3]
    h, P, S = valid.shape
    K = attrs.shape[-1]
    out = P * S * (2 + 4 * K)
    if not batch:
        needed = P * S + int((valid[1:] != 0).sum())
        return h * P * S + needed * (1 + 4 * K) + out
    tmask = args[3]
    used = (tmask != 0).any(dim=1).to(valid.device)
    needed = int(((valid != 0) & used[:, None, None]).sum())
    return h * P * S + tmask.numel() * 4 + needed * (1 + 4 * K) + out * tmask.shape[1]


def motif_work(adj) -> tuple:
    """Operations and bytes the motif function needs on ``adj``: (A.A)[i,j]
    only where A[i,j] != 0 (2N operations each), then that product and
    the column sum (2 per nonzero); the adjacency read once, the (T, N)
    int32 output written once."""
    T, N, _ = adj.shape
    nnz = int((adj != 0).sum())
    return 2 * nnz * N + 2 * nnz, adj.numel() * 4 + T * N * 4


def pagerank_work(adj, active, iters: int = 20) -> tuple:
    """Float operations and bytes PageRank needs: per iteration 2 per
    nonzero (the product) and ~8 per node (contrib, dangling, update); the
    adjacency and the mask read once, the (T, N) float32 ranks written
    once."""
    T, N, _ = adj.shape
    nnz = int((adj != 0).sum())
    return (iters * (2 * nnz + 8 * T * N),
            adj.numel() * 4 + active.numel() * active.element_size() + T * N * 4)


def cc_work(adj, active, iters: int = 32) -> tuple:
    """Integer operations and bytes components need on these inputs: one
    compare per entry to find the edges, then one min per edge and per
    node in each round that changes a label at that timepoint (the kernel
    stops a timepoint after its first round that changes nothing); the
    adjacency and the mask read once, the (T, N) int32 labels written
    once."""
    T, N, _ = adj.shape
    edge = adj > 0
    act = active != 0
    labels = torch.where(act, torch.arange(N, dtype=torch.int32, device=adj.device), N)
    per_round = edge.sum(dim=(1, 2)) + N  # (T,) mins in one round
    ops = adj.numel()
    for _ in range(iters):
        new = torch.minimum(labels, torch.where(edge, labels[:, :, None], N).amin(dim=1))
        moved = (new != labels).any(dim=1)
        if not bool(moved.any()):
            break
        ops += int(per_round[moved].sum())
        labels = new
    return ops, adj.numel() * 4 + active.numel() * active.element_size() + T * N * 4


def kernel_case(name, args, tag):
    """Run one kernel on ``args`` against its plain version: bit-identical
    (PageRank: within DENSE_PR_TOL, and the same bits on a second run) or
    fail; returns the times, bound and error."""
    from repro_torch.kernels.delta_overlay import ops as ov_ops
    from repro_torch.kernels.delta_overlay import ref as ov_ref
    from repro_torch.kernels.temporal_cc import ops as cc_ops
    from repro_torch.kernels.temporal_cc import ref as cc_ref
    from repro_torch.kernels.temporal_motif import ops as motif_ops
    from repro_torch.kernels.temporal_motif import ref as motif_ref
    from repro_torch.kernels.temporal_pagerank import ops as pr_ops
    from repro_torch.kernels.temporal_pagerank import ref as pr_ref

    library, peak, tol = None, TF32_OPS_PER_S, None
    if name == "delta_overlay.overlay":
        kern, plain = ov_ops.overlay, ov_ref.overlay_ref
        ops, nbytes = 0, overlay_bytes(args, batch=False)
        shape = dict(h=args[0].shape[0], P=args[0].shape[1], S=args[0].shape[2],
                     K=args[2].shape[-1])
    elif name == "delta_overlay.overlay_batch":
        kern, plain = ov_ops.overlay_batch, ov_ref.overlay_batch_ref
        ops, nbytes = 0, overlay_bytes(args, batch=True)
        shape = dict(h=args[0].shape[0], P=args[0].shape[1], S=args[0].shape[2],
                     K=args[2].shape[-1], T=args[3].shape[1])
    elif name == "temporal_motif.motif":
        kern, plain = motif_ops.temporal_motif, motif_ref.motif_ref
        T, N, _ = args[0].shape
        ops, nbytes = motif_work(args[0])
        shape = dict(T=T, N=N, nnz=int((args[0] != 0).sum()))

        def library():
            a = args[0]
            return ((torch.bmm(a, a) * a).sum(dim=1) * 0.5).to(torch.int32)
    elif name == "temporal_pagerank.pagerank":
        kern, plain, tol = pr_ops.temporal_pagerank, pr_ref.pagerank_ref, DENSE_PR_TOL
        T, N, _ = args[0].shape
        (ops, nbytes), peak = pagerank_work(*args), FP32_OPS_PER_S
        shape = dict(T=T, N=N, nnz=int((args[0] != 0).sum()), iters=20)

        def library():  # the same loop of PyTorch calls, cuBLAS bmm for the product
            return pr_ref.pagerank_ref(*args)
    else:
        kern, plain = cc_ops.temporal_cc, cc_ref.cc_ref
        T, N, _ = args[0].shape
        (ops, nbytes), peak = cc_work(*args), INT32_OPS_PER_S
        shape = dict(T=T, N=N, nnz=int((args[0] != 0).sum()), iters=32)

    got = kern(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if tol is None:
        err = max_err(got, want)
        if err != 0:
            fail(f"{name} ({tag}) differs from its plain version: max err {err}")
    else:
        (g,), (w,) = got, want
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{name} ({tag}): {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        err = float((g - w).abs().max())
        if not torch.allclose(g, w, **tol):
            fail(f"{name} ({tag}) outside {tol} of its plain version: max err {err}")
        if not torch.equal(kern(*args), g):
            fail(f"{name} ({tag}): two runs differ")
    ops_ms, bytes_ms = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms > bytes_ms else "bytes"
    row = dict(shape=shape, max_abs_err=err, ms=device_ms(lambda: kern(*args)),
               plain_ms=device_ms(lambda: plain(*args)), bound_ms=bound_ms,
               bound_by=bound_by,
               library_ms=None if library is None else device_ms(library))
    emit(phase="kernel_vs_plain", kernel=name, inputs=tag, **row)
    return row


def headline_inputs(dev):
    g = torch.Generator(device="cpu").manual_seed(11)

    def stacks(h, P, S, K):
        valid = torch.rand(h, P, S, generator=g) < 0.4
        present = (torch.rand(h, P, S, generator=g) < 0.7).to(torch.int8)
        attrs = torch.randint(-1, 5, (h, P, S, K), generator=g, dtype=torch.int32)
        return [x.to(dev) for x in (valid, present, attrs)]

    def tmask(h, T):
        m = (torch.rand(h, T, generator=g) < 0.6).to(torch.int8)
        m[0] = 1
        return m.to(dev)

    def adjacency(T, N, p=0.02):
        a = torch.triu((torch.rand(T, N, N, generator=g) < p).float(), 1)
        return [(a + a.transpose(1, 2)).to(dev)]

    gd = torch.Generator(device=dev).manual_seed(13)

    def analytics(T, N, p=0.02):
        """Symmetric 0/1 adjacency made on the card (2.1 GB at T=8
        N=8192) and a ~80% activity mask; edges may touch inactive nodes."""
        a = torch.triu(torch.rand(T, N, N, generator=gd, device=dev) < p, 1)
        a = a.to(torch.float32)
        a += a.transpose(1, 2).clone()
        return [a, (torch.rand(T, N, generator=gd, device=dev) < 0.8).to(torch.float32)]

    dense = [(f"T={T} N={N}", analytics(T, N))
             for T, N in ((4, 4096), (4, 4000), (8, 8192))]
    return [(k, tag, a) for tag, a in dense
            for k in ("temporal_pagerank.pagerank", "temporal_cc.cc")] + [
        ("delta_overlay.overlay", "h=8 P=16 S=65536 K=4", stacks(8, 16, 65536, 4)),
        ("delta_overlay.overlay", "h=8 P=16 S=65537 K=4", stacks(8, 16, 65537, 4)),
        ("delta_overlay.overlay_batch", "h=8 P=16 S=65536 K=4 T=32",
         stacks(8, 16, 65536, 4) + [tmask(8, 32)]),
        ("delta_overlay.overlay_batch", "h=8 P=16 S=65537 K=4 T=32",
         stacks(8, 16, 65537, 4) + [tmask(8, 32)]),
        ("temporal_motif.motif", "T=4 N=4096", adjacency(4, 4096)),
        ("temporal_motif.motif", "T=4 N=4000", adjacency(4, 4000)),
    ]


SOURCES = {
    "delta_overlay.overlay": (
        "src/repro_torch/kernels/delta_overlay/delta_overlay.cu",
        "src/repro/kernels/delta_overlay/delta_overlay.py:42"),
    "delta_overlay.overlay_batch": (
        "src/repro_torch/kernels/delta_overlay/delta_overlay.cu",
        "src/repro/kernels/delta_overlay/delta_overlay.py:103"),
    "temporal_motif.motif": (
        "src/repro_torch/kernels/temporal_motif/temporal_motif.cu",
        "src/repro/kernels/temporal_motif/temporal_motif.py:32"),
    "temporal_pagerank.pagerank": (
        "src/repro_torch/kernels/temporal_pagerank/temporal_pagerank.cu",
        "src/repro/kernels/temporal_pagerank/temporal_pagerank.py:47"),
    "temporal_cc.cc": (
        "src/repro_torch/kernels/temporal_cc/temporal_cc.cu",
        "src/repro/kernels/temporal_cc/temporal_cc.py:46"),
}


# ---------------------------------------------------------------------------


def main() -> int:
    start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--events", type=int, default=200_000)
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    if args.device == "cpu":  # rehearsal of the main path, no result
        main_path(torch.device("cpu"), args.events)
        print("chip_smoke: CPU rehearsal only, no result", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # plain versions and yardsticks in full float32: TF32 would round the
    # PageRank products to a 10-bit mantissa
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    emit(phase="device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    # 2. build every kernel source, in parallel
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    seconds = _build.build()
    ptxas = {n: [ln.strip() for ln in _build.library(n).with_suffix(".log")
                 .read_text().splitlines() if "Used" in ln]
             for n in _build.NAMES}
    emit(phase="build", seconds=time.perf_counter() - t0, per_source=seconds,
         ptxas=ptxas)

    # 3. the main path on the card
    dev = torch.device("cuda")
    recorder = Recorder()
    launches = main_path(dev, args.events, recorder)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"kernels of the main path never launched: {missing}")

    # 4. each kernel against its plain version
    rows = []
    headlines = headline_inputs(dev)
    for kname, (source, replaces) in SOURCES.items():
        inputs = recorder.inputs.get((kname, "main path"))
        if inputs is None:
            fail(f"no main-path inputs recorded for {kname}")
        row = kernel_case(kname, inputs, "main path")
        others = [(tag, a) for (n, tag), a in recorder.inputs.items()
                  if n == kname and tag != "main path"]
        others += [(tag, a) for n, tag, a in headlines if n == kname]
        headline = {tag: kernel_case(kname, a, tag) for tag, a in others}
        rows.append(dict(name=kname, route="cuda", source=source,
                         replaces=replaces, launches=launches[kname],
                         max_abs_err=max([row["max_abs_err"]] + [
                             h["max_abs_err"] for h in headline.values()]),
                         ms=row["ms"], plain_ms=row["plain_ms"],
                         bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                         library_ms=row["library_ms"], shape=row["shape"],
                         headline=headline))
    emit(phase="done", seconds=time.perf_counter() - start)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
