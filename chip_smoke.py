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
   ``components`` plans.  Then the same read path over the wire
   (``service``): the same events and config indexed over a port
   ``LocalCluster`` of 3 subprocess cells (``repro_torch.service.cell``,
   file backend, r=2), the 64 snapshots and the single snapshot by the
   kernel fold bit for bit against the local host fold, the fused
   ``components T=128`` plan against the local one, then cell 0
   SIGKILLed and the 64 snapshots read again through failover.  Then the
   LM serving path: ``serve(
   "recurrentgemma-9b", batch=4, prompt_len=4096, gen_tokens=16)`` at
   full width and depth in bf16 with seeded weights (prefill seconds,
   decode tokens/s, parameter bytes, peak memory), a batch-1 check that
   prefill(S-1) + decode_step gives prefill(S)'s last logits, and the
   reduced config on the card against the CPU's plain versions.  Each
   serving path's decode attends through the ``decode_attention`` kernel,
   launched once an attention call of each decode step, and a batch-1
   decode step through it is held against the same step through its plain
   version (``decode_vs_plain``, the path's handoff bound).  Then the
   MoE and xLSTM families: ``serve("phi3.5-moe-42b-a6.6b", 4, 4096, 16)``
   at full width cut to MOE_LAYERS layers (``flash_attention`` once a
   layer) and ``serve("xlstm-350m", 4, 4096, 16)`` whole (no kernel), each
   with a handoff check (MoE: prefill(1023) + decode against
   prefill(1024) with capacity for every token; xLSTM: prefill(4096) +
   256 decode steps, each against the forward's logits over the 4352
   tokens at its position), and the reduced mixtral,
   phi3.5-moe, xlstm, whisper and phi-3-vision configs on the card
   against the CPU (forward, prefill and 4 decode steps within 1e-4).
   Then the LM training path: ``launch.train.run`` on ``recurrentgemma-9b`` at full
   width cut to 5 layers (float32 masters, bf16 activations, remat
   "full"), 3 AdamW steps on 2 x 4096 tokens of ``SyntheticLM(seed=0)``
   (losses, grad norms, seconds per step, peak memory, every parameter's
   step-0 gradient finite and non-zero), and the reduced config (float32)
   for 12 steps with a save every 4: a crash at step 8 and a resume give
   the same losses, and the CPU's plain versions the same within 1e-4;
   step 0's full-width loss must repeat 3047.7 (it runs only forward
   kernels), and the run prints the losses, step seconds and peak memory
   the CUDA-core attention backward gave beside its own.  Then
   ``multi-card on one card``: a 1-rank NCCL group (a FileStore under
   build/), ``sharded_degree_series`` over a ("workers",) mesh on the
   degree step's operand bit for bit against the ``mesh=None`` series;
   the same full-width training cut to 5 layers for 2 steps through
   ``Sharder.distribute`` on a (data=1, model=1) mesh (DTensor
   parameters and batches, the attention and RG-LRU kernels and their
   backward kernels through ``local_map``: 4, 2, 16 and 8 launches), its
   losses bit for bit the unsharded run's first two;
   ``compress_grads_podwise`` over a (pod=1, data=1) mesh on its layer-0
   gradients through NCCL's all-reduce, within one int8 quantum of the
   plain computation on the CPU.
   After training, the encoder-decoder and image-prefix families, whole: ``serve(
   "whisper-small", 32, 224, 16)`` (12 encoder layers over 32 × 1,500
   frames, 12 decoder layers with cross-attention; ``flash_attention`` 36
   times a prefill) and ``serve("phi-3-vision-4.2b", 4, 4096, 16)`` (576
   image embeddings before each prompt, S = 4,672, head dim 96; 32
   launches), each with a handoff check on seeded N(0, 1) frames or image
   embeddings (whisper: prefill(223) + decode against prefill(224);
   phi-3-vision: 576 + prefill(511) + decode against 576 + prefill(512)).
   Kernel launch counts are zeroed just before each path and read just
   after; a kernel of a path that never launched fails the run, the
   serve prefill must launch ``flash_attention`` 12 and ``rglru_scan`` 52
   times, the training run 6, 3 (backward), 24 and 12 (backward), the
   other serving paths ``flash_attention`` once an attention layer, once
   more a cross-attention layer and once an encoder layer, and every
   serving path ``decode_attention`` as often in each of its 15 decode
   steps, the encoder's layers apart.  Then the
   examples (phase 3h): ``examples/quickstart_torch.py`` and
   ``examples/temporal_analytics_torch.py`` at their reference sizes and
   the quickstart at 200,000 events, each on the card and on the CPU in
   this process, every result and printed line equal (floats within
   1e-5); ``examples/train_lm_torch.py`` at its reference settings for
   the reduced ``qwen3-1.7b``, ``qwen2-7b``, ``granite-3-8b`` and
   ``minitron-8b`` (card against CPU within 1e-4, the resumed step's
   loss bit for bit, failovers, the attention kernels and their backward
   launched), and at full width (``qwen3-1.7b``, 28 layers, batch 8 of
   1,024-token walks, 6 steps, a 20.6 GB save, the crash, the restore:
   seconds a step, peak memory, save and restore seconds, every step-0
   gradient finite and non-zero, the resumed loss bit for bit; its
   attention inputs go to phase 4).  Then the dense family (phase 3i):
   ``qwen3-1.7b``, ``qwen2-7b``, ``granite-3-8b`` and ``minitron-8b``
   whole at full width, ``serve(arch, B, 32_744, 16)`` (max_seq 32,768,
   decode_32k's length) at B = 8 for qwen3-1.7b and 4 for the others
   (``DENSE_BATCH``; a peak of 75 GB fails), ``flash_attention`` once a
   layer, its first layer's call held against the plain version on
   every block of 512 queries of every sequence, the ragged last one
   included; a batch-1 handoff, prefill(32,767) + decode against
   prefill(32,768), with three decode faults planted beside it (KV heads
   grouped h % KV must fail its bound; the position one off and the
   newest KV entry dropped are reported); and the reduced configs with
   grouped KV heads (8 over 2; qwen2-7b also 14 over 2) on the card
   against the CPU, with a float32 handoff that must reject all three
   faults.  Before it and before phase 4's long cases, the card bytes
   that only reference cycles hold are counted, and more than
   ``CYCLE_BYTES_MAX`` fails.  Then (phase 3j) the families that had
   trained only on the CPU, at full width through ``launch.train.run``
   (``TRAIN_FAMILIES``, 3 AdamW steps, remat "full", seeded weights, a
   depth cut handed in as ``params``): ``phi3.5-moe-42b-a6.6b`` cut to 2
   layers (2 x 4,096 tokens, the tokens each expert took in step 0),
   ``phi-3-vision-4.2b`` cut to ``VLM_TRAIN_LAYERS`` (2 x (576 zero image
   embeddings + 4,096 tokens)), ``whisper-small`` whole (32 x 448 tokens
   over 32 x 1,500 frames, the published 448-row table) and
   ``xlstm-350m`` whole (4 x 1,024 tokens): finite losses and gradient
   norms, every step-0 gradient finite and non-zero, a peak under 75 GB,
   ``flash_attention`` launched 2 x and its backward 1 x the attention
   calls of a forward each step; each path's layer-0 attention forward
   and backward (whisper's encoder, decoder and cross-attention apart)
   held against the plain versions over every head of every sequence,
   the plain versions run a few heads at a time (``per_heads``); and
   each family's reduced float32 config trained 6 steps on the card and
   on the CPU from the same weights, losses within 1e-4.  Last, the
   roofline of every timed path (each serving path's prefill and decode
   step, the training steps): its step dry-run on meta tensors at the same
   depth, batch and length (``repro_torch.launch.dryrun.dry_run``, in
   child processes of this script started before phase 3, ``--dry-runs``),
   and another child, ``MESH_DRY_RUN`` (``recurrentgemma-9b train_4k``)
   on the reference's 16 x 16 mesh over a fake group of 256 ranks, whose
   line prints its per-device counts, its collectives and its roofline
   with the collective term (CPU counts, not device metrics);
   one ``roofline`` line each with the model, counted and analytic FLOPs,
   the roofline's compute and memory terms at the H100's data-sheet peaks
   (``repro_torch.roofline.roofline``, which the kernels' bounds below
   read too), the measured seconds, ``mfu`` and ``roofline_share``, and
   the dry run's peak memory beside the measured one; a share over 1.05
   (the card beating its own roofline: a miscount) or a failed dry run
   fails the run;
4. kernels  — each kernel against its plain PyTorch version (bit for
   bit; PageRank within atol=1e-6, rtol=1e-5; attention, decode attention
   included, within 2e-5 in float32 and 2e-2 in bf16, RG-LRU within 2e-5,
   the reference's kernel test tolerances), on the inputs each step of the
   main paths gave it (decode attention: each serving path's first decode
   call, the encoder-decoder's cross-attention apart; the dense paths'
   held in phase 3i, untimed)
   (phase 3j's with the plain versions a few heads at a time, each timed
   beside SDPA's forward or backward for the same function),
   at headline shapes (the dense kernels in both of their regimes, each
   row naming the regime that ran: 0/1 stacks, a 10% dense one whose rows
   overflow the cluster kernels' row lists, and weighted asymmetric ones
   with negative entries and a 60% dense column, one beside a 0/1
   timepoint; motif also on an asymmetric stack with half its diagonal set; ``overlay_batch`` also on a wide snapshot group's mask,
   2 shared layers and one layer per timepoint; RG-LRU also on one
   4097-token prompt, a ragged last chunk; decode attention at the decode
   cell's shape and at the dense family's 32k decode, each beside SDPA
   over the cache expanded to the query heads; bf16 decode attention also
   within 2^-8 of its largest plain output, rtol 2^-7, limits a dropped
   range of the kernel's slots and P in fp8 must miss on these inputs,
   ``decode_forward_check``) and on the reference's
   kernel-test grid, plus a bf16
   case at each compiled head dim, the encoder-decoder and VLM shapes
   (bf16 at D = 96 causal, non-causal at S = 1500, cross-attention Sq =
   224 over Sk = 1500; the backward non-causal over a ragged Sk = 1500 in
   bf16 and float32) and the attention mask check: q = 0
   and v holding the bits of each key's position, so one key more or
   less in a window moves an output by more than its 2^-8 bound (with
   and without holes in k_pos); on every case the redesigned kernels are
   also held against the plain emulation of their decomposition
   (``overlay`` bit for bit against ``overlay_seeded_ref``,
   ``overlay_batch``'s pre-pass layer lists against ``layer_lists_ref``,
   RG-LRU within 2e-5 of ``rglru_chunked_ref``, the bf16 attention
   backward within 2^-10 of each output's largest value, rtol 2^-7, of
   ``attention_bwd_bf16_ref``, the float32 attention forward and backward
   within 2^-16 of it, rtol 2^-16, of ``attention_3xtf32_ref`` /
   ``attention_bwd_3xtf32_ref``, limits the one-term TF32 emulation must
   miss at D = 256; the float32 forward also at B=1 H=4 S=2048 D=256,
   window 1024, one KV head at stride 0); the backward kernels
   (``flash_attention.bwd``, ``rglru_scan.bwd``) on the inputs the train
   steps gave them and at headline shapes, against ``attention_bwd_ref``,
   ``rglru_bwd_ref`` and ``rglru_bwd_chunked_ref``, with limits that scale
   with each gradient's largest plain value (BWD_TOL: 2e-5 in float32,
   one bf16 step in bf16), each row printing that value beside its error;
   each backward case also shows that those limits reject a kernel with a
   planted fault (dQ zeroed, the delta term dropped; db zeroed, the carry
   between chunks dropped; on the train steps' inputs the carry and the
   float32 delta faults are only reported), and the forward's row
   log-sum-exp is held
   against ``lse_ref``; the RG-LRU backward also at W = 4094 (its
   per-lane load path), each case naming the load path it took and
   failing if the kernel left its scratch non-zero, its row carrying each
   path's registers, shared memory and blocks an SM;
   device times from
   CUDA events (decode attention's from ``torch.profiler``, its kernel's
   own time), beside the plain version's, the fastest of the PyTorch
   calls that compute the same function (for attention: SDPA with the
   boolean mask, with no mask where no key is masked, with ``is_causal``
   where the mask is exactly causal; each row names the call), and the
   bound: the larger of the bytes the function
   must move over the memory rate and the operations these inputs need
   over the peak rate for their type, both counted from the data (float32
   attention: three TF32 products a product, at the TF32 rate).
   Then the LM kernels at the reference's long shapes: ``flash_attention``
   at qwen2-7b's prefill_32k shape for one sequence and at long_500k's
   length as recurrentgemma-9b runs it (B = 1 and 2: 2^31 and 2^32 query
   elements), ``rglru_scan`` at long_500k's length (2^31 and 2^32
   elements an array), each run whole and held against its plain version
   on every block of 512 queries or every span of 4,096 steps, the plain
   scan carrying its own state from span to span (``long_cases``).
   Then ``overlay`` bit for bit at the edges of its seed from layer 0
   (``ref.overlay_edge_stacks``, K = 0, 1, 4, 5, 20) and on unaligned attrs,
   and ``overlay_batch`` at the edges the cases above do not reach: other
   K (0, 1, 3, 20, 1000), one layer, one timepoint; both folds on more
   than 2^31 attrs (64-bit indices).

Phase 1 also prints ``nvidia-smi``'s own line.  The line before the
last is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.  ``--device cpu --events N`` rehearses
phase 3 on the CPU with the plain versions (the wire cluster included,
the LM paths at their reduced config) and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
sys.path[:0] = [str(SRC), str(ROOT / "tools")]  # the port; the handoff inputs
if (SRC / "repro_torch" / "__init__.py").exists():  # else main() says so and exits 1
    # the H100 SXM5's data-sheet peaks, one source for the kernels' bounds
    # and the steps' rooflines
    from repro_torch.roofline.roofline import (
        FP32_FLOPS as FP32_OPS_PER_S,
        HBM_BW as HBM_BYTES_PER_S,
        INT32_OPS as INT32_OPS_PER_S,
        PEAK_FLOPS as BF16_OPS_PER_S,
        TF32_FLOPS as TF32_OPS_PER_S,
    )

PAGERANK_ATOL = 1e-5  # f32 device vs f64 host (taf/compile.py PageRankOp)
DENSE_PR_TOL = dict(atol=1e-6, rtol=1e-5)  # f32 sums in another order
# the reference's kernel-test tolerances (tests/test_kernels.py): f32 sums
# in another order; bf16 outputs rounded from nearby f32 values
ATTN_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
            torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
RGLRU_TOL = dict(atol=2e-5, rtol=2e-5)
# the backward kernels' outputs are gradients, whose size follows the loss
# and not the inputs (1e-4 and below on the full-width train step), so
# their atol is a share of each output's largest plain value (``scaled``):
# in float32 the reference's 2e-5; in bf16 one bf16 step (2^-7) at the
# element (the kernel's f32 sum rounding the other way) and one at the
# largest value
BWD_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
           torch.bfloat16: dict(atol=2.0 ** -7, rtol=2.0 ** -7)}
LSE_TOL = dict(atol=1e-4, rtol=1e-4)  # f32 row log-sum-exp, sums in another order
# the bf16 backward against the emulation of its own arithmetic
# (``attention_bwd_bf16_ref``: the same bf16 roundings of P^T, dS^T and dS):
# the f32 sums differ only in order, so an output may round to the other
# side of a bf16 step (rtol) and the rest is 2^-10 of the largest value,
# 8 times tighter than BWD_TOL
BWD_BF16_REF_TOL = dict(atol=2.0 ** -10, rtol=2.0 ** -7)
# the float32 attention kernels against the emulation of their 3xTF32
# arithmetic (``attention_3xtf32_ref``, ``attention_bwd_3xtf32_ref``): the
# same split products, summed in float32 in another order and, inside the
# tensor cores, with another rounding of the accumulator, whose drift grows
# with the length of a sum (dV over 1,024 queries at the S=2048 headline
# sits 7.4e-6 of its largest value from the emulation, as far as from the
# plain version); so 2^-16 of each output's largest value (and rtol 2^-16),
# a third tighter than the float32 BWD_TOL, while one TF32 product alone
# is off by ~2^-11 of a product (~3e-4 of the largest value at D = 256)
F32_REF_TOL = dict(atol=2.0 ** -16, rtol=2.0 ** -16)
# the bf16 attention forward, per output: one bf16 step at the element
# (rtol: the kernel's float32 sum and the plain version's round to either
# side of it) and 2^-8 of the largest value.  ATTN_TOL's atol, 2e-2, is
# above every output of a non-causal row over 1,500 keys of randn * 0.5
# (~0.013, at most ~0.05), so faults of the ragged last key tile, which move
# such rows by 2-6%, would pass it; these limits reject them
# (``bf16_forward_check``)
FWD_BF16_TOL = dict(atol=2.0 ** -8, rtol=2.0 ** -7)
# the bf16 forward's key tile (BM in flash_attention.cu)
FA_KEY_TILE = 64
# the mask check (q = 0, v = key-position bits): bf16 rounds its outputs by
# at most 2^-9, one key more or less in a window of 64 moves a bit column
# by at least 0.5 / 65
MASK_TOL = dict(atol=2.0 ** -8, rtol=0.0)


def scaled(tol, want) -> dict:
    """``tol`` with its atol taken as a share of max |want|."""
    return dict(atol=tol["atol"] * float(want.float().abs().max()), rtol=tol["rtol"])


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
    return fused.value


class Recorder:
    """Keeps the first inputs each kernel wrapper is given in each step
    (``tag``) of the main path, so phase 4 can hold the kernel against its
    plain version on exactly those inputs.  ``variant`` (args, kw) -> a
    suffix of the tag keeps the first call of each kind apart (an
    encoder-decoder's encoder, decoder and cross-attention calls).
    ``last`` keeps the last call instead, until ``sealed`` is set (a
    backward pass runs the layers in reverse: its last call in step 0 is
    layer 0's).  ``host`` keeps the copies in host memory: a small copy
    made on the card mid-path can pin an allocator segment through the
    training phases (decode attention's, recorded mid-step; ``on_card``
    brings them back)."""

    def __init__(self):
        self.inputs = {}  # (kernel name, tag) -> args
        self.tag = "main path"
        self.sealed = False
        self._undo = []

    def wrap(self, mod, fn: str, name: str, variant=None, last: bool = False,
             host: bool = False):
        orig = getattr(mod, fn)

        def shim(*args, **kw):
            tag = self.tag + (variant(args, kw) if variant is not None else "")
            if (name, tag) not in self.inputs or (last and not self.sealed):
                self.inputs[(name, tag)] = ([_keep(a, host) for a in args], dict(kw))
            return orig(*args, **kw)

        setattr(mod, fn, shim)
        self._undo.append((mod, fn, orig))

    def restore(self):
        for mod, fn, orig in self._undo:
            setattr(mod, fn, orig)
        self._undo.clear()
        self.sealed = False


def _keep(a, host: bool = False):
    """A copy of ``a`` with its layout: strides kept, and a stride-0 axis
    (an expanded KV head) kept at stride 0 over one copied slice; in host
    memory with ``host``."""
    if not torch.is_tensor(a):
        return a
    base = a.detach()
    for d, (n, s) in enumerate(zip(a.shape, a.stride())):
        if s == 0 and n > 1:
            base = base.narrow(d, 0, 1)
    return (base.cpu() if host else base.clone()).expand(a.shape)


def on_card(args: list, device) -> list:
    """Recorded inputs on ``device`` (those a ``host`` recorder kept)."""
    return [a.to(device) if torch.is_tensor(a) else a for a in args]


def main_path(device, n_events: int, recorder=None):
    """Returns the kernels' launch counts and what the service phase
    holds the wire store against: the events, the config, the 64
    timepoints and their host-fold snapshots, the single snapshot, and
    the fused ``components T=128`` plan with its result."""
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
    host64 = store.snapshots(ts, use_kernel=False)
    t2 = time.perf_counter()
    kern = store.snapshots(ts, use_kernel=True)
    t3 = time.perf_counter()
    for j, (a, b) in enumerate(zip(kern, host64)):
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
    cc_points = np.linspace(q0, q1 - 1, 128).astype(np.int64)
    components = fused_and_staged(sub.node_compute(
        tc.components(), style="temporal", points=cc_points), "components T=128")
    fused_and_staged(sub.node_compute(
        tc.pagerank(), style="temporal",
        points=np.linspace(q0, q1 - 1, 32).astype(np.int64)), "pagerank T=32",
        exact=False)
    sub16 = sub.filter(node_ids=range(1500))
    ts16 = np.linspace(q0, q1 - 1, 16).astype(np.int64)
    fused_and_staged(sub16.node_compute(tc.triangles(), style="temporal",
                                        points=ts16), "triangles T=16")
    degree_sots = sub.materialize().operand
    degree_ts = np.linspace(q0, q1 - 1, 128).astype(np.int64)
    degree = kernel_style_degree(device, degree_sots, degree_ts)
    dense_analytics(device, sub16.materialize().operand, ts16)

    if recorder is not None:
        recorder.restore()
    launches = {f"{name}.{k}": v for name, mod in kernel_ops.items()
                for k, v in mod.LAUNCHES.items()}
    emit(phase="main_path", check="launches", launches=launches,
         plan_compile=store.cache_stats()["plan_compile"])
    local = dict(events=events, cfg=store.cfg, ts=ts, host=host64, t_one=t_one,
                 one_host=one_host, cc_span=(q0, q1), cc_points=cc_points,
                 components=components, degree=(degree_sots, degree_ts, degree))
    return launches, local


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
    return series


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
# Phase 3b: the read path over the wire
# ---------------------------------------------------------------------------


def service_path(device, local) -> None:
    """The main path's events and config indexed over a port
    ``LocalCluster`` of 3 subprocess cells (file backend, r=2), then
    Algorithm 1 over the wire with the kernel fold on ``device``: the 64
    snapshots and one single snapshot bit for bit against the local
    store's host fold, and the fused ``components T=128`` plan against the
    local store's; then cell 0 is SIGKILLed and the 64 snapshots are read
    again through the surviving replicas (a read that fails raises, and
    the phase with it).  The delta_overlay launches are counted from 0
    just before the snapshots and read after the second pass: on the card
    both kernels must have launched."""
    import tempfile

    from repro_torch.kernels.delta_overlay import ops as ov_ops
    from repro_torch.service import ClusterSpec, LocalCluster
    from repro_torch.taf import HistoricalGraphStore
    from repro_torch.taf import compile as tc
    from repro_torch.taf.plan import PlanExecutor

    ts, host = local["ts"], local["host"]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cells-") as root, \
            LocalCluster(ClusterSpec(n_cells=3, r=2, backend="file", root=root),
                         mode="subprocess") as cluster:
        modules = [proc.args[2] for proc in cluster._procs]
        if modules != ["repro_torch.service.cell"] * 3:
            fail(f"service: the cluster spawned {modules}")
        client = cluster.client(timeout=2.0, retries=1, backoff=0.02, suspect_ttl=30.0)
        t0 = time.perf_counter()
        store = HistoricalGraphStore.build(local["events"], local["cfg"], store=client,
                                           device=device)
        build_s = time.perf_counter() - t0
        for k in ov_ops.LAUNCHES:
            ov_ops.LAUNCHES[k] = 0

        def snapshots(what):
            t = time.perf_counter()
            got = store.snapshots(ts, use_kernel=True)
            seconds = time.perf_counter() - t
            for j, (a, b) in enumerate(zip(got, host)):
                same_state(a, b, f"service {what}: snapshots[{j}] t={ts[j]}")
            return seconds

        fold_s = snapshots("wire")
        store.tgi.invalidate_caches()
        one = store.snapshot(local["t_one"], use_kernel=True)
        same_state(one, local["one_host"], f"service: snapshot t={local['t_one']}")
        q0, q1 = local["cc_span"]
        PlanExecutor._replay_cache.clear()  # the plan must read over the wire
        t1 = time.perf_counter()
        plan = store.subgraphs(q0, q1).node_compute(
            tc.components(), style="temporal", points=local["cc_points"]).run()
        plan_s = time.perf_counter() - t1
        if not any("compile: fused" in n for n in plan.notes):
            fail(f"service: components T=128 not fused: {plan.notes}")
        for got, want in zip(plan.value, local["components"]):
            if not np.array_equal(np.asarray(got), np.asarray(want)):
                fail("service: components T=128 over the wire != the local store's")
        before_kill = client.stats.failovers
        cluster.kill(0)
        client.clear_pool()
        store.tgi.invalidate_caches()
        fold_killed_s = snapshots("cell 0 killed")
        failovers = client.stats.failovers - before_kill
        if failovers <= 0:
            fail("service: no failover after cell 0 was killed")
        launches = dict(ov_ops.LAUNCHES)
        client.close()
    if device.type == "cuda" and 0 in launches.values():
        fail(f"service: a delta_overlay kernel never launched: {launches}")
    emit(phase="service", cells=3, r=2, backend="file", events=len(local["events"]),
         T=len(ts), wire_build_seconds=build_s, kernel_fold_seconds=fold_s,
         components_T128_seconds=plan_s, kernel_fold_seconds_cell0_killed=fold_killed_s,
         failovers=failovers, launches=launches)


# ---------------------------------------------------------------------------
# Phase 3c: the LM serving path
# ---------------------------------------------------------------------------

LM_ARCH = "recurrentgemma-9b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 4096, 16
# at full depth: a prefill's, and decode_attention once an attention layer
# in each of the LM_GEN - 1 decode steps
LM_LAUNCHES = {"flash_attention": 12, "rglru_scan": 52, "decode_attention": 12 * (LM_GEN - 1)}
# prefill(S-1) + decode_step against prefill(S), both in bf16.  bf16
# serving of this 38-layer stack with random weights departs from its
# own f32 answer by 2.6-3.5% (relative L2 of the last logits), and the
# two paths round at other places in every layer, so each may sit that
# far from it; faults of the cache handoff (ring roll dropped, conv tail
# lost, window ignored) move the logits by 10-45%
# (tools/lm_bf16_consistency.py, on the CPU at widths 64 and 256).  The
# bound lies between: relative L2 under 2^-4.
LM_CONSISTENCY_REL = 2.0 ** -4
LM_REDUCED_TOL = dict(atol=1e-4, rtol=1e-4)  # f32, card kernels vs CPU plain
# a reduced float32 decode step against the forward at its position:
# relative L2, where float32 sums in another order give ~1e-7 and a decode
# position one off moves the logits by percents (``reduced_handoff``
# plants it and requires it rejected)
LM_REDUCED_HANDOFF_REL = 1e-4


def lm_serve(device, recorder=None, reduced=False):
    """``serve(LM_ARCH, 4, 4096, 16)`` on ``device`` with seeded weights,
    kernel launches counted around it; then the batch-1 self-consistency
    check of prefill + decode_step against a longer prefill."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import lm

    cfg = serve_mod.serving_config(LM_ARCH, reduced=reduced)
    prompt = LM_PROMPT if not reduced else 48
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init(cfg, seed=0, device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    kernel_ops = {"flash_attention": fa_ops, "rglru_scan": rg_ops, "decode_attention": dec_ops}
    if recorder is not None:
        recorder.tag = "main path"
        recorder.wrap(fa_ops, "flash_attention", "flash_attention")
        recorder.wrap(rg_ops, "rglru", "rglru_scan")
        recorder.wrap(dec_ops, "decode_attention", "decode_attention", host=True)
    for mod in kernel_ops.values():
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    gen, stats = serve_mod.serve(LM_ARCH, LM_BATCH, prompt, LM_GEN, reduced=reduced,
                                 seed=0, device=device, params=model)
    launches = {"flash_attention": fa_ops.LAUNCHES["flash_attention"],
                "rglru_scan": rg_ops.LAUNCHES["rglru"],
                "decode_attention": dec_ops.LAUNCHES["decode_attention"]}
    if recorder is not None:
        recorder.restore()
    if any(mod.LAUNCHES.get("bwd") for mod in kernel_ops.values()):
        fail("lm serve launched a backward kernel")
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    if gen.shape != (LM_BATCH, LM_GEN) or not ((gen >= 0) & (gen < cfg.vocab_size)).all():
        fail(f"lm serve: tokens {gen.shape} outside [0, {cfg.vocab_size})")
    if not stats["logits_finite"]:
        fail("lm serve: non-finite decode logits")
    emit(phase="main_path", check="lm serve", arch=LM_ARCH, reduced=reduced,
         layers=cfg.n_layers, d_model=cfg.d_model, batch=LM_BATCH, prompt_len=prompt,
         gen_tokens=LM_GEN, dtype=cfg.dtype, init_seconds=init_s,
         prefill_seconds=stats["prefill_s"], decode_seconds=stats["decode_s"],
         decode_tok_per_s=stats["tok_per_s"],
         param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
         peak_memory_bytes=peak, launches=launches, first_tokens=gen[0, :4].tolist())
    timed_serve("lm serve", stats, peak)
    lm_consistency(model, prompt)
    decode_vs_plain(model, prompt - 1, LM_CONSISTENCY_REL, "lm decode kernel vs plain")
    return launches


def timed_serve(tag: str, stats: dict, peak) -> None:
    """Keep a serving path's prefill seconds and seconds a decode step
    (the mean of its LM_GEN - 1 steps) for the roofline phase."""
    TIMED[f"{tag} prefill"] = dict(seconds=stats["prefill_s"], peak_memory_bytes=peak)
    TIMED[f"{tag} decode"] = dict(seconds=stats["decode_s"] / (LM_GEN - 1),
                                  peak_memory_bytes=peak)


def lm_consistency(model, S: int):
    """Batch 1: prefill(S-1) then decode_step at position S-1 gives the
    last-token logits of prefill(S).  S > window, so the ring cache (rolled
    at prefill, overwritten by the decode) and the RG-LRU state handoff run
    through both paths."""
    handoff_check(model, S - 1, 1, LM_CONSISTENCY_REL, "lm prefill+decode vs prefill")


def handoff_logits(model, prefill_len: int, steps: int, inputs: dict) -> tuple:
    """Batch 1: prefill(prefill_len), then ``steps`` decode steps
    teacher-forced on the same tokens: (each step's logits, what they
    should be).  One step: the last-token logits of prefill(prefill_len +
    1).  More: the forward's logits at each step's position over the whole
    sequence (the same pass as its prefill, all positions kept).
    ``inputs``: the image embeddings or frames every pass takes; decode
    positions start after the image prefix, and the cache has room for
    it."""
    dev = model.embed.device
    n = prefill_len + steps
    n_img = model.cfg.n_img_tokens
    tokens = handoff_tokens(model, n)
    with torch.inference_mode():
        if steps == 1:
            want = model.prefill(tokens, cache_len=n_img + n + 8, **inputs)[0][0]
        else:
            want = model(tokens, **inputs)[0, n_img + prefill_len:]
        _, caches = model.prefill(tokens[:, :prefill_len], cache_len=n_img + n + 8, **inputs)
        got = []
        for t in range(prefill_len, n):
            step, caches = model.decode_step(
                caches, tokens[:, t:t + 1], torch.tensor([n_img + t], dtype=torch.int32,
                                                         device=dev))
            got.append(step[0, -1])
    return torch.stack(got), want


def handoff_tokens(model, n: int):
    """The handoff checks' (1, n) int32 tokens, seeded, on the model's device."""
    return torch.from_numpy(np.random.RandomState(1).randint(
        0, model.cfg.vocab_size, size=(1, n)).astype(np.int32)).to(model.embed.device)


def step_rels(got, want) -> list:
    """Each decode step's relative L2 against what it should be."""
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).tolist()


def handoff_check(model, prefill_len: int, steps: int, bound: float, what: str,
                  steps_bound=None, inputs=None, logits=None, **note):
    """``handoff_logits`` (or ``logits``, the same pair computed by the
    caller): the first step's relative L2 (the handoff) must be within
    ``bound``, every step's within ``steps_bound`` (default ``bound``).
    ``note`` goes into the printed line; a callable in it is called after
    the run."""
    inputs = inputs or {}
    got, want = logits if logits is not None else handoff_logits(model, prefill_len, steps,
                                                                   inputs)
    if not (torch.isfinite(want).all() and torch.isfinite(got).all()):
        fail(f"{what}: non-finite logits")
    rels = step_rels(got, want)
    steps_bound = bound if steps_bound is None else steps_bound
    emit(phase="main_path", check=what, arch=model.cfg.name, layers=model.cfg.n_layers,
         S=model.cfg.n_img_tokens + prefill_len + steps, prefill_len=prefill_len,
         decode_steps=steps, rel_l2=rels[0], bound=bound,
         margin=bound / rels[0] if rels[0] > 0 else None,
         frontend_inputs=sorted(inputs), n_img_tokens=model.cfg.n_img_tokens,
         max_step_rel_l2=max(rels), steps_bound=steps_bound, last_step_rel_l2=rels[-1],
         max_abs_diff=float((got - want).abs().max()), max_abs=float(want.abs().max()),
         same_argmax=float((got.argmax(-1) == want.argmax(-1)).float().mean()),
         **{k: v() if callable(v) else v for k, v in note.items()})
    if not (rels[0] <= bound and max(rels) <= steps_bound):
        fail(f"{what}: relative L2 {rels[0]} at the first step (bound {bound}), "
             f"{max(rels)} at most (bound {steps_bound})")


@contextlib.contextmanager
def plain_decode_attention():
    """Decode attention through its plain version (``decode_attention_ref``,
    the arithmetic the kernel replaced) on any device, for the checks that
    hold the kernel's path against it."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref

    kernel = dec_ops.decode_attention
    dec_ops.decode_attention = dec_ref.decode_attention_ref
    try:
        yield
    finally:
        dec_ops.decode_attention = kernel


def decode_calls(model) -> int:
    """``decode_attention`` calls of one decode step: one an attention
    layer, one more a layer with cross-attention."""
    return sum(1 + b.cross for b in model.layers if b.kind == "attn")


def decode_vs_plain(model, prefill_len: int, bound: float, what: str, inputs=None) -> None:
    """Batch 1: prefill(prefill_len), then one decode step from that cache
    through the ``decode_attention`` kernel and one from a copy of it
    through the plain version: the logits' relative L2 within ``bound``
    (the path's handoff bound: both round in bf16, at other places) and the
    kernel launched ``decode_calls`` times (on the CPU both are the plain
    version and nothing launches)."""
    from torch.utils._pytree import tree_map

    from repro_torch.kernels.decode_attention import ops as dec_ops

    if not decode_calls(model):
        return
    dev = model.embed.device
    n_img = model.cfg.n_img_tokens
    tokens = handoff_tokens(model, prefill_len + 1)
    pos = torch.tensor([n_img + prefill_len], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        _, caches = model.prefill(tokens[:, :prefill_len], cache_len=n_img + prefill_len + 8,
                                  **(inputs or {}))
        copy = tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, caches)
        before = dec_ops.LAUNCHES["decode_attention"]
        got = model.decode_step(caches, tokens[:, prefill_len:], pos)[0][0, -1]
        launched = dec_ops.LAUNCHES["decode_attention"] - before
        with plain_decode_attention():
            want = model.decode_step(copy, tokens[:, prefill_len:], pos)[0][0, -1]
    del caches, copy
    rel = step_rels(got[None], want[None])[0]
    want_launches = decode_calls(model) if dev.type == "cuda" else 0
    emit(phase="main_path", check=what, arch=model.cfg.name, layers=model.cfg.n_layers,
         prefill_len=prefill_len, n_img_tokens=n_img, frontend_inputs=sorted(inputs or {}),
         rel_l2=rel, bound=bound, margin=bound / rel if rel > 0 else None,
         max_abs_diff=float((got - want).abs().max()), max_abs=float(want.abs().max()),
         same_argmax=bool(got.argmax() == want.argmax()), launches=launched,
         want_launches=want_launches)
    if not (torch.isfinite(got).all() and rel <= bound):
        fail(f"{what}: the kernel's decode step {rel} (relative L2) from the plain version's, "
             f"bound {bound}")
    if launched != want_launches:
        fail(f"{what}: decode_attention launched {launched} times, not {want_launches}")


def reduced_handoff(model, inputs: dict) -> dict:
    """The reduced encoder-decoder, VLM or dense config (float32) on the
    card: prefill(80) + 4 decode steps against the forward over 84 tokens,
    every step within LM_REDUCED_HANDOFF_REL; then the same with a decode
    fault planted that the bf16 handoffs cannot see (the decode position
    one off; whisper's learned position one off at decode, the table read
    one row late; for a dense config also the newest KV entry dropped and
    KV heads grouped h % KV, ``dense_decode_faults``), each of which the
    same bound must reject.  Returns each fault's largest step relative
    L2."""
    from lm_bf16_consistency import dense_decode_faults

    what = f"{model.cfg.name} reduced prefill+decode vs forward (float32)"
    decode, table = model.decode_step, model.pos

    def position_one_off(caches, tokens, pos):
        return decode(caches, tokens, pos + 1)

    def learned_one_off(caches, tokens, pos):
        model.pos = torch.nn.Parameter(torch.roll(table.detach(), -1, 0), requires_grad=False)
        try:
            return decode(caches, tokens, pos)
        finally:
            model.pos = table

    faults = {"decode position one off": position_one_off}
    if table is not None:
        faults["learned position one off"] = learned_one_off
    if model.cfg.family == "dense":
        faults = dense_decode_faults(model)
    planted = {}
    for fault, step in faults.items():
        model.decode_step = step
        try:
            planted[fault] = max(step_rels(*handoff_logits(model, 80, 4, inputs)))
        finally:
            del model.decode_step
        if not planted[fault] > LM_REDUCED_HANDOFF_REL:
            fail(f"{what}: '{fault}' passes the bound {LM_REDUCED_HANDOFF_REL} "
                 f"(relative L2 {planted[fault]})")
    handoff_check(model, 80, 4, LM_REDUCED_HANDOFF_REL, what, inputs=inputs,
                  planted_max_step_rel_l2=planted)
    return planted


def lm_reduced_card_vs_cpu(device, arch: str = LM_ARCH, heads=None):
    """``arch``'s reduced config (float32, head dim 16; ``heads``: its
    (query, KV) head counts replaced, so grouped KV heads stay grouped) on
    the card through its kernels against the same weights on the CPU
    through the plain versions: forward logits, prefill logits and 4
    decode steps' logits within 1e-4.  Then, for a config with a frontend
    or a dense one, ``reduced_handoff`` on the card."""
    from lm_bf16_consistency import frontend_inputs
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import lm

    cfg = serve_mod.serving_config(arch, reduced=True)
    if heads:
        cfg = cfg.replace(n_heads=heads[0], n_kv_heads=heads[1])
    card = lm.init(cfg, seed=3, device=device, max_seq=96)
    host = lm.from_state_dict(cfg, {k: v.cpu() for k, v in card.state_dict().items()},
                              device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, size=(2, 84)).astype(np.int32))
    extra = frontend_inputs(cfg, 2, torch.device("cpu"))
    on_card = {k: v.to(device) for k, v in extra.items()}
    n_img = cfg.n_img_tokens
    err = 0.0

    def check(got, want, what):
        nonlocal err
        got = got.cpu()
        if not torch.allclose(got, want, **LM_REDUCED_TOL):
            fail(f"lm reduced {arch}: {what}, card vs CPU max err "
                 f"{float((got - want).abs().max())}")
        err = max(err, float((got - want).abs().max()))

    with torch.inference_mode():
        check(card(tokens[:, :80].to(device), **on_card), host(tokens[:, :80], **extra),
              "forward")
        got, c_card = card.prefill(tokens[:, :80].to(device), cache_len=n_img + 96, **on_card)
        want, c_host = host.prefill(tokens[:, :80], cache_len=n_img + 96, **extra)
        check(got, want, "prefill")
        for t in range(80, 84):
            pos = torch.full((2,), n_img + t, dtype=torch.int32)
            got, c_card = card.decode_step(c_card, tokens[:, t:t + 1].to(device),
                                           pos.to(device))
            want, c_host = host.decode_step(c_host, tokens[:, t:t + 1], pos)
            check(got, want, f"decode step {t - 80}")
    emit(phase="main_path", check="lm reduced card vs cpu", arch=arch, layers=cfg.n_layers,
         kinds=sorted({b.kind for b in card.layers}), moe=cfg.is_moe, window=cfg.window,
         heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, enc_layers=len(card.enc_layers or ()),
         n_img_tokens=n_img, frontend_inputs=sorted(extra), max_abs_err=err,
         tol=LM_REDUCED_TOL)
    if extra or cfg.family == "dense":
        reduced_handoff(card, frontend_inputs(cfg, 1, device))


# ---------------------------------------------------------------------------
# Phase 3e: the MoE and xLSTM families
# ---------------------------------------------------------------------------

MOE_ARCH, XLSTM_ARCH = "phi3.5-moe-42b-a6.6b", "xlstm-350m"
# phi3.5-moe at full width, cut in depth: a layer holds 1,300,316,160
# parameters (16 experts x 3 x 4096 x 6400, 41.9 M of attention), 2.60 GB
# in bf16, the embedding and LM head 0.53 GB: all 32 layers need 83.7 GB,
# more than the card holds.  MOE_LAYERS is the deepest cut whose serving
# peak (weights, KV cache and one layer's dispatch buffers) stays under
# about 75 GB.
MOE_LAYERS = 26
# the MoE handoff check runs one routing group each way: prefill(1023) +
# decode against prefill(1024)
MOE_HANDOFF_S = 1024
# the xLSTM handoff check: prefill(4096), then 256 teacher-forced decode
# steps against the forward over the 4352 tokens: the mLSTM chunk carry (16
# chunks of 256), mlstm_step and the sLSTM state across the handoff
XLSTM_PREFILL, XLSTM_STEPS = 4096, 256
# the MoE handoff in bf16: 1.2% (width 64) and 7.4% (width 256, where bf16
# rounding gave one of the 24 layers other experts for the last token)
# relative L2; faults of the handoff move it 58-130% (the prompt's KV lost,
# the layers' caches handed to the wrong layers, the decode token's FFN
# dropped; tools/lm_bf16_consistency.py, on the CPU).  The bound lies
# between, with room for a routing flip or two at full width.  Faults
# smaller than the bf16 noise (one KV entry lost, 1.9-37%; the decode
# position one off, 4.1-4.5%) are beyond this check.
MOE_CONSISTENCY_REL = 2.0 ** -2
# the xLSTM handoff in bf16, relative L2 at the first decode step: 1.6%
# (width 64) and 2.2% (width 256) on the CPU, 5.0% at full width on an
# H100; its faults move that step 28-34% (the sLSTM h reset) and 114-142%
# (the mLSTM conv tail dropped; tools/lm_bf16_consistency.py, on the CPU).
# The bound lies between.  Zeroing the mLSTM stabilizer m moves it 4.8-4.9%,
# inside the bf16 noise: beyond this check.  Over the 256 steps bf16 drift
# reaches 13-23% and the faults wash out (the last step moves 8.1-9.6% with
# or without them), so the later steps are held only to 2^-1: a decode step
# that goes wrong, not the handoff.
XLSTM_CONSISTENCY_REL = 2.0 ** -3
XLSTM_STEPS_REL = 2.0 ** -1
AUDIO_ARCH, VLM_ARCH = "whisper-small", "phi-3-vision-4.2b"
FAMILY_REDUCED = ("mixtral-8x22b", MOE_ARCH, XLSTM_ARCH, AUDIO_ARCH, VLM_ARCH)


def attention_call_kind(args, kw) -> str:
    """The recorder's tag suffix of a ``flash_attention`` call: "" for
    causal self-attention, " (encoder)" for non-causal self-attention,
    " (cross)" for non-causal attention over another sequence."""
    if kw.get("causal", True):
        return ""
    return " (cross)" if args[0].shape[2] != args[1].shape[2] else " (encoder)"


def attention_launches(model) -> int:
    """``flash_attention`` launches of one prefill: one per attention
    layer, one more per decoder layer with cross-attention, one per
    encoder layer (the cache's second pass and the decode attend in plain
    torch)."""
    return sum(1 + b.cross for b in model.layers if b.kind == "attn") + \
        len(model.enc_layers or ())


def family_serve(device, arch: str, layers=None, recorder=None, reduced=False,
                 batch: int = LM_BATCH, prompt: int = LM_PROMPT, tag=None):
    """``serve(arch, batch, prompt, 16)`` in bf16 with seeded weights at
    full width (cut to ``layers`` layers when given), the kernels' launch
    counts zeroed just before and read just after: ``flash_attention``
    must launch ``attention_launches`` times (in the prefill),
    ``decode_attention`` ``decode_calls`` times in each of the LM_GEN - 1
    decode steps, and no other kernel at all.  ``tag`` names
    the path (default "<family> serve").  Returns (model, launches)."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import lm

    full = serve_mod.serving_config(arch, reduced=reduced)
    cfg = full.replace(n_layers=layers) if layers and not reduced else full
    prompt = prompt if not reduced else 48
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init(cfg, seed=0, device=device, max_seq=prompt + LM_GEN + 8)
    sync(device)
    init_s = time.perf_counter() - t0
    tag = tag or f"{cfg.family} serve"
    if recorder is not None:
        recorder.tag = tag
        recorder.wrap(fa_ops, "flash_attention", "flash_attention", attention_call_kind)
        # a cross-attention call attends the encoder's output: enc_seq slots
        recorder.wrap(dec_ops, "decode_attention", "decode_attention",
                      lambda args, kw: " (cross)" if cfg.is_encdec
                      and args[0].shape[1] == cfg.enc_seq else "", host=True)
    for mod in (fa_ops, rg_ops, dec_ops):
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    try:
        gen, stats = serve_mod.serve(arch, batch, prompt, LM_GEN, reduced=reduced, seed=0,
                                     device=device, params=model)
    finally:
        if recorder is not None:
            recorder.restore()
    launches = {"flash_attention": fa_ops.LAUNCHES["flash_attention"],
                "flash_attention.bwd": fa_ops.LAUNCHES["bwd"],
                "rglru_scan": rg_ops.LAUNCHES["rglru"], "rglru_scan.bwd": rg_ops.LAUNCHES["bwd"],
                "decode_attention": dec_ops.LAUNCHES["decode_attention"]}
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    want = dict.fromkeys(launches, 0)
    if device.type == "cuda":
        want["flash_attention"] = attention_launches(model)
        want["decode_attention"] = (LM_GEN - 1) * decode_calls(model)
    emit(phase="main_path", check=tag, arch=arch, reduced=reduced, layers=cfg.n_layers,
         full_depth=full.n_layers, enc_layers=len(model.enc_layers or ()),
         enc_seq=cfg.enc_seq if cfg.is_encdec else None, n_img_tokens=cfg.n_img_tokens,
         d_model=cfg.d_model, batch=batch, prompt_len=prompt, gen_tokens=LM_GEN,
         cache_len=stats["cache_len"], dtype=cfg.dtype, init_seconds=init_s,
         prefill_seconds=stats["prefill_s"], decode_seconds=stats["decode_s"],
         decode_tok_per_s=stats["tok_per_s"], params=sum(p.numel() for p in model.parameters()),
         param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
         peak_memory_bytes=peak, launches=launches, first_tokens=gen[0, :4].tolist())
    if gen.shape != (batch, LM_GEN) or not ((gen >= 0) & (gen < cfg.vocab_size)).all():
        fail(f"{tag}: tokens {gen.shape} outside [0, {cfg.vocab_size})")
    if not stats["logits_finite"]:
        fail(f"{tag}: non-finite decode logits")
    if launches != want:
        fail(f"{tag} launched {launches}, not {want}")
    timed_serve(tag, stats, peak)
    return model, launches


def _with_config(model, cfg) -> None:
    """Run ``model`` under ``cfg`` (a copy that differs in a routing option)."""
    model.cfg = cfg
    for layer in model.layers:
        layer.cfg = cfg


def moe_consistency(model) -> None:
    """prefill(S-1) + decode_step against prefill(S), S one routing group,
    under a copy of the config with capacity_factor = n_experts / top_k:
    an expert then has a slot for every token of a group, so no token is
    dropped (asserted from ``_capacity``) and both paths compute the same
    function.  With the served capacity they do not: dropping depends on a
    token's rank in its group, and the last token is the first to go."""
    from repro_torch.models import moe

    cfg = model.cfg
    check = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    for g in (MOE_HANDOFF_S - 1, MOE_HANDOFF_S, 1):
        if moe._capacity(check, g) < g:
            fail(f"moe handoff: capacity {moe._capacity(check, g)} < {g} tokens a group")
    picks, route = [], moe._route

    def recording(p, x2d, cfg):  # each layer's experts for the sequence's last token
        out = route(p, x2d, cfg)
        picks.append(set(out[1][-1].tolist()))
        return out

    _with_config(model, check)
    moe._route = recording
    try:
        handoff_check(model, MOE_HANDOFF_S - 1, 1, MOE_CONSISTENCY_REL,
                      "moe prefill+decode vs prefill", capacity_factor=check.capacity_factor,
                      capacity=moe._capacity(check, MOE_HANDOFF_S), tokens_dropped=0,
                      routing_differs_in_layers=lambda: sum(
                          a != b for a, b in zip(picks[:len(model.layers)],
                                                 picks[-len(model.layers):])))
    finally:
        moe._route = route
        _with_config(model, cfg)


def family_paths(device, recorder=None, reduced=False) -> dict:
    """The MoE and xLSTM serving paths with their handoff checks, then (on
    the card) the three reduced configs against the CPU.  Returns each
    serving path's launches."""
    model, moe_launches = family_serve(device, MOE_ARCH, MOE_LAYERS, recorder, reduced)
    moe_consistency(model)
    decode_vs_plain(model, MOE_HANDOFF_S - 1, MOE_CONSISTENCY_REL, "moe decode kernel vs plain")
    del model
    model, xlstm_launches = family_serve(device, XLSTM_ARCH, None, recorder, reduced)
    prefill_len, steps = (XLSTM_PREFILL, XLSTM_STEPS) if not reduced else (48, 16)
    handoff_check(model, prefill_len, steps, XLSTM_CONSISTENCY_REL,
                  "xlstm prefill+decode vs prefill", steps_bound=XLSTM_STEPS_REL)
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
        for arch in FAMILY_REDUCED:
            lm_reduced_card_vs_cpu(device, arch)
    return {"moe serve": moe_launches, "ssm serve": xlstm_launches}


# ---------------------------------------------------------------------------
# Phase 3f: the encoder-decoder and image-prefix families
# ---------------------------------------------------------------------------

# whisper-small whole (12 encoder and 12 decoder layers): 32 windows of 30 s
# of audio (1,500 frames each, 48,000 encoder tokens) and 224-token
# prompts, 16 tokens each: 240 decoder positions, inside the published
# 448-token context, so the learned table is not extended
AUDIO_BATCH, AUDIO_PROMPT = 32, 224
# the VLM handoff: 576 image embeddings, prefill(511 text tokens) + one
# step against prefill(512)
VLM_HANDOFF_TEXT = 512
# bf16 prefill(S-1) + decode against prefill(S), on seeded N(0, 1) frames
# or image embeddings (tools/lm_bf16_consistency.py, on the CPU at widths
# 64 and 256 and the served depths).  whisper: bf16 moves the handoff
# 0.7-1.0%; the cross-attention cache zeroed moves it 76-77%, taken from an
# encoder run without its sinusoidal table 48-83%.  The learned position
# one off at decode moves it 0.86-0.87%, inside the bf16 noise: beyond this
# check (the CPU tests hold decode's pos[pos] to the reference's within
# 1e-4).  The bound, 2^-4, lies between.  phi-3-vision: bf16 2.1-2.3%;
# decode positions not offset by the 576 image tokens 31-32%, the image
# prefix's KV entries lost 28-35%, the decode position one off 6.2-7.7%;
# the bound, 2^-3, lies between bf16 and the first two, with room for the
# larger bf16 drift full widths have shown (xLSTM: 5.0% on the card, 2.2%
# at width 256); the one-off position is beyond it.
AUDIO_CONSISTENCY_REL = 2.0 ** -4
VLM_CONSISTENCY_REL = 2.0 ** -3


def encdec_vlm_paths(device, recorder=None, reduced=False) -> dict:
    """``serve("whisper-small", 32, 224, 16)`` and ``serve(
    "phi-3-vision-4.2b", 4, 4096, 16)``, whole, bf16, seeded weights (the
    serve inputs: frames ``randn * 0.02``, zero image embeddings), each
    with a handoff check on seeded non-zero frames or image embeddings.
    Returns each serving path's launches."""
    from lm_bf16_consistency import frontend_inputs

    model, audio = family_serve(device, AUDIO_ARCH, None, recorder, reduced,
                                batch=AUDIO_BATCH, prompt=AUDIO_PROMPT)
    handoff_check(model, (AUDIO_PROMPT if not reduced else 48) - 1, 1, AUDIO_CONSISTENCY_REL,
                  "whisper prefill+decode vs prefill",
                  inputs=frontend_inputs(model.cfg, 1, device))
    decode_vs_plain(model, (AUDIO_PROMPT if not reduced else 48) - 1, AUDIO_CONSISTENCY_REL,
                    "whisper decode kernel vs plain", inputs=frontend_inputs(model.cfg, 1, device))
    del model
    model, vlm = family_serve(device, VLM_ARCH, None, recorder, reduced)
    handoff_check(model, (VLM_HANDOFF_TEXT if not reduced else 48) - 1, 1, VLM_CONSISTENCY_REL,
                  "vlm prefill+decode vs prefill", inputs=frontend_inputs(model.cfg, 1, device))
    decode_vs_plain(model, (VLM_HANDOFF_TEXT if not reduced else 48) - 1, VLM_CONSISTENCY_REL,
                    "vlm decode kernel vs plain", inputs=frontend_inputs(model.cfg, 1, device))
    del model
    return {"audio serve": audio, "vlm serve": vlm}


# ---------------------------------------------------------------------------
# Phase 3d: the LM training path
# ---------------------------------------------------------------------------

# full width, depth cut to 5 layers (2 remainder recurrent layers and one
# (rec, rec, attn) unit): 2,049,093,632 parameters at 16 bytes each (f32
# parameter, gradient and two moments) are 32.8 GB; the 38 layers would
# need 137 GB.  f32 masters, bf16 activations, remat="full".
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 5, 2, 4096, 3
# per run: under remat each layer's forward runs twice (forward and the
# recompute in the backward pass), its backward once
TRAIN_LAUNCHES = {"flash_attention": 2 * TRAIN_STEPS, "flash_attention.bwd": TRAIN_STEPS,
                  "rglru_scan": 8 * TRAIN_STEPS, "rglru_scan.bwd": 4 * TRAIN_STEPS}
# the reduced config (float32, remat "none"): 12 steps, a save every 4
REDUCED_TRAIN = dict(steps=12, batch=4, seq=64, checkpoint_every=4, seed=0, log_every=100)
# what the full-width run gave with the CUDA-core attention backward, before
# the bf16 one ran on wgmma (H100 80GB HBM3, 700 W): step 0's loss runs only
# forward kernels, which have not changed since, so it must repeat; the
# later losses follow the backward's rounding and are printed beside these
CUDA_CORE_BWD_LOSSES = (3047.7, 2787.7, 1154.2)
CUDA_CORE_BWD_STEP_SECONDS, CUDA_CORE_BWD_PEAK_GB = (0.524, 0.561), (71.3, 71.4)
REDUCED_TRAIN_LAUNCHES = {"flash_attention": 12, "flash_attention.bwd": 12,
                          "rglru_scan": 48, "rglru_scan.bwd": 48}
RESUME_TOL = dict(rtol=1e-5, atol=1e-6)  # the reference's crash/resume test
TRAIN_CARD_VS_CPU_RTOL = 1e-4  # f32 losses, card kernels vs CPU plain versions


def _train_kernels(recorder, tag):
    """Zero the LM kernels' launch counts and, with a recorder, record the
    inputs of the forward and backward wrappers under ``tag``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops

    for mod in (fa_ops, rg_ops):
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    if recorder is not None:
        recorder.tag = tag
        recorder.wrap(fa_ops, "flash_attention", "flash_attention")
        recorder.wrap(fa_ops, "flash_attention_bwd", "flash_attention.bwd")
        recorder.wrap(rg_ops, "rglru", "rglru_scan")
        recorder.wrap(rg_ops, "rglru_bwd", "rglru_scan.bwd")

    def read():
        return {"flash_attention": fa_ops.LAUNCHES["flash_attention"],
                "flash_attention.bwd": fa_ops.LAUNCHES["bwd"],
                "rglru_scan": rg_ops.LAUNCHES["rglru"], "rglru_scan.bwd": rg_ops.LAUNCHES["bwd"]}

    return read


@contextlib.contextmanager
def observed_updates(device, on_update=None):
    """AdamW's ``update`` observed as it is called, for the duration:
    yields a list that gets, each step, each parameter's gradient norm
    before the clip (``names``, ``norms``), the clipped global norm, the
    learning rate and the time the step ended (the card synchronized).
    ``on_update`` is called after each step."""
    from repro_torch.optim import adamw

    steps, orig = [], adamw.update

    def observed_update(grads, state, params, ocfg):
        norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                             for g in grads.values()])
        out = orig(grads, state, params, ocfg)
        sync(device)
        steps.append(dict(end=time.perf_counter(), names=list(grads), norms=norms.cpu(),
                          grad_norm=float(out[2]["grad_norm"]), lr=float(out[2]["lr"])))
        if on_update is not None:
            on_update()
        return out

    adamw.update = observed_update
    try:
        yield steps
    finally:
        adamw.update = orig


def step0_without_gradient(steps) -> list:
    """The parameters whose step-0 gradient norm is not finite and non-zero."""
    first = steps[0]
    return [n for n, g in zip(first["names"], first["norms"].tolist())
            if not (math.isfinite(g) and g > 0)]


def lm_train(device, recorder=None, reduced=False):
    """``launch.train.run`` on ``LM_ARCH`` at full width, cut to
    TRAIN_LAYERS layers, with seeded weights: TRAIN_STEPS AdamW steps on
    TRAIN_BATCH x TRAIN_SEQ tokens of ``SyntheticLM(seed=0)``.  AdamW's
    ``update`` is observed as it is called: each parameter's gradient norm
    before the clip (all finite and non-zero in step 0: no kernel cut the
    gradient) and the time each step ends.  Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.models import lm

    cfg = get_config(LM_ARCH).replace(n_layers=TRAIN_LAYERS)
    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    if reduced:  # the CPU rehearsal
        cfg, batch, seq = get_config(LM_ARCH).reduced(), 2, 64
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init(cfg, seed=0, device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    read = _train_kernels(recorder, "main path")
    t0 = time.perf_counter()
    try:
        with observed_updates(device) as steps:
            _, opt_state, losses = train_mod.run(LM_ARCH, steps=TRAIN_STEPS, batch=batch,
                                                 seq=seq, reduced=reduced, seed=0, log_every=1,
                                                 device=device, params=model)
    finally:
        if recorder is not None:
            recorder.restore()
    launches = read()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    ends = [t0] + [st["end"] for st in steps]
    step_s = [b - a for a, b in zip(ends, ends[1:])]
    first = steps[0]
    bad = step0_without_gradient(steps)
    emit(phase="main_path", check="lm train", arch=LM_ARCH, reduced=reduced,
         layers=cfg.n_layers, d_model=cfg.d_model, params=n_params,
         param_dtype=cfg.param_dtype, dtype=cfg.dtype, remat=cfg.remat, batch=batch,
         seq=seq, steps=len(losses), losses=losses,
         cuda_core_bwd_losses=CUDA_CORE_BWD_LOSSES,
         grad_norms=[st["grad_norm"] for st in steps], lrs=[st["lr"] for st in steps],
         init_seconds=init_s, first_step_seconds=step_s[0], step_seconds=step_s[1:],
         peak_memory_bytes=peak, cuda_core_bwd_step_seconds=CUDA_CORE_BWD_STEP_SECONDS,
         cuda_core_bwd_peak_memory_gb=CUDA_CORE_BWD_PEAK_GB, launches=launches,
         step0_params_with_gradient=len(first["names"]) - len(bad),
         step0_params_without_finite_nonzero_gradient=bad,
         step0_grad_norm_min=float(first["norms"].min()),
         step0_grad_norm_max=float(first["norms"].max()))
    del model, opt_state
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"lm train: losses {losses}")
    if device.type == "cuda" and round(losses[0], 1) != CUDA_CORE_BWD_LOSSES[0]:
        fail(f"lm train: step 0's loss {losses[0]}, not {CUDA_CORE_BWD_LOSSES[0]}: "
             "the forward changed")
    if len(steps) != TRAIN_STEPS or len(first["names"]) != len(first["norms"]) or bad:
        fail(f"lm train: parameters without a finite non-zero gradient in step 0: {bad}")
    if device.type == "cuda" and launches != TRAIN_LAUNCHES:
        fail(f"lm train launched {launches}, not {TRAIN_LAUNCHES}")
    TIMED["lm train"] = dict(seconds=statistics.median(step_s[1:]), peak_memory_bytes=peak)
    TRAIN_LOSSES[:] = losses
    return launches


def lm_train_reduced(device, recorder=None):
    """The reduced config (float32, so the float32 attention kernel and its
    backward run) for 12 steps on ``device``, saving every 4 steps to a
    checkpoint store: the same losses after a crash at step 8 and a resume
    from the step-7 save, and the same losses as the plain versions on
    the CPU from the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run
    from repro_torch.models import lm
    from repro_torch.storage.checkpoint import CheckpointConfig, CheckpointStore
    from repro_torch.storage.kvstore import DeltaStore

    cfg = get_config(LM_ARCH).reduced()
    card = lm.init(cfg, seed=3, device=device)
    state = {k: v.detach().to("cpu", copy=True) for k, v in card.state_dict().items()}

    def store():
        return CheckpointStore(DeltaStore(m=2, r=1, backend="mem"),
                               CheckpointConfig(snapshot_every=2))

    straight = store()
    read = _train_kernels(recorder, "reduced train f32")
    t0 = time.perf_counter()
    try:
        _, _, losses = run(LM_ARCH, **REDUCED_TRAIN, store=straight, device=device,
                           params=card)
    finally:
        if recorder is not None:
            recorder.restore()
    seconds = time.perf_counter() - t0
    launches = read()
    crashed = store()
    _, _, before = run(LM_ARCH, **REDUCED_TRAIN, store=crashed, stop_after=8, device=device,
                       params=lm.from_state_dict(cfg, state, device=device))
    _, _, after = run(LM_ARCH, **REDUCED_TRAIN, store=crashed, resume=True, device=device,
                      params=lm.from_state_dict(cfg, state, device=device))
    _, _, host = run(LM_ARCH, **REDUCED_TRAIN, device="cpu", params=state)
    resumed = np.asarray(before + after)
    resume_err = float(np.abs(resumed - losses).max())
    cpu_rel = float((np.abs(np.asarray(host) - losses) / np.abs(host)).max())
    emit(phase="main_path", check="lm train reduced", layers=cfg.n_layers, dtype=cfg.dtype,
         **{k: v for k, v in REDUCED_TRAIN.items() if k != "log_every"},
         saves=[e["step"] for e in straight.saves],
         checkpoint_bytes=straight.storage_cost()["bytes_written"], losses=losses,
         resumed_losses=resumed.tolist(), resume_max_abs_diff=resume_err,
         cpu_losses=host, card_vs_cpu_max_rel_diff=cpu_rel, seconds=seconds,
         launches=launches)
    if not np.allclose(resumed, losses, **RESUME_TOL):
        fail(f"lm train reduced: crash/resume losses differ by {resume_err}")
    if not cpu_rel <= TRAIN_CARD_VS_CPU_RTOL:
        fail(f"lm train reduced: card vs CPU losses differ by {cpu_rel} (relative)")
    if device.type == "cuda" and launches != REDUCED_TRAIN_LAUNCHES:
        fail(f"lm train reduced launched {launches}, not {REDUCED_TRAIN_LAUNCHES}")


# ---------------------------------------------------------------------------
# Phase 3f: multi-card on one card
# ---------------------------------------------------------------------------

# the full-width training run's losses (``lm_train``), which the sharded
# run on a 1 x 1 mesh must repeat bit for bit
TRAIN_LOSSES: list = []
MULTI_CARD_STEPS = 2
# per step, as lm train launches them (remat "full")
MULTI_CARD_LAUNCHES = {k: v * MULTI_CARD_STEPS // TRAIN_STEPS for k, v in TRAIN_LAUNCHES.items()}
COMPRESSED_LAYER = "layers.0."  # the gradients the compression check takes
# the card's scale (amax / 127: CUDA multiplies by the reciprocal of a
# scalar divisor) may sit one float32 ulp from the CPU's, so the card's
# int8 value may differ from the CPU's by one, only where the CPU's
# x / scale lies this close to a rounding tie (relative to |x / scale|)
COMPRESSION_TIE_REL = 2.0 ** -21
COMPRESSION_SCALE_ULPS = 1


def compression_check(grads, ghat, new_err) -> dict:
    """``compress_grads_podwise``'s result on a one-pod mesh against the
    CPU: each leaf's g_hat lies bit for bit on the card's own int8 grid
    (``_dequantize(_quantize(g))`` on the card: a compressor that did not
    quantize fails here), the residual is g - g_hat bit for bit, the
    card's scales are within COMPRESSION_SCALE_ULPS ulps of the CPU's and
    its int8 values equal the CPU's except at rounding ties
    (COMPRESSION_TIE_REL), where they differ by one at most.  Returns the
    counts; fails on any other difference."""
    from repro_torch.optim import compression

    ch = compression.CHUNK
    out = {"values": 0, "moved": 0, "ties": 0, "q_differ": 0, "scale_ulps": 0}
    for k, g in grads.items():
        n = g.numel()
        flat = g.detach().to(torch.float32).reshape(-1)
        if not torch.equal(new_err[k], g.to(torch.float32) - ghat[k]):
            fail(f"multi-card: the residual of {k} is not the gradient less g_hat")
        q_card, s_card = compression._quantize(torch.nn.functional.pad(flat, (0, (-n) % ch)))
        grid = compression._dequantize(q_card, s_card)[:n].reshape(g.shape)
        if not torch.equal(ghat[k], grid):
            fail(f"multi-card: g_hat of {k} is not the card's int8 grid")
        x = torch.nn.functional.pad(flat.cpu(), (0, (-n) % ch))
        q_cpu, s_cpu = compression._quantize(x)
        s_card = s_card.cpu()
        ulps = int(((s_card.view(torch.int32) - s_cpu.view(torch.int32)).abs().max()))
        t = (x.reshape(-1, ch) / s_cpu).abs()
        tie = ((t - t.floor() - 0.5).abs() <= t * COMPRESSION_TIE_REL).reshape(-1)[:n]
        dq = (q_card.cpu().to(torch.int32) - q_cpu.to(torch.int32)).reshape(-1)[:n]
        if ulps > COMPRESSION_SCALE_ULPS:
            fail(f"multi-card: the card's scales of {k} are {ulps} ulps off the CPU's")
        if bool(((dq != 0) & ~tie).any()) or int(dq.abs().max()) > 1:
            fail(f"multi-card: the card's int8 values of {k} differ from the CPU's "
                 f"away from rounding ties")
        out["values"] += n
        out["moved"] += int((grid.reshape(-1) != flat).sum())
        out["ties"] += int(tie.sum())
        out["q_differ"] += int((dq != 0).sum())
        out["scale_ulps"] = max(out["scale_ulps"], ulps)
    return out


def multi_card_phase(device, degree):
    """The multi-card code on one card: a 1-rank NCCL group (a FileStore
    under build/), then (1) ``sharded_degree_series`` over a ("workers",)
    mesh on the main path's operand, bit for bit against the ``mesh=None``
    series (``degree``: the operand, its times and that series); (2)
    ``LM_ARCH`` at full width cut to TRAIN_LAYERS layers trained
    MULTI_CARD_STEPS steps through ``Sharder.distribute`` on a (data=1,
    model=1) mesh, the kernels run through ``local_map``, the losses bit
    for bit the unsharded run's first ones (same seed, same batches); (3)
    ``compress_grads_podwise`` over a (pod=1, data=1) mesh on that run's
    layer-0 gradients, through NCCL's all-reduce, held against the CPU by
    ``compression_check``.  Returns the kernels' launch counts."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.models.sharding import Sharder
    from repro_torch.optim import compression
    from repro_torch.taf import exec as taf_exec

    store_path = ROOT / "build" / "multi_card_store"
    store_path.parent.mkdir(parents=True, exist_ok=True)
    store_path.unlink(missing_ok=True)
    torch.cuda.set_device(device.index or 0)
    dist.init_process_group("nccl", store=dist.FileStore(str(store_path), 1), rank=0,
                            world_size=1)
    try:
        sots, ts, want = degree
        t0 = time.perf_counter()
        got = taf_exec.sharded_degree_series(sots, ts, mesh=taf_exec.make_worker_mesh(),
                                             device=device)
        degree_s = time.perf_counter() - t0
        if got.dtype != want.dtype or not np.array_equal(got, want):
            fail("multi-card: sharded_degree_series on a ('workers',) mesh != mesh=None")

        cfg = get_config(LM_ARCH).replace(n_layers=TRAIN_LAYERS)
        mesh = make_host_mesh((1, 1), ("data", "model"))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = lm.init(cfg, seed=0, device=device)
        read = _train_kernels(None, None)
        t0 = time.perf_counter()
        model, _, losses = train_mod.run(LM_ARCH, steps=TRAIN_STEPS, stop_after=MULTI_CARD_STEPS,
                                         batch=TRAIN_BATCH, seq=TRAIN_SEQ, reduced=False, seed=0,
                                         log_every=1, device=device, params=model,
                                         shd=Sharder(mesh))
        sync(device)
        train_s = time.perf_counter() - t0
        launches = read()
        peak = torch.cuda.max_memory_allocated()
        want_losses = TRAIN_LOSSES[:MULTI_CARD_STEPS]
        parted = [i for i, (a, b) in enumerate(zip(losses, want_losses)) if a != b]

        grads = {k: p.grad.to_local() for k, p in model.named_parameters()
                 if k.startswith(COMPRESSED_LAYER)}
        del model
        pod_mesh = make_host_mesh((1, 1), ("pod", "data"))
        err = compression.init_error_state(grads)
        ghat, new_err = compression.compress_grads_podwise(grads, err, pod_mesh)
        comp = compression_check(grads, ghat, new_err)
        n_leaves = len(grads)
        del grads, ghat, new_err, err
        emit(phase="main_path", check="multi-card on one card", backend="nccl",
             world_size=dist.get_world_size(), degree_members=len(sots), degree_T=len(ts),
             degree_seconds=degree_s, arch=LM_ARCH, layers=cfg.n_layers,
             mesh={"data": 1, "model": 1},
             steps=len(losses), losses=losses, unsharded_losses=want_losses,
             parted_at_steps=parted, train_seconds=train_s, peak_memory_bytes=peak,
             launches=launches, compressed_leaves=n_leaves,
             compression={**comp, "tie_rel": COMPRESSION_TIE_REL})
        if parted:
            fail(f"multi-card: sharded losses {losses} part from the unsharded "
                 f"{want_losses} at step {parted[0]}")
        if launches != MULTI_CARD_LAUNCHES:
            fail(f"multi-card launched {launches}, not {MULTI_CARD_LAUNCHES}")
        return launches
    finally:
        dist.destroy_process_group()
        store_path.unlink(missing_ok=True)


# ---------------------------------------------------------------------------
# Phase 3h: the examples
# ---------------------------------------------------------------------------

# the graph examples' floats, card against CPU: the fused plans' float32
# (tests/test_torch_compile.py's tolerance; the host's float64 values are
# the same code on the same host)
EXAMPLE_FLOAT_ATOL = 1e-5
# the quickstart again at the graph cell's scale
EXAMPLE_EVENTS = 200_000
# train_lm at its reference settings (reduced, 24 steps, the crash at step 16)
EXAMPLE_TRAIN_ARCHS = ("qwen3-1.7b", "qwen2-7b", "granite-3-8b", "minitron-8b")
# and qwen3-1.7b as its config file has it (28 layers, d_model 2048, 16
# heads of 128 over 8 KV heads, qk-norm, d_ff 6144, vocab 151,936 tied,
# 1.72 B parameters): f32 masters, bf16 activations, remat "full"; batch 8
# of 1,024-token walks, a save after step 3, the crash at step 4, the resume
EXAMPLE_FULL = dict(arch="qwen3-1.7b", batch=8, seq=1024, steps=6, reduced=False)
EXAMPLE_FULL_PATH = "example train_lm"


def load_example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quiet(fn, *args, **kw):
    """``fn(*args, **kw)`` and the lines it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


def differences(card, cpu, path: str = "") -> list:
    """Where the card's example result differs from the CPU's: integers,
    strings, node ids and snapshots (``present``, ``attrs``, ``edge_key``)
    equal, floats within EXAMPLE_FLOAT_ATOL."""
    if isinstance(cpu, dict):
        if set(card) != set(cpu):
            return [path]
        return [d for k in cpu for d in differences(card[k], cpu[k], f"{path}.{k}")]
    if isinstance(cpu, (list, tuple)):
        if len(card) != len(cpu):
            return [path]
        return [d for i, (a, b) in enumerate(zip(card, cpu))
                for d in differences(a, b, f"{path}[{i}]")]
    if hasattr(cpu, "edge_key"):
        same = all(np.array_equal(getattr(card, f), getattr(cpu, f))
                   for f in ("present", "attrs", "edge_key"))
        return [] if same else [path]
    if isinstance(cpu, (float, np.floating)) or (isinstance(cpu, np.ndarray)
                                                 and cpu.dtype.kind == "f"):
        same = (np.shape(card) == np.shape(cpu)
                and np.allclose(card, cpu, atol=EXAMPLE_FLOAT_ATOL, rtol=0))
        return [] if same else [path]
    if isinstance(cpu, np.ndarray):
        return [] if np.array_equal(card, cpu) else [path]
    return [] if card == cpu else [path]


def graph_examples(device, n_events: int = EXAMPLE_EVENTS) -> None:
    """``quickstart_torch`` and ``temporal_analytics_torch`` at their
    reference sizes and the quickstart at ``n_events``, each on the card
    and on the CPU in this process: every result and every printed line
    (but the one of wall times) the same.  No kernel: like the
    reference's, they fold on the host (``use_kernel=False``) and run
    their fused plans as torch programs on the device."""
    qs, ta = load_example("quickstart_torch"), load_example("temporal_analytics_torch")
    for what, fn, kw in (("quickstart", qs.main, {}),
                         ("temporal_analytics", ta.main, {}),
                         (f"quickstart n_events={n_events}", qs.main, {"n_events": n_events})):
        t0 = time.perf_counter()
        card, lines = quiet(fn, device, **kw)
        t1 = time.perf_counter()
        cpu, cpu_lines = quiet(fn, "cpu", **kw)
        t2 = time.perf_counter()
        diffs = differences(card, cpu)
        untimed = [[x for x in ls if not x.startswith("label-count")]
                   for ls in (lines, cpu_lines)]
        if untimed[0] != untimed[1]:
            diffs.append("printed lines")
        emit(phase="examples", check=what, card_seconds=t1 - t0, cpu_seconds=t2 - t1,
             printed=lines, differences=diffs)
        if diffs:
            fail(f"example {what}: the card's results differ from the CPU's at {diffs}")


def _resumed_pair(out) -> tuple:
    """The two losses of the step the example ran again after its crash."""
    i = out["steps"].index(out["crash_at"])
    j = out["steps"].index(out["crash_at"], i + 1)
    return out["losses"][i], out["losses"][j]


def train_examples(device) -> dict:
    """``train_lm_torch`` at its reference settings for each of
    EXAMPLE_TRAIN_ARCHS (reduced, float32, so the float32 attention kernel
    and its backward run), on the card and on the CPU from the same
    weights: losses within TRAIN_CARD_VS_CPU_RTOL, the resumed step's loss
    bit for bit its first run's, failovers, and the example's own check
    that the loss fell.  Returns each arch's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    tl = load_example("train_lm_torch")
    by_arch = {}
    for arch in EXAMPLE_TRAIN_ARCHS:
        cfg = get_config(arch).reduced()
        state = lm.init(cfg, seed=0, device="cpu", max_seq=4 * 64).state_dict()
        read = _train_kernels(None, "")
        t0 = time.perf_counter()
        try:
            card, lines = quiet(tl.main, device, arch=arch,
                                params={k: v.clone() for k, v in state.items()})
            launches = read()
            t1 = time.perf_counter()
            cpu, _ = quiet(tl.main, "cpu", arch=arch,
                           params={k: v.clone() for k, v in state.items()})
        except AssertionError as e:
            fail(f"example train_lm {arch}: {e}")
        t2 = time.perf_counter()
        losses, host = np.asarray(card["losses"]), np.asarray(cpu["losses"])
        rel = float((np.abs(losses - host) / np.abs(host)).max())
        first, again = _resumed_pair(card)
        emit(phase="examples", check="train_lm reduced", arch=arch, layers=card["n_layers"],
             d_model=card["d_model"], steps=card["steps"], losses=card["losses"],
             cpu_losses=cpu["losses"], card_vs_cpu_max_rel_diff=rel,
             resumed_step=card["crash_at"], resumed_losses=[first, again],
             saved_steps=card["saved_steps"], failovers=card["failovers"],
             checkpoint_bytes=card["bytes_written"], launches=launches,
             card_seconds=t1 - t0, cpu_seconds=t2 - t1, printed=lines)
        if not rel <= TRAIN_CARD_VS_CPU_RTOL or card["steps"] != cpu["steps"]:
            fail(f"example train_lm {arch}: card vs CPU losses differ by {rel} (relative)")
        if first != again:
            fail(f"example train_lm {arch}: the resumed step's loss {again} is not {first}")
        if not card["failovers"] > 0:
            fail(f"example train_lm {arch}: no failover after node 1 was killed")
        if device.type == "cuda" and not (launches["flash_attention"] > 0
                                          and launches["flash_attention.bwd"] > 0):
            fail(f"example train_lm {arch}: launched {launches}")
        by_arch[arch] = launches
    return by_arch


def full_width_example(device, recorder=None, reduced: bool = False) -> dict:
    """``train_lm_torch`` with EXAMPLE_FULL (``reduced``: the CPU
    rehearsal's reduced config): seconds a step after the first, peak
    memory, the losses, seconds to save and to restore, the attention
    launches forward and backward.  Checks: finite losses, every
    parameter's step-0 gradient finite and non-zero (read by wrapping
    ``optim.adamw.update``), the resumed step's loss bit for bit its first
    run's, failovers.  Returns the launch counts."""
    from repro_torch.optim import adamw

    tl = load_example("train_lm_torch")
    kw = dict(EXAMPLE_FULL, reduced=reduced, **({"seq": 64} if reduced else {}))
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    step0 = []
    orig = adamw.update

    def observed_update(grads, state, params, ocfg):
        if not step0:
            step0.append((list(grads), torch.stack([torch.linalg.vector_norm(
                g, dtype=torch.float32) for g in grads.values()]).cpu()))
        return orig(grads, state, params, ocfg)

    read = _train_kernels(recorder, EXAMPLE_FULL_PATH)
    adamw.update = observed_update
    try:
        out, lines = quiet(tl.main, device, **kw)
    except AssertionError as e:
        fail(f"{EXAMPLE_FULL_PATH}: {e}")
    finally:
        adamw.update = orig
        if recorder is not None:
            recorder.restore()
    launches = read()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    names, norms = step0[0]
    bad = [n for n, g in zip(names, norms.tolist()) if not (math.isfinite(g) and g > 0)]
    first, again = _resumed_pair(out)
    emit(phase="examples", check=EXAMPLE_FULL_PATH, arch=out["arch"], reduced=reduced,
         layers=out["n_layers"], d_model=out["d_model"], params=out["n_params"],
         batch=kw["batch"], seq=kw["seq"], steps=out["steps"], losses=out["losses"],
         resumed_step=out["crash_at"], resumed_losses=[first, again],
         first_step_seconds=out["step_seconds"][0], step_seconds=out["step_seconds"][1:],
         save_seconds=out["save_seconds"], restore_seconds=out["restore_seconds"],
         saved_steps=out["saved_steps"], checkpoint_bytes=out["bytes_written"],
         failovers=out["failovers"], peak_memory_bytes=peak, launches=launches,
         step0_params_with_gradient=len(names) - len(bad),
         step0_params_without_finite_nonzero_gradient=bad,
         step0_grad_norm_min=float(norms.min()), step0_grad_norm_max=float(norms.max()),
         printed=lines)
    if not all(math.isfinite(x) for x in out["losses"]):
        fail(f"{EXAMPLE_FULL_PATH}: losses {out['losses']}")
    if bad:
        fail(f"{EXAMPLE_FULL_PATH}: parameters without a finite non-zero step-0 gradient {bad}")
    if first != again:
        fail(f"{EXAMPLE_FULL_PATH}: the resumed step's loss {again} is not {first}")
    if not out["failovers"] > 0:
        fail(f"{EXAMPLE_FULL_PATH}: no failover after node 1 was killed")
    if device.type == "cuda" and not (launches["flash_attention"] > 0
                                      and launches["flash_attention.bwd"] > 0):
        fail(f"{EXAMPLE_FULL_PATH}: launched {launches}")
    TIMED[EXAMPLE_FULL_PATH] = dict(seconds=statistics.median(out["step_seconds"][1:]),
                                    peak_memory_bytes=peak)
    return launches


# ---------------------------------------------------------------------------
# Phase 3i: the dense family served whole at decode_32k's length
# ---------------------------------------------------------------------------

DENSE_ARCHS = ("qwen3-1.7b", "qwen2-7b", "granite-3-8b", "minitron-8b")
# 32,744-token prompts and 16 generated tokens: serve's max_seq (prompt +
# 16 + 8) is 32,768, the length of decode_32k and prefill_32k
# (configs/base.py)
DENSE_PROMPT = 32_744
# each config's batch, a cut from prefill_32k's global batch of 32 and
# decode_32k's 128: the largest of 8, 4, 2, 1 whose peak stayed under
# DENSE_PEAK_MAX on an H100 80GB (PERF.md section 4: peaks 54.2 / 49.9 /
# 59.0 / 53.3 GB; batch 8 ran out of memory for the last three)
DENSE_BATCH = {"qwen3-1.7b": 8, "qwen2-7b": 4, "granite-3-8b": 4, "minitron-8b": 4}
DENSE_PEAK_MAX = 75e9
DENSE_SHAPE_BATCHES = {"prefill_32k": 32, "decode_32k": 128}
# batch 1: prefill(32,767) + decode_step against prefill(32,768)
DENSE_HANDOFF_S = 32_768
# the dense handoff in bf16 (tools/lm_bf16_consistency.py --family dense, on
# the CPU at each config's depth and head counts, widths 64 and 256, S =
# 1024): bf16 moves it 1.7-2.4% relative L2 (the bf16 prefill sits 1.4-2.3%
# from its f32 twin); KV heads grouped h % KV at decode move it 94-123%;
# the decode position one off 2.8-7.4% and the newest KV entry dropped
# 1.8-4.0%, inside or near the bf16 noise.  The bound, 2^-3, lies between
# the noise, with room for the larger drift full widths have shown (xLSTM:
# 5.0% on the card, 2.2% at width 256), and the grouping fault, which it
# must reject (DENSE_REJECTED); the other two are reported, and the
# float32 reduced handoff on the card (``reduced_handoff``, 1e-4) rejects
# all three.
DENSE_CONSISTENCY_REL = 2.0 ** -3
DENSE_REJECTED = ("grouped heads mapped h % KV",)
# the reduced configs the card holds against the CPU, grouped KV heads kept
# (tests/test_torch_dense_serve.py's cases): (arch, heads, KV heads)
DENSE_REDUCED = (("qwen3-1.7b", 8, 2), ("qwen2-7b", 8, 2), ("granite-3-8b", 8, 2),
                 ("minitron-8b", 8, 2), ("qwen2-7b", 14, 2))
# card bytes that only reference cycles may hold at a phase's start: a
# cycle that holds tensors keeps them until the collector runs (the
# checkpoint store's tree walk, a nested function that called itself and
# closed over the leaves, held a whole training state that way)
CYCLE_BYTES_MAX = 1 << 30


def held_in_cycles(where: str) -> None:
    """Count the card tensors that only reference cycles hold (the
    collector run with DEBUG_SAVEALL, which keeps what it would free),
    print them with the referrers of the largest, then free them; fail
    when they pass CYCLE_BYTES_MAX."""
    import gc

    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.collect()
    finally:
        gc.set_debug(0)
    garbage, ids = list(gc.garbage), {id(o) for o in gc.garbage}
    gc.garbage.clear()
    tensors = {t.untyped_storage().data_ptr(): t for t in garbage
               if torch.is_tensor(t) and t.is_cuda}
    held = sum(t.untyped_storage().nbytes() for t in tensors.values())
    chain = holders(max(tensors.values(), key=lambda t: t.untyped_storage().nbytes()),
                    ids) if tensors else []
    emit(phase="memory", check="held in cycles", where=where, bytes=held,
         tensors=len(tensors), objects=len(garbage), largest_held_by=chain,
         limit=CYCLE_BYTES_MAX)
    del garbage, tensors
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    if held > CYCLE_BYTES_MAX:
        fail(f"{where}: {held} card bytes held only by reference cycles ({chain})")


def holders(obj, ids: set, depth: int = 6) -> list:
    """The names of the objects that hold ``obj``, one referrer a step,
    among the objects whose ids are ``ids``."""
    import gc

    chain, seen = [], {id(obj)}
    for _ in range(depth):
        refs = [r for r in gc.get_referrers(obj) if id(r) in ids and id(r) not in seen]
        if not refs:
            break
        obj = refs[0]
        seen.add(id(obj))
        chain.append(getattr(obj, "__qualname__", type(obj).__name__))
    return chain


def dense_attention(tag: str, recorder) -> None:
    """The first ``flash_attention`` call of the serving path ``tag``
    (its first layer's prefill, recorded as it ran), the kernel run on
    those inputs twice (the same bits) and held against the plain version
    on every block of LONG_BLOCK queries of every sequence, the ragged last
    one with the key tile that Sk = 32,744 leaves short included
    (``attention_blocks``); the inputs are dropped after."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    args, kw = recorder.inputs.pop(("flash_attention", tag))
    q, k, v, q_pos, k_pos = args
    S = q.shape[2]
    arange = torch.arange(S, dtype=q_pos.dtype, device=q_pos.device)
    if not (torch.equal(q_pos, arange) and torch.equal(k_pos, arange)):
        fail(f"{tag}: the prefill's attention positions are not 0..{S - 1}")
    got = fa_ops.flash_attention(*args, **kw)
    if not torch.equal(fa_ops.flash_attention(*args, **kw), got):
        fail(f"flash_attention ({tag}): two runs differ")
    row = attention_blocks(tag, q, k, v, q_pos, kw, got)
    emit(phase="main_path", check=f"{tag} attention vs plain", layer=0,
         shape=dict(B=q.shape[0], H=q.shape[1], S=S, D=q.shape[3], dtype=str(q.dtype),
                    kv_head_stride=k.stride(1), **kw),
         ragged_key_tile=S % FA_KEY_TILE, tol=ATTN_TOL[q.dtype], **row)


def dense_handoff(model, S: int) -> tuple:
    """Batch 1: prefill(S)'s last logits and prefill(S-1)'s cache, each
    computed once; decode_step at position S-1 from a copy of that cache
    with each of ``dense_decode_faults`` planted, then from the cache
    itself.  Returns ({fault: (1, V) logits}, the sound (1, V) logits,
    prefill(S)'s (1, V))."""
    from torch.utils._pytree import tree_map

    from lm_bf16_consistency import dense_decode_faults

    tokens = handoff_tokens(model, S)
    pos = torch.tensor([S - 1], dtype=torch.int32, device=tokens.device)
    planted = {}
    with torch.inference_mode():
        want = model.prefill(tokens, cache_len=S + 8)[0][0]
        _, caches = model.prefill(tokens[:, :S - 1], cache_len=S + 8)
        for fault, step in dense_decode_faults(model).items():
            copy = tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, caches)
            planted[fault] = step(copy, tokens[:, S - 1:], pos)[0][0, -1][None]
            del copy
        got = model.decode_step(caches, tokens[:, S - 1:], pos)[0][0, -1][None]
    return planted, got, want


def dense_consistency(model, S: int, rejected=()) -> None:
    """prefill(S-1) + decode_step against prefill(S) within
    DENSE_CONSISTENCY_REL (``dense_handoff``), each planted fault's
    relative L2 reported; those in ``rejected`` must pass the bound."""
    faulty, got, want = dense_handoff(model, S)
    planted = {fault: step_rels(logits, want)[0] for fault, logits in faulty.items()}
    handoff_check(model, S - 1, 1, DENSE_CONSISTENCY_REL, "dense prefill+decode vs prefill",
                  logits=(got, want), heads=model.cfg.n_heads, kv_heads=model.cfg.n_kv_heads,
                  planted_rel_l2=planted)
    kept = [f for f in rejected if not planted[f] > DENSE_CONSISTENCY_REL]
    if kept:
        fail(f"dense prefill+decode vs prefill ({model.cfg.name}): {kept} pass the bound "
             f"{DENSE_CONSISTENCY_REL} ({planted})")


def dense_batch(arch: str, reduced: bool) -> int:
    return 2 if reduced else DENSE_BATCH[arch]


def dense_paths(device, recorder, reduced: bool = False) -> dict:
    """Phase 3i: each of DENSE_ARCHS whole at ``dense_batch`` through
    ``family_serve`` (a peak of DENSE_PEAK_MAX fails), its first
    attention call against the plain version (``dense_attention``), its
    first decode attention call too, its handoff check and its decode step
    through the kernel against the plain version (``decode_vs_plain``);
    then (on the card) DENSE_REDUCED card against CPU.
    Returns each serving path's launches."""
    t0 = time.perf_counter()
    held_in_cycles("dense serve phase")
    launches = {}
    for arch in DENSE_ARCHS:
        tag, batch = f"dense serve {arch}", dense_batch(arch, reduced)
        model, launches[tag] = family_serve(device, arch, None, recorder, reduced, batch=batch,
                                            prompt=DENSE_PROMPT, tag=tag)
        peak = TIMED[f"{tag} prefill"]["peak_memory_bytes"]
        prompt = DENSE_PROMPT if not reduced else 48
        emit(phase="main_path", check="dense serve batch", arch=arch, batch=batch,
             peak_memory_bytes=peak, peak_max=DENSE_PEAK_MAX, max_seq=prompt + LM_GEN + 8,
             cut_from={shape: f"batch {batch} of {n}" for shape, n in DENSE_SHAPE_BATCHES.items()})
        if peak is not None and peak >= DENSE_PEAK_MAX:
            fail(f"{tag}: peak {peak} bytes at batch {batch}, over {DENSE_PEAK_MAX}")
        dense_attention(tag, recorder)
        # its first decode call (layer 0, the first step) held now, not in
        # phase 4: the recorded 32k cache would stay allocated through phase 3j
        args, kw = recorder.inputs.pop(("decode_attention", tag))
        kernel_case("decode_attention", on_card(args, device), kw, tag, timed=False)
        if reduced:  # float32: the bf16 bound says nothing of its faults
            dense_consistency(model, 48)
        else:
            dense_consistency(model, DENSE_HANDOFF_S, DENSE_REJECTED)
        decode_vs_plain(model, (DENSE_HANDOFF_S if not reduced else 48) - 1,
                        DENSE_CONSISTENCY_REL, "dense decode kernel vs plain")
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if device.type == "cuda":
        for arch, heads, kv in DENSE_REDUCED:
            lm_reduced_card_vs_cpu(device, arch, heads=(heads, kv))
    emit(phase="main_path", check="dense serve phase", seconds=time.perf_counter() - t0,
         batches={arch: dense_batch(arch, reduced) for arch in DENSE_ARCHS})
    return launches


# ---------------------------------------------------------------------------
# Phase 3j: the other families trained at full width
# ---------------------------------------------------------------------------

# the VLM's depth: the deepest of 32, 24, 16 and 12 layers whose training
# peak stayed under TRAIN_PEAK_MAX and whose gradients stayed finite in
# every step on an H100 80GB (PERF.md section 4).  The peaks allow 32
# (62.5 GB); the gradients do not: the reference's stub image embeddings,
# zeros, stay zero rows through every layer, RMSNorm scales their
# gradient by 1/sqrt(eps) at each norm, and it overflows to inf (0 x inf
# = NaN in every weight's gradient) in step 0 at 32 and 24 layers and in
# step 2 at 16 (tests/test_torch_train_families.py pins the reference
# doing the same)
VLM_TRAIN_LAYERS = 12
# path -> (arch, batch, text tokens a sequence, layers or None for all):
# each config at its published widths through ``launch.train.run``,
# TRAIN_STEPS AdamW steps, float32 masters, bf16 activations, remat "full".
# train moe: 2 of 32 layers, 2,863,833,088 parameters, 45.8 GB of state at
# 16 B a parameter (3 layers need 66.6 GB); its 8,192 tokens route in 8
# groups of 1,024, 160 slots an expert.  train vlm: 576 zero image
# embeddings before each sequence (S = 4,672).  train audio: whisper-small
# whole over 32 x 1,500 frames.  train ssm: xlstm-350m whole, its length cut
# from 4,096 to 1,024 (the sLSTM steps through the sequence on the host).
TRAIN_FAMILIES = {"train moe": (MOE_ARCH, 2, 4096, 2),
                  "train vlm": (VLM_ARCH, 2, 4096, VLM_TRAIN_LAYERS),
                  "train audio": (AUDIO_ARCH, 32, 448, None),
                  "train ssm": (XLSTM_ARCH, 4, 1024, None)}
# whisper's published decoder context: the rows of its learned table
AUDIO_MAX_SEQ = 448
TRAIN_PEAK_MAX = 75e9
# each family's reduced config (float32) on the card and on the CPU
FAMILY_REDUCED_TRAIN = dict(steps=6, batch=4, seq=32, seed=0, log_every=100)


def train_family_shape(path: str, reduced: bool) -> tuple:
    """(config, batch, text tokens, learned table rows) of a phase-3j
    path: the full config cut to its depth, or (``reduced``, the CPU
    rehearsal) the reduced config at that depth, batch 2 of 64 tokens."""
    from repro_torch.configs import get_config

    arch, batch, seq, layers = TRAIN_FAMILIES[path]
    cfg = get_config(arch)
    if reduced:
        cfg, batch, seq = cfg.reduced(), 2, 64
    if layers:
        cfg = cfg.replace(n_layers=layers)
    return cfg, batch, seq, AUDIO_MAX_SEQ if cfg.pos_kind == "learned" else 0


def train_family(device, path: str, recorder=None, reduced: bool = False) -> dict:
    """``launch.train.run`` on a TRAIN_FAMILIES path with seeded weights
    (``lm.init(seed=0)``; a depth cut handed in as ``params``): TRAIN_STEPS
    steps of ``SyntheticLM(seed=0)`` with ``run``'s stub inputs.  Checks:
    finite losses, every parameter's step-0 gradient finite and non-zero,
    a peak under TRAIN_PEAK_MAX and, on the card, the attention kernels
    launched 2 x and their backward 1 x the forward's attention calls a
    step (remat "full"), no RG-LRU launch.  The recorder keeps layer 0's
    forward and backward call of each kind.  Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train as train_mod
    from repro_torch.models import lm, moe

    cfg, batch, seq, max_seq = train_family_shape(path, reduced)
    arch = cfg.name
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init(cfg, seed=0, device=device, max_seq=max_seq)
    sync(device)
    init_s = time.perf_counter() - t0
    n_params, n_attn = sum(p.numel() for p in model.parameters()), attention_launches(model)
    n_moe = sum(b.moe for b in model.layers)
    routed, route = [], moe._route

    def counting(p, x2d, c):  # the tokens each expert takes in step 0's forward
        out = route(p, x2d, c)
        if len(routed) < n_moe:
            routed.append(torch.bincount(out[1].flatten(), minlength=c.n_experts))
        return out

    def seal():
        if recorder is not None:
            recorder.sealed = True

    read = _train_kernels(None, path)
    if recorder is not None:
        recorder.tag = path
        recorder.wrap(fa_ops, "flash_attention", "flash_attention", attention_call_kind)
        recorder.wrap(fa_ops, "flash_attention_bwd", "flash_attention.bwd", attention_call_kind,
                      last=True)
    moe._route = counting
    t0 = time.perf_counter()
    try:
        with observed_updates(device, seal) as steps:
            _, opt_state, losses = train_mod.run(arch, steps=TRAIN_STEPS, batch=batch, seq=seq,
                                                 reduced=reduced, seed=0, log_every=1,
                                                 device=device, params=model)
    finally:
        moe._route = route
        if recorder is not None:
            recorder.restore()
    launches = read()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    ends = [t0] + [st["end"] for st in steps]
    step_s = [b - a for a, b in zip(ends, ends[1:])]
    bad = step0_without_gradient(steps)
    want = {"flash_attention": 2 * n_attn * TRAIN_STEPS,
            "flash_attention.bwd": n_attn * TRAIN_STEPS, "rglru_scan": 0, "rglru_scan.bwd": 0}
    emit(phase="main_path", check=path, arch=arch, reduced=reduced, layers=cfg.n_layers,
         full_depth=get_config(arch).n_layers, enc_layers=len(model.enc_layers or ()),
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         head_dim=cfg.resolved_head_dim, params=n_params, param_dtype=cfg.param_dtype,
         dtype=cfg.dtype, remat=cfg.remat, batch=batch, seq=seq,
         n_img_tokens=cfg.n_img_tokens, enc_seq=cfg.enc_seq if cfg.is_encdec else None,
         learned_positions=max_seq or None, steps=len(losses), losses=losses,
         grad_norms=[st["grad_norm"] for st in steps], lrs=[st["lr"] for st in steps],
         init_seconds=init_s, first_step_seconds=step_s[0], step_seconds=step_s[1:],
         peak_memory_bytes=peak, peak_max=TRAIN_PEAK_MAX, launches=launches,
         expected_launches=want, attention_calls_a_forward=n_attn,
         tokens_per_expert_step0=[r.tolist() for r in routed] or None,
         step0_params_with_gradient=len(steps[0]["names"]) - len(bad),
         step0_params_without_finite_nonzero_gradient=bad,
         step0_grad_norm_min=float(steps[0]["norms"].min()),
         step0_grad_norm_max=float(steps[0]["norms"].max()))
    del model, opt_state
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"{path}: losses {losses}")
    if len(steps) != TRAIN_STEPS or bad:
        fail(f"{path}: parameters without a finite non-zero gradient in step 0: {bad}")
    if not all(math.isfinite(st["grad_norm"]) for st in steps):
        fail(f"{path}: gradient norms {[st['grad_norm'] for st in steps]}")
    if n_moe and (len(routed) != n_moe
                  or any(int(r.sum()) != batch * seq * cfg.top_k for r in routed)):
        fail(f"{path}: step 0 routed {[int(r.sum()) for r in routed]} (token, choice) pairs "
             f"in its {n_moe} MoE layers, not {batch * seq * cfg.top_k} each")
    if device.type == "cuda" and launches != want:
        fail(f"{path} launched {launches}, not {want}")
    if peak is not None and peak >= TRAIN_PEAK_MAX:
        fail(f"{path}: peak {peak} bytes, over {TRAIN_PEAK_MAX}")
    TIMED[path] = dict(seconds=statistics.median(step_s[1:]), peak_memory_bytes=peak)
    return launches


def train_attention(path: str, recorder, device, n_img: int = 0) -> None:
    """The attention calls ``path`` recorded (layer 0's forward and, on the
    card, its backward, for each kind: whisper's encoder, decoder and
    cross-attention), each run again and held against the plain version
    over every head of every sequence (``kernel_case`` untimed, the plain
    versions a few heads at a time); with an image prefix of ``n_img``
    positions, the backward also at the text positions alone
    (``text_rows_bwd``).  The inputs stay for phase 4."""
    kinds = sorted({tag for _, tag in recorder.inputs
                    if tag == path or tag.startswith(path + " (")})
    for tag in kinds:
        for name in ("flash_attention", "flash_attention.bwd"):
            if (name, tag) in recorder.inputs:
                kernel_case(name, *recorder.inputs[(name, tag)], tag, recorded=True,
                            by_head=True, timed=False)
            elif device.type == "cuda":
                fail(f"{path}: no {name} call of '{tag}' recorded")
        if n_img and ("flash_attention.bwd", tag) in recorder.inputs:
            text_rows_bwd(tag, *recorder.inputs[("flash_attention.bwd", tag)], n_img)


def text_rows_bwd(tag, args, kw, n_img: int) -> dict:
    """The attention backward at an image-prefix path's text positions
    alone: dQ of the queries and dK, dV of the keys from ``n_img`` on,
    within BWD_TOL of the plain version (and, in bf16, BWD_BF16_REF_TOL of
    the emulation of the kernels' arithmetic) scaled by their own largest
    values.  The zero image rows' gradient runs to 1e23 and more (ROADMAP
    Queue 3 item 8), so limits scaled by a whole output's largest value
    would let any text-row error through."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    dt = args[0].dtype
    got = [g[:, :, n_img:] for g in fa_ops.flash_attention_bwd(*args, **kw)]
    refs = {"plain": (per_heads(fa_ref.attention_bwd_ref), BWD_TOL[dt])}
    if dt == torch.bfloat16:
        refs["bf16_ref"] = (fa_ref.attention_bwd_bf16_ref, BWD_BF16_REF_TOL)
    out = {}
    for what, (fn, tol) in refs.items():
        want = [w[:, :, n_img:].to(dt) for w in fn(*args, **kw)]
        lims = [scaled(tol, w) for w in want]
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        out[what] = dict(max_abs_err=err, limits=[lim["atol"] for lim in lims],
                         max_abs_ref=[float(w.float().abs().max()) for w in want])
        if not all(torch.allclose(g.float(), w.float(), **lim)
                   for g, w, lim in zip(got, want, lims)):
            fail(f"flash_attention.bwd ({tag}) at the text positions outside {lims} of "
                 f"{what}: max err {err}")
    emit(phase="main_path", check=f"{tag} flash_attention.bwd vs plain (text positions)",
         positions_from=n_img, **out)
    return out


def family_train_reduced(device, arch: str) -> None:
    """``arch``'s reduced config (float32, so the float32 attention kernels
    and their backward run in the family's layouts) for 6 steps on the
    card and on the CPU from the same weights: losses within
    TRAIN_CARD_VS_CPU_RTOL (relative); on the card the attention kernels
    and their backward launched once an attention call a step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run
    from repro_torch.models import lm

    cfg = get_config(arch).reduced()
    card = lm.init(cfg, seed=3, device=device,
                   max_seq=AUDIO_MAX_SEQ if cfg.pos_kind == "learned" else 0)
    state = {k: v.detach().to("cpu", copy=True) for k, v in card.state_dict().items()}
    n_attn = attention_launches(card)
    read = _train_kernels(None, "")
    t0 = time.perf_counter()
    _, _, losses = run(arch, **FAMILY_REDUCED_TRAIN, device=device, params=card)
    t1 = time.perf_counter()
    launches = read()
    _, _, host = run(arch, **FAMILY_REDUCED_TRAIN, device="cpu", params=state)
    rel = float((np.abs(np.asarray(host) - losses) / np.abs(host)).max())
    want = {"flash_attention": n_attn * FAMILY_REDUCED_TRAIN["steps"],
            "flash_attention.bwd": n_attn * FAMILY_REDUCED_TRAIN["steps"],
            "rglru_scan": 0, "rglru_scan.bwd": 0}
    emit(phase="main_path", check="train reduced card vs cpu", arch=arch, layers=cfg.n_layers,
         dtype=cfg.dtype, **{k: v for k, v in FAMILY_REDUCED_TRAIN.items() if k != "log_every"},
         losses=losses, cpu_losses=host, card_vs_cpu_max_rel_diff=rel,
         rtol=TRAIN_CARD_VS_CPU_RTOL, card_seconds=t1 - t0,
         cpu_seconds=time.perf_counter() - t1, launches=launches)
    if not (len(losses) == len(host) and rel <= TRAIN_CARD_VS_CPU_RTOL):
        fail(f"train reduced {arch}: card vs CPU losses differ by {rel} (relative)")
    if device.type == "cuda" and launches != want:
        fail(f"train reduced {arch} launched {launches}, not {want}")


def train_families(device, recorder=None, reduced: bool = False) -> dict:
    """Phase 3j: each TRAIN_FAMILIES path (``train_family``), its layer-0
    attention held against the plain version (``train_attention``); then
    (on the card) each family's reduced config card against CPU.  Returns
    each path's launches."""
    t0 = time.perf_counter()
    launches = {}
    for path in TRAIN_FAMILIES:
        launches[path] = train_family(device, path, recorder, reduced)
        if recorder is not None:
            train_attention(path, recorder, device,
                            train_family_shape(path, reduced)[0].n_img_tokens)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if device.type == "cuda":
        for arch, *_ in TRAIN_FAMILIES.values():
            family_train_reduced(device, arch)
    emit(phase="main_path", check="train families phase", seconds=time.perf_counter() - t0,
         layers={path: layers for path, (_, _, _, layers) in TRAIN_FAMILIES.items()})
    return launches


# ---------------------------------------------------------------------------
# Phase 3g: the roofline of every timed path
# ---------------------------------------------------------------------------

# each timed path's measured seconds (a serving path's prefill and mean
# decode step, the training step's median after the first) and the path's
# peak memory, filled by phase 3
TIMED: dict = {}
# a card that beats the roofline of its own step means the count is wrong
ROOFLINE_SHARE_MAX = 1.05
# the xLSTM prefill's dry run steps through 6 sLSTM layers x 4,096 cells on
# meta, minutes of host time, and its training step through 1,024 cells
# three times (forward, remat, backward): each runs in a process of its
# own beside another for every other path, all started before phase 3 and
# read after
SLOW_DRY_RUNS = ("ssm serve prefill", "train ssm")
# another child: one training step on the reference's 16 x 16 mesh
MESH_DRY_RUN = (LM_ARCH, "train_4k")
DRY_RUN_TIMEOUT_S = 900


def roofline_paths(reduced: bool = False) -> dict:
    """Each timed path's (config, shape, cache_len, max_seq) for
    ``repro_torch.launch.dryrun.dry_run``: the depth, batch, length, cache
    allocation and position table phase 3 ran it at (``reduced``: the CPU
    rehearsal's).  A decode shape's length is the context before the first
    decode step (image prefix and prompt)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig

    serving = {"lm serve": (LM_ARCH, None, LM_BATCH, LM_PROMPT),
               "moe serve": (MOE_ARCH, MOE_LAYERS, LM_BATCH, LM_PROMPT),
               "ssm serve": (XLSTM_ARCH, None, LM_BATCH, LM_PROMPT),
               "audio serve": (AUDIO_ARCH, None, AUDIO_BATCH, AUDIO_PROMPT),
               "vlm serve": (VLM_ARCH, None, LM_BATCH, LM_PROMPT)}
    paths = {}
    for tag, (arch, layers, batch, prompt) in serving.items():
        cfg = get_config(arch)
        if reduced:
            cfg, prompt = cfg.reduced(), 48
        elif layers:
            cfg = cfg.replace(n_layers=layers)
        ctx = cfg.n_img_tokens + prompt
        for kind in ("prefill", "decode"):
            paths[f"{tag} {kind}"] = (cfg, ShapeConfig(f"{tag} {kind}", ctx, batch, kind),
                                      ctx + LM_GEN + 8, prompt + LM_GEN + 8)
    cfg, batch, seq = get_config(LM_ARCH).replace(n_layers=TRAIN_LAYERS), TRAIN_BATCH, TRAIN_SEQ
    if reduced:
        cfg, batch, seq = get_config(LM_ARCH).reduced(), 2, 64
    paths["lm train"] = (cfg, ShapeConfig("lm train", seq, batch, "train"), 0, 4 * seq)
    cfg, batch, seq = get_config(EXAMPLE_FULL["arch"]), EXAMPLE_FULL["batch"], EXAMPLE_FULL["seq"]
    if reduced:
        cfg, seq = cfg.reduced(), 64
    paths[EXAMPLE_FULL_PATH] = (cfg, ShapeConfig(EXAMPLE_FULL_PATH, seq, batch, "train"), 0,
                                4 * seq)
    for arch in DENSE_ARCHS:
        cfg, prompt, batch = get_config(arch), DENSE_PROMPT, dense_batch(arch, reduced)
        if reduced:
            cfg, prompt = cfg.reduced(), 48
        for kind in ("prefill", "decode"):
            name = f"dense serve {arch} {kind}"
            paths[name] = (cfg, ShapeConfig(name, prompt, batch, kind), prompt + LM_GEN + 8,
                           prompt + LM_GEN + 8)
    for path in TRAIN_FAMILIES:  # a step's length counts the image prefix
        cfg, batch, seq, max_seq = train_family_shape(path, reduced)
        paths[path] = (cfg, ShapeConfig(path, cfg.n_img_tokens + seq, batch, "train"), 0,
                       max_seq)
    return paths


def attention_pair_flops(cfg, shape, cache_len: int) -> tuple:
    """A dense path's attention FLOPs as the dry run counts them (every
    (query, key) pair: the plain attention's S x S scores in a prefill,
    every one of the cache's ``cache_len`` slots in a decode step) and as
    the masks let them through (causal pairs; the filled slots up to the
    new token), 4 x head_dim a pair, a head and a layer."""
    B, S = shape.global_batch, shape.seq_len
    every, visible = (S * S, S * (S + 1) // 2) if shape.kind == "prefill" else (cache_len, S + 1)
    per_pair = 4 * cfg.resolved_head_dim * cfg.n_heads * B * cfg.n_layers
    return per_pair * every, per_pair * visible


def dry_runs(names, reduced: bool) -> int:
    """The child process of the roofline phase: each named path's dry run
    on meta, printed as one JSON line {name: record}."""
    from repro_torch.launch.dryrun import dry_run

    paths = roofline_paths(reduced)
    for name in names:
        cfg, shape, cache_len, max_seq = paths[name]
        rec = dry_run(cfg, shape, cache_len=cache_len, max_seq=max_seq)
        print(json.dumps({name: rec}), flush=True)
    return 0


def start_dry_runs(reduced: bool = False) -> list:
    """Start the dry runs of every timed path in child processes (one for
    each of SLOW_DRY_RUNS, one for the rest), and MESH_DRY_RUN in another
    (no card: meta tensors only), so their host
    time overlaps phase 3's."""
    cmd = [sys.executable, str(Path(__file__).resolve())]
    if reduced:
        cmd += ["--device", "cpu"]
    names = list(roofline_paths(reduced))
    runs = [["--dry-runs", n] for n in SLOW_DRY_RUNS] + [
        ["--dry-runs", *[n for n in names if n not in SLOW_DRY_RUNS]], ["--mesh-dry-run"]]
    return [subprocess.Popen(cmd + args, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, cwd=ROOT,
                             env=dict(os.environ, OMP_NUM_THREADS="1"))
            for args in runs]


def stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def read_dry_runs(procs) -> dict:
    """Wait for the dry-run children; {path name: record}.  Fails when one
    failed or ran over DRY_RUN_TIMEOUT_S."""
    recs = {}
    for p in procs:
        try:
            out, err = p.communicate(timeout=DRY_RUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            stop(procs)
            fail(f"roofline: a dry run took over {DRY_RUN_TIMEOUT_S} s")
        if p.returncode:
            fail(f"roofline: a dry run failed ({p.returncode}): {err[-3000:]}")
        for line in out.splitlines():
            recs.update(json.loads(line))
    return recs


def roofline_phase(recs: dict, reduced: bool = False) -> None:
    """One line a timed path: its model FLOPs (``roofline.model_flops`` of
    the active parameters), counted and analytic FLOPs, the roofline's
    compute and memory terms at the H100's data-sheet peaks, the measured
    seconds, ``mfu`` = model FLOPs / (measured s x PEAK_FLOPS) and
    ``roofline_share`` = the roofline's step time / measured s; the dry
    run's peak-memory estimate beside the path's measured peak.  A dense
    serving path's line also carries the count with attention charged
    only for the pairs its masks let through (``attention_pair_flops``)
    and the share that count gives.  Fails when a share exceeds
    ROOFLINE_SHARE_MAX."""
    from repro_torch.roofline import roofline as rl

    shares = {}
    for name, (cfg, shape, cache_len, _) in roofline_paths(reduced).items():
        rec, timed = recs[name], TIMED[name]
        roof, seconds = rec["roofline"], timed["seconds"]
        mf = rl.model_flops(shape.kind, rec["n_active_params"], rec["tokens_per_step"])
        shares[name] = roof["step_time_s"] / seconds
        visible = {}
        if name.startswith("dense "):
            every, seen = attention_pair_flops(cfg, shape, cache_len)
            flops = rec["cost"]["flops"] - every + seen
            step_s = max(flops / rl.PEAK_FLOPS, roof["memory_s"])
            visible = dict(attention_flops_counted=every, attention_flops_visible=seen,
                           visible_pair_flops=flops, visible_step_time_s=step_s,
                           visible_roofline_share=step_s / seconds)
        emit(phase="roofline", path=name, arch=cfg.name, layers=cfg.n_layers, kind=shape.kind,
             batch=shape.global_batch, seq_len=shape.seq_len, cache_len=cache_len,
             tokens=rec["tokens_per_step"], n_active_params=rec["n_active_params"],
             model_flops=mf, counted_flops=rec["cost"]["flops"],
             analytic_flops=rec["analytic"]["flops_global"],
             counted_vs_analytic=rec["analytic"]["counted_vs_analytic"],
             analytic_bytes=rec["analytic"]["bytes_per_dev"]["total"],
             compute_s=roof["compute_s"], memory_s=roof["memory_s"], dominant=roof["dominant"],
             step_time_s=roof["step_time_s"], roofline_mfu=roof["mfu"], measured_s=seconds,
             mfu=mf / (seconds * rl.PEAK_FLOPS), roofline_share=shares[name],
             predicted_peak_memory_bytes=rec["memory"]["peak_bytes_est"],
             measured_peak_memory_bytes=timed["peak_memory_bytes"],
             dry_run_seconds=rec["trace_s"], source=roof["source"], **visible)
    over = {n: v for n, v in shares.items() if v > ROOFLINE_SHARE_MAX}
    if over:
        fail(f"roofline: measured faster than the roofline allows {over}: a miscount")
    mesh_roofline(recs["mesh"])


def mesh_dry_run(reduced: bool) -> int:
    """The roofline phase's child: MESH_DRY_RUN's step on the reference's
    16 x 16 mesh over a fake process group of 256 ranks (meta tensors, no
    card; the reduced config on a 2 x 2 mesh in the CPU rehearsal),
    printed as one JSON line {"mesh": record}."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import lower_cell

    arch, shape = MESH_DRY_RUN
    if reduced:
        rec = lower_cell(arch, ShapeConfig("reduced train", 64, 4, "train"), False,
                         reduced=True, mesh_shape=(2, 2))
    else:
        rec = lower_cell(arch, shape, False)
    print(json.dumps({"mesh": rec}, default=float), flush=True)
    return 0


def mesh_roofline(rec: dict) -> None:
    """One line for MESH_DRY_RUN's record: its per-device counts, the
    collectives DTensor issued (summarized with the reference's ring
    model) and the roofline with its collective term.  These are counts
    on the CPU, not device metrics.  Fails when the dry run failed or
    recorded no collective."""
    if rec.get("status") != "OK":
        fail(f"roofline: the mesh dry run failed: {rec.get('error')}")
    roof, coll = rec["roofline"], rec["collectives"]
    emit(phase="roofline", path="mesh " + " ".join(MESH_DRY_RUN), arch=rec["arch"],
         shape=rec["shape"], mesh=rec["mesh"], n_chips=rec["n_chips"], cpu_counts=True,
         counted_flops_per_device=rec["cost"]["flops"],
         counted_vs_analytic=rec["analytic"]["counted_vs_analytic"],
         analytic_bytes_per_device=rec["analytic"]["bytes_per_dev"]["total"],
         peak_bytes_per_device=rec["memory"]["peak_bytes_est"], collectives=coll,
         compute_s=roof["compute_s"], memory_s=roof["memory_s"],
         collective_s=roof["collective_s"], dominant=roof["dominant"],
         step_time_s=roof["step_time_s"], roofline_mfu=roof["mfu"],
         dry_run_seconds=rec["trace_s"], source=roof["source"])
    if not coll["wire_bytes"] > 0:
        fail("roofline: the mesh dry run recorded no collective")


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


def profiled_ms(fn, reps: int = 20) -> float:
    """Device time of one call: its kernels' own time from ``torch.profiler``
    over ``reps`` calls, without the launch gaps and event records that
    ``device_ms`` brackets (the decode kernel's ~30 us is of the order of
    those)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages())
    if total_us <= 0:
        fail("torch.profiler recorded no device time")
    return total_us / reps / 1e3


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


def attention_work(q, k, v, q_pos, k_pos, causal=True, window=0) -> tuple:
    """Operations and bytes attention needs on these inputs: 4 D per
    (query, key) pair the masks let through, for every (b, h); q, out and
    the distinct elements of k and v (a stride-0 head axis holds one head)
    moved once, the positions read once."""
    from repro_torch.kernels.flash_attention import ref as fa_ref

    B, H, _, D = q.shape
    pairs = int(fa_ref.position_mask(q_pos, k_pos, causal=causal, window=window).sum())

    def distinct(t):
        return math.prod(n for n, s in zip(t.shape, t.stride()) if s != 0 or n == 1)

    nbytes = (2 * q.numel() + distinct(k) + distinct(v)) * q.element_size() \
        + 4 * (q_pos.numel() + k_pos.numel())
    return 4 * D * pairs * B * H, nbytes, pairs * B * H


def attention_bwd_work(q, k, v, q_pos, k_pos, o, lse, do, causal=True, window=0) -> tuple:
    """Operations and bytes the attention backward needs on these inputs:
    10 D per (query, key) pair the masks let through (recomputing S, dP,
    and the dV, dK and dQ products), for every (b, h); q, o, dO and dQ,
    the distinct elements of k and v, and every head's dK and dV moved
    once, lse and the positions read once."""
    _, fwd_bytes, pairs = attention_work(q, k, v, q_pos, k_pos, causal=causal, window=window)
    B, H, Sq, D = q.shape
    nbytes = fwd_bytes + (2 * q.numel() + 2 * B * H * k.shape[2] * D) * q.element_size() \
        + 4 * lse.numel()
    return 10 * D * pairs, nbytes, pairs


def sdpa_calls(q_pos, k_pos, causal=True, window=0) -> dict:
    """Each ``scaled_dot_product_attention`` call that computes attention
    under these masks, by name -> its keyword arguments: with the boolean
    mask always; with no mask where the mask hides no key; with
    ``is_causal=True`` where the mask is exactly the lower triangle (Sq =
    Sk, a causal run over positions that order the keys as the queries,
    no window cutting in, no hole).  Timed as yardsticks only."""
    from repro_torch.kernels.flash_attention import ref as fa_ref

    mask = fa_ref.position_mask(q_pos, k_pos, causal=causal, window=window)
    calls = {"SDPA, boolean mask": dict(attn_mask=mask)}
    if bool(mask.all()):
        calls["SDPA, no mask"] = {}
    Sq, Sk = mask.shape
    if Sq == Sk and torch.equal(mask, torch.ones_like(mask).tril()):
        calls["SDPA, is_causal"] = dict(is_causal=True)
    return calls


def decode_work(k, v, q, k_pos, pos, window=0, logit_cap=0.0) -> tuple:
    """Operations and bytes decode attention needs on these inputs: 4 hd
    per (query head, slot) pair the masks let through; the K and V rows of
    those slots read once (each KV head once for its group), q and out
    moved once, k_pos and pos read once.  Returns (ops, bytes, pairs)."""
    from repro_torch.kernels.decode_attention import ref as dec_ref

    B, Sc, KV, hd = k.shape
    visible = int(dec_ref.slot_mask(k_pos, pos, window).sum())
    nbytes = (2 * visible * KV * hd + 2 * q.numel()) * k.element_size() \
        + 4 * (k_pos.numel() + pos.numel())
    return 4 * hd * q.shape[2] * visible, nbytes, q.shape[2] * visible


def decode_sdpa(k, v, q, k_pos, pos, window=0, logit_cap=0.0):
    """``scaled_dot_product_attention`` computing decode attention over the
    cache expanded to the query heads beforehand (a library yardstick,
    timed only: the expansion is not timed, the port calls neither)."""
    from repro_torch.kernels.decode_attention import ref as dec_ref

    ke, ve = (t.transpose(1, 2).contiguous()
              for t in dec_ref.expand_kv(k, v, q.shape[2]))
    mask = dec_ref.slot_mask(k_pos, pos, window)[:, None, None, :]
    return functools.partial(torch.nn.functional.scaled_dot_product_attention,
                             q.transpose(1, 2), ke, ve, attn_mask=mask)


def attention_ops_peak(ops, dtype) -> tuple:
    """The operations attention's bound counts and the peak rate they run
    at: bf16 products on the tensor cores at the bf16 rate; float32 ones to
    float32 accuracy as 3xTF32, three TF32 products each (the kernels'
    arithmetic; CUDA cores alone reach only FP32_OPS_PER_S)."""
    if dtype == torch.bfloat16:
        return ops, BF16_OPS_PER_S
    return 3 * ops, TF32_OPS_PER_S


# float32 scores a plain attention call may hold at once where it runs a
# few heads at a time (``per_heads``): 512 MiB
PLAIN_SCORES_MAX = 1 << 27


def per_heads(fn):
    """A plain attention function of (q, k, v, ...) run on one sequence and
    as many heads as keep its (query, key) scores within PLAIN_SCORES_MAX,
    its outputs put back together: whole, the plain versions hold every
    score in float32 several times over, more than the card holds at a
    training path's shapes.  Positions (1-D) are shared; every tensor of
    3 or more axes is sliced by sequence and head."""
    def run(q, k, *rest, **kw):
        B, H, Sq, _ = q.shape
        n = max(1, PLAIN_SCORES_MAX // (Sq * k.shape[2]))
        rows = []
        for b in range(B):
            parts = [fn(*(t[b:b + 1, h:h + n] if torch.is_tensor(t) and t.dim() >= 3 else t
                          for t in (q, k, *rest)), **kw) for h in range(0, H, n)]
            if isinstance(parts[0], tuple):
                rows.append(tuple(torch.cat(o, 1) for o in zip(*parts)))
            else:
                rows.append(torch.cat(parts, 1))
        if isinstance(rows[0], tuple):
            return tuple(torch.cat(o, 0) for o in zip(*rows))
        return torch.cat(rows, 0)

    return run


def kernel_case(name, args, kw, tag, tol=None, recorded=False, by_head=False, timed=True):
    """Run one kernel on ``args`` against its plain version: bit-identical
    (PageRank, attention, RG-LRU: within their tolerance, or ``tol``, and
    the same bits on a second run) or fail; returns the times, bound and
    error.  ``recorded``: ``args`` are inputs a main path gave the kernel
    (see ``planted_faults``).  ``by_head``: the plain attention versions
    run a few heads at a time (``per_heads``).  Without ``timed`` the case
    is only held (a ``main_path`` line, no times)."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.delta_overlay import ops as ov_ops
    from repro_torch.kernels.delta_overlay import ref as ov_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rglru_scan import ref as rg_ref
    from repro_torch.kernels.temporal_cc import ops as cc_ops
    from repro_torch.kernels.temporal_cc import ref as cc_ref
    from repro_torch.kernels.temporal_motif import ops as motif_ops
    from repro_torch.kernels.temporal_motif import ref as motif_ref
    from repro_torch.kernels.temporal_pagerank import ops as pr_ops
    from repro_torch.kernels.temporal_pagerank import ref as pr_ref

    library, peak, grad, timer = {}, TF32_OPS_PER_S, False, device_ms
    split = per_heads if by_head else (lambda fn: fn)
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

        def motif_bmm():
            a = args[0]
            return ((torch.bmm(a, a) * a).sum(dim=1) * 0.5).to(torch.int32)

        library = {"bmm and sum, f32": motif_bmm}
    elif name == "temporal_pagerank.pagerank":
        kern, plain, tol = pr_ops.temporal_pagerank, pr_ref.pagerank_ref, DENSE_PR_TOL
        T, N, _ = args[0].shape
        (ops, nbytes), peak = pagerank_work(*args), FP32_OPS_PER_S
        shape = dict(T=T, N=N, nnz=int((args[0] != 0).sum()), iters=20,
                     regime=pr_ops.regime(N))
    elif name == "temporal_cc.cc":
        kern, plain = cc_ops.temporal_cc, cc_ref.cc_ref
        T, N, _ = args[0].shape
        (ops, nbytes), peak = cc_work(*args), INT32_OPS_PER_S
        shape = dict(T=T, N=N, nnz=int((args[0] > 0).sum()), iters=32,
                     regime=pr_ops.regime(N))
    elif name == "flash_attention":
        q = args[0]
        kern = fa_ops.flash_attention
        tol = tol or ATTN_TOL[q.dtype]

        def plain(*a, **k):
            return split(fa_ref.attention_ref)(*a, **k).to(a[0].dtype)

        ops, nbytes, pairs = attention_work(*args, **kw)
        ops, peak = attention_ops_peak(ops, q.dtype)
        B, H, Sq, D = q.shape
        shape = dict(B=B, H=H, Sq=Sq, Sk=args[1].shape[2], D=D, dtype=str(q.dtype),
                     kv_head_stride=args[1].stride(1), pairs=pairs, **kw)
        library = {call: functools.partial(torch.nn.functional.scaled_dot_product_attention,
                                           *args[:3], **sdpa_kw)
                   for call, sdpa_kw in sdpa_calls(*args[3:5], **kw).items()}
    elif name == "decode_attention":
        k, q = args[0], args[2]
        kern, plain = dec_ops.decode_attention, dec_ref.decode_attention_ref
        tol = tol or ATTN_TOL[q.dtype]
        timer = profiled_ms
        ops, nbytes, pairs = decode_work(*args, **kw)
        # bf16 products on the tensor cores, float32 ones on the CUDA cores
        peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
        B, Sc, KV, hd = k.shape
        shape = dict(B=B, Sc=Sc, H=q.shape[2], kv_heads=KV, hd=hd, dtype=str(q.dtype),
                     window=args[5] if len(args) > 5 else kw.get("window", 0), pairs=pairs)
        library = {"SDPA, boolean mask, on the cache expanded to H heads":
                   decode_sdpa(*args, **kw)}
    elif name == "flash_attention.bwd":
        q = args[0]
        kern, grad = fa_ops.flash_attention_bwd, True
        tol = tol or BWD_TOL[q.dtype]

        def plain(*a, **k):
            return tuple(g.to(a[0].dtype) for g in split(fa_ref.attention_bwd_ref)(*a, **k))

        ops, nbytes, pairs = attention_bwd_work(*args, **kw)
        ops, peak = attention_ops_peak(ops, q.dtype)
        B, H, Sq, D = q.shape
        shape = dict(B=B, H=H, Sq=Sq, Sk=args[1].shape[2], D=D, dtype=str(q.dtype),
                     kv_head_stride=args[1].stride(1), pairs=pairs, **kw)
        leaves = [t.detach().requires_grad_() for t in args[:3]]
        for call, sdpa_kw in sdpa_calls(*args[3:5], **kw).items():
            sdpa_out = torch.nn.functional.scaled_dot_product_attention(*leaves, **sdpa_kw)
            # SDPA's backward, timed only
            library[call] = functools.partial(torch.autograd.grad, sdpa_out, leaves, args[7],
                                              retain_graph=True)
    elif name == "rglru_scan.bwd":
        kern, plain, grad = rg_ops.rglru_bwd, rg_ref.rglru_bwd_ref, True
        tol = tol or BWD_TOL[torch.float32]
        B, S, W = args[0].shape
        # g = dh + e, e = a g, a = exp(log_a), dlog_a = g a h_prev: ~5 a step;
        # log_a, h, dh read and dlog_a, db written once
        ops, nbytes, peak = 5 * args[0].numel(), 5 * args[0].numel() * 4, FP32_OPS_PER_S
        shape = dict(B=B, S=S, W=W, chunk=rg_ops.CHUNK, load_path=rg_ops.bwd_load_path(*args))
    else:
        kern, plain, tol = rg_ops.rglru, rg_ref.rglru_ref, RGLRU_TOL
        B, S, W = args[0].shape
        ops, nbytes, peak = 3 * args[0].numel(), 3 * args[0].numel() * 4, FP32_OPS_PER_S
        shape = dict(B=B, S=S, W=W, chunk=rg_ops.CHUNK)

    got = kern(*args, **kw)
    sync(args[0].device)
    want = plain(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if tol is None:
        err = max_err(got, want)
        if err != 0:
            fail(f"{name} ({tag}) differs from its plain version: max err {err}")
        extra = {}
    else:
        err, lims = 0.0, [scaled(tol, w) if grad else tol for w in want]
        for g, w, lim in zip(got, want, lims):
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"{name} ({tag}): {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
            err = max(err, float((g.float() - w.float()).abs().max()))
            if not torch.allclose(g.float(), w.float(), **lim):
                fail(f"{name} ({tag}) outside {lim} of its plain version: max err {err}")
        again = kern(*args, **kw)
        again = again if isinstance(again, tuple) else (again,)
        if not all(torch.equal(a, g) for a, g in zip(again, got)):
            fail(f"{name} ({tag}): two runs differ")
        extra = dict(max_abs_ref=[float(w.float().abs().max()) for w in want])
        if name == "flash_attention" and args[0].dtype == torch.bfloat16:
            extra.update(bf16_forward_check(tag, args, kw, got[0], want[0], plain, recorded))
        if name == "decode_attention" and args[0].dtype == torch.bfloat16:
            _, n_split, split_len = dec_ops.plan(args[2], args[0])
            extra.update(split_plan=[n_split, split_len], **decode_forward_check(
                tag, args, kw, got[0], want[0], split_len, recorded))
        if grad:
            extra.update(limits=[lim["atol"] for lim in lims],
                         planted=planted_faults(name, tag, args, kw, got, want, lims, plain,
                                                recorded))
    extra.update(decomposition_check(name, tag, args, kw, got, split))
    if not timed:
        row = dict(shape=shape, max_abs_err=err, **extra)
        emit(phase="main_path", check=f"{tag} {name} vs plain", by_head=by_head, **row)
        return row
    ops_ms, bytes_ms = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms > bytes_ms else "bytes"
    library_all = {call: device_ms(fn) for call, fn in library.items()}
    library_call = min(library_all, key=library_all.get) if library_all else None
    row = dict(shape=shape, max_abs_err=err, ms=timer(lambda: kern(*args, **kw)),
               plain_ms=device_ms(lambda: plain(*args, **kw)), bound_ms=bound_ms,
               bound_by=bound_by,
               library_ms=library_all[library_call] if library_call else None,
               library_call=library_call, library_all_ms=library_all, **extra)
    emit(phase="kernel_vs_plain", kernel=name, inputs=tag, **row)
    return row


def planted_faults(name, tag, args, kw, got, want, lims, plain, recorded) -> dict:
    """What a backward kernel with a known fault would return, each held
    against the plain version under the same limits.  A zeroed output (dQ;
    db) must be rejected on every input.  A fault of the algorithm (the
    attention's delta term dropped: the plain version given O = 0, so
    delta = rowsum(dO * O) = 0; past one chunk, the RG-LRU's carry between
    chunks dropped: g restarts from dh at each chunk's end) changes the
    output by as much as the inputs let that term weigh, so it must be
    rejected at the headline shapes, whose inputs are drawn to make it
    weigh, and on every bf16 attention case, and is only reported on the
    other inputs a main path recorded (on the full-width train step,
    dropping the carry moves db by ~1e-5 of its largest value).
    Returns each fault's max abs error and whether it was rejected."""
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rglru_scan import ref as rg_ref

    bf16 = got[0].dtype == torch.bfloat16
    if name == "flash_attention.bwd":
        faults = {"dQ zeroed": (torch.zeros_like(got[0]),) + got[1:],
                  "delta dropped": plain(*args[:5], torch.zeros_like(args[5]), *args[6:], **kw)}
    else:
        log_a, h, dh = args
        faults = {"db zeroed": (got[0], torch.zeros_like(got[1]))}
        if log_a.shape[1] > rg_ops.CHUNK:
            cut = log_a.clone()
            cut[:, rg_ops.CHUNK::rg_ops.CHUNK] = -torch.inf
            _, g = rg_ref.rglru_bwd_ref(cut, h, dh)
            h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
            faults["carry dropped"] = (g * torch.exp(log_a) * h_prev, g)
    out = {}
    for fault, outs in faults.items():
        err = max(float((o.float() - w.float()).abs().max()) for o, w in zip(outs, want))
        rejected = not all(torch.allclose(o.float(), w.float(), **lim)
                           for o, w, lim in zip(outs, want, lims))
        out[fault] = dict(max_abs_err=err, rejected=rejected)
        if not rejected and ("zeroed" in fault or not recorded or bf16):
            fail(f"{name} ({tag}): a kernel with '{fault}' would pass the limits {lims} "
                 f"(its max err {err})")
    return out


def bf16_forward_check(tag, args, kw, got, want, plain, recorded) -> dict:
    """The bf16 attention forward within FWD_BF16_TOL (``scaled``) of its
    plain version.  Where no mask is causal and Sk is no multiple of the
    key tile, two faults of the ragged last tile are planted and held
    against the same limits: its zero-filled keys scored 0 (the plain
    version over k and v padded with zero rows to a whole tile) and the
    tile dropped (the plain version over the whole tiles only).  Each must
    be rejected on synthetic inputs; on inputs a main path recorded it is
    reported.  Returns the share of the limits the kernel used at its
    worst element, and each fault's."""
    lim = scaled(FWD_BF16_TOL, want)
    allow = lim["atol"] + lim["rtol"] * want.float().abs()

    def share(out):  # the largest |out - want| over what the limits allow
        return float(((out.float() - want.float()).abs() / allow).max())

    used = share(got)
    if used > 1:
        fail(f"flash_attention ({tag}) outside {lim} of its plain version "
             f"({used} of the limit at its worst element)")
    out = dict(fwd_bf16_limits=lim, fwd_bf16_share_of_limit=used)
    q, k, v, q_pos, k_pos = args
    Sk = k.shape[2]
    if kw.get("causal", True) or Sk % FA_KEY_TILE == 0:
        return out
    pad, whole = -Sk % FA_KEY_TILE, Sk - Sk % FA_KEY_TILE
    zeros = k.new_zeros(*k.shape[:2], pad, k.shape[3])
    pad_pos = torch.cat([k_pos, int(k_pos.max()) + 1 + torch.arange(
        pad, dtype=k_pos.dtype, device=k_pos.device)])
    faults = {"padded keys scored 0": plain(q, torch.cat([k, zeros], 2),
                                            torch.cat([v, zeros], 2), q_pos, pad_pos, **kw),
              "ragged tile dropped": plain(q, k[:, :, :whole], v[:, :, :whole], q_pos,
                                           k_pos[:whole], **kw)}
    out["planted"] = {}
    for fault, faulty in faults.items():
        worst = share(faulty)
        out["planted"][fault] = dict(share_of_limit=worst, rejected=worst > 1)
        if not recorded and worst <= 1:
            fail(f"flash_attention ({tag}): a kernel with '{fault}' would pass the limits "
                 f"{lim} ({worst} of them)")
    return out


def decode_forward_check(tag, args, kw, got, want, split_len: int, recorded) -> dict:
    """The bf16 decode attention within FWD_BF16_TOL (``scaled``) of its
    plain version, as the bf16 attention forward is held: ATTN_TOL's atol,
    2e-2, is above a typical output at the decode shapes (a mean of v over
    thousands of slots of randn * 0.5: ~0.008, at most ~0.03).  Two faults
    are planted and held against the same limits: the kernel's first range
    of ``split_len`` slots dropped (the plain version with them masked) and
    P rounded to fp8 before P V (``decode_attention_splits_ref`` at
    ``split_len`` with P in float8_e4m3fn).  Each must be rejected on
    synthetic inputs; on inputs a main path recorded it is reported.
    Returns the share of the limits the kernel used at its worst element,
    and each fault's."""
    from repro_torch.kernels.decode_attention import ref as dec_ref

    lim = scaled(FWD_BF16_TOL, want)
    allow = lim["atol"] + lim["rtol"] * want.float().abs()

    def share(out):  # the largest |out - want| over what the limits allow
        return float(((out.float() - want.float()).abs() / allow).max())

    used = share(got)
    if used > 1:
        fail(f"decode_attention ({tag}) outside {lim} of its plain version "
             f"({used} of the limit at its worst element)")
    k, v, q, k_pos, pos = args[:5]
    window = args[5] if len(args) > 5 else kw.get("window", 0)
    dropped = k_pos.clone()
    dropped[:, :split_len] = -1
    faults = {"a slot range dropped": dec_ref.decode_attention_ref(k, v, q, dropped, pos, window),
              "P in fp8": dec_ref.decode_attention_splits_ref(
                  k, v, q, k_pos, pos, window, split_len, p_dtype=torch.float8_e4m3fn)}
    out = dict(decode_bf16_limits=lim, decode_bf16_share_of_limit=used, planted={})
    for fault, faulty in faults.items():
        worst = share(faulty)
        out["planted"][fault] = dict(share_of_limit=worst, rejected=worst > 1)
        if not recorded and worst <= 1:
            fail(f"decode_attention ({tag}): a kernel with '{fault}' would pass the limits "
                 f"{lim} ({worst} of them)")
    return out


def decomposition_check(name, tag, args, kw, got, split=lambda fn: fn) -> dict:
    """The redesigned kernels against the plain emulation of their own
    decomposition: ``overlay`` bit for bit against ``overlay_seeded_ref``
    (its walk: step 1 in full, invalid layers skipped from step 2 on),
    ``overlay_batch``'s pre-pass lists bit for bit against
    ``layer_lists_ref``, ``rglru_scan`` and its backward within RGLRU_TOL
    of ``rglru_chunked_ref`` / ``rglru_bwd_chunked_ref`` at the kernel's
    chunk; the attention backward's input ``lse`` (the forward kernel's)
    within LSE_TOL of ``lse_ref``, ``-inf`` on the same rows, and its bf16
    outputs within BWD_BF16_REF_TOL of ``attention_bwd_bf16_ref``; the
    float32 attention forward and backward within F32_REF_TOL of
    ``attention_3xtf32_ref`` / ``attention_bwd_3xtf32_ref``, where the same
    limits must reject the one-term TF32 emulation at D = 256.  ``split``
    wraps ``lse_ref`` (``per_heads``)."""
    if name in ("flash_attention", "flash_attention.bwd") and args[0].dtype == torch.float32:
        out = tf32_check(name, tag, args, kw, got)
        if name == "flash_attention":
            return out
    else:
        out = {}
    if name == "delta_overlay.overlay":
        from repro_torch.kernels.delta_overlay import ref as ov_ref

        if max_err(got, ov_ref.overlay_seeded_ref(*args)) != 0:
            fail(f"{name} ({tag}) != overlay_seeded_ref")
        return dict(seeded_ref="equal")
    if name == "delta_overlay.overlay_batch":
        from repro_torch.kernels.delta_overlay import ops as ov_ops
        from repro_torch.kernels.delta_overlay import ref as ov_ref

        lists, counts = ov_ops.layer_lists(args[3])
        want_lists, want_counts = ov_ref.layer_lists_ref(args[3])
        if not (torch.equal(lists, want_lists) and torch.equal(counts, want_counts)):
            fail(f"{name} ({tag}): pre-pass layer lists != layer_lists_ref")
        return dict(layer_lists="equal", listed_layers=int(counts.sum()))
    if name == "rglru_scan":
        from repro_torch.kernels.rglru_scan import ops as rg_ops
        from repro_torch.kernels.rglru_scan import ref as rg_ref

        want = rg_ref.rglru_chunked_ref(*args, rg_ops.CHUNK)
        err = float((got[0] - want).abs().max())
        if not torch.allclose(got[0], want, **RGLRU_TOL):
            fail(f"{name} ({tag}) outside {RGLRU_TOL} of rglru_chunked_ref: {err}")
        return dict(chunked_ref_max_abs_err=err)
    if name == "rglru_scan.bwd":
        from repro_torch.kernels.rglru_scan import ops as rg_ops
        from repro_torch.kernels.rglru_scan import ref as rg_ref

        want = rg_ref.rglru_bwd_chunked_ref(*args, rg_ops.CHUNK)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        lims = [scaled(BWD_TOL[torch.float32], w) for w in want]
        if not all(torch.allclose(g, w, **lim) for g, w, lim in zip(got, want, lims)):
            fail(f"{name} ({tag}) outside {lims} of rglru_bwd_chunked_ref: {err}")
        if rg_ops._bwd_scratch(args[0]).any():  # the next launch would read stale carries
            fail(f"{name} ({tag}): the kernel left its scratch non-zero")
        return dict(chunked_ref_max_abs_err=err)
    if name == "flash_attention.bwd":
        # the forward kernel's log-sum-exp the backward was given
        from repro_torch.kernels.flash_attention import ref as fa_ref

        q, k, _, q_pos, k_pos, _, lse, _ = args
        want = split(fa_ref.lse_ref)(q, k, q_pos, k_pos, **kw)
        finite = torch.isfinite(want)
        if not torch.equal(torch.isfinite(lse), finite):
            fail(f"{name} ({tag}): the forward's lse is -inf on other rows than lse_ref's")
        err = float((lse[finite] - want[finite]).abs().max()) if finite.any() else 0.0
        if not torch.allclose(lse[finite], want[finite], **LSE_TOL):
            fail(f"{name} ({tag}): the forward's lse outside {LSE_TOL} of lse_ref: {err}")
        out.update(lse_max_abs_err=err, rows_without_key=int((~finite).sum()))
        if q.dtype == torch.bfloat16:  # the wgmma kernels' own arithmetic
            want = fa_ref.attention_bwd_bf16_ref(*args, **kw)
            lims = [scaled(BWD_BF16_REF_TOL, w) for w in want]
            err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
            if not all(torch.allclose(g.float(), w.float(), **lim)
                       for g, w, lim in zip(got, want, lims)):
                fail(f"{name} ({tag}) outside {lims} of attention_bwd_bf16_ref: {err}")
            out.update(bf16_ref_max_abs_err=err, bf16_ref_limits=[lim["atol"] for lim in lims])
        return out
    return {}


def tf32_check(name, tag, args, kw, got) -> dict:
    """A float32 attention kernel's outputs against the plain emulation of
    its 3xTF32 arithmetic, within F32_REF_TOL of each output's largest
    value; the one-term TF32 emulation under the same limits is reported
    and, at D = 256, must be rejected."""
    from repro_torch.kernels.flash_attention import ref as fa_ref

    if name == "flash_attention":
        def emulate(terms):
            return fa_ref.attention_3xtf32_ref(*args, terms=terms, **kw)[:1]
    else:
        def emulate(terms):
            return fa_ref.attention_bwd_3xtf32_ref(*args, terms=terms, **kw)
    want = emulate(3)
    lims = [scaled(F32_REF_TOL, w) for w in want]

    def within(outs):
        err = max(float((g - w).abs().max()) for g, w in zip(outs, want))
        return err, all(torch.allclose(g, w, **lim) for g, w, lim in zip(outs, want, lims))

    err, ok = within(got)
    if not ok:
        fail(f"{name} ({tag}) outside {lims} of the 3xTF32 emulation: {err}")
    one_err, one_ok = within(emulate(1))
    if one_ok and args[0].shape[-1] == 256:
        fail(f"{name} ({tag}): the one-term TF32 emulation passes the limits {lims}")
    return dict(tf32x3_ref_max_abs_err=err, tf32x3_ref_limits=[lim["atol"] for lim in lims],
                one_term_tf32=dict(max_abs_err=one_err, rejected=not one_ok))


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

    def wide_tmask(T, shared=2):
        """A snapshot group's structure: the shared path layers feed every
        timepoint, then one eventlist layer feeds each timepoint."""
        m = torch.zeros(shared + T, T, dtype=torch.int8)
        m[:shared] = 1
        m[shared + torch.arange(T), torch.arange(T)] = 1
        return m.to(dev)

    def adjacency(T, N, p=0.02):
        a = torch.triu((torch.rand(T, N, N, generator=g) < p).float(), 1)
        return [(a + a.transpose(1, 2)).to(dev)]

    gd = torch.Generator(device=dev).manual_seed(13)

    def analytics(T, N, p=0.02, gen=gd):
        """Symmetric 0/1 adjacency made on the card (2.1 GB at T=8
        N=8192) and a ~80% activity mask; edges may touch inactive nodes."""
        a = torch.triu(torch.rand(T, N, N, generator=gen, device=dev) < p, 1)
        a = a.to(torch.float32)
        a += a.transpose(1, 2).clone()
        return [a, (torch.rand(T, N, generator=gen, device=dev) < 0.8).to(torch.float32)]

    def attention(B, H, Sq, Sk, D, causal, window, dtype, holes=0, gen=gd):
        """The reference's kernel-test case on the card; ``holes`` > 0
        leaves only the first ``holes`` keys valid (a ring cache)."""
        q, k, v = ((torch.randn(B, H, n, D, generator=gen, device=dev) * 0.5).to(dtype)
                   for n in (Sq, Sk, Sk))
        k_pos = torch.arange(Sk, dtype=torch.int32, device=dev)
        q_pos = k_pos[Sk - Sq:] if causal else k_pos[:Sq]
        if holes:
            k_pos = torch.where(k_pos < holes, k_pos, -1)
            q_pos = torch.full((Sq,), holes - 1, dtype=torch.int32, device=dev)
        tag = f"B={B} H={H} Sq={Sq} Sk={Sk} D={D} {str(dtype)[6:]} causal={causal} " \
              f"window={window}" + (f" holes after {holes}" if holes else "")
        return ("flash_attention", tag, [q, k, v, q_pos, k_pos],
                dict(causal=causal, window=window), None)

    def mask_check(holes):
        """bf16, q = 0: every allowed key weighs exactly 1/n, so out[..., :12]
        is the mean of the allowed keys' position bits and out[..., 12] is 1
        (0 for a query with no key).  Causal, window 64, S = 700 (no multiple
        of 64 or 128), one KV head at stride 0.  ``holes``: 10% of the keys
        and the whole tile of keys 320..383 are holes (-1), so query 383
        sees no key; a hole's v holds the bits of its index."""
        B, H, S, D = 2, 4, 700, 128
        idx = torch.arange(S, dtype=torch.int32, device=dev)
        k_pos = idx.clone()
        if holes:
            k_pos[torch.rand(S, generator=gd, device=dev) < 0.1] = -1
            k_pos[320:384] = -1
        code = torch.where(k_pos >= 0, k_pos, idx)
        v = torch.zeros(B, S, 1, D, device=dev)
        v[..., :12] = ((code[:, None] >> torch.arange(12, device=dev)) & 1).float()[:, None]
        v[..., 12] = 1.0
        k = torch.randn(B, S, 1, D, generator=gd, device=dev)
        q = torch.zeros(B, S, H, D, dtype=torch.bfloat16, device=dev).transpose(1, 2)
        k, v = (t.to(torch.bfloat16).expand(B, S, H, D).transpose(1, 2) for t in (k, v))
        tag = f"mask check B={B} H={H} S={S} D={D} bf16 causal window=64 KV head stride 0" \
            + (" holes" if holes else "")
        return ("flash_attention", tag, [q, k, v, idx, k_pos],
                dict(causal=True, window=64), MASK_TOL)

    def rglru(B, S, W):
        la = -torch.rand(B, S, W, generator=gd, device=dev).abs() * 0.5
        return ("rglru_scan", f"B={B} S={S} W={W}",
                [la, torch.randn(B, S, W, generator=gd, device=dev)], {}, None)

    f32, bf16 = torch.float32, torch.bfloat16
    dense = [(f"T={T} N={N}", analytics(T, N))
             for T, N in ((4, 4096), (4, 4000), (8, 8192))]
    # ~10% dense: a cluster CTA's 12,500 rows overflow its 8,000-entry row
    # lists, so the cluster kernels sweep the bits.  This case and the
    # weighted ones draw from generators of their own, so every other case
    # gets the same inputs as without them.
    dense.append(("T=2 N=1000 10% dense (no room for row lists: the bit sweep)",
                  analytics(2, 1000, p=0.05,
                            gen=torch.Generator(device=dev).manual_seed(17))))
    lm = [attention(1, 2, 64, 64, 32, True, 0, f32), attention(2, 1, 128, 128, 16, True, 0, bf16),
          attention(1, 2, 96, 160, 32, True, 48, f32), attention(1, 1, 64, 256, 64, False, 0, f32),
          attention(2, 2, 1, 96, 32, True, 0, f32), attention(1, 1, 1, 64, 16, True, 0, f32, 40),
          attention(1, 2, 300, 300, 256, True, 128, bf16),
          attention(1, 2, 200, 200, 64, True, 0, bf16), mask_check(False), mask_check(True),
          rglru(1, 128, 128), rglru(2, 64, 256), rglru(1, 96, 130), rglru(2, 33, 64),
          rglru(1, 40, 32), rglru(1, 4097, 4096)]
    def asymmetric(T, N, p=0.02):
        """A 0/1 stack with no symmetry and half the diagonal set."""
        a = (torch.rand(T, N, N, generator=g) < p).float()
        a[:, torch.arange(0, N, 2), torch.arange(0, N, 2)] = 1.0
        return [a.to(dev)]

    gw = torch.Generator(device="cpu").manual_seed(19)

    def weighted(T, N, p=0.02, binary=()):
        """A weighted, asymmetric stack: 2% of entries in [0.25, 2), a
        seventh of those negated and scaled by 0.1, column 7 60% dense, and
        a ~80% activity mask; the timepoints in ``binary`` keep only the
        0/1 pattern."""
        w = torch.rand(T, N, N, generator=gw) * 1.75 + 0.25
        w = torch.where(torch.rand(T, N, N, generator=gw) < 1 / 7, -0.1 * w, w)
        a = torch.where(torch.rand(T, N, N, generator=gw) < p, w, 0.0)
        a[:, :, 7] = torch.where(torch.rand(T, N, generator=gw) < 0.6, w[:, :, 7], 0.0)
        for t in binary:
            a[t] = (a[t] != 0).float()
        return [a.to(dev), (torch.rand(T, N, generator=gw) < 0.8).float().to(dev)]

    dense += [("T=2 N=1000 weighted asymmetric, negative entries, column 7 60% dense",
               weighted(2, 1000)),
              ("T=2 N=4000 as above at t=0, its 0/1 pattern at t=1",
               weighted(2, 4000, binary=(1,)))]
    dense = [(k, tag, a) for tag, a in dense
             for k in ("temporal_pagerank.pagerank", "temporal_cc.cc")]
    # the backward kernels, from a generator of their own (the cases above
    # get the inputs they had without these); o and lse from the forward
    # kernels, as the training path gives them
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops

    gb = torch.Generator(device=dev).manual_seed(23)

    def attention_bwd(B, H, S, D, window, dtype, holes=False, shared_kv=False):
        """Causal; ``holes``: every fifth key a hole and query 0 with no
        key; ``shared_kv``: one KV head expanded at stride 0."""
        q = (torch.randn(B, H, S, D, generator=gb, device=dev) * 0.5).to(dtype)
        k, v = ((torch.randn(B, 1 if shared_kv else H, S, D, generator=gb, device=dev) * 0.5)
                .to(dtype).expand(B, H, S, D) for _ in range(2))
        pos = torch.arange(S, dtype=torch.int32, device=dev)
        q_pos, k_pos = pos.clone(), pos
        if holes:
            k_pos = torch.where(pos % 5 == 2, -1, pos)
            q_pos[0] = -1
        do = (torch.randn(B, H, S, D, generator=gb, device=dev) * 0.5).to(dtype)
        o, lse = fa_ops.flash_attention_lse(q, k, v, q_pos, k_pos, causal=True, window=window)
        tag = f"B={B} H={H} S={S} D={D} {str(dtype)[6:]} causal window={window}" \
            + (" holes, a query with no key" if holes else "") \
            + (" KV head stride 0" if shared_kv else "")
        return ("flash_attention.bwd", tag, [q, k, v, q_pos, k_pos, o, lse, do],
                dict(causal=True, window=window), None)

    def rglru_bwd(B, S, W):
        la = -torch.rand(B, S, W, generator=gb, device=dev) * 0.5
        x, dh = (torch.randn(B, S, W, generator=gb, device=dev) for _ in range(2))
        return ("rglru_scan.bwd", f"B={B} S={S} W={W}", [la, rg_ops.rglru(la, x), dh], {}, None)

    bwd = [attention_bwd(1, 2, 300, 256, 128, f32),
           attention_bwd(1, 4, 2048, 256, 1024, f32, shared_kv=True),
           attention_bwd(2, 4, 700, 128, 64, bf16, holes=True, shared_kv=True),
           attention_bwd(1, 2, 200, 64, 0, bf16, holes=True),
           rglru_bwd(1, 4097, 4096), rglru_bwd(2, 33, 64), rglru_bwd(1, 130, 96),
           # drawn last, so the cases above keep their inputs
           attention_bwd(1, 4, 2048, 256, 1024, bf16),
           # W % 4 != 0: the RG-LRU backward's per-lane load path at the ragged shape
           rglru_bwd(1, 4097, 4094)]
    # the float32 forward at the backward's headline shape, from a generator
    # of its own, so every case above keeps its inputs
    gf = torch.Generator(device=dev).manual_seed(29)
    q = torch.randn(1, 4, 2048, 256, generator=gf, device=dev) * 0.5
    k, v = (torch.randn(1, 1, 2048, 256, generator=gf, device=dev).mul(0.5)
            .expand(1, 4, 2048, 256) for _ in range(2))
    pos = torch.arange(2048, dtype=torch.int32, device=dev)
    f32_headline = ("flash_attention",
                    "B=1 H=4 Sq=2048 Sk=2048 D=256 float32 causal=True window=1024 "
                    "KV head stride 0", [q, k, v, pos, pos], dict(causal=True, window=1024), None)
    # the encoder-decoder and VLM shapes, from a generator of their own:
    # bf16 at D = 96 (a whole swizzle atom and half of one), causal;
    # non-causal at S = 1500 (a ragged last key tile every row sees);
    # cross-attention, Sq = 224 over Sk = 1500; the backward non-causal
    # over a ragged Sk in both types
    ge = torch.Generator(device=dev).manual_seed(31)

    def cross_bwd(B, H, Sq, Sk, D, dtype):
        q, k, v, do = ((torch.randn(B, H, n, D, generator=ge, device=dev) * 0.5).to(dtype)
                       for n in (Sq, Sk, Sk, Sq))
        q_pos = torch.arange(Sq, dtype=torch.int32, device=dev)
        k_pos = torch.arange(Sk, dtype=torch.int32, device=dev)
        o, lse = fa_ops.flash_attention_lse(q, k, v, q_pos, k_pos, causal=False)
        tag = f"B={B} H={H} Sq={Sq} Sk={Sk} D={D} {str(dtype)[6:]} non-causal (cross)"
        return ("flash_attention.bwd", tag, [q, k, v, q_pos, k_pos, o, lse, do],
                dict(causal=False, window=0), None)

    encdec_vlm = [attention(2, 8, 1100, 1100, 96, True, 0, bf16, gen=ge),
                  attention(2, 12, 1500, 1500, 64, False, 0, bf16, gen=ge),
                  attention(2, 12, 224, 1500, 64, False, 0, bf16, gen=ge),
                  cross_bwd(1, 4, 224, 1500, 64, bf16), cross_bwd(1, 4, 224, 1500, 64, f32)]
    # decode attention at the decode cell's shape (qwen2-7b: 8 sequences,
    # 4,168 slots, 28 heads over 4 KV heads) and at the dense family's 32k
    # decode (qwen2-7b at DENSE_BATCH), each request half-way through its
    # tokens: the slots past the new token's position still empty
    gd = torch.Generator(device=dev).manual_seed(37)

    def decode(B, Sc, KV, G, hd, filled):
        k, v = ((torch.randn(B, Sc, KV, hd, generator=gd, device=dev) * 0.5).to(bf16)
                for _ in range(2))
        q = (torch.randn(B, 1, KV * G, hd, generator=gd, device=dev) * 0.5).to(bf16)
        slots = torch.arange(Sc, dtype=torch.int32, device=dev)
        k_pos = torch.where(slots < filled, slots, -1)[None].repeat(B, 1)
        pos = torch.full((B,), filled - 1, dtype=torch.int32, device=dev)
        return ("decode_attention", f"B={B} Sc={Sc} H={KV * G} KV={KV} hd={hd} bfloat16, "
                f"{filled} slots filled", [k, v, q, k_pos, pos, 0, 0.0], {}, None)

    decode_cases = [decode(8, 4096 + 64 + 8, 4, 7, 128, 4096 + 32),
                    decode(DENSE_BATCH["qwen2-7b"], 32_768, 4, 7, 128, DENSE_PROMPT + 8)]
    return lm + bwd + [f32_headline] + encdec_vlm + decode_cases + [
        (k, tag, a, {}, None) for k, tag, a in dense + [
        ("delta_overlay.overlay", "h=8 P=16 S=65536 K=4", stacks(8, 16, 65536, 4)),
        ("delta_overlay.overlay", "h=8 P=16 S=65537 K=4", stacks(8, 16, 65537, 4)),
        ("delta_overlay.overlay_batch", "h=8 P=16 S=65536 K=4 T=32",
         stacks(8, 16, 65536, 4) + [tmask(8, 32)]),
        ("delta_overlay.overlay_batch", "h=8 P=16 S=65537 K=4 T=32",
         stacks(8, 16, 65537, 4) + [tmask(8, 32)]),
        ("delta_overlay.overlay_batch",
         "h=34 P=16 S=65537 K=4 T=32, wide-group mask (2 shared + 1 per t)",
         stacks(34, 16, 65537, 4) + [wide_tmask(32)]),
        ("temporal_motif.motif", "T=4 N=4096", adjacency(4, 4096)),
        ("temporal_motif.motif", "T=4 N=4000", adjacency(4, 4000)),
        ("temporal_motif.motif", "T=2 N=1000 asymmetric, half the diagonal set",
         asymmetric(2, 1000)),
    ]]


# the long cases: each attention case's query blocks and each scan's spans
# are held against the plain version on their own (the plain attention
# cannot hold 28 x 32,768^2 float32 scores, 120 GB, nor the plain scan 2^32
# elements in its log-depth passes)
LONG_BLOCK, LONG_SPAN = 512, 4096


def attention_blocks(tag, q, k, v, pos, kw, got) -> dict:
    """``got``, the bf16 kernel's output over q, k, v with queries and
    keys both at positions ``pos`` = 0..S-1, held against the plain
    version on every block of LONG_BLOCK queries (the last one short where
    S is no multiple of it) of every sequence, each over the keys it can
    see, within ATTN_TOL and FWD_BF16_TOL (``bf16_forward_check``).
    Returns the blocks compared, the max abs error and the largest share
    of the bf16 limit with its block."""
    from repro_torch.kernels.flash_attention import ref as fa_ref

    B, S, window = q.shape[0], q.shape[2], kw.get("window", 0)

    def plain(*a, **k):
        return fa_ref.attention_ref(*a, **k).to(q.dtype)

    err, worst, n = 0.0, (None, None), 0
    for a in range(0, S, LONG_BLOCK):
        b = min(a + LONG_BLOCK, S)
        lo = max(0, a - window + 1) if window else 0
        for r in range(B):
            where = f"sequence {r} queries {a}..{b - 1}"
            args = [q[r:r + 1, :, a:b], k[r:r + 1, :, lo:b], v[r:r + 1, :, lo:b], pos[a:b],
                    pos[lo:b]]
            want, part = plain(*args, **kw), got[r:r + 1, :, a:b]
            e = float((part.float() - want.float()).abs().max())
            err = max(err, e)
            if not torch.allclose(part.float(), want.float(), **ATTN_TOL[q.dtype]):
                fail(f"flash_attention ({tag}) {where} outside {ATTN_TOL[q.dtype]} of the "
                     f"plain version: max err {e}")
            if q.dtype == torch.bfloat16:
                share = bf16_forward_check(f"{tag} {where}", args, kw, part, want, plain,
                                           False)["fwd_bf16_share_of_limit"]
                if worst[0] is None or share > worst[0]:
                    worst = (share, where)
            n += 1
    return dict(blocks_compared=n, block=LONG_BLOCK, max_abs_err=err,
                fwd_bf16_share_of_limit=worst[0], worst_block=worst[1])


def visible_pairs(S: int, window: int = 0) -> int:
    """Causal (query, key) pairs over positions 0..S-1, a query seeing at
    most ``window`` keys (itself and the window - 1 before it; 0: all)."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def long_attention_case(dev, gen, tag, B, H, S, D, kv_heads, window, starts, ends, reps=15):
    """bf16 causal attention over S positions (K/V drawn at ``kv_heads``
    heads and repeated to H, one head at stride 0), run whole; held
    against the plain version on every block of LONG_BLOCK queries
    (``attention_blocks``); the same bits on a second run.  Times: the
    kernel whole (the median of ``reps`` calls); the plain version, the
    kernel and SDPA with a boolean mask over the timed blocks, LONG_BLOCK
    queries from each of ``starts`` and the last ``ends`` queries; SDPA
    with ``is_causal`` whole where there is no window."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    bf16 = torch.bfloat16
    q = torch.empty(B, H, S, D, dtype=bf16, device=dev).normal_(0.0, 0.5, generator=gen)
    k, v = (torch.empty(B, kv_heads, S, D, dtype=bf16, device=dev).normal_(0.0, 0.5,
                                                                           generator=gen)
            for _ in range(2))
    if kv_heads == 1:
        k, v = k.expand(B, H, S, D), v.expand(B, H, S, D)
    else:
        k, v = k.repeat_interleave(H // kv_heads, 1), v.repeat_interleave(H // kv_heads, 1)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    kw = dict(causal=True, window=window)
    got = fa_ops.flash_attention(q, k, v, pos, pos, **kw)
    torch.cuda.synchronize()
    again = fa_ops.flash_attention(q, k, v, pos, pos, **kw)
    if not torch.equal(again, got):
        fail(f"flash_attention ({tag}): two runs differ")
    del again
    blocks = [(a, a + LONG_BLOCK) for a in starts] + [(S - n, S) for n in ends]

    def block(a, b):  # the block's queries and the keys they can see
        lo = max(0, a - window + 1) if window else 0
        return [q[:, :, a:b], k[:, :, lo:b], v[:, :, lo:b], pos[a:b], pos[lo:b]]

    def plain(*a, **k):
        return fa_ref.attention_ref(*a, **k).to(bf16)

    compared = attention_blocks(tag, q, k, v, pos, kw, got)
    pairs = visible_pairs(S, window) * B * H
    ops = 4 * D * pairs
    nbytes = (2 * q.numel() + B * kv_heads * S * D * 2) * 2 + 8 * S
    ops_ms, bytes_ms = ops / BF16_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    del got

    def each(fn):
        return lambda: [fn(*block(a, b)) for a, b in blocks]

    masked = [dict(attn_mask=fa_ref.position_mask(*block(a, b)[3:], **kw)) for a, b in blocks]

    def sdpa_blocks():
        return [torch.nn.functional.scaled_dot_product_attention(*block(a, b)[:3], **m)
                for (a, b), m in zip(blocks, masked)]

    library_all = {"SDPA, boolean mask, over the timed blocks": device_ms(sdpa_blocks)}
    if not window:
        library_all["SDPA, is_causal, whole"] = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True))
    library_call = "SDPA, is_causal, whole" if not window else \
        "SDPA, boolean mask, over the timed blocks"
    row = dict(shape=dict(B=B, H=H, Sq=S, Sk=S, D=D, dtype="torch.bfloat16", kv_heads=kv_heads,
                          kv_head_stride=k.stride(1), q_elements=q.numel(), pairs=pairs, **kw),
               timed_blocks=[f"{a}..{b - 1}" for a, b in blocks], **compared,
               ms=device_ms(lambda: fa_ops.flash_attention(q, k, v, pos, pos, **kw), reps),
               reps=reps,
               kernel_blocks_ms=device_ms(each(lambda *a: fa_ops.flash_attention(*a, **kw))),
               plain_ms=device_ms(each(lambda *a: plain(*a, **kw))),
               plain_ms_over="the timed blocks", bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms > bytes_ms else "bytes",
               library_ms=library_all[library_call], library_call=library_call,
               library_all_ms=library_all)
    emit(phase="kernel_vs_plain", kernel="flash_attention", inputs=tag, **row)
    return row


def long_rglru_case(dev, gen, tag, B, S, W):
    """The RG-LRU scan over (B, S, W) float32, run whole; held against the
    plain scan on every span of LONG_SPAN steps of every batch row, the
    plain scan carrying its own h from one span to the next (x at a span's
    first step plus exp(log_a) h there), within RGLRU_TOL; every h
    finite; the same bits on a second run.  Times: the kernel whole, the
    plain scan over its first, a middle and its last span."""
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rglru_scan import ref as rg_ref

    la = torch.empty(B, S, W, device=dev).uniform_(-0.5, 0.0, generator=gen)
    x = torch.empty(B, S, W, device=dev).normal_(generator=gen)
    h = rg_ops.rglru(la, x)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(part).all()) for part in h.view(-1).split(1 << 28)):
        fail(f"rglru_scan ({tag}): non-finite h")
    again = rg_ops.rglru(la, x)
    if not torch.equal(again, h):
        fail(f"rglru_scan ({tag}): two runs differ")
    del again
    mid = S // 2 - 100  # no multiple of the kernel's chunk
    spans = [(0, LONG_SPAN), (mid, mid + LONG_SPAN), (S - LONG_SPAN, S)]
    err, carry, n = 0.0, None, 0
    for a in range(0, S, LONG_SPAN):
        b = min(a + LONG_SPAN, S)
        xs = x[:, a:b].clone()
        if carry is not None:
            xs[:, 0] += torch.exp(la[:, a]) * carry
        want = rg_ref.rglru_ref(la[:, a:b], xs)
        e = float((h[:, a:b] - want).abs().max())
        err, carry, n = max(err, e), want[:, -1], n + 1
        if not torch.allclose(h[:, a:b], want, **RGLRU_TOL):
            fail(f"rglru_scan ({tag}) steps {a}..{b - 1} outside {RGLRU_TOL} of the plain "
                 f"scan: max err {e}")
    del h, xs, want, carry
    ops_ms = 3 * la.numel() / FP32_OPS_PER_S * 1e3
    bytes_ms = 12 * la.numel() / HBM_BYTES_PER_S * 1e3
    row = dict(shape=dict(B=B, S=S, W=W, chunk=rg_ops.CHUNK, elements=la.numel()),
               spans_compared=n, span=LONG_SPAN, carry="the plain scan's own",
               timed_spans=[f"{a}..{b - 1}" for a, b in spans], max_abs_err=err,
               ms=device_ms(lambda: rg_ops.rglru(la, x)),
               plain_ms=device_ms(lambda: [rg_ref.rglru_ref(la[:, a:b], x[:, a:b])
                                           for a, b in spans]),
               plain_ms_over="the timed spans", bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms > bytes_ms else "bytes", library_ms=None,
               library_call=None)
    emit(phase="kernel_vs_plain", kernel="rglru_scan", inputs=tag, **row)
    return row


def long_cases(dev) -> dict:
    """The LM kernels at the reference's long shapes: ``flash_attention``
    at qwen2-7b's prefill_32k shape for one sequence (H = 28 over 4 KV
    heads, D = 128, causal) and at long_500k's length as recurrentgemma-9b
    runs it (H = 16 over one KV head, D = 256, window 2048) at B = 1 and 2
    (2^31 and 2^32 query elements); ``rglru_scan`` at long_500k's length,
    W = 4096, B = 1 and 2 (2^31 and 2^32 elements an array).  Returns
    {kernel: {tag: row}}.  Long_500k's attention takes seconds a call
    (PERF.md), so its whole-input time is the median of 3 calls."""
    held_in_cycles("long cases")
    emit(phase="long_cases", allocated_bytes=torch.cuda.memory_allocated())
    gen = torch.Generator(device=dev).manual_seed(37)
    out = {"flash_attention": {}, "rglru_scan": {}}
    S = 32_768
    tag = f"qwen2-7b prefill_32k B=1 H=28 S={S} D=128 bf16 causal, 4 KV heads repeated"
    out["flash_attention"][tag] = long_attention_case(
        dev, gen, tag, 1, 28, S, 128, 4, 0, starts=(0, S // 2 - 64), ends=(LONG_BLOCK,))
    torch.cuda.empty_cache()
    S = 524_288
    for B in (1, 2):
        tag = f"long_500k B={B} H=16 S={S} D=256 bf16 causal window=2048 KV head stride 0"
        out["flash_attention"][tag] = long_attention_case(
            dev, gen, tag, B, 16, S, 256, 1, 2048, starts=(0, S // 2 - 64), ends=(2048,),
            reps=3)
        torch.cuda.empty_cache()
    for B in (1, 2):
        tag = f"long_500k B={B} S={S} W=4096"
        out["rglru_scan"][tag] = long_rglru_case(dev, gen, tag, B, S, 4096)
        torch.cuda.empty_cache()
    return out


def overlay_edges(dev) -> None:
    """``overlay`` bit for bit against ``overlay_ref`` and
    ``overlay_seeded_ref`` at the edges of its seed from layer 0 (the
    stacks ``ref.overlay_edge_stacks`` gives the CPU tests) at K = 0, 1, 4,
    5 and 20, ragged S = 300, and at K = 4 on attrs that are not 16-byte
    aligned; then ``overlay_batch`` and its pre-pass, bit for bit against
    their plain versions, where the main path and the headline cases (all
    K = 4, all indices in 31 bits) do not go: the generic-K kernel (K = 0,
    1, 3, 20, 1000), one layer, one timepoint, a column no layer feeds and
    a layer no timepoint uses, T past one tile; and both folds' 64-bit
    index kernels, with h * P * S * K = 2^31 + 8,192 attrs (8.6 GB)."""
    from repro_torch.kernels.delta_overlay import ops as ov_ops
    from repro_torch.kernels.delta_overlay import ref as ov_ref

    def single(what, stacks):
        got = ov_ops.overlay(*stacks)
        for plain in (ov_ref.overlay_ref, ov_ref.overlay_seeded_ref):
            if max_err(got, plain(*stacks)) != 0:
                fail(f"overlay {what} != {plain.__name__}")
        return dict(case=what, h=stacks[0].shape[0], P=stacks[0].shape[1],
                    S=stacks[0].shape[2], K=stacks[2].shape[-1])

    t0 = time.perf_counter()
    singles = [single(f"{name}, K={K}", stacks) for K in (0, 1, 4, 5, 20)
               for name, stacks in ov_ref.overlay_edge_stacks(K, seed=K, device=dev).items()]
    v, p, a = ov_ref.overlay_edge_stacks(4, seed=40, device=dev)["h=2"]
    flat = torch.empty(a.numel() + 1, dtype=torch.int32, device=dev)
    flat[1:] = a.flatten()
    singles.append(single("h=2 K=4, attrs 4 bytes past a 16-byte boundary",
                          (v, p, flat[1:].view(a.shape))))
    g = torch.Generator(device=dev).manual_seed(17)

    def case(h, P, S, K, T, density=0.4, fold_one=False):
        valid = torch.rand(h, P, S, generator=g, device=dev) < density
        present = (torch.rand(h, P, S, generator=g, device=dev) < 0.7).to(torch.int8)
        attrs = torch.randint(-1, 5, (h, P, S, K), generator=g, device=dev,
                              dtype=torch.int32)
        if fold_one:
            singles.append(single(f"64-bit indices, {h * P * S * K} attrs",
                                  (valid, present, attrs)))
        tmask = (torch.rand(h, T, generator=g, device=dev) < 0.6).to(torch.int8)
        tmask[:, 0] = 0
        if h > 2:
            tmask[1] = 0
        got = ov_ops.overlay_batch(valid, present, attrs, tmask)
        if max_err(got, ov_ref.overlay_batch_ref(valid, present, attrs, tmask)) != 0:
            fail(f"overlay_batch h={h} P={P} S={S} K={K} T={T} != its plain version")
        lists = ov_ops.layer_lists(tmask)
        if not all(torch.equal(a, b) for a, b in zip(lists, ov_ref.layer_lists_ref(tmask))):
            fail(f"overlay_batch h={h} T={T}: pre-pass lists != layer_lists_ref")
        return dict(h=h, P=P, S=S, K=K, T=T)

    shapes = [case(*c) for c in ((1, 1, 1, 4, 1), (3, 2, 33, 4, 1), (6, 2, 777, 3, 5),
                                 (4, 1, 300, 20, 40), (3, 1, 100, 0, 3), (3, 1, 70, 1000, 40),
                                 (9, 1, 5000, 1, 70), (5, 3, 1000, 4, 33))]
    shapes.append(case(128, 16, 262145, 4, 3, density=0.05, fold_one=True))
    torch.cuda.empty_cache()
    emit(phase="kernel_edges", kernel="delta_overlay.overlay", cases=singles,
         max_abs_err=0)
    emit(phase="kernel_edges", kernel="delta_overlay.overlay_batch", cases=shapes,
         max_abs_err=0, seconds=time.perf_counter() - t0)


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
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:67"),
    "rglru_scan": (
        "src/repro_torch/kernels/rglru_scan/rglru_scan.cu",
        "src/repro/kernels/rglru_scan/rglru_scan.py:45"),
    # replaces no Pallas kernel: the reference computes decode attention in jnp
    "decode_attention": (
        "src/repro_torch/kernels/decode_attention/decode_attention.cu",
        "none (src/repro/models/attention.py:352, _decode_mha in jnp)"),
    # the port's own backward kernels: the reference differentiates the
    # functions of these Pallas kernels by jnp autodiff
    "flash_attention.bwd": (
        "src/repro_torch/kernels/flash_attention/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:67"),
    "rglru_scan.bwd": (
        "src/repro_torch/kernels/rglru_scan/rglru_scan.cu",
        "src/repro/kernels/rglru_scan/rglru_scan.py:45"),
}


# ---------------------------------------------------------------------------


def main() -> int:
    start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--events", type=int, default=200_000)
    ap.add_argument("--dry-runs", nargs="+", metavar="PATH",
                    help="the roofline phase's child: dry-run these timed paths on meta")
    ap.add_argument("--mesh-dry-run", action="store_true",
                    help="the roofline phase's child: MESH_DRY_RUN on a fake group's mesh")
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 1
    if args.dry_runs:
        return dry_runs(args.dry_runs, reduced=args.device == "cpu")
    if args.mesh_dry_run:
        return mesh_dry_run(reduced=args.device == "cpu")
    if args.device == "cpu":  # rehearsal of the main paths, no result
        procs = start_dry_runs(reduced=True)
        try:
            service_path(torch.device("cpu"), main_path(torch.device("cpu"), args.events)[1])
            lm_serve(torch.device("cpu"), reduced=True)
            family_paths(torch.device("cpu"), reduced=True)
            lm_train(torch.device("cpu"), reduced=True)
            lm_train_reduced(torch.device("cpu"))
            encdec_vlm_paths(torch.device("cpu"), reduced=True)
            graph_examples(torch.device("cpu"), args.events)
            train_examples(torch.device("cpu"))
            full_width_example(torch.device("cpu"), reduced=True)
            dense_paths(torch.device("cpu"), Recorder(), reduced=True)
            train_families(torch.device("cpu"), Recorder(), reduced=True)
            roofline_phase(read_dry_runs(procs), reduced=True)
        finally:
            stop(procs)
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
                 .read_text().splitlines()
                 if any(w in ln for w in ("Used", "spill", "Performance Loss"))]
             for n in _build.NAMES}
    emit(phase="build", seconds=time.perf_counter() - t0, per_source=seconds,
         ptxas=ptxas)

    # 3. the main path on the card, the timed paths' dry runs beside it
    procs = start_dry_runs()
    try:
        dev = torch.device("cuda")
        recorder = Recorder()
        launches, local = main_path(dev, args.events, recorder)
        by_path = {"main path": dict(launches)}
        service_path(dev, local)
        degree = local["degree"]
        del local
        lm_launches = lm_serve(dev, recorder)
        if lm_launches != LM_LAUNCHES:
            fail(f"lm serve launched {lm_launches}, not {LM_LAUNCHES}")
        launches.update(lm_launches)
        lm_reduced_card_vs_cpu(dev)
        torch.cuda.empty_cache()  # the 17 GB model is gone
        by_path["lm serve"] = lm_launches
        by_path.update(family_paths(dev, recorder))
        torch.cuda.empty_cache()  # the MoE and xLSTM models are gone
        train_launches = lm_train(dev, recorder)
        by_path["lm train"] = train_launches
        launches.update({k: v for k, v in train_launches.items() if k.endswith(".bwd")})
        lm_train_reduced(dev, recorder)
        torch.cuda.empty_cache()  # the 33 GB training state is gone
        by_path["multi-card"] = multi_card_phase(dev, degree=degree)
        del degree
        torch.cuda.empty_cache()  # the sharded run's training state is gone
        # after training: the inputs these paths record for phase 4 would stay
        # in the allocator's segments and split the 71 GB training peak
        by_path.update(encdec_vlm_paths(dev, recorder))
        torch.cuda.empty_cache()  # whisper and phi-3-vision are gone
        # 3h. the examples
        graph_examples(dev)
        by_path.update({f"example train_lm {a}": c for a, c in train_examples(dev).items()})
        by_path[EXAMPLE_FULL_PATH] = full_width_example(dev, recorder)
        torch.cuda.empty_cache()  # the 27.5 GB training state is gone
        # 3i. the dense family whole at decode_32k's length
        by_path.update(dense_paths(dev, recorder))
        torch.cuda.empty_cache()
        # 3j. the other families trained at full width
        by_path.update(train_families(dev, recorder))
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            fail(f"kernels of the main path never launched: {missing}")
        # 3g. each timed path's roofline
        roofline_phase(read_dry_runs(procs))
    finally:
        stop(procs)

    # 4. each kernel against its plain version
    from repro_torch.kernels.rglru_scan import ops as rg_ops

    rows = []
    headlines = headline_inputs(dev)
    for kname, (source, replaces) in SOURCES.items():
        inputs = recorder.inputs.get((kname, "main path"))
        if inputs is None:
            fail(f"no main-path inputs recorded for {kname}")
        row = kernel_case(kname, on_card(inputs[0], dev), inputs[1], "main path", recorded=True)
        others = [(tag, on_card(a, dev), kw, None, True)
                  for (n, tag), (a, kw) in recorder.inputs.items()
                  if n == kname and tag != "main path"]
        others += [(tag, a, kw, tol, False) for n, tag, a, kw, tol in headlines if n == kname]
        headline = {tag: kernel_case(kname, a, kw, tag, tol, rec,
                                     by_head=tag.split(" (")[0] in TRAIN_FAMILIES)
                    for tag, a, kw, tol, rec in others}
        rows.append(dict(name=kname, route="cuda", source=source,
                         replaces=replaces, launches=launches[kname],
                         launches_by_path={p: c[kname] for p, c in by_path.items()
                                           if c.get(kname)},
                         max_abs_err=max([row["max_abs_err"]] + [
                             h["max_abs_err"] for h in headline.values()]),
                         ms=row["ms"], plain_ms=row["plain_ms"],
                         bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                         library_ms=row["library_ms"], library_call=row["library_call"],
                         shape=row["shape"],
                         headline=headline))
        if kname == "rglru_scan.bwd":  # each load path's registers, shared memory, residency
            rows[-1]["resources"] = rg_ops.bwd_resources()
    del headlines, others, inputs
    recorder.inputs.clear()
    torch.cuda.empty_cache()
    for kname, cases in long_cases(dev).items():
        row = next(r for r in rows if r["name"] == kname)
        row["headline"].update(cases)
        row["max_abs_err"] = max([row["max_abs_err"]] + [c["max_abs_err"] for c in cases.values()])
    overlay_edges(dev)
    emit(phase="done", seconds=time.perf_counter() - start)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
