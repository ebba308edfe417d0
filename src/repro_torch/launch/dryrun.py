"""Dry run of one step on ``meta`` tensors (port of
``repro.launch.dryrun``), on one H100 or on the reference's production
meshes: nothing is allocated and no card is needed.

Per cell this script:
  1. builds the model, optimizer state, batch and cache as ``meta``
     tensors (``repro_torch.launch.specs``); on a mesh (``--multi-pod``,
     ``--single-pod``, ``--both-meshes``) it first starts a ``fake``
     process group of 256 or 512 ranks (this process is rank 0), builds
     the production mesh over it (``launch.mesh``) and places every one
     of them with the ``Sharder`` as DTensors;
  2. runs the train, prefill or serve step of ``repro_torch.train.steps``
     once, eagerly, under ``FlopCount`` (the FLOPs of the products run,
     by torch's flop formulas), ``LiveBytes`` (the bytes of live storages
     before the step, after it and at its peak) and, on a mesh,
     ``roofline.CollectiveRecorder``; each of them sees the operations
     on this rank's local tensors, so the counts are per device;
  3. takes the step's HBM bytes from the analytic model
     (``repro_torch.roofline.analytic.step_bytes``, at dp = tp = chips = 1
     on one card and at the mesh's data and model axes and chip count on
     a mesh), as the reference takes its memory term;
  4. writes one JSON record, with the reference's keys, under
     ``experiments/dryrun_torch/``: the counts, the analytic FLOPs beside
     them, the collectives' summary and the roofline at the H100's
     data-sheet peaks, the collective term at ``roofline.NVLINK_BW``.

On ``meta`` every kernel wrapper runs its plain version, which computes
nothing there, so the count is the plain version's arithmetic (the
counterpart of the reference's ``attn_impl="direct"`` probe): attention
counts every (query, key) pair, the causal and window-masked ones
included, where the card's kernel skips masked tiles; the peak-memory
estimate likewise holds the plain attention's (B, H, S, S) scores, which
the kernel never materializes.

The reference needs a cost probe: XLA counts a scanned layer's or a
while loop's body once, so it compiles unrolled 1- and 2-unit variants
and extrapolates (``probe_costs``), and adds the sLSTM's per-timestep
scan analytically (``slstm_scan_correction``).  Eager execution runs
every layer and every sLSTM step, and the counter sees each of their
products, so neither has a counterpart here; ``analytic.step_flops`` is
recorded beside the count (``counted_vs_analytic``) as the reference
records ``probe_vs_analytic``.  The sLSTM loop costs host time: ~20
operations a step and layer, each a few hundred microseconds on meta
under the counters, so minutes for xlstm-350m's 6 sLSTM layers at 4,096
steps.  On a mesh the xLSTM recurrences run on each rank's block as
plain tensors (``models.xlstm_blocks._per_rank``), so DTensor's dispatch
does not add to each step.

The fake group's mesh is a CPU mesh, where DTensor would move a shard
from one dimension to another by gathering the whole tensor and keeping
a chunk (gloo has no all-to-all); the dry run models an NCCL mesh, so
it routes that move through DTensor's own all-to-all operation
(``nccl_shard_moves``), which runs on meta tensors.  The collectives are
what DTensor issues for the step, op by op, which differ by design from
what GSPMD chooses for the reference's program.  A 16-wide axis spans
two 8-GPU H100 nodes, so NVLink's rate
makes the collective term a floor.  The reference's shapes (``SHAPES``)
are pod-sized, so on one card most of them report a peak over 80 GB:
that is their answer.  A fake group has one size a process, so
``--both-meshes`` runs each mesh in a child process of its own.

Usage:
  python -m repro_torch.launch.dryrun --arch recurrentgemma-9b --shape prefill_32k
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--skip-existing] [--no-probe]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, make_production_mesh
from repro_torch.models.sharding import (LONG_CONTEXT_OVERRIDES, NO_SHD, Sharder, make_rules,
                                         mesh_axes, place)
from repro_torch.roofline import CollectiveRecorder, analytic, compute_roofline, model_flops
from repro_torch.roofline.collectives import dtensor_op, fake
from repro_torch.train import make_prefill_step, make_serve_step, make_train_step

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
MESH_TAGS = {None: "onecard", False: "singlepod", True: "multipod"}
COUNTED = ("flops=counted (FlopCount over the eager step on meta; attention by its plain "
           "version, every masked pair counted) ")
SOURCE = {
    True: (COUNTED + "bytes=analytic (step_bytes at dp=tp=chips=1) collectives=none "
           "(one card)"),
    False: ("flops=analytic (step_flops) bytes=analytic (step_bytes at dp=tp=chips=1) "
            "collectives=none (one card)"),
}
MESH_SOURCE = (COUNTED + "per device bytes=analytic (step_bytes at the mesh's dp, tp, chips) "
               "collectives=recorded (what DTensor issues, as on an NCCL mesh; not "
               "GSPMD's) at NVLink's rate, a floor: a 16-wide axis spans two 8-GPU nodes")


class FlopCount(TorchDispatchMode):
    """The FLOPs of the products run while active, by torch's flop
    formulas (``torch.utils.flop_counter.flop_registry``), composites
    decomposed first, as ``FlopCounterMode`` counts, but on local
    tensors: a DTensor operation
    is left to DTensor (``NotImplemented``), whose local operations come
    back here, so on a mesh the count is this rank's."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if dtensor_op(types):
            return NotImplemented
        kwargs = kwargs or {}
        if func is not torch.ops.prim.device.default:  # composites: count their parts
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None and not fake(out):
            self.flops += formula(*args, **kwargs, out_val=out)
        return out

    def get_total_flops(self) -> int:
        return self.flops


def cell_supported(cfg, shape) -> (bool, str):
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "pure full-attention arch: 500k-token decode has no sub-quadratic "
            "path (unbounded KV); skipped per DESIGN.md §Arch-applicability"
        )
    return True, ""


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages alive at each moment of a step, and their
    peak: a storage counts from the first time an operation returns it
    (or ``hold`` is given a tensor on it) until it is freed; views and
    in-place results share their storage and count once.  (torch's own
    ``mem_tracker.MemTracker`` hooks every parameter's gradient and
    raises on the frozen parameters of a serving step.)  On a mesh it
    counts this rank's local storages, as ``FlopCount`` does."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def hold(self, tensors) -> None:
        for t in tensors:
            self._see(t.to_local() if isinstance(t, DTensor) else t)

    def _see(self, t) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if dtensor_op(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not fake(out):
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._see(t)
        return out


def dry_run(cfg: ModelConfig, shape: ShapeConfig, *, cache_len: int = 0, max_seq: int = 0,
            count: bool = True, shd: Sharder = NO_SHD) -> dict:
    """One step of ``cfg`` at ``shape`` on ``meta``, at the config's own
    depth, batch and length: the record of ``run_cell`` without its file.

    ``cache_len``: the KV-cache allocation of a prefill or decode (default
    ``shape.seq_len``, which counts an image prefix); ``max_seq``: the
    learned position table's rows (default ``shape.seq_len``).  Serving
    runs in ``cfg.dtype`` (parameters stored in it), training in
    ``cfg.param_dtype`` masters.  ``shd`` with a mesh places the model,
    optimizer state, batch and cache on it and counts per device."""
    kind, B, S = shape.kind, shape.global_batch, shape.seq_len
    if kind != "train":
        cfg = cfg.replace(param_dtype=cfg.dtype)
    mesh = shd.mesh
    n_chips = mesh.size() if mesh is not None else 1
    t0 = time.perf_counter()
    model = specs_mod.abstract_params(cfg, max_seq=max_seq or S)
    n_par = specs_mod.n_params(model)
    n_act = specs_mod.n_active_params(cfg, model)
    if kind == "train":
        model.train()
        model.requires_grad_(True)
    shd.distribute(model)
    batch = specs_mod.batch_specs(cfg, shape)
    if mesh is not None:
        placed = specs_mod.batch_shardings(batch, shd)
        batch = {k: place(v, mesh, placed[k]) for k, v in batch.items()}
    if kind == "train":
        args = (model, specs_mod.abstract_opt_state(model), batch)
        step = make_train_step(cfg, shd=shd)
        tokens = B * S
    elif kind == "prefill":
        args = (model, batch)
        step = make_prefill_step(cache_len=cache_len or S, shd=shd)
        tokens = B * S
    else:  # decode
        cache, tok, pos = specs_mod.decode_specs(cfg, shape, model_axis=shd.model_axis,
                                                 cache_len=cache_len)
        if mesh is not None:
            cache = shd.place_tree(cache, specs_mod.cache_axes(cfg))
            tok = place(tok, mesh, shd.param_sharding(tok, ("batch", None)))
            pos = place(pos, mesh, shd.param_sharding(pos, ("batch",)))
        args = (model, cache, tok, pos)
        step = make_serve_step(shd)
        tokens = B  # one token per sequence
    live, counter, coll = LiveBytes(), FlopCount(), CollectiveRecorder()
    live.hold(t for a in (list(model.parameters()), args[1:]) for t in tree_leaves(a)
              if isinstance(t, torch.Tensor))
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(nccl_shard_moves())
        for m in ((live, counter) + ((coll,) if mesh is not None else ()) if count else ()):
            stack.enter_context(m)
        before = live.live
        with torch.set_grad_enabled(kind == "train"):
            out = step(*args)
        after, peak = live.live, live.peak
        del out, args
    trace_s = time.perf_counter() - t0

    axes = mesh_axes(mesh) if mesh is not None else {}
    dp, tp = axes.get("data", 1), axes.get("model", 1)
    an_flops = analytic.step_flops(cfg, kind, B, S)
    an_bytes = analytic.step_bytes(cfg, kind, B, S, dp=dp, tp=tp, chips=n_chips)
    flops = counter.get_total_flops() if count else an_flops / n_chips
    colls = coll.summary() if (count and mesh is not None) else {"wire_bytes": 0.0}
    mf = model_flops(kind, n_act, tokens)
    roof = compute_roofline({"flops": flops, "bytes accessed": an_bytes["total"]},
                            colls["wire_bytes"], mf, n_chips)
    outb = max(after - before, 0)
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "multi_pod": "pod" in axes,
        "status": "OK",
        "n_chips": n_chips,
        "mesh": axes or None,
        "n_params": n_par,
        "n_active_params": n_act,
        "tokens_per_step": tokens,
        "trace_s": trace_s,
        # eager steps update in place, so nothing is donated (alias 0):
        # argument = live before the step (parameters, optimizer state,
        # batch, caches), output = what the step left live beyond that,
        # temp = the rest of the peak
        "memory": {
            "argument_bytes": before,
            "output_bytes": outb,
            "temp_bytes": max(peak - before - outb, 0),
            "alias_bytes": 0,
            "peak_bytes_est": peak,
        } if count else {},
        "cost": {"flops": float(flops)} if count else {},
        "collectives": colls,
        "analytic": {
            "flops_global": an_flops,
            "flops_per_dev": an_flops / n_chips,
            "counted_vs_analytic": (flops / (an_flops / n_chips)
                                    if (count and an_flops) else None),
            "bytes_per_dev": an_bytes,
        },
        "roofline": dict(roof.to_dict(), source=(MESH_SOURCE if mesh is not None
                                                 else SOURCE[count])),
    }


@contextlib.contextmanager
def nccl_shard_moves():
    """DTensor's shard-to-shard move as on an NCCL mesh (one all-to-all,
    ``torch.ops._dtensor.shard_dim_alltoall``) while active, where a CPU
    mesh would all-gather the whole tensor and keep a chunk."""
    from torch.distributed.tensor import _collective_utils, placement_types

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                      mesh.get_group(mesh_dim).group_name)

    modules = [m for m in (_collective_utils, placement_types)
               if hasattr(m, "shard_dim_alltoall")]
    saved = [m.shard_dim_alltoall for m in modules]
    for m in modules:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m, f in zip(modules, saved):
            m.shard_dim_alltoall = f


def start_fake_group(world_size: int) -> None:
    """This process as rank 0 of a ``fake`` process group of
    ``world_size`` ranks (collectives return at once and move nothing):
    what a production mesh needs in a dry run.  A running group of
    another size raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is running; "
                               f"the mesh needs {world_size}: one mesh size a process")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def lower_cell(arch: str, shape_name, multi_pod: bool, *, mesh_shape=None,
               reduced: bool = False, count: bool = True) -> dict:
    """Dry-run one cell on the production mesh (16 x 16, or 2 x 16 x 16
    with ``multi_pod``; ``mesh_shape`` another shape over the same axes)
    over a fake group: the record, with the per-device counts and the
    recorded collectives.  ``shape_name`` may be a ``ShapeConfig``;
    ``reduced`` takes the arch's reduced config."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "multi_pod": multi_pod, "status": "SKIP",
                "reason": reason}
    shape_axes = MULTI_POD if multi_pod else SINGLE_POD
    mesh_shape = tuple(mesh_shape or shape_axes[0])
    start_fake_group(math.prod(mesh_shape))
    if mesh_shape == shape_axes[0]:
        mesh = make_production_mesh(multi_pod=multi_pod)
    else:
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(mesh_shape, shape_axes[1])
    overrides = dict(LONG_CONTEXT_OVERRIDES) if shape.name == "long_500k" else {}
    shd = Sharder(mesh, make_rules(**overrides))
    rec = dry_run(cfg, shape, shd=shd, count=count)
    rec["multi_pod"] = multi_pod
    return rec


def run_cell(arch: str, shape_name: str, multi_pod=None, skip_existing: bool = False,
             verbose: bool = True, with_probe: bool = True) -> dict:
    """Dry-run one (arch, shape) cell of the reference's table and write
    its record: on one card (``multi_pod=None``), on the single-pod mesh
    (False) or on the multi-pod mesh (True); ``with_probe=False`` traces
    the step without counting (the roofline then takes the analytic
    FLOPs)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    tag = MESH_TAGS[multi_pod]
    fname = OUT_DIR / f"{arch}__{shape_name}__{tag}.json"
    if skip_existing and fname.exists():
        print(f"[skip-existing] {fname.name}")
        return json.loads(fname.read_text())
    cfg, shape = get_config(arch), SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "multi_pod": bool(multi_pod),
               "status": "SKIP", "reason": reason}
    else:
        try:
            if multi_pod is None:
                rec = dry_run(cfg, shape, count=with_probe)
            else:
                rec = lower_cell(arch, shape_name, multi_pod, count=with_probe)
        except Exception as e:  # recorded, and the run exits 1
            rec = {"arch": arch, "shape": shape_name, "multi_pod": bool(multi_pod),
                   "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
    fname.write_text(json.dumps(rec, indent=2, default=float))
    if verbose:
        s = rec["status"]
        if s == "OK":
            r = rec["roofline"]
            peak = rec["memory"].get("peak_bytes_est")
            print(
                f"[{s}] {arch} x {shape_name} ({tag}): trace={rec['trace_s']:.1f}s "
                + (f"mem/dev={peak / 2**30:.2f}GiB " if peak is not None else "")
                + f"compute={r['compute_s'] * 1e3:.2f}ms mem={r['memory_s'] * 1e3:.2f}ms "
                f"coll={r['collective_s'] * 1e3:.2f}ms dom={r['dominant']} "
                f"useful={r['useful_ratio']:.2f} mfu={r['mfu']:.3f}"
            )
        elif s == "SKIP":
            print(f"[{s}] {arch} x {shape_name} ({tag}): {rec['reason'][:90]}")
        else:
            print(f"[{s}] {arch} x {shape_name} ({tag}): {rec['error'][:200]}")
    sys.stdout.flush()
    return rec


def main():
    global OUT_DIR
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--single-pod", action="store_true", help="the 16 x 16 mesh")
    ap.add_argument("--multi-pod", action="store_true", help="the 2 x 16 x 16 mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="both meshes, each in a child process")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-probe", action="store_true",
                    help="trace only (no FLOP count or memory; analytic FLOPs)")
    ap.add_argument("--out", default=None, help="where the records go (default: OUT_DIR)")
    args = ap.parse_args()
    if args.out:
        OUT_DIR = Path(args.out)
    if args.both_meshes:  # a fake group has one size a process
        rest = [a for a in sys.argv[1:] if a not in ("--both-meshes", "--single-pod",
                                                     "--multi-pod")]
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *rest]
        src = str(Path(__file__).resolve().parents[2])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (src, os.environ.get("PYTHONPATH")) if p))
        procs = [subprocess.Popen(cmd + [flag], env=env)
                 for flag in ("--single-pod", "--multi-pod")]
        sys.exit(max(p.wait() for p in procs))
    multi_pod = True if args.multi_pod else (False if args.single_pod else None)
    archs = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    n_fail = 0
    for a in archs:
        for s in shapes:
            rec = run_cell(a, s, multi_pod, skip_existing=args.skip_existing,
                           with_probe=not args.no_probe)
            n_fail += rec["status"] == "FAIL"
    if n_fail:
        sys.exit(1)


if __name__ == "__main__":
    main()
