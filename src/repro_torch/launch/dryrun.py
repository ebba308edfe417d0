"""Dry run of one step on one H100, on ``meta`` tensors (port of
``repro.launch.dryrun``): nothing is allocated and no card is needed.

Per cell this script:
  1. builds the model, optimizer state, batch and cache as ``meta``
     tensors (``repro_torch.launch.specs``);
  2. runs the train, prefill or serve step of ``repro_torch.train.steps``
     once, eagerly, under ``torch.utils.flop_counter.FlopCounterMode``
     (the step's counted FLOPs) and ``LiveBytes`` (the bytes of live
     storages before the step, after it and at its peak);
  3. takes the step's HBM bytes from the analytic model
     (``repro_torch.roofline.analytic.step_bytes`` at dp = tp = chips =
     1), as the reference takes its memory term;
  4. writes one JSON record, with the reference's keys, under
     ``experiments/dryrun_torch/``: the counts, the analytic FLOPs beside
     them, and the roofline at the H100's data-sheet peaks.

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
steps.

One card has no mesh and no collectives: ``--multi-pod`` and
``--both-meshes`` (the reference's 16 x 16 and 2 x 16 x 16 meshes) wait
for the multi-card slice.  The reference's shapes (``SHAPES``) are
pod-sized, so on one card most of them report a peak over 80 GB: that is
their answer.

Usage:
  python -m repro_torch.launch.dryrun --arch recurrentgemma-9b --shape prefill_32k
  python -m repro_torch.launch.dryrun --all [--skip-existing] [--no-probe]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import specs as specs_mod
from repro_torch.roofline import analytic, compute_roofline, model_flops
from repro_torch.train import make_prefill_step, make_serve_step, make_train_step

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
MULTI_CARD = ("the production meshes (16 x 16, 2 x 16 x 16) wait for the port's "
              "multi-card slice (ROADMAP Queue 1, item 5)")
SOURCE = {
    True: ("flops=counted (FlopCounterMode over the eager step on meta; attention by its "
           "plain version, every masked pair counted) bytes=analytic (step_bytes at "
           "dp=tp=chips=1) collectives=none (one card)"),
    False: ("flops=analytic (step_flops) bytes=analytic (step_bytes at dp=tp=chips=1) "
            "collectives=none (one card)"),
}


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
    raises on the frozen parameters of a serving step.)"""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def hold(self, tensors) -> None:
        for t in tensors:
            self._see(t)

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
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._see(t)
        return out


def dry_run(cfg: ModelConfig, shape: ShapeConfig, *, cache_len: int = 0, max_seq: int = 0,
            count: bool = True) -> dict:
    """One step of ``cfg`` at ``shape`` on ``meta``, at the config's own
    depth, batch and length: the record of ``run_cell`` without its file.

    ``cache_len``: the KV-cache allocation of a prefill or decode (default
    ``shape.seq_len``, which counts an image prefix); ``max_seq``: the
    learned position table's rows (default ``shape.seq_len``).  Serving
    runs in ``cfg.dtype`` (parameters stored in it), training in
    ``cfg.param_dtype`` masters."""
    kind, B, S = shape.kind, shape.global_batch, shape.seq_len
    if kind != "train":
        cfg = cfg.replace(param_dtype=cfg.dtype)
    t0 = time.perf_counter()
    model = specs_mod.abstract_params(cfg, max_seq=max_seq or S)
    n_par = specs_mod.n_params(model)
    n_act = specs_mod.n_active_params(cfg, model)
    live, counter = LiveBytes(), FlopCounterMode(display=False)
    modes = (live, counter) if count else ()
    with contextlib.ExitStack() as stack:
        for m in modes:
            stack.enter_context(m)
        live.hold(model.parameters())
        if kind == "train":
            model.train()
            model.requires_grad_(True)
            args = (model, specs_mod.abstract_opt_state(model), specs_mod.batch_specs(cfg, shape))
            step = make_train_step(cfg)
            tokens = B * S
        elif kind == "prefill":
            args = (model, specs_mod.batch_specs(cfg, shape))
            step = make_prefill_step(cache_len=cache_len or S)
            tokens = B * S
        else:  # decode
            args = (model, *specs_mod.decode_specs(cfg, shape, model_axis=1,
                                                   cache_len=cache_len))
            step = make_serve_step()
            tokens = B  # one token per sequence
        before = live.live
        with torch.inference_mode(kind != "train"):
            out = step(*args)
        after, peak = live.live, live.peak
        del out, args
    trace_s = time.perf_counter() - t0

    an_flops = analytic.step_flops(cfg, kind, B, S)
    an_bytes = analytic.step_bytes(cfg, kind, B, S, dp=1, tp=1, chips=1)
    flops = counter.get_total_flops() if count else an_flops
    mf = model_flops(kind, n_act, tokens)
    roof = compute_roofline({"flops": flops, "bytes accessed": an_bytes["total"]}, 0.0, mf, 1)
    outb = max(after - before, 0)
    rec = {
        "arch": cfg.name,
        "shape": shape.name,
        "multi_pod": False,
        "status": "OK",
        "n_chips": 1,
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
        "collectives": {"wire_bytes": 0.0},
        "analytic": {
            "flops_global": an_flops,
            "flops_per_dev": an_flops,
            "counted_vs_analytic": flops / an_flops if (count and an_flops) else None,
            "bytes_per_dev": an_bytes,
        },
        "roofline": dict(roof.to_dict(), source=SOURCE[count]),
    }
    return rec


def run_cell(arch: str, shape_name: str, skip_existing: bool = False, verbose: bool = True,
             with_probe: bool = True) -> dict:
    """Dry-run one (arch, shape) cell of the reference's table on one card
    and write its record; ``with_probe=False`` traces the step without
    counting (the roofline then takes the analytic FLOPs)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    fname = OUT_DIR / f"{arch}__{shape_name}__onecard.json"
    if skip_existing and fname.exists():
        print(f"[skip-existing] {fname.name}")
        return json.loads(fname.read_text())
    cfg, shape = get_config(arch), SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "multi_pod": False, "status": "SKIP",
               "reason": reason}
    else:
        try:
            rec = dry_run(cfg, shape, count=with_probe)
        except Exception as e:  # recorded, and the run exits 1
            rec = {"arch": arch, "shape": shape_name, "multi_pod": False, "status": "FAIL",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
    fname.write_text(json.dumps(rec, indent=2, default=float))
    if verbose:
        s = rec["status"]
        if s == "OK":
            r = rec["roofline"]
            peak = rec["memory"].get("peak_bytes_est")
            print(
                f"[{s}] {arch} x {shape_name} (one card): trace={rec['trace_s']:.1f}s "
                + (f"mem={peak / 2**30:.2f}GiB " if peak is not None else "")
                + f"compute={r['compute_s'] * 1e3:.2f}ms mem={r['memory_s'] * 1e3:.2f}ms "
                f"dom={r['dominant']} useful={r['useful_ratio']:.2f} mfu={r['mfu']:.3f}"
            )
        elif s == "SKIP":
            print(f"[{s}] {arch} x {shape_name} (one card): {rec['reason'][:90]}")
        else:
            print(f"[{s}] {arch} x {shape_name} (one card): {rec['error'][:200]}")
    sys.stdout.flush()
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-probe", action="store_true",
                    help="trace only (no FLOP count or memory; analytic FLOPs)")
    args = ap.parse_args()
    if args.multi_pod or args.both_meshes:
        raise NotImplementedError(MULTI_CARD)

    archs = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    n_fail = 0
    for a in archs:
        for s in shapes:
            rec = run_cell(a, s, skip_existing=args.skip_existing, with_probe=not args.no_probe)
            n_fail += rec["status"] == "FAIL"
    if n_fail:
        sys.exit(1)


if __name__ == "__main__":
    main()
