#!/usr/bin/env python3
"""Time the RG-LRU backward kernel (``rglru_bwd_kernel``) against builds
with other lanes a block, and against a parent tree's kernel, on one CUDA
card.

Builds, each its own ``nvcc`` (all started together):

- ``kernel``: ``src/repro_torch/kernels/rglru_scan/rglru_scan.cu`` as the
  port builds it (64 steps x 64 lanes a block, 48 KB of tiles: four
  blocks an SM);
- ``128 lanes`` and ``32 lanes``: a copy of that source with its one line
  ``constexpr int BWD_LANES = 64;`` set to 128 (96 KB a block: two an SM)
  or 32 (24 KB, one warp); nothing else differs;
- ``parent`` (with ``--parent DIR``): the ``rglru_scan.cu`` of another
  checkout, e.g. ``git archive`` of the parent commit unpacked under
  ``build/checkout/``.

On seeded inputs (log_a = -U(0, 0.5), x and dh standard normal, h from the
forward kernel) at the training path's shape (B=2 S=4096 W=4096), the
ragged one (B=1 S=4097 W=4096), the reduced train step's (B=4 S=64 W=64),
an unaligned width (B=1 S=4097 W=4094, the per-lane load path) and one
block (B=1 S=1 W=4: the launch floor), each build is held within
``chip_smoke.py``'s float32 backward limits of ``ref.rglru_bwd_ref`` and
of ``ref.rglru_bwd_chunked_ref``, its bits are compared with ``kernel``'s
and the parent's, it must leave its scratch zero (the parent, which
zeroes it with a memset before each launch, need not), and it is timed by
``chip_smoke.py``'s ``device_ms`` in two rounds (the builds in order, then
in reverse).  Also times ``zero_()`` of a scratch the size of the carries
(a stand-in for the memset).  Prints one JSON line per shape, one with
each build's resources (``rglru_bwd_resources``; not in a parent that
lacks it), and the card's ``nvidia-smi`` name and power limit.

    python3 tools/rglru_bwd_designs.py [--parent DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from functools import partial
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

OUT = ROOT / "build" / "repro_torch_ext" / "designs"
LANES_LINE = "constexpr int BWD_LANES = 64;"
VARIANTS = {"kernel": 64, "128 lanes": 128, "32 lanes": 32}  # name -> lanes a block
SHAPES = [(2, 4096, 4096), (1, 4097, 4096), (4, 64, 64), (1, 4097, 4094), (1, 1, 4)]


def lanes_source(src: Path, lanes: int) -> Path:
    """``src``, or a copy of it under OUT with ``lanes`` lanes a block."""
    if lanes == 64:
        return src
    text = src.read_text()
    if text.count(LANES_LINE) != 1:
        raise RuntimeError(f"{src} has no single line {LANES_LINE!r}")
    copy = OUT / f"rglru_scan_{lanes}_lanes.cu"
    copy.write_text(text.replace(LANES_LINE, f"constexpr int BWD_LANES = {lanes};"))
    return copy


def build(sources: dict) -> dict:
    """name -> library: one nvcc a build, all at once."""
    from repro_torch.kernels import _build

    jobs = {}
    for name, src in sources.items():
        key = hashlib.sha256(Path(src).read_bytes()).hexdigest()[:12]
        lib = OUT / f"librglru-{key}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib)
    libs = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        cdll.rglru_bwd_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        if hasattr(cdll, "rglru_bwd_resources"):  # not in a parent that predates it
            cdll.rglru_bwd_resources.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        cdll.error_string.restype = ctypes.c_char_p
        cdll.error_string.argtypes = [ctypes.c_int]
        libs[name] = cdll
    return libs


def resources(lib) -> dict | None:
    if not hasattr(lib, "rglru_bwd_resources"):
        return None
    out = {}
    for bulk, path in enumerate(("lane", "bulk")):
        got = (ctypes.c_int * 5)()
        err = lib.rglru_bwd_resources(bulk, got)
        if err:
            raise RuntimeError(lib.error_string(err).decode())
        out[path] = dict(zip(("registers", "static_smem_bytes", "dynamic_smem_bytes",
                              "blocks_per_sm", "local_bytes"), got))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="another checkout whose kernel to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rglru_bwd_designs: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru_scan import ops, ref

    OUT.mkdir(parents=True, exist_ok=True)
    src = _build.source("rglru_scan")
    sources = {name: lanes_source(src, lanes) for name, lanes in VARIANTS.items()}
    if args.parent is not None:
        sources["parent"] = args.parent / src.relative_to(ROOT)
    libs = build(sources)
    print(json.dumps(dict(resources={n: resources(lib) for n, lib in libs.items()})),
          flush=True)
    dev = torch.device("cuda")
    tol = chip_smoke.BWD_TOL[torch.float32]
    ok = True
    for B, S, W in SHAPES:
        g = torch.Generator(device=dev).manual_seed(B * S + W)
        la = -torch.rand(B, S, W, generator=g, device=dev) * 0.5
        x, dh = (torch.randn(B, S, W, generator=g, device=dev) for _ in range(2))
        h = ops.rglru(la, x)
        # a scratch each build, zero at the start
        scratch = {n: torch.zeros(B * W + 1, dtype=torch.int64, device=dev) for n in libs}
        want = (ref.rglru_bwd_ref(la, h, dh), ref.rglru_bwd_chunked_ref(la, h, dh, ops.CHUNK))
        outs = {}

        def call(name, out):
            lib = libs[name]
            err = lib.rglru_bwd_launch(la.data_ptr(), h.data_ptr(), dh.data_ptr(),
                                       out[0].data_ptr(), out[1].data_ptr(),
                                       scratch[name].data_ptr(), B, S, W,
                                       _build.stream_of(la))
            if err:
                raise RuntimeError(lib.error_string(err).decode())
            return out

        row = dict(shape=dict(B=B, S=S, W=W), load_path=ops.bwd_load_path(la, h, dh),
                   bound_ms=5 * la.numel() * 4 / chip_smoke.HBM_BYTES_PER_S * 1e3, builds={})
        for name in libs:
            got = call(name, (torch.empty_like(la), torch.empty_like(la)))
            torch.cuda.synchronize()
            outs[name] = got
            errs = {"scratch_left_zero": not scratch[name].any().item()}
            ok &= errs["scratch_left_zero"] or name == "parent"
            for what, ref_out in zip(("ref", "chunked_ref"), want):
                errs[what] = max(float((a - w).abs().max()) for a, w in zip(got, ref_out))
                within = all(torch.allclose(a, w, **chip_smoke.scaled(tol, w))
                             for a, w in zip(got, ref_out))
                ok &= within
                errs[f"{what}_within"] = within
            row["builds"][name] = dict(max_abs_err=errs, ms=[])
        for name, got in outs.items():
            row["builds"][name]["bits_equal"] = {
                other: all(torch.equal(a, b) for a, b in zip(got, outs[other]))
                for other in ("kernel", "parent") if other in outs and other != name}
        order = list(libs)
        for names in (order, order[::-1]):
            for name in names:
                out = (torch.empty_like(la), torch.empty_like(la))
                row["builds"][name]["ms"].append(chip_smoke.device_ms(partial(call, name, out)))
        row["scratch_zero_ms"] = chip_smoke.device_ms(scratch["kernel"].zero_)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi.strip(),
                          ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
