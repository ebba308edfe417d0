"""Build the kernels' CUDA sources and load them with ``ctypes``.

Each ``kernels/<name>/<name>.cu`` exposes ``extern "C"`` launchers that
take raw device pointers and a CUDA stream and return a ``cudaError_t``.
``nvcc`` compiles a source into ``build/repro_torch_ext/lib<name>-<hash>.so``
under the repository root (the hash covers the source, the shared
``kernels/*.cuh`` headers, the flags and the nvcc version, so a change
to any of them is rebuilt); no PyTorch
header is compiled, so a build takes seconds.
Builds start at first use, or all at once, in parallel, through
``build()``.  A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_ext"
NAMES = ("delta_overlay", "temporal_motif", "temporal_pagerank", "temporal_cc",
         "flash_attention", "rglru_scan", "decode_attention")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def source(name: str) -> Path:
    return KERNELS_DIR / name / f"{name}.cu"


def library(name: str) -> Path:
    """The built library's path, named by a hash of the source, the
    shared headers it may include (``kernels/*.cuh``), the flags and the
    compiler's version, so a change to any of them builds anew."""
    h = hashlib.sha256(source(name).read_bytes())
    for header in sorted(KERNELS_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update("\0".join((*NVCC_FLAGS, _nvcc_version())).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def _nvcc_version() -> str:
    return subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build(names: Iterable[str] = NAMES) -> Dict[str, float]:
    """Compile every named source that has no current library, one
    ``nvcc`` per source, all started together.  Returns the seconds each
    build took (0.0 for a library already built); ``ptxas`` resource
    usage lands in ``<library>.log`` beside it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    for name in names:
        out = library(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {source(name)}:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, with
    the argument types of its launchers set from ``signatures``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library(name)))
            lib.error_string.restype = ctypes.c_char_p
            lib.error_string.argtypes = [ctypes.c_int]
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err}: {lib.error_string(err).decode()}")


def stream_of(t) -> ctypes.c_void_p:
    """The current PyTorch stream of ``t``'s device, as a launcher arg."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
