#!/usr/bin/env python3
"""The rate of ``mma.sync`` m16n8k8 TF32 on one CUDA card: the ceiling of
the float32 attention kernels, which issue each product as three of them
(3xTF32).

A kernel of its own, built here with nvcc (into ``build/repro_torch_ext/``),
runs in every warp long chains of
``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`` into 8 independent
accumulators: no loads, no other work.  One block per SM of 1, 2, 4 or 8
warps a scheduler (128 to 1,024 threads).  Times from CUDA events, the
median of 5 launches after a warm-up.  Prints one JSON line: the TF32
TFLOP/s at each occupancy, beside the card's name and ``nvidia-smi``
power limit.

    python3 tools/mma_tf32_peak.py
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
ITERS = 20_000
CHAINS = 8

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void chains(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a = __float_as_uint(1.0f + threadIdx.x * 1e-3f) & 0xffffe000u;
  const uint32_t b = __float_as_uint(1.0f - threadIdx.x * 1e-3f) & 0xffffe000u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
          "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a), "r"(b), "r"(a), "r"(b), "r"(a), "r"(b));
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (s == 1234.5f) out[0] = s;  // keeps the chains alive
}

extern "C" int run(float* out, int blocks, int threads, int iters, void* stream) {
  chains<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_tf32_peak: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "mma_tf32_peak.cu"
    lib_path = _build.BUILD_DIR / "libmma_tf32_peak.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for warps_per_scheduler in (1, 2, 4, 8):
        threads = 128 * warps_per_scheduler

        def launch():
            if lib.run(out.data_ptr(), sms, threads, ITERS, stream) != 0:
                raise RuntimeError("mma_tf32_peak: launch failed")

        launch()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            launch()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        flop = sms * threads // 32 * ITERS * CHAINS * 2 * 16 * 8 * 8
        rates[warps_per_scheduler] = flop / statistics.median(times) / 1e12
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(tf32_tflops_by_warps_per_scheduler=rates, sms=sms, iters=ITERS,
                          chains_per_warp=CHAINS, device=torch.cuda.get_device_name(0),
                          nvidia_smi=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
