#!/usr/bin/env python3
"""Time the single fold ``delta_overlay.overlay`` against other designs
of it and against an empty kernel, on one CUDA card.

- ``kernel``: the port's kernel (``ops.overlay``: the layers 4 at a time,
  outputs stored directly);
- ``one_layer``: the same walk one layer at a time;
- ``staged``: that walk with its outputs staged in shared memory and
  written back by the block as one coalesced run (what the batch fold's
  tile does);
- ``dense``: present bytes and attrs loaded for every layer, valid or not;
- ``hint``: every load asks L2 for a 256-byte run (``L2::256B``);
- ``two_slot``: two slots a thread (s and s + 256 of a 512-slot block);
- ``persistent``: as many blocks as the card holds at once, each striding
  over the 256-slot tiles;
- ``kernel, L2 fetch 32 B``: the port's kernel with the card's L2 fetch
  granularity (``cudaLimitMaxL2FetchGranularity``) set to 32 bytes for the
  timing, then set back;
- ``empty``: a kernel with an empty body, launched on one block: the
  least time a launch takes when timed this way.

The other designs and the empty kernel are built here from the CUDA
source below (K = 4, 16-byte aligned attrs, 32-bit indices).  Every
design is held bit for bit against ``ref.overlay_ref`` first, and every
time is ``chip_smoke.py``'s ``device_ms`` (median of CUDA-event timings
of one call), on a seeded stack of the main path's shape (h=2 P=16
S=384 K=4) and on ``chip_smoke.py``'s two headline stacks (h=8 P=16
S=65536 and 65537, K=4).  Prints one JSON line per stack, then the
card's ``nvidia-smi`` name and power limit.

    python3 tools/overlay_designs.py
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

// Loads through the read-only path; HINT asks L2 to fetch 256-byte runs.
template <bool HINT>
__device__ __forceinline__ int4 ld4(const int4* p) {
  if (!HINT) return __ldg(p);
  int4 r;
  asm("ld.global.nc.L2::256B.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

template <bool HINT>
__device__ __forceinline__ int8_t ld1(const int8_t* p) {
  if (!HINT) return __ldg(p);
  short r;
  asm("ld.global.nc.L2::256B.s8 %0, [%1];" : "=h"(r) : "l"(p));
  return (int8_t)r;
}

// The single fold of slot s, one layer at a time: layer 0 raw, step 1 in
// full, invalid layers skipped from step 2 on (DENSE: their present bytes
// and attrs loaded all the same).
template <bool DENSE, bool HINT>
__device__ __forceinline__ void walk(const int8_t* __restrict__ valid,
                                     const int8_t* __restrict__ present,
                                     const int4* __restrict__ attrs, int h, int n,
                                     int s, int8_t& v, int8_t& p, int4& a) {
  v = ld1<HINT>(valid + s) != 0;
  p = ld1<HINT>(present + s);
  a = ld4<HINT>(attrs + s);
#pragma unroll 4
  for (int i = 1; i < h; ++i) {
    const int off = i * n + s;
    const bool vi = ld1<HINT>(valid + off) != 0;
    int8_t pi = 0;
    int4 b = make_int4(-1, -1, -1, -1);
    if (DENSE || vi) {
      pi = ld1<HINT>(present + off);
      b = ld4<HINT>(attrs + off);
    }
    if (vi) {
      v = 1;
      p = pi;
      if (b.x != -1) a.x = b.x;
      if (b.y != -1) a.y = b.y;
      if (b.z != -1) a.z = b.z;
      if (b.w != -1) a.w = b.w;
    } else if (i > 1) {
      continue;
    }
    if (p == 0) a = make_int4(-1, -1, -1, -1);
  }
}

struct Args {
  const int8_t* valid;
  const int8_t* present;
  const int4* attrs;
  int8_t* o_v;
  int8_t* o_p;
  int4* o_a;
  int h, n;
};

template <bool DENSE, bool HINT>
__device__ __forceinline__ void fold(const Args& a, int s) {
  int8_t v, p;
  int4 r;
  walk<DENSE, HINT>(a.valid, a.present, a.attrs, a.h, a.n, s, v, p, r);
  a.o_v[s] = v;
  a.o_p[s] = p;
  a.o_a[s] = r;
}

template <bool DENSE, bool HINT>
__global__ void __launch_bounds__(256) slot_kernel(const Args a) {
  const int s = blockIdx.x * 256 + threadIdx.x;
  if (s < a.n) fold<DENSE, HINT>(a, s);
}

__global__ void __launch_bounds__(256) two_slot_kernel(const Args a) {
  for (int s = blockIdx.x * 512 + threadIdx.x, j = 0; j < 2 && s < a.n; ++j, s += 256)
    fold<false, false>(a, s);
}

__global__ void __launch_bounds__(256) persistent_kernel(const Args a) {
  for (int s = blockIdx.x * 256 + threadIdx.x; s < a.n; s += gridDim.x * 256)
    fold<false, false>(a, s);
}

__global__ void __launch_bounds__(256) staged_kernel(const Args a) {
  __shared__ int32_t st_a[256 * 5];  // an odd stride: no bank conflicts
  __shared__ int8_t st_v[256], st_p[256];
  const int s0 = blockIdx.x * 256, t = threadIdx.x;
  const int sn = min(256, a.n - s0);
  if (t < sn) {
    int8_t v, p;
    int4 r;
    walk<false, false>(a.valid, a.present, a.attrs, a.h, a.n, s0 + t, v, p, r);
    st_a[t * 5] = r.x;
    st_a[t * 5 + 1] = r.y;
    st_a[t * 5 + 2] = r.z;
    st_a[t * 5 + 3] = r.w;
    st_v[t] = v;
    st_p[t] = p;
  }
  __syncthreads();
  int32_t* out = reinterpret_cast<int32_t*>(a.o_a) + (long long)s0 * 4;
  for (int q = t; q < sn * 4; q += 256) out[q] = st_a[(q >> 2) * 5 + (q & 3)];
  if (t < sn) {
    a.o_v[s0 + t] = st_v[t];
    a.o_p[s0 + t] = st_p[t];
  }
}

}  // namespace

// which: 0 empty, 1 one_layer, 2 staged, 3 dense, 4 hint, 5 two_slot,
// 6 persistent.
extern "C" int design_launch(int which, const void* valid, const void* present,
                             const void* attrs, void* o_v, void* o_p, void* o_a,
                             int h, int n, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Args a{(const int8_t*)valid, (const int8_t*)present, (const int4*)attrs,
               (int8_t*)o_v, (int8_t*)o_p, (int4*)o_a, h, n};
  unsigned blocks = (unsigned)((n + 255) / 256);
  switch (which) {
    case 0: empty_kernel<<<1, 32, 0, st>>>(); break;
    case 1: slot_kernel<false, false><<<blocks, 256, 0, st>>>(a); break;
    case 2: staged_kernel<<<blocks, 256, 0, st>>>(a); break;
    case 3: slot_kernel<true, false><<<blocks, 256, 0, st>>>(a); break;
    case 4: slot_kernel<false, true><<<blocks, 256, 0, st>>>(a); break;
    case 5: two_slot_kernel<<<(unsigned)((n + 511) / 512), 256, 0, st>>>(a); break;
    default: {
      int per_sm = 0, sms = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, persistent_kernel, 256, 0);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
      if ((unsigned)(per_sm * sms) < blocks) blocks = (unsigned)(per_sm * sms);
      persistent_kernel<<<blocks, 256, 0, st>>>(a);
    }
  }
  return (int)cudaGetLastError();
}

// Sets the L2 fetch granularity to `bytes`; returns what it was.
extern "C" long long set_l2_fetch(long long bytes) {
  size_t old = 0;
  cudaDeviceGetLimit(&old, cudaLimitMaxL2FetchGranularity);
  cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, (size_t)bytes);
  return (long long)old;
}
"""
DESIGNS = {"empty": 0, "one_layer": 1, "staged": 2, "dense": 3, "hint": 4, "two_slot": 5,
           "persistent": 6}


def load_designs():
    from repro_torch.kernels import _build

    digest = hashlib.sha256((SOURCE + "\0".join(_build.NVCC_FLAGS)).encode()).hexdigest()
    lib = _build.BUILD_DIR / f"liboverlay_designs-{digest[:16]}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = lib.with_suffix(".cu")
        src.write_text(SOURCE)
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
        print(json.dumps({"ptxas": [ln.strip() for ln in (out.stdout + out.stderr).splitlines()
                                    if "Used" in ln or "spill" in ln]}), flush=True)
    dll = ctypes.CDLL(str(lib))
    dll.design_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                                  + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    dll.set_l2_fetch.restype = ctypes.c_longlong
    dll.set_l2_fetch.argtypes = [ctypes.c_longlong]
    return dll


def main() -> int:
    if not torch.cuda.is_available():
        print("overlay_designs: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.delta_overlay import ops, ref

    _build.build(["delta_overlay"])
    print(json.dumps({"delta_overlay ptxas": [
        ln.strip() for ln in _build.library("delta_overlay").with_suffix(".log")
        .read_text().splitlines() if "Used" in ln or "spill" in ln]}), flush=True)
    lib = load_designs()
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(3)
    main_like = [(torch.rand(2, 16, 384, generator=g) < 0.4).to(dev),
                 (torch.rand(2, 16, 384, generator=g) < 0.7).to(torch.int8).to(dev),
                 torch.randint(-1, 5, (2, 16, 384, 4), generator=g,
                               dtype=torch.int32).to(dev)]
    stacks = [("h=2 P=16 S=384 K=4, the main path's shape", main_like)] + [
        (tag, args) for k, tag, args, _, _ in chip_smoke.headline_inputs(dev)
        if k == "delta_overlay.overlay"]
    for tag, (valid, present, attrs) in stacks:
        h, P, S = valid.shape
        want = ref.overlay_ref(valid, present, attrs)
        outs = [torch.empty_like(w) for w in want]

        def design(which, outs=outs, valid=valid, present=present, attrs=attrs, h=h,
                   n=P * S):
            err = lib.design_launch(which, valid.data_ptr(), present.data_ptr(),
                                    attrs.data_ptr(), *(o.data_ptr() for o in outs),
                                    h, n, _build.stream_of(valid))
            if err != 0:
                raise RuntimeError(f"design {which}: CUDA error {err}")

        def kernel(valid=valid, present=present, attrs=attrs):
            return ops.overlay(valid, present, attrs)

        for name, which in DESIGNS.items():
            if name == "empty":
                continue
            for o in outs:
                o.zero_()
            design(which)
            torch.cuda.synchronize()
            if not all(torch.equal(o, w) for o, w in zip(outs, want)):
                raise SystemExit(f"overlay_designs: {name} != overlay_ref on {tag}")
        if not all(torch.equal(o, w) for o, w in zip(kernel(), want)):
            raise SystemExit(f"overlay_designs: kernel != overlay_ref on {tag}")
        ms = {"kernel": chip_smoke.device_ms(kernel)}
        ms.update({name: chip_smoke.device_ms(lambda w=which: design(w))
                   for name, which in DESIGNS.items()})
        old = lib.set_l2_fetch(32)
        try:
            ms["kernel, L2 fetch 32 B"] = chip_smoke.device_ms(kernel)
        finally:
            lib.set_l2_fetch(old)
        bound = chip_smoke.overlay_bytes((valid, present, attrs), batch=False) \
            / chip_smoke.HBM_BYTES_PER_S * 1e3
        print(json.dumps({"inputs": tag, "ms": ms, "bound_ms": bound,
                          "l2_fetch_bytes": old}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
