// RG-LRU scan: the first-order linear recurrence
//   h[b, t, w] = exp(log_a[b, t, w]) * h[b, t-1, w] + x[b, t, w],  h[b, -1, w] = 0
// over float32 (B, S, W) tensors, for any B, S and W.
//
// Replaces the Pallas TPU kernel _rglru_kernel / rglru_pallas in
// src/repro/kernels/rglru_scan/rglru_scan.py, which streams (64, 128)
// tiles through VMEM and carries h across the sequential chunk axis.
//
// Bound: the function reads log_a and x once and writes h once (12 bytes
// per element) and does 3 float operations per element, so the bytes
// bound it.  Design: one thread owns one (b, w) lane and walks the whole
// sequence, so h never leaves a register and nothing crosses threads;
// neighbouring threads take neighbouring w, so each step's loads and
// store are coalesced.  The chain through h is serial, so each thread
// first issues the loads of UNROLL steps (2 * UNROLL independent loads in
// flight) and their expf, then runs the dependent FMAs.  With B * W lanes
// this fills the card only when B * W is large: the serving path has
// B * W = 16,384 threads, about 124 per SM, too few to keep HBM busy.  A
// chunked two-pass scan (chunk-local scans plus a carry pass) would fill
// it; that is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 16;

__global__ void __launch_bounds__(THREADS)
rglru_kernel(const float* __restrict__ log_a, const float* __restrict__ x,
             float* __restrict__ h, int S, int W, long long lanes) {
  const long long lane = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= lanes) return;
  const long long bi = lane / W, w = lane % W;
  const size_t base = (size_t)bi * S * W + w;
  const float* la = log_a + base;
  const float* xb = x + base;
  float* out = h + base;
  float hv = 0.f;
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float a[UNROLL], v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      a[u] = __ldg(la + (size_t)(t + u) * W);
      v[u] = __ldg(xb + (size_t)(t + u) * W);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) a[u] = expf(a[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      hv = a[u] * hv + v[u];
      out[(size_t)(t + u) * W] = hv;
    }
  }
  for (; t < S; ++t) {
    hv = expf(__ldg(la + (size_t)t * W)) * hv + __ldg(xb + (size_t)t * W);
    out[(size_t)t * W] = hv;
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// log_a, x, h: contiguous (B, S, W) float32 on the device.
int rglru_launch(const void* log_a, const void* x, void* h, int B, int S, int W,
                 void* stream) {
  if (B < 1 || S < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)B * W;
  const long long blocks = (lanes + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  rglru_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)log_a, (const float*)x, (float*)h, S, W, lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
