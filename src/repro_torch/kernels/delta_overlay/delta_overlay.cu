// Fused h-way last-writer-wins delta overlay (Algorithm 1's node fold).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/delta_overlay/
// delta_overlay.py: _overlay_kernel / overlay_pallas (one fold) and
// _overlay_batch_kernel / overlay_batch_pallas (T folds over shared layers).
//
// Semantics, per slot (p, s), exactly those of _overlay_kernel:
//   acc = layer 0;  for i in 1..h-1:
//     if valid[i]: present <- present[i]; attrs[k] <- attrs[i][k] where != -1
//     if present == 0: attrs <- -1          (every step, valid or not)
//     valid |= valid[i]
// The clear runs on every step after a tombstone, which makes the fold
// non-associative across tombstones (tests/test_delta_properties.py pins
// that); it is kept as is.  The batch variant starts each timepoint t from
// the neutral accumulator (valid 0, present 0, attrs -1) and folds the layers
// i with tmask[i][t] != 0, the clear included from layer 0 on.
//
// Design: one thread per slot, consecutive threads on consecutive slots
// (coalesced int8 loads), any h, T and K, no padding of S (the last block
// masks the ragged edge), no shared memory.  Valid and present fold first;
// then each attribute folds on its own, repeating the present fold, so the
// accumulator is two scalars whatever K is.  The repeated reads of a slot's
// layers hit the cache; device memory sees each layer about once.  A layer
// whose valid byte is 0 cannot change the attrs, so its attrs are not read;
// the batch kernel tests tmask (the same for the whole warp) before it
// reads a layer, so a layer outside timepoint t costs no load of the slot.
// Outputs are written once each, directly.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void overlay_kernel(const int8_t* __restrict__ valid,
                               const int8_t* __restrict__ present,
                               const int32_t* __restrict__ attrs,
                               int8_t* __restrict__ o_valid,
                               int8_t* __restrict__ o_present,
                               int32_t* __restrict__ o_attrs, int h,
                               long long n, int K) {
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= n) return;
  int acc_v = valid[s] != 0;
  int8_t acc_p = present[s];
  for (int i = 1; i < h; ++i) {
    const int vi = valid[i * n + s] != 0;
    if (vi) acc_p = present[i * n + s];
    acc_v |= vi;
  }
  o_valid[s] = (int8_t)acc_v;
  o_present[s] = acc_p;
  for (int k = 0; k < K; ++k) {
    int8_t p = present[s];
    int32_t a = attrs[s * K + k];
    for (int i = 1; i < h; ++i) {
      const long long off = i * n + s;
      if (valid[off] != 0) {
        p = present[off];
        const int32_t ai = attrs[off * K + k];
        if (ai != -1) a = ai;
      }
      if (p == 0) a = -1;
    }
    o_attrs[s * K + k] = a;
  }
}

__global__ void overlay_batch_kernel(const int8_t* __restrict__ valid,
                                     const int8_t* __restrict__ present,
                                     const int32_t* __restrict__ attrs,
                                     const int32_t* __restrict__ tmask,
                                     int8_t* __restrict__ o_valid,
                                     int8_t* __restrict__ o_present,
                                     int32_t* __restrict__ o_attrs, int h,
                                     long long n, int K, int T) {
  const long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= n) return;
  for (int t = 0; t < T; ++t) {
    int acc_v = 0;
    int8_t acc_p = 0;
    for (int i = 0; i < h; ++i) {
      const int vi = tmask[i * T + t] != 0 && valid[i * n + s] != 0;
      if (vi) acc_p = present[i * n + s];
      acc_v |= vi;
    }
    o_valid[s * T + t] = (int8_t)acc_v;
    o_present[s * T + t] = acc_p;
    for (int k = 0; k < K; ++k) {
      int8_t p = 0;
      int32_t a = -1;
      for (int i = 0; i < h; ++i) {
        const long long off = i * n + s;
        if (tmask[i * T + t] != 0 && valid[off] != 0) {
          p = present[off];
          const int32_t ai = attrs[off * K + k];
          if (ai != -1) a = ai;
        }
        if (p == 0) a = -1;
      }
      o_attrs[(s * T + t) * K + k] = a;
    }
  }
}

constexpr int THREADS = 256;

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// valid/present: (h, n) int8 (bool bytes accepted); attrs: (h, n, K) int32;
// outputs (n,) and (n, K).  n = P * S slots.
int overlay_launch(const void* valid, const void* present, const void* attrs,
                   void* o_valid, void* o_present, void* o_attrs, int h,
                   long long n, int K, void* stream) {
  if (h < 1 || n < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  overlay_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)valid, (const int8_t*)present, (const int32_t*)attrs,
      (int8_t*)o_valid, (int8_t*)o_present, (int32_t*)o_attrs, h, n, K);
  return (int)cudaGetLastError();
}

// + tmask: (h, T) int32; outputs (n, T) and (n, T, K).
int overlay_batch_launch(const void* valid, const void* present,
                         const void* attrs, const void* tmask, void* o_valid,
                         void* o_present, void* o_attrs, int h, long long n,
                         int K, int T, void* stream) {
  if (h < 1 || n < 1 || K < 0 || T < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  overlay_batch_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)valid, (const int8_t*)present, (const int32_t*)attrs,
      (const int32_t*)tmask, (int8_t*)o_valid, (int8_t*)o_present,
      (int32_t*)o_attrs, h, n, K, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
