// Temporal connected components over a dense adjacency stack: for every
// timepoint, bounded min-label propagation.  Labels start as the row index
// on active nodes and N elsewhere; each round
//   labels[j] = min(labels[j], min over i with A[i][j] > 0 of prev[i])
// reads only the previous round's labels (Jacobi, double-buffered), and
// the output is the label on active nodes, -1 elsewhere.  Inactive nodes
// are masked only at the start and the end, so they relay labels along
// their edges, as the reference does.
//
// Replaces the Pallas TPU kernel _cc_kernel / cc_pallas in
// src/repro/kernels/temporal_cc/temporal_cc.py.
//
// Bound: the function reads each adjacency entry once; its min operations
// are few against those bytes, so the bytes bound it.  This kernel reads
// the stack once per round that runs.
// Design: one launch per round (the launch boundary is the barrier between
// rounds); grid (column strips of 32, T); a block's lanes own 32 columns
// (128-byte coalesced row reads), its 8 warps take the rows in stripes,
// and the previous labels are staged in shared memory a chunk at a time.
// Min is exact and order-free, so the result is bit-identical to the plain
// version.  Early exit: labels only fall, so once a round changes nothing
// at timepoint t (a per-(round, t) flag) every later round would change
// nothing either; those blocks return at once, and both label buffers
// already hold the final labels.  Any N is taken: no padding.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int COLS = 32;
constexpr int WARPS = 8;
constexpr int THREADS = COLS * WARPS;
constexpr int CHUNK = 2048;  // previous labels staged at once

__global__ void init_kernel(const float* __restrict__ act,
                            int32_t* __restrict__ lab, long long n, int N) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) lab[i] = act[i] != 0.f ? (int32_t)(i % N) : N;
}

__global__ void __launch_bounds__(THREADS)
round_kernel(const float* __restrict__ adj, const int32_t* __restrict__ lab,
             int32_t* __restrict__ lab_next, int32_t* __restrict__ changed,
             int round, int T, int N) {
  const int t = blockIdx.y;
  // converged at t: lab and lab_next are equal already (uniform per block)
  if (round > 0 && changed[(size_t)(round - 1) * T + t] == 0) return;
  const int lane = threadIdx.x % COLS, w = threadIdx.x / COLS;
  const int j = blockIdx.x * COLS + lane;
  const float* A = adj + (size_t)t * N * N;
  const int32_t* lt = lab + (size_t)t * N;
  __shared__ int32_t labs[CHUNK];
  __shared__ int32_t part[WARPS][COLS];
  int32_t m = N;
  for (int c0 = 0; c0 < N; c0 += CHUNK) {
    const int rows = min(CHUNK, N - c0);
    for (int k = threadIdx.x; k < rows; k += THREADS) labs[k] = lt[c0 + k];
    __syncthreads();
    if (j < N) {
      const float* col = A + (size_t)c0 * N + j;
#pragma unroll 4
      for (int k = w; k < rows; k += WARPS)
        if (col[(size_t)k * N] > 0.f) m = min(m, labs[k]);
    }
    __syncthreads();
  }
  part[w][lane] = m;
  __syncthreads();
  if (w == 0 && j < N) {
#pragma unroll
    for (int q = 1; q < WARPS; ++q) m = min(m, part[q][lane]);
    const int32_t old = lt[j], now = min(old, m);
    lab_next[(size_t)t * N + j] = now;
    if (now != old) changed[(size_t)round * T + t] = 1;
  }
}

__global__ void final_kernel(const float* __restrict__ act,
                             const int32_t* __restrict__ lab,
                             int32_t* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = act[i] != 0.f ? lab[i] : -1;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// adj: (T, N, N) float32; act: (T, N) float32; out: (T, N) int32 labels;
// scratch (caller-allocated): two (T, N) int32 label buffers and an
// (iters, T) int32 flag array zeroed by the caller.
int cc_launch(const void* adj, const void* act, void* lab_a, void* lab_b,
              void* changed, void* out, int T, int N, int iters,
              void* stream) {
  if (T < 1 || N < 1 || T > 65535 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)T * N;
  const unsigned flat = (unsigned)((n + 255) / 256);
  int32_t* bufs[2] = {(int32_t*)lab_a, (int32_t*)lab_b};
  init_kernel<<<flat, 256, 0, st>>>((const float*)act, bufs[0], n, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + COLS - 1) / COLS, T);
  for (int r = 0; r < iters; ++r) {
    round_kernel<<<grid, THREADS, 0, st>>>((const float*)adj, bufs[r % 2],
                                           bufs[(r + 1) % 2],
                                           (int32_t*)changed, r, T, N);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  final_kernel<<<flat, 256, 0, st>>>((const float*)act, bufs[iters % 2],
                                     (int32_t*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
