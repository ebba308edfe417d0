// Temporal PageRank over a dense adjacency stack: for every timepoint t,
// `iters` damped power-iteration steps with the dangling mass spread
// uniformly over the active nodes and inactive nodes pinned to 0:
//   deg = column sums of A;  n = max(sum(act), 1);  r = act / n
//   contrib = deg > 0 ? r / max(deg, 1) : 0
//   nxt[j] = sum_i contrib[i] * A[i][j];  dangling = sum_i r[i] act[i] (deg[i] == 0)
//   r = act * ((1 - d) / n + d * (nxt + dangling / n))
// A is any float32 matrix (weighted, asymmetric): the orientation is the
// reference's, column sums for deg and a contraction over rows for nxt.
//
// Replaces the Pallas TPU kernel _pagerank_kernel / pagerank_pallas in
// src/repro/kernels/temporal_pagerank/temporal_pagerank.py.
//
// Bound: the function reads each adjacency entry once and does
// iters * (2 nnz + ~8 T N) float operations, so the bytes bound it.  This
// kernel reads the whole stack once per iteration (iters + 1 passes): a
// stack past the 50 MB L2 streams from HBM every time.
// Design: one launch per iteration; the launch boundary is the barrier
// every step needs (each step reads all of the previous step's ranks).
// The grid is (column strips of 32, T), enough blocks to fill the card at
// T = 8 or 16; one CTA per timepoint would run 16 CTAs on 132 SMs.  A
// block owns 32 columns (one per lane, 128-byte coalesced row reads); its
// 8 warps take the rows in stripes.  The rows' contrib values are staged
// in shared memory a chunk at a time, and every block also sums the
// timepoint's dangling mass itself, so no step needs a second pass.  All
// arithmetic is float32 FMA on CUDA cores (no TF32).  Sums run in a fixed
// order (sequential per thread, a fixed tree across threads, warps
// combined in index order), so two runs give the same bits; no atomics.
// N is taken as it is: no padding.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int COLS = 32;   // columns of a block's strip, one per lane
constexpr int WARPS = 8;   // row stripes
constexpr int THREADS = COLS * WARPS;
constexpr int CHUNK = 1024;  // rows whose contrib is staged at once

// Sum of one value per thread, in a fixed order; every thread gets it.
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// deg (column sums), n per timepoint and the first ranks act / n.
__global__ void __launch_bounds__(THREADS)
setup_kernel(const float* __restrict__ adj, const float* __restrict__ act,
             float* __restrict__ deg, float* __restrict__ nvec,
             float* __restrict__ r0, int N) {
  const int t = blockIdx.y;
  const int lane = threadIdx.x % COLS, w = threadIdx.x / COLS;
  const int j = blockIdx.x * COLS + lane;
  const float* A = adj + (size_t)t * N * N;
  const float* at = act + (size_t)t * N;
  __shared__ float red[THREADS];
  __shared__ float part[WARPS][COLS];
  float s = 0.f;
  if (j < N) {
#pragma unroll 4
    for (int i = w; i < N; i += WARPS) s += A[(size_t)i * N + j];
  }
  part[w][lane] = s;
  float live = 0.f;
  for (int i = threadIdx.x; i < N; i += THREADS) live += at[i];
  const float n = fmaxf(block_sum(live, red), 1.f);  // syncs: part is visible
  if (w == 0 && j < N) {
    float d = 0.f;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) d += part[q][lane];
    deg[(size_t)t * N + j] = d;
    r0[(size_t)t * N + j] = at[j] / n;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) nvec[t] = n;
}

// One power-iteration step: r -> r_next for the block's 32 columns.
__global__ void __launch_bounds__(THREADS)
step_kernel(const float* __restrict__ adj, const float* __restrict__ act,
            const float* __restrict__ deg, const float* __restrict__ nvec,
            const float* __restrict__ r, float* __restrict__ r_next,
            float base, float damping, int N) {
  const int t = blockIdx.y;
  const int lane = threadIdx.x % COLS, w = threadIdx.x / COLS;
  const int j = blockIdx.x * COLS + lane;
  const float* A = adj + (size_t)t * N * N;
  const float* at = act + (size_t)t * N;
  const float* dt = deg + (size_t)t * N;
  const float* rt = r + (size_t)t * N;
  __shared__ float contrib[CHUNK];
  __shared__ float red[THREADS];
  __shared__ float part[WARPS][COLS];
  float acc = 0.f, dang = 0.f;
  for (int c0 = 0; c0 < N; c0 += CHUNK) {
    const int rows = min(CHUNK, N - c0);
    for (int k = threadIdx.x; k < rows; k += THREADS) {
      const float d = dt[c0 + k], rv = rt[c0 + k];
      contrib[k] = d > 0.f ? rv / fmaxf(d, 1.f) : 0.f;
      dang += rv * (d == 0.f ? at[c0 + k] : 0.f);
    }
    __syncthreads();
    if (j < N) {
      const float* col = A + (size_t)c0 * N + j;
#pragma unroll 4
      for (int k = w; k < rows; k += WARPS) acc += contrib[k] * col[(size_t)k * N];
    }
    __syncthreads();
  }
  part[w][lane] = acc;
  const float dangling = block_sum(dang, red);  // syncs: part is visible
  if (w == 0 && j < N) {
    float nxt = 0.f;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) nxt += part[q][lane];
    const float n = nvec[t];
    r_next[(size_t)t * N + j] = at[j] * (base / n + damping * (nxt + dangling / n));
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// adj: (T, N, N) float32; act: (T, N) float32; out: (T, N) float32 ranks;
// scratch (caller-allocated): deg and rank buffer (T, N) float32 each, nvec
// (T,) float32.  The ranks alternate between out and the buffer, starting
// where the last step lands in out.
int pagerank_launch(const void* adj, const void* act, void* deg, void* nvec,
                    void* buf, void* out, int T, int N, int iters,
                    double damping, void* stream) {
  if (T < 1 || N < 1 || T > 65535 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((N + COLS - 1) / COLS, T);
  float* bufs[2] = {(float*)out, (float*)buf};
  int cur = iters % 2;  // after `iters` swaps the ranks sit in bufs[0]
  setup_kernel<<<grid, THREADS, 0, st>>>((const float*)adj, (const float*)act,
                                         (float*)deg, (float*)nvec, bufs[cur], N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float base = (float)(1.0 - damping), d = (float)damping;
  for (int it = 0; it < iters; ++it, cur ^= 1) {
    step_kernel<<<grid, THREADS, 0, st>>>(
        (const float*)adj, (const float*)act, (const float*)deg,
        (const float*)nvec, bufs[cur], bufs[cur ^ 1], base, d, N);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
