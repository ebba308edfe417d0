// The pack pass shared by the dense analytics kernels (temporal_pagerank,
// temporal_cc), a fixed-order block sum, and the row lists their cluster
// kernels build from the words.
//
// pack_kernel reads a (T, N, N) float32 stack once and writes its column
// words: bit i % 32 of C[t][i / 32][j] is set when A[t][i][j] is an edge
// (PageRank: A != 0; components: A > 0).  The words are uint32, 1/32 of
// the stack, stored word-major so a warp writes 32 consecutive j.  Tail
// bits (rows past N) are zero.  PageRank's pass also writes each column's
// partial sum over the word's 32 rows, P[t][w][j] (rows in order), and
// one flag per block, odd[t][w][x] (x the block's column tile), set when
// some nonzero entry of its tile is not 1.0 (no flag needs resetting
// first; weighted() reduces a timepoint's flags).
//
// One block per (t, 32 rows, 256 columns), as temporal_motif.cu's pack
// pass: the tile's rows are read with aligned 16-byte loads (offsets into
// the whole stack, so any N works: a float4 may straddle two rows, and
// only its elements of the tile are kept; the stack's last float4, when
// T N N is not a multiple of 4, is read element by element) into shared
// memory; thread c then walks the tile's 32 rows of column c.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dense_bits {

constexpr int PACK_THREADS = 256;
constexpr int PR = 32, PC = PACK_THREADS;  // the pack tile: rows x columns
constexpr int SPAN = PC / 4 + 1;           // aligned float4s that cover any PC columns of a row

template <bool PAGERANK>
__global__ void __launch_bounds__(PACK_THREADS)
pack_kernel(const float* __restrict__ adj, uint32_t* __restrict__ cols,
            float* __restrict__ part, int* __restrict__ odd_out, int N, int W) {
  __shared__ __align__(16) float tile[PR][PC];
  const int t = blockIdx.z, i0 = PR * blockIdx.y, j0 = PC * blockIdx.x;
  const int ncol = min(PC, N - j0), nrow = min(PR, N - i0);
  const long long total = (long long)gridDim.z * N * N;  // T N N entries
  for (int f = threadIdx.x; f < nrow * SPAN; f += PACK_THREADS) {
    const int r = f / SPAN, k = f % SPAN;
    const long long start = ((long long)t * N + i0 + r) * N + j0;
    const long long a = (start & ~3ll) + 4ll * k;  // first element of this float4
    if (a >= start + ncol) continue;
    float e[4];
    if (a + 4 <= total) {
      const float4 v = *reinterpret_cast<const float4*>(adj + a);
      e[0] = v.x, e[1] = v.y, e[2] = v.z, e[3] = v.w;
    } else {  // the stack's last, partial float4: no read past its end
#pragma unroll
      for (int c = 0; c < 4; ++c) e[c] = a + c < total ? adj[a + c] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long col = a + c - start;
      if (col >= 0 && col < ncol) tile[r][col] = e[c];
    }
  }
  __syncthreads();
  const int c = threadIdx.x, j = j0 + c;
  uint32_t word = 0;
  float sum = 0.f;
  bool odd = false;
  if (c < ncol) {
    for (int b = 0; b < nrow; ++b) {  // rows past N stay zero bits
      const float v = tile[b][c];
      const bool edge = PAGERANK ? v != 0.f : v > 0.f;
      word |= (uint32_t)edge << b;
      if (PAGERANK) {
        sum += v;
        odd |= edge && v != 1.f;
      }
    }
    const size_t o = ((size_t)t * W + blockIdx.y) * N + j;
    cols[o] = word;
    if (PAGERANK) part[o] = sum;
  }
  if (PAGERANK) {
    const int any = __syncthreads_or(odd);
    if (threadIdx.x == 0)
      odd_out[((size_t)t * W + blockIdx.y) * gridDim.x + blockIdx.x] = any;
  }
}

// Column tiles of the pack pass: the flags a timepoint has are W * tiles(N).
__host__ __device__ inline int tiles(int N) { return (N + PC - 1) / PC; }

// Whether timepoint t's stack holds a nonzero entry other than 1.0: the OR
// of its pack flags.  All threads of the block call it.
__device__ inline bool weighted(const int* odd, int t, int N, int W) {
  const int n = W * tiles(N);
  int any = 0;
  for (int k = threadIdx.x; k < n; k += blockDim.x) any |= odd[(size_t)t * n + k];
  return __syncthreads_or(any) != 0;
}

// Launch the pack pass over the whole stack; the caller checks the error.
template <bool PAGERANK>
void pack(const float* adj, uint32_t* cols, float* part, int* odd, int T, int N, int W,
          cudaStream_t st) {
  const dim3 grid(tiles(N), W, T);
  pack_kernel<PAGERANK><<<grid, PACK_THREADS, 0, st>>>(adj, cols, part, odd, N, W);
}

// Sum of one float per thread in a fixed order (a lane tree, then the
// warps in index order); every thread gets the same bits.  blockDim.x is a
// multiple of 32; red holds blockDim.x / 32 floats.  All threads call it.
__device__ inline float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red is free, and shared stores before the call are visible after it
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int q = 0; q < (int)blockDim.x / 32; ++q) s += red[q];
  return s;
}

// Row lists of the column words a cluster CTA holds in shared memory.
// Thread k < G S (group g = k / S, column c = k % S) owns the set bits of
// column c in words [g WG, g WG + WG); its rows, in increasing order, go to
// list[offs[k] .. offs[k + 1]) as uint16 (N <= 65536).  offs (blockDim.x + 1
// ints) comes from an exclusive scan of the counts in thread order, through
// wsum (blockDim.x / 32 ints).  Returns whether the CTA's rows fit in `cap`
// entries; if not, no list is written and the caller sweeps the bits.  All
// threads call it; it ends with a barrier.
__device__ inline bool build_lists(const uint32_t* words, int W, int S, int G, int ncols,
                                   int* offs, int* wsum, uint16_t* list, int cap) {
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32, WG = (W + G - 1) / G;
  const int g = tid / S, c = tid - g * S;
  const bool mine = tid < G * S && c < ncols;
  const int w0 = g * WG, w1 = min(W, w0 + WG);
  int cnt = 0;
  if (mine)
    for (int w = w0; w < w1; ++w) cnt += __popc(words[w * S + c]);
  int x = cnt;  // inclusive scan within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[wid] = x;
  __syncthreads();
  if (wid == 0) {  // inclusive scan of the warp totals
    int v = lane < (int)blockDim.x / 32 ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane < (int)blockDim.x / 32) wsum[lane] = v;
  }
  __syncthreads();
  const int start = x - cnt + (wid > 0 ? wsum[wid - 1] : 0);
  offs[tid] = start;
  if (tid == (int)blockDim.x - 1) offs[tid + 1] = start + cnt;
  const bool fits = wsum[blockDim.x / 32 - 1] <= cap;
  if (fits && mine) {
    int k = start;
    for (int w = w0; w < w1; ++w)
      for (uint32_t bits = words[w * S + c]; bits; bits &= bits - 1)
        list[k++] = (uint16_t)(32 * w + __ffs(bits) - 1);
  }
  __syncthreads();
  return fits;
}

}  // namespace dense_bits
