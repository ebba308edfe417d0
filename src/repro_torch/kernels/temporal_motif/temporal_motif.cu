// Per-node triangle participation at every timepoint of a dense adjacency
// stack: out[t][j] = (sum_i (A_t A_t)[i][j] * A_t[i][j]) / 2, i.e. the
// column sums of (A.A)oA halved, with A a 0/1 matrix (any nonzero entry is
// an edge).  For a symmetric A with a zero diagonal this is diag(A^3)/2;
// the kernel is exact for any pattern (asymmetric, a set diagonal).
//
// Replaces the Pallas TPU kernel _motif_kernel / motif_pallas in
// src/repro/kernels/temporal_motif/temporal_motif.py.
//
// Work: the function needs (A.A)[i][j] only where A[i][j] != 0, and over
// 0/1 entries that is popc(row_i & col_j) of the bit-packed row i and
// column j: nnz * W word ANDs (W = ceil(N / 32)), against T*N^2 floats
// read once.  The bytes bound it; the dense product the Pallas kernel runs
// (2*T*N^3) would discard 98% of its products at 2% density.
// Design: two passes, no atomics.
//  1. pack: one block per (t, 32 rows, 256 columns).  The block reads the
//     tile's rows with aligned 16-byte loads (offsets into the whole stack,
//     so any N works: a float4 may straddle two rows, and only its
//     elements of the tile are kept; the stack's last float4, when T N N
//     is not a multiple of 4, is read element by element), as 0/1 bytes in
//     shared memory.  Warp w takes the tile's columns 32 w..32 w + 31: a
//     ballot per row gives the row word R[t][i][w], each lane's own 32
//     flags the column word C[t][w][j] (stored word-major, so a warp
//     writes 32 consecutive j).
//     Row words go out through shared memory, 8 consecutive words a row.
//     Tail bits past N are zero.  R and C (uint32, T*N*W each: 16.8 MB
//     together at T=4 N=4096) stay in L2 for the second pass.
//  2. count: one warp per (t, j), column j's W words held in registers
//     (W <= 32 * WPL).  For each set bit i of column j, the lanes split the
//     W words of popc(R[t][i][w] & C[t][w][j]); edges go two at a time so
//     their row loads overlap.  One warp sum at the end, halved into the
//     int32 output.  Integer sums: exact, and the same bits on every run.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;          // warps of a block
constexpr int PR = 32, PC = 256;  // the pack pass's tile: rows x columns
constexpr int SPAN = PC / 4 + 1;  // aligned float4s that cover any PC columns of a row
constexpr int MAX_N = 32 * 32 * 32;  // W <= 1024: the count pass's widest column

__global__ void __launch_bounds__(32 * WARPS)
pack_kernel(const float* __restrict__ adj, uint32_t* __restrict__ rows,
            uint32_t* __restrict__ cols, int N, int W) {
  __shared__ __align__(16) uint8_t tile[PR][PC];
  __shared__ uint32_t row_words[PR][PC / 32];
  const int t = blockIdx.z, i0 = PR * blockIdx.y, j0 = PC * blockIdx.x;
  for (int f = threadIdx.x; f < PR * PC / 16; f += 32 * WARPS)
    reinterpret_cast<uint4*>(&tile[0][0])[f] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int ncol = min(PC, N - j0);
  const long long total = (long long)gridDim.z * N * N;  // T N N entries
  for (int f = threadIdx.x; f < PR * SPAN; f += 32 * WARPS) {
    const int r = f / SPAN, k = f % SPAN;
    if (i0 + r >= N) continue;
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
      if (col >= 0 && col < ncol) tile[r][col] = e[c] != 0.f;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  uint32_t row = 0, col = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const uint32_t f = tile[b][32 * w + lane];
    const uint32_t bits = __ballot_sync(0xffffffffu, f);  // row i0 + b
    if (lane == b) row = bits;
    col |= f << b;  // column j0 + 32 w + lane, rows i0..i0 + 31
  }
  row_words[lane][w] = row;
  const int j = j0 + 32 * w + lane;
  if (j < N) cols[((size_t)t * W + blockIdx.y) * N + j] = col;
  __syncthreads();
  const int r = threadIdx.x / WARPS, ww = threadIdx.x % WARPS, wj = j0 / 32 + ww;
  if (i0 + r < N && wj < W) rows[((size_t)t * N + i0 + r) * W + wj] = row_words[r][ww];
}

template <int WPL>
__global__ void __launch_bounds__(32 * WARPS)
count_kernel(const uint32_t* __restrict__ rows, const uint32_t* __restrict__ cols,
             int32_t* __restrict__ out, int T, int N, int W) {
  const long long task = (long long)blockIdx.x * WARPS + threadIdx.x / 32;  // t * N + j
  if (task >= (long long)T * N) return;
  const int lane = threadIdx.x % 32;
  const int t = (int)(task / N), j = (int)(task % N);
  const uint32_t* R = rows + (size_t)t * N * W;
  uint32_t cw[WPL];  // word lane + 32 u of column j
#pragma unroll
  for (int u = 0; u < WPL; ++u)
    cw[u] = lane + 32 * u < W ? cols[((size_t)t * W + lane + 32 * u) * N + j] : 0u;
  unsigned long long total = 0;
#pragma unroll
  for (int u = 0; u < WPL; ++u) {
    for (int src = 0; src < 32 && 32 * u + src < W; ++src) {
      uint32_t word = __shfl_sync(0xffffffffu, cw[u], src);  // rows 32 (32 u + src)..
      const int base = 32 * (32 * u + src);
      while (word) {
        const uint32_t* R1 = R + (size_t)(base + __ffs(word) - 1) * W;
        word &= word - 1;
        const uint32_t* R2 = R1;  // a second edge, or R1 again with its words masked off
        uint32_t second = 0;
        if (word) {
          R2 = R + (size_t)(base + __ffs(word) - 1) * W;
          word &= word - 1;
          second = 0xffffffffu;
        }
        uint32_t c = 0;
#pragma unroll
        for (int v = 0; v < WPL; ++v) {
          const int w = lane + 32 * v;
          if (w < W) c += __popc(R1[w] & cw[v]) + __popc(R2[w] & cw[v] & second);
        }
        total += c;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
  if (lane == 0) out[task] = (int32_t)(total / 2);
}

template <int WPL>
void count(const uint32_t* rows, const uint32_t* cols, int32_t* out, int T, int N, int W,
           cudaStream_t st) {
  if (W > 32 * WPL) return count<2 * WPL>(rows, cols, out, T, N, W, st);
  const unsigned blocks = (unsigned)(((long long)T * N + WARPS - 1) / WARPS);
  count_kernel<WPL><<<blocks, 32 * WARPS, 0, st>>>(rows, cols, out, T, N, W);
}
template <>
void count<64>(const uint32_t*, const uint32_t*, int32_t*, int, int, int, cudaStream_t) {}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// adj: (T, N, N) float32, 16-byte aligned; scratch: 2 * T * N * ceil(N / 32)
// uint32 (the row words, then the column words; no initial value needed);
// out: (T, N) int32.
int motif_launch(const void* adj, void* scratch, void* out, int T, int N, void* stream) {
  if (T < 1 || N < 1 || N > MAX_N || T > 65535 || (uintptr_t)adj % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int W = (N + 31) / 32;
  uint32_t* rows = static_cast<uint32_t*>(scratch);
  uint32_t* cols = rows + (size_t)T * N * W;
  const dim3 grid((N + PC - 1) / PC, (N + PR - 1) / PR, T);
  pack_kernel<<<grid, 32 * WARPS, 0, st>>>(static_cast<const float*>(adj), rows, cols, N, W);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  count<1>(rows, cols, static_cast<int32_t*>(out), T, N, W, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
