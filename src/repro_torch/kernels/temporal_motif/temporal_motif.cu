// Per-node triangle participation at every timepoint of a dense adjacency
// stack: out[t][j] = (sum_i (A_t A_t)[i][j] * A_t[i][j]) / 2, i.e. the
// column sums of (A.A)oA halved, with A a 0/1 matrix (any nonzero entry is
// an edge).  For a symmetric A with a zero diagonal this is diag(A^3)/2.
//
// Replaces the Pallas TPU kernel _motif_kernel / motif_pallas in
// src/repro/kernels/temporal_motif/temporal_motif.py.
//
// Work: the function needs (A.A)[i][j] only where A[i][j] != 0, 2*N
// operations for each of the nnz edges, against T*N^2 floats read once; on
// sparse graphs the bytes bound it.  This kernel does the dense 2*T*N^3
// multiply-adds all the same (sparse work is a later step).
// Design: a tiled shared-memory product per t; each block
// owns a 64x64 tile of A.A, accumulated in float32 registers (4x4 per
// thread, 16-deep k tiles).  Every entry of A.A is an integer <= N, exact in
// float32 for N < 2^24.  The epilogue multiplies each entry by A[i][j] and
// reduces the tile's columns in int64, then adds them to a per-(t, j) int64
// total with one atomic per column; A.A never reaches device memory.  Integer
// atomics are exact, so the result does not depend on block order.  A second
// small kernel halves the totals into the int32 output.  Any N is taken: the
// edge tiles load zeros past N.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(THREADS)
motif_kernel(const float* __restrict__ adj,
             unsigned long long* __restrict__ total, int N) {
  const int t = blockIdx.z;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const float* A = adj + (size_t)t * N * N;
  __shared__ float As[BK][BM + 1];  // As[k][i] = A[i0 + i][k0 + k]
  __shared__ __align__(16) float Bs[BK][BN];  // Bs[k][j] = A[k0 + k][j0 + j]
  __shared__ unsigned long long red[BM / TM][BN];
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  float c[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TN; ++q) c[r][q] = 0.f;

  for (int k0 = 0; k0 < N; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;  // 16 threads share one row
      const int gi = i0 + r, gk = k0 + kk;
      As[kk][r] =
          (gi < N && gk < N && A[(size_t)gi * N + gk] != 0.f) ? 1.f : 0.f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int kk = e / BN, q = e % BN;
      const int gk = k0 + kk, gj = j0 + q;
      Bs[kk][q] =
          (gk < N && gj < N && A[(size_t)gk * N + gj] != 0.f) ? 1.f : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = As[kk][ty * TM + r];
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        c[r][0] += a[r] * b.x;
        c[r][1] += a[r] * b.y;
        c[r][2] += a[r] * b.z;
        c[r][3] += a[r] * b.w;
      }
    }
    __syncthreads();
  }

  // epilogue: (A.A)[i][j] * A[i][j], summed over this thread's rows
#pragma unroll
  for (int q = 0; q < TN; ++q) {
    const int gj = j0 + tx * TN + q;
    unsigned long long s = 0;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int gi = i0 + ty * TM + r;
      if (gi < N && gj < N && A[(size_t)gi * N + gj] != 0.f)
        s += (unsigned long long)c[r][q];
    }
    red[ty][tx * TN + q] = s;
  }
  __syncthreads();
  if (threadIdx.x < BN) {
    const int gj = j0 + threadIdx.x;
    if (gj < N) {
      unsigned long long s = 0;
#pragma unroll
      for (int y = 0; y < BM / TM; ++y) s += red[y][threadIdx.x];
      if (s) atomicAdd(&total[(size_t)t * N + gj], s);
    }
  }
}

__global__ void halve_kernel(const unsigned long long* __restrict__ total,
                             int32_t* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = (int32_t)(total[i] / 2);
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// adj: (T, N, N) float32; total: (T, N) int64 zeroed by the caller
// (scratch); out: (T, N) int32.
int motif_launch(const void* adj, void* total, void* out, int T, int N,
                 void* stream) {
  if (T < 1 || N < 1 || N >= (1 << 24) || T > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((N + BN - 1) / BN, (N + BM - 1) / BM, T);
  motif_kernel<<<grid, THREADS, 0, st>>>(
      (const float*)adj, (unsigned long long*)total, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)T * N;
  halve_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const unsigned long long*)total, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
