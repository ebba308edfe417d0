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
// are few against those bytes, so the bytes of the stack bound it.
// Design: the stack is read from HBM once, by the pack pass
// (dense_bits.cuh), into column words C[t][w][j] (A > 0): only the edge
// pattern matters, so weights need no second read.  The rounds run over
// the words; for each set bit i of column j, m = min(m, prev[i]).  Min is
// exact and order-free, so the result is bit-identical to the plain
// version.  Early exit: labels only fall, so once a round changes nothing
// at timepoint t every later round would change nothing either; t stops
// there.  Two regimes, chosen by the wrapper from N alone (ops.regime):
//  (a) cluster (N <= 3072): one launch runs every round of every
//      timepoint.  A cluster of CL = 8 CTAs per timepoint; CTA q owns
//      columns [q S, q S + S), S = ceil(N / 8), keeps their words in
//      shared memory beside two full label buffers, turns them once into
//      lists of row indices when they fit (dense_bits::build_lists; else
//      the rounds sweep the bits), and writes its slice
//      of the new labels into every CTA's buffer through distributed
//      shared memory.  Each CTA also writes whether its slice changed into
//      every CTA; after cluster.sync() all CTAs read the same flags and
//      stop together.
//  (b) stream (N > 3072): one launch per round over (column strips of 32,
//      T), 8 row groups per strip reading the words from L2 or HBM, 8 at a
//      time, with the timepoint's previous labels staged in shared memory
//      (8192 rows at once, rows padded to 16 bytes); a per-(round, t) flag
//      ends a timepoint, whose blocks then return at once (both label
//      buffers already hold its final labels).
// Any N is taken: the stack is not padded.
#include <cooperative_groups.h>

#include "../dense_bits.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;    // CTAs of a cluster: one timepoint
constexpr int CT = 512;  // threads of a CTA
constexpr int SMEM_MAX = 232448;  // dynamic shared memory of one block on sm_90
constexpr int WB = 8;             // words a thread loads at once

// m lowered to the least lab[i - i0] over the set bits b of `bits` (rows
// i = 32 w + b).
__device__ __forceinline__ int32_t bits_min(int32_t m, uint32_t bits, int w,
                                            const int32_t* lab, int i0) {
  while (bits) {
    m = min(m, lab[32 * w + __ffs(bits) - 1 - i0]);
    bits &= bits - 1;
  }
  return m;
}

// m lowered to the least lab[i] over the n rows i of a column's list.
__device__ __forceinline__ int32_t list_min(int32_t m, const uint16_t* rows, int n,
                                            const int32_t* lab) {
  int k = 0;
  for (; k + 4 <= n; k += 4)
    m = min(min(m, min(lab[rows[k]], lab[rows[k + 1]])),
            min(lab[rows[k + 2]], lab[rows[k + 3]]));
  for (; k < n; ++k) m = min(m, lab[rows[k]]);
  return m;
}

// words W*S, label buffers 2N, act N, group minima CT, change flags 2 CL,
// list offsets CT + 1 and scan totals CT / 32, then `cap` uint16 list entries
size_t cluster_smem(int N, int W, int S, int cap) {
  return 4 * ((size_t)W * S + 3 * (size_t)N + CT + 2 * CL + CT + 1 + CT / 32) + 2 * (size_t)cap;
}

__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(CT)
cluster_kernel(const float* __restrict__ act_g, const uint32_t* __restrict__ cols,
               int32_t* __restrict__ out, int N, int W, int S, int G, int cap, int iters) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);  // [W][S]
  int32_t* lab = reinterpret_cast<int32_t*>(words + (size_t)W * S);  // [2][N]
  int32_t* act = lab + 2 * N;
  int32_t* gmin = act + N;  // [G][S]
  int32_t* chg = gmin + CT;  // [2][CL]
  int* offs = chg + 2 * CL;  // [CT + 1]
  int* wsum = offs + CT + 1;  // [CT / 32]
  uint16_t* list = reinterpret_cast<uint16_t*>(wsum + CT / 32);  // [cap]
  const int t = blockIdx.y, q = (int)cluster.block_rank(), tid = threadIdx.x;
  const int j0 = q * S, ncols = max(0, min(S, N - j0));
  const uint32_t* Ct = cols + (size_t)t * W * N;
  if (tid < CT / S * S) {  // CT / S rows of words at once (S <= CT)
    const int c = tid % S;
#pragma unroll 4
    for (int w = tid / S; w < W; w += CT / S)
      words[w * S + c] = c < ncols ? Ct[(size_t)w * N + j0 + c] : 0u;
  }
  for (int i = tid; i < N; i += CT) {
    act[i] = act_g[(size_t)t * N + i] != 0.f;
    lab[i] = act[i] ? i : N;
  }
  __syncthreads();  // words are visible
  // each thread's rows as a list, when the CTA's rows fit: the rounds then
  // walk the list instead of the bits
  const bool lists = dense_bits::build_lists(words, W, S, G, ncols, offs, wsum, list, cap);
  cluster.sync();  // every CTA runs: its shared memory may be written
  const int WG = (W + G - 1) / G;  // words of a row group
  int cur = 0;
  for (int round = 0; round < iters; ++round) {
    const int32_t* lc = lab + cur * N;
    int32_t* ln = lab + (cur ^ 1) * N;
    if (tid < G * S) {  // thread (g, c): column j0 + c over words [g WG, g WG + WG)
      const int g = tid / S, c = tid - g * S;
      int32_t m = N;
      if (c < ncols && lists) {
        m = list_min(m, list + offs[tid], offs[tid + 1] - offs[tid], lc);
      } else if (c < ncols) {
        const int w1 = min(W, (g + 1) * WG);
        for (int w = g * WG; w < w1; w += WB) {
          uint32_t bw[WB];
#pragma unroll
          for (int u = 0; u < WB; ++u) bw[u] = w + u < w1 ? words[(w + u) * S + c] : 0u;
#pragma unroll
          for (int u = 0; u < WB; ++u) m = bits_min(m, bw[u], w + u, lc, 0);
        }
      }
      gmin[tid] = m;
    }
    __syncthreads();
    bool moved = false;
    for (int c = tid; c < ncols; c += CT) {
      int32_t m = gmin[c];
      for (int g = 1; g < G; ++g) m = min(m, gmin[g * S + c]);
      const int j = j0 + c;
      const int32_t now = min(lc[j], m);
      moved |= now != lc[j];
      for (int p = 0; p < CL; ++p) cluster.map_shared_rank(ln, p)[j] = now;
    }
    const int any = __syncthreads_or(moved);
    if (tid < CL) cluster.map_shared_rank(chg, tid)[(round & 1) * CL + q] = any;
    cluster.sync();
    cur ^= 1;
    bool done = true;
    for (int p = 0; p < CL; ++p) done &= chg[(round & 1) * CL + p] == 0;
    if (done) break;  // the same flags in every CTA: the cluster stops together
  }
  for (int c = tid; c < ncols; c += CT) {
    const int j = j0 + c;
    out[(size_t)t * N + j] = act[j] ? lab[cur * N + j] : -1;
  }
}

// (b) stream regime: blocks of SC columns x SG row groups
constexpr int SC = 32, SG = 8, ST = SC * SG;
constexpr int CH = 8192;  // rows whose labels a round block stages at once (32 KB)

// Label rows padded to a multiple of 4, so a row is read in 16-byte words.
__host__ __device__ inline int padded(int N) { return (N + 3) & ~3; }

__global__ void init_kernel(const float* __restrict__ act, int32_t* __restrict__ lab,
                            int T, int N) {
  const long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const int NP = padded(N), t = (int)(k / NP), j = (int)(k % NP);
  if (t < T && j < N) lab[k] = act[(size_t)t * N + j] != 0.f ? j : N;
}

__global__ void __launch_bounds__(ST)
round_kernel(const uint32_t* __restrict__ cols, const int32_t* __restrict__ lab,
             int32_t* __restrict__ lab_next, int32_t* __restrict__ changed,
             int round, int T, int N, int W) {
  const int t = blockIdx.y;
  // converged at t: lab and lab_next are equal already (uniform per block)
  if (round > 0 && changed[(size_t)(round - 1) * T + t] == 0) return;
  __shared__ int32_t gmin[SG][SC];
  __shared__ __align__(16) int32_t ls[CH];
  const int c = threadIdx.x % SC, g = threadIdx.x / SC;
  const int j = blockIdx.x * SC + c;
  const int32_t* lt = lab + (size_t)t * padded(N);
  const uint32_t* Ct = cols + (size_t)t * W * N;
  int32_t m = N;
  for (int c0 = 0; c0 < N; c0 += CH) {  // rows c0..c0 + CH - 1: words c0 / 32..
    const int rows = min(CH, N - c0), cw0 = c0 / 32, cwn = (rows + 31) / 32;
    __syncthreads();  // the last chunk's readers are done
#pragma unroll 4
    for (int k = threadIdx.x; k < (rows + 3) / 4; k += ST)
      reinterpret_cast<int4*>(ls)[k] = reinterpret_cast<const int4*>(lt + c0)[k];
    __syncthreads();
    const int WG = (cwn + SG - 1) / SG;
    const int w0 = cw0 + g * WG, w1 = cw0 + min(cwn, (g + 1) * WG);
    if (j >= N) continue;
    for (int w = w0; w < w1; w += WB) {
      uint32_t bw[WB];
#pragma unroll
      for (int u = 0; u < WB; ++u) bw[u] = w + u < w1 ? __ldg(Ct + (size_t)(w + u) * N + j) : 0u;
#pragma unroll
      for (int u = 0; u < WB; ++u) m = bits_min(m, bw[u], w + u, ls, c0);
    }
  }
  gmin[g][c] = m;
  __syncthreads();
  if (g == 0 && j < N) {
#pragma unroll
    for (int q = 1; q < SG; ++q) m = min(m, gmin[q][c]);
    const int32_t old = lt[j], now = min(old, m);
    lab_next[(size_t)t * padded(N) + j] = now;
    if (now != old) changed[(size_t)round * T + t] = 1;
  }
}

__global__ void final_kernel(const float* __restrict__ act,
                             const int32_t* __restrict__ lab,
                             int32_t* __restrict__ out, int T, int N) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)T * N) return;
  const int t = (int)(i / N), j = (int)(i % N);
  out[i] = act[i] != 0.f ? lab[(size_t)t * padded(N) + j] : -1;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// adj: (T, N, N) float32, 16-byte aligned; act: (T, N) float32; out: (T, N)
// int32 labels.  Scratch (caller-allocated, no initial value needed): words,
// T * ceil(N / 32) * N uint32.  regime 0 (cluster) needs nothing more (the
// other pointers may be null); regime 1 (stream) also two T padded(N) int32
// label buffers (rows padded to a multiple of 4) and an (iters, T) int32
// flag array.  regime 0 returns cudaErrorInvalidValue when a timepoint does
// not fit a cluster.
int cc_launch(const void* adj, const void* act, void* out, void* words,
              void* lab_a, void* lab_b, void* changed, int T, int N, int iters,
              int regime, void* stream) {
  if (T < 1 || N < 1 || T > 65535 || iters < 0 || (uintptr_t)adj % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int W = (N + 31) / 32;
  dense_bits::pack<false>((const float*)adj, (uint32_t*)words, nullptr, nullptr, T, N, W, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (regime == 0) {
    const int S = (N + CL - 1) / CL;
    // list room for up to two rows a word (6.25% dense), within the limit
    const int cap = (int)min((size_t)2 * W * S,
                             (SMEM_MAX - min((size_t)SMEM_MAX, cluster_smem(N, W, S, 0))) / 2);
    const size_t smem = cluster_smem(N, W, S, cap);
    if (S > CT || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int G = max(1, min(W, CT / S));  // row groups a column is split into
    cluster_kernel<<<dim3(CL, T), CT, smem, st>>>((const float*)act, (const uint32_t*)words,
                                                  (int32_t*)out, N, W, S, G, cap, iters);
    return (int)cudaGetLastError();
  }
  if (regime != 1) return (int)cudaErrorInvalidValue;
  if (iters > 0 && (e = cudaMemsetAsync(changed, 0, sizeof(int32_t) * (size_t)iters * T, st))
                       != cudaSuccess)
    return (int)e;
  int32_t* bufs[2] = {(int32_t*)lab_a, (int32_t*)lab_b};
  init_kernel<<<(unsigned)(((long long)T * padded(N) + 255) / 256), 256, 0, st>>>(
      (const float*)act, bufs[0], T, N);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const dim3 grid((N + SC - 1) / SC, T);
  for (int r = 0; r < iters; ++r) {
    round_kernel<<<grid, ST, 0, st>>>((const uint32_t*)words, bufs[r % 2], bufs[(r + 1) % 2],
                                      (int32_t*)changed, r, T, N, W);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  final_kernel<<<(unsigned)(((long long)T * N + 255) / 256), 256, 0, st>>>(
      (const float*)act, bufs[iters % 2], (int32_t*)out, T, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
