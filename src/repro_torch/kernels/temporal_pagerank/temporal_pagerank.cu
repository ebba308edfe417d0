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
// iters * (2 nnz + ~8 T N) float operations, so the bytes of the stack
// bound it (T N^2 * 4 over the memory rate).
// Design: the stack is read from HBM once, by the pack pass
// (dense_bits.cuh): column words C[t][w][j] (A != 0), the partial column
// sums P[t][w][j] of each word's 32 rows, and flags that tell whether a
// timepoint holds a nonzero other than 1.0.  Every iteration then runs over
// the words: on a 0/1 timepoint nxt[j] is the sum of contrib[i] over the
// set bits of column j, and deg is the count of those bits; on a weighted
// one deg sums the partials, and each set bit is multiplied by
// A[t][i][j], read from the stack at the set bits only (kept right, not
// fast).  Two regimes, chosen by the wrapper from N alone (ops.regime):
//  (a) cluster (N <= 3072): one launch runs every iteration of every
//      timepoint.  A cluster of CL = 8 CTAs per timepoint; CTA q owns
//      columns [q S, q S + S), S = ceil(N / 8), and keeps their words in
//      shared memory (W S words, 2.5 KB to 144 KB), beside a full copy of
//      contrib (double-buffered).  Once, each thread turns the set bits of
//      its column and row group into a list of row indices (uint16, in
//      increasing order) when the CTA's rows fit the list room (two rows a
//      word); else it sweeps the bits.  Each iteration a CTA sums its
//      columns over the lists or bits (G row groups per column, combined in
//      order: the same terms in the same order either way), writes
//      its slice of the next contrib into every CTA through distributed
//      shared memory, and each of its warps writes its share of the
//      dangling mass into a slot of every CTA; cluster.sync() separates the
//      iterations, and every warp then sums the slots in one fixed order.
//  (b) stream (N > 3072: 4 MB of words a timepoint and more): a setup
//      launch (deg, n, the first contrib, per-block dangling partials) and
//      one launch per iteration over (column strips of 32, T), with 8 row
//      groups per strip reading the words from L2 or HBM, 8 at a time, and
//      the timepoint's contrib staged in shared memory (8192 rows at once,
//      rows padded to 16 bytes).  Each step writes the next contrib and its
//      block's dangling partial; the next step sums the partials in order.
// Sums run in a fixed order (over increasing i within a thread, row groups
// combined in index order, fixed trees), so two runs give the same bits;
// no float atomics.  N is taken as it is: no padding of the stack.
#include <cooperative_groups.h>

#include "../dense_bits.cuh"

namespace cg = cooperative_groups;

namespace {

// (a) cluster regime
constexpr int CL = 8;    // CTAs of a cluster: one timepoint
constexpr int CT = 512;  // threads of a CTA
constexpr int NW = CT / 32;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory of one block on sm_90
constexpr int WB = 8;             // words a thread loads at once

// acc plus the sum, over the set bits b of `bits` (rows i = 32 w + b, in
// increasing order), of con[i - i0], times Aj[i N] = A[i][j] on a weighted
// stack (WTD); the weights are read four at a time, so their loads overlap.
// WTD is a template parameter so the 0/1 loop carries no weighted code.
template <bool WTD>
__device__ __forceinline__ float bits_sum(float acc, uint32_t bits, int w, const float* con,
                                          int i0, const float* Aj, int N) {
  if (!WTD) {
    while (bits) {
      acc += con[32 * w + __ffs(bits) - 1 - i0];
      bits &= bits - 1;
    }
    return acc;
  }
  while (bits) {
    int i[4];
    float a[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      i[u] = bits ? 32 * w + __ffs(bits) - 1 : -1;
      bits &= bits - 1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] = i[u] >= 0 ? Aj[(size_t)i[u] * N] : 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i[u] >= 0) acc += con[i[u] - i0] * a[u];
  }
  return acc;
}

// acc plus the sum of con[i] over the n rows i of a column's list (in
// increasing order, as bits_sum), times Aj[i N] = A[i][j] on a weighted
// stack (WTD); four rows at a time, so their loads overlap.
template <bool WTD>
__device__ __forceinline__ float list_sum(float acc, const uint16_t* rows, int n,
                                          const float* con, const float* Aj, int N) {
  int k = 0;
  for (; k + 4 <= n; k += 4) {
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = rows[k + u];
      x[u] = WTD ? con[i] * Aj[(size_t)i * N] : con[i];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc += x[u];
  }
  for (; k < n; ++k) {
    const int i = rows[k];
    acc += WTD ? con[i] * Aj[(size_t)i * N] : con[i];
  }
  return acc;
}

// words W*S, contrib 2N, the slice's act, deg and ranks (S each), group
// partials CT, dangling partials 2 CL NW, list offsets CT + 1 and scan
// totals NW (int), then `cap` uint16 list entries
size_t cluster_smem(int N, int W, int S, int cap) {
  return 4 * ((size_t)W * S + 2 * (size_t)N + 3 * (size_t)S + CT + 2 * CL * NW + CT + 1 + NW) +
         2 * (size_t)cap;
}

// Each warp's sum of one value per lane (a fixed tree), written by lane 0
// into slot k of every CTA's dangling-partial array `slots`.
__device__ __forceinline__ void share_warp_sum(cg::cluster_group& cluster, float v,
                                               float* slots, int k) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0)
    for (int p = 0; p < CL; ++p) cluster.map_shared_rank(slots, p)[k] = v;
}

__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(CT)
cluster_kernel(const float* __restrict__ adj, const float* __restrict__ act_g,
               const uint32_t* __restrict__ cols, const float* __restrict__ part,
               const int* __restrict__ odd, float* __restrict__ out, int N,
               int W, int S, int G, int cap, int iters, float base, float damping) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);  // [W][S]
  float* contrib = reinterpret_cast<float*>(words + (size_t)W * S);  // [2][N]
  float* act = contrib + 2 * N;  // the slice's [S]
  float* deg = act + S;
  float* rank = deg + S;
  float* gpart = rank + S;  // [G][S]
  float* dslot = gpart + CT;  // [2][CL][NW]: each warp's dangling partial
  int* offs = reinterpret_cast<int*>(dslot + 2 * CL * NW);  // [CT + 1]
  int* wsum = offs + CT + 1;  // [NW]
  uint16_t* list = reinterpret_cast<uint16_t*>(wsum + NW);  // [cap]
  const int t = blockIdx.y, q = (int)cluster.block_rank(), tid = threadIdx.x;
  const int j0 = q * S, ncols = max(0, min(S, N - j0));
  const int nwc = (S + 31) / 32;  // warps that hold columns (in every CTA)
  const float* At = adj + (size_t)t * N * N;
  const uint32_t* Ct = cols + (size_t)t * W * N;
  const float* Pt = part + (size_t)t * W * N;
  const bool wtd = dense_bits::weighted(odd, t, N, W);
  if (tid < CT / S * S) {  // CT / S rows of words at once (S <= CT)
    const int c = tid % S;
#pragma unroll 4
    for (int w = tid / S; w < W; w += CT / S)
      words[w * S + c] = c < ncols ? Ct[(size_t)w * N + j0 + c] : 0u;
  }
  for (int k = tid; k < 2 * CL * NW; k += CT) dslot[k] = 0.f;
  float live = 0.f;
  for (int i = tid; i < N; i += CT) live += act_g[(size_t)t * N + i];
  const float n = fmaxf(dense_bits::block_sum(live, gpart), 1.f);  // syncs: words are visible
  const float bn = base / n;
  // each thread's rows as a list, when the CTA's rows fit: the iterations
  // then walk the list instead of the bits (the same rows, in the same order)
  const bool lists = dense_bits::build_lists(words, W, S, G, ncols, offs, wsum, list, cap);
  cluster.sync();  // every CTA runs: its shared memory may be written
  // the slice's deg (on a 0/1 stack the popcount of its words, else the
  // column sums of the weights), first ranks act / n and first contrib
  if (tid < 32 * nwc) {  // whole warps: share_warp_sum shuffles
    float dg = 0.f;
    if (tid < ncols) {
      const int j = j0 + tid;
      float d = 0.f;
      if (wtd) {
#pragma unroll 8
        for (int w = 0; w < W; ++w) d += Pt[(size_t)w * N + j];
      } else {  // the column's set bits: its row groups' counts
        for (int g = 0; g < G; ++g) d += (float)(offs[g * S + tid + 1] - offs[g * S + tid]);
      }
      const float a = act_g[(size_t)t * N + j], r0 = a / n;
      act[tid] = a;
      deg[tid] = d;
      rank[tid] = r0;
      dg = r0 * (d == 0.f ? a : 0.f);
      const float cv = d > 0.f ? r0 / fmaxf(d, 1.f) : 0.f;
      for (int p = 0; p < CL; ++p) cluster.map_shared_rank(contrib, p)[j] = cv;
    }
    share_warp_sum(cluster, dg, dslot, q * NW + tid / 32);
  }
  cluster.sync();
  const int WG = (W + G - 1) / G;  // words of a row group
  int cur = 0;
  for (int it = 0; it < iters; ++it, cur ^= 1) {
    const float* cc = contrib + cur * N;
    // the CTAs' warp partials: each warp sums them in one fixed order (lane
    // sums, then a tree), so every warp of every CTA has the same bits
    float dangling = 0.f;
    for (int k = tid % 32; k < CL * NW; k += 32) dangling += dslot[cur * CL * NW + k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dangling += __shfl_xor_sync(0xffffffffu, dangling, o);
    if (tid < G * S) {  // thread (g, c): column j0 + c over words [g WG, g WG + WG)
      const int g = tid / S, c = tid - g * S;
      float acc = 0.f;
      if (c < ncols && lists) {
        const uint16_t* rows = list + offs[tid];
        const int n_rows = offs[tid + 1] - offs[tid];
        acc = wtd ? list_sum<true>(acc, rows, n_rows, cc, At + j0 + c, N)
                  : list_sum<false>(acc, rows, n_rows, cc, At + j0 + c, N);
      } else if (c < ncols) {
        const int w1 = min(W, (g + 1) * WG);
        for (int w = g * WG; w < w1; w += WB) {
          uint32_t bw[WB];
#pragma unroll
          for (int u = 0; u < WB; ++u) bw[u] = w + u < w1 ? words[(w + u) * S + c] : 0u;
#pragma unroll
          for (int u = 0; u < WB; ++u)
            acc = wtd ? bits_sum<true>(acc, bw[u], w + u, cc, 0, At + j0 + c, N)
                      : bits_sum<false>(acc, bw[u], w + u, cc, 0, At + j0 + c, N);
        }
      }
      gpart[tid] = acc;
    }
    __syncthreads();
    if (tid < 32 * nwc) {
      float dn = 0.f;
      if (tid < ncols) {
        float nxt = gpart[tid];
        for (int g = 1; g < G; ++g) nxt += gpart[g * S + tid];
        const float a = act[tid], d = deg[tid];
        const float v = a * (bn + damping * (nxt + dangling / n));
        rank[tid] = v;
        dn = v * (d == 0.f ? a : 0.f);
        const float cv = d > 0.f ? v / fmaxf(d, 1.f) : 0.f;
        float* nc = contrib + (cur ^ 1) * N;
        for (int p = 0; p < CL; ++p) cluster.map_shared_rank(nc, p)[j0 + tid] = cv;
      }
      share_warp_sum(cluster, dn, dslot + (cur ^ 1) * CL * NW, q * NW + tid / 32);
    }
    cluster.sync();
  }
  if (tid < ncols) out[(size_t)t * N + j0 + tid] = rank[tid];
}

// (b) stream regime: blocks of SC columns x SG row groups
constexpr int SC = 32, SG = 8, ST = SC * SG;
constexpr int CH = 8192;  // rows whose contrib a step block stages at once (32 KB)

// Rows padded to a multiple of 4 floats, so a row's contrib is read in
// 16-byte words.
__host__ __device__ inline int padded(int N) { return (N + 3) & ~3; }

// deg, n, r0 = act / n (also into out, for iters = 0), contrib0 and the
// blocks' dangling partials.
__global__ void __launch_bounds__(ST)
setup_kernel(const float* __restrict__ part, const float* __restrict__ act,
             const int* __restrict__ odd, int* __restrict__ wt, float* __restrict__ deg,
             float* __restrict__ nvec, float* __restrict__ contrib,
             float* __restrict__ dpart, float* __restrict__ out, int N, int W, int nb) {
  __shared__ float gsum[SG][SC];
  __shared__ float red[ST / 32];
  const int t = blockIdx.y, c = threadIdx.x % SC, g = threadIdx.x / SC;
  const int j = blockIdx.x * SC + c;
  const float* at = act + (size_t)t * N;
  if (blockIdx.x == 0) {  // the timepoint's flag, for the steps
    const bool w = dense_bits::weighted(odd, t, N, W);
    if (threadIdx.x == 0) wt[t] = w;
  }
  float live = 0.f;
#pragma unroll 8
  for (int i = threadIdx.x; i < N; i += ST) live += at[i];
  const float n = fmaxf(dense_bits::block_sum(live, red), 1.f);
  const int WG = (W + SG - 1) / SG, w1 = min(W, (g + 1) * WG);
  float s = 0.f;
  if (j < N) {
#pragma unroll 8
    for (int w = g * WG; w < w1; ++w) s += part[((size_t)t * W + w) * N + j];
  }
  gsum[g][c] = s;
  __syncthreads();
  float dg = 0.f;
  if (g == 0 && j < N) {
    float d = gsum[0][c];
#pragma unroll
    for (int q = 1; q < SG; ++q) d += gsum[q][c];
    const size_t o = (size_t)t * N + j;
    const float r0 = at[j] / n;
    deg[o] = d;
    out[o] = r0;
    contrib[(size_t)t * padded(N) + j] = d > 0.f ? r0 / fmaxf(d, 1.f) : 0.f;
    dg = r0 * (d == 0.f ? at[j] : 0.f);
  }
  const float bsum = dense_bits::block_sum(dg, red);
  if (threadIdx.x == 0) {
    dpart[(size_t)t * nb + blockIdx.x] = bsum;
    if (blockIdx.x == 0) nvec[t] = n;
  }
}

// One power-iteration step over the words: contrib, dangling partials ->
// r (into out), next contrib, next partials.
__global__ void __launch_bounds__(ST)
step_kernel(const float* __restrict__ adj, const uint32_t* __restrict__ cols,
            const int* __restrict__ wt, const float* __restrict__ act,
            const float* __restrict__ deg, const float* __restrict__ nvec,
            const float* __restrict__ contrib, const float* __restrict__ dpart,
            float* __restrict__ contrib_next, float* __restrict__ dpart_next,
            float* __restrict__ out, float base, float damping, int N, int W, int nb) {
  __shared__ float gsum[SG][SC];
  __shared__ float red[ST / 32];
  __shared__ __align__(16) float cs[CH];
  const int t = blockIdx.y, c = threadIdx.x % SC, g = threadIdx.x / SC;
  const int j = blockIdx.x * SC + c;
  const bool wtd = wt[t] != 0;
  const float* ct = contrib + (size_t)t * padded(N);
  const uint32_t* Ct = cols + (size_t)t * W * N;
  const float* At = adj + (size_t)t * N * N;
  // this thread's share of the blocks' dangling partials, loaded now and
  // summed (in a fixed order) after the sweep, so the loads overlap it
  float ds = 0.f;
  for (int b = threadIdx.x; b < nb; b += ST) ds += dpart[(size_t)t * nb + b];
  float acc = 0.f;
  for (int c0 = 0; c0 < N; c0 += CH) {  // rows c0..c0 + CH - 1: words c0 / 32..
    const int rows = min(CH, N - c0), cw0 = c0 / 32, cwn = (rows + 31) / 32;
    __syncthreads();  // the last chunk's readers are done
#pragma unroll 4
    for (int k = threadIdx.x; k < (rows + 3) / 4; k += ST)
      reinterpret_cast<float4*>(cs)[k] = reinterpret_cast<const float4*>(ct + c0)[k];
    __syncthreads();
    const int WG = (cwn + SG - 1) / SG;
    const int w0 = cw0 + g * WG, w1 = cw0 + min(cwn, (g + 1) * WG);
    if (j >= N) continue;
    for (int w = w0; w < w1; w += WB) {
      uint32_t bw[WB];
#pragma unroll
      for (int u = 0; u < WB; ++u) bw[u] = w + u < w1 ? __ldg(Ct + (size_t)(w + u) * N + j) : 0u;
#pragma unroll
      for (int u = 0; u < WB; ++u)
        acc = wtd ? bits_sum<true>(acc, bw[u], w + u, cs, c0, At + j, N)
                  : bits_sum<false>(acc, bw[u], w + u, cs, c0, At + j, N);
    }
  }
  gsum[g][c] = acc;
  const float dangling = dense_bits::block_sum(ds, red);  // syncs: gsum is visible
  float dg = 0.f;
  if (g == 0 && j < N) {
    float nxt = gsum[0][c];
#pragma unroll
    for (int q = 1; q < SG; ++q) nxt += gsum[q][c];
    const size_t o = (size_t)t * N + j;
    const float n = nvec[t], a = act[o], d = deg[o];
    const float v = a * (base / n + damping * (nxt + dangling / n));
    out[o] = v;
    contrib_next[(size_t)t * padded(N) + j] = d > 0.f ? v / fmaxf(d, 1.f) : 0.f;
    dg = v * (d == 0.f ? a : 0.f);
  }
  const float bsum = dense_bits::block_sum(dg, red);
  if (threadIdx.x == 0) dpart_next[(size_t)t * nb + blockIdx.x] = bsum;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// adj: (T, N, N) float32, 16-byte aligned; act: (T, N) float32; out: (T, N)
// float32 ranks.  Scratch (caller-allocated, no initial value needed):
// words and part, T * ceil(N / 32) * N uint32 / float32 each; flags,
// T * ceil(N / 32) * ceil(N / 256) + T int32.  regime 0 (cluster) needs
// nothing more (the other pointers may be null); regime 1 (stream) also
// deg (T, N), nvec (T,), contrib 2 T padded(N) (rows padded to a multiple
// of 4) and dpart 2 T ceil(N / 32), float32.  regime 0 returns
// cudaErrorInvalidValue when a timepoint does not fit a cluster.
int pagerank_launch(const void* adj, const void* act, void* out, void* words,
                    void* part, void* flags, void* deg, void* nvec, void* contrib,
                    void* dpart, int T, int N, int iters, double damping,
                    int regime, void* stream) {
  if (T < 1 || N < 1 || T > 65535 || iters < 0 || (uintptr_t)adj % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int W = (N + 31) / 32;
  const float base = (float)(1.0 - damping), d = (float)damping;
  dense_bits::pack<true>((const float*)adj, (uint32_t*)words, (float*)part, (int*)flags,
                         T, N, W, st);
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
    cluster_kernel<<<dim3(CL, T), CT, smem, st>>>(
        (const float*)adj, (const float*)act, (const uint32_t*)words, (const float*)part,
        (const int*)flags, (float*)out, N, W, S, G, cap, iters, base, d);
    return (int)cudaGetLastError();
  }
  if (regime != 1) return (int)cudaErrorInvalidValue;
  const int nb = (N + SC - 1) / SC;
  float* cb[2] = {(float*)contrib, (float*)contrib + (size_t)T * padded(N)};
  float* db[2] = {(float*)dpart, (float*)dpart + (size_t)T * nb};
  const dim3 grid(nb, T);
  int* wt = (int*)flags + (size_t)T * W * dense_bits::tiles(N);
  setup_kernel<<<grid, ST, 0, st>>>((const float*)part, (const float*)act, (const int*)flags,
                                    wt, (float*)deg, (float*)nvec, cb[0], db[0], (float*)out,
                                    N, W, nb);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  for (int it = 0; it < iters; ++it) {
    const int k = it % 2;
    step_kernel<<<grid, ST, 0, st>>>(
        (const float*)adj, (const uint32_t*)words, (const int*)wt, (const float*)act,
        (const float*)deg, (const float*)nvec, cb[k], db[k], cb[k ^ 1], db[k ^ 1],
        (float*)out, base, d, N, W, nb);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
