// Flash attention with position masks: for every (b, h) and query i,
//   out[i] = softmax_j(scale * q[i] . k[j] over the allowed j) @ v
// where key j is allowed for query i iff k_pos[j] >= 0 (-1 is a hole of a
// ring cache), k_pos[j] <= q_pos[i] when causal, and
// k_pos[j] > q_pos[i] - window when window > 0.  A query with no allowed
// key gives 0.  scale = D^-1/2.  q, k, v: (B, H, S, D) with any strides on
// B, H and S and unit stride on D; out has q's type.  Any Sq and Sk; D a
// multiple of 16 up to 256.
//
// Replaces the Pallas TPU kernel _fa_kernel / flash_attention_pallas in
// src/repro/kernels/flash_attention/flash_attention.py (grid (B, H, nq,
// nk), the KV axis sequential, m, l and the accumulator in VMEM), without
// its padding of S to the block size.
//
// Bound: 4 D operations per allowed (query, key) pair against reading q,
// k and v and writing out once: at D = 256 the operations bound it by far.
// Two kernels, chosen by the input type (a fixed dispatch, not a fallback):
//
// fa_wgmma<DP>, bfloat16 (the serving path): the products on the tensor
// cores, as the bf16 rate bounds them.  One block per (128-query tile, h,
// b) with three warpgroups: a producer warp issues TMA loads (Q once; K and
// V tiles of 64 keys through a 2-stage ring of mbarriers), two consumer
// warpgroups own 64 query rows each (setmaxnreg moves the registers to
// them: the producer drops to 24 a thread and the consumers rise to 240,
// which is the 168 x 384 the block holds; a 64 x DP f32 O accumulator is
// DP / 2 of them).  With each tile the producer fills a slot of the stage:
// the tile's key positions, their range and whether any is a hole, so the
// consumers read no k_pos from device memory and never visit a tile the
// block skips; a last slot with no tile ends the stream.
// S = Q K^T is wgmma m64n64k16 with both operands in shared memory,
// K-major; the online softmax runs on the accumulator fragments (row max
// and sum over the 4 lanes of a quad, exp2 on scores pre-scaled by
// scale * log2 e); P is rounded to bf16 in registers and is the A operand
// of O += P V, one m64nDPk16 per 16 keys with V read from shared memory
// MN-major (the transpose bit), its DP / 64 atoms 8 KB apart.  P
// in bf16 is what the reference's model path multiplies
// (src/repro/models/attention.py, blockwise_attention); the row sums l
// add the f32 p, as there.  O is rescaled only when some row of the warp
// has a new max (alpha != 1): past the first tiles of a row it rarely
// does.  The epilogue stages each warpgroup's O / l rows in its own rows
// of the Q tile, then writes each row's D * 2 bytes 16 bytes a thread.
// Tiles use the 128-byte swizzle that TMA writes and the wgmma
// descriptors read; D is compiled at 64, 128 and 256 (DP),
// a smaller D zero-filled by TMA past D and never stored.  Tensor maps are
// 4-D (D, S, H, B) over the tensors' own strides; a stride-0 axis (MQA's
// expanded KV head) is passed as length 1 and the kernel maps h to it.
// The producer tests each tile's key positions against the block's 128
// queries: a tile no query may see is never loaded; a consumer warpgroup
// also skips the tiles none of its 64 rows sees, runs a tile every row
// sees whole without the per-element mask, and masks per element only the
// tiles that straddle a mask edge.  No atomics:
// two runs give the same bits.  Shared memory at DP = 256: Q 64 KB + 2 x
// (K 32 KB + V 32 KB) = 192 KB, one block per SM.
//
// fa_kernel<DP>, float32 (the exact path, 2e-5): the products on the
// tensor cores in 3xTF32.  One TF32 product keeps 11 significant bits, too
// few for 2e-5; so each operand is split, a = hi + lo with hi and lo
// rounded to TF32 as cvt.rna.tf32.f32 rounds (hi from a, lo from a - hi;
// done in two integer operations), and every product is lo.hi + hi.lo +
// hi.hi summed in float32 (mma.sync m16n8k8 .tf32, the small terms first):
// float32 accuracy at a third of the 495 TFLOP/s TF32 rate, which bounds
// it (3 x 4 D operations a pair).  One block of 8 warps per (64-query
// tile, h, b): Q copied once, key tiles of 32 through a 2-stage cp.async
// ring of K and V; two warps share each 16 rows and take 16 keys of a tile
// each (they swap row maxima, keep their own sums and add them at the
// end), so each scheduler has two warps to switch between.  S and P V on
// mma.sync with the split done as fragments are read from shared memory
// (rows DP + 4 floats apart: no bank conflicts), P split in registers; the
// online softmax in float32 on the accumulator fragments.  The block lists
// the key tiles it may see first (tile_hidden), so a hidden tile is never
// loaded; a warp pair skips a tile none of its rows sees and masks per
// element only a tile that straddles a mask edge.  DP = 32, 64, 128, 256
// compiled; 205 KB of shared memory at DP = 256.
//
// The backward (the port's own: the reference differentiates its jnp
// attention), launches in stream order, chosen by type as the forward.  With
// P = exp(scale S - lse) under the masks, delta = rowsum(dO * O) and dS =
// P (dP - delta): dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K.  Bound:
// 10 D operations a pair (S and dP recomputed, three updates); these
// kernels do 14 D, as the dQ kernel computes S and dP again.
// bfloat16 (tcb::), three launches: prep_kernel writes delta and each 64-row tile's
// position range; dkdv_wgmma<DP> (a block per 64-key tile: the keys' K and
// V once, the query tiles they may be seen by streamed through a ring)
// and dq_wgmma<DP> (a block per 128 queries over the key tiles they may
// see) run every product on wgmma fed by TMA, as fa_wgmma does; P^T, dS^T
// and dS are rounded to bf16 only as A operands, dS is formed from the f32
// P, every sum is f32.  float32 (tf::): two launches, 3xTF32 products
// as the forward's: dq_kernel<DP> (a block per 64 queries: first each
// row's delta, then the key tiles the block may see, 16 or 32 keys, through
// a cp.async ring; per 16 rows one warp S and P, the other dP, swapped in
// shared memory, then each dQ += dS K over half of D) and dkdv_kernel<DP>
// (a block per 32 keys over the query tiles of 32 that may see them; per
// 16 keys and half a tile one warp S^T, P^T and dV, the other dP^T, dS^T
// and dK, P^T handed over in shared memory; the tile halves' sums added at
// the end).  Neither uses atomics: each accumulator sums its tiles in one
// fixed order, so two runs give the same bits.
#include <climits>
#include <cstdint>
#include <initializer_list>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -0.7f * 3.4028234663852886e38f;  // the reference's

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ void warp_min_max(int& mn, int& mx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
}

// A KV tile no query of [qmin, qmax] may see: no valid key, all keys after
// qmax (causal), or all at or before qmin - window.
__device__ __forceinline__ bool tile_hidden(int kmin, int kmax, int qmin, int qmax, int causal,
                                            int window) {
  return kmin > kmax || qmin > qmax || (causal && kmin > qmax) ||
         (window > 0 && (long long)kmax <= (long long)qmin - window);
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 products on the tensor cores (mma.sync)
// ---------------------------------------------------------------------------

namespace tf {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 64;        // queries of a forward or dQ block: 4 row groups of 16
constexpr int BT = 32;        // keys of a forward tile and of a dK/dV block; its query tiles
constexpr int MAXT = 256;     // tiles listed at a time
constexpr unsigned FULL = 0xffffffffu;

// DP: D rounded up to a compiled width.  Rows in shared memory are DP + 4
// floats apart (LD = 4 mod 32 words), so the fragment loads below hit 32
// distinct banks: a warp reads M[g][k + t] (bank 4 g + t) or M[2 t][n + g]
// and M[2 t + 1][n + g] (8 t + g and 8 t + 4 + g).
template <int DP> struct Shape {
  static constexpr int LD = DP + 4;
  static constexpr int NT = DP / 8;                 // output n-tiles of 8 columns
  static constexpr int DQ_BK = DP >= 128 ? 16 : 32;  // keys of a dQ tile
  static constexpr int FA_SMEM = (BQ + 4 * BT) * LD * 4;          // Q; 2 x (K, V)
  static constexpr int DQ_SMEM = (2 * BQ + 4 * DQ_BK) * LD * 4;   // Q, dO; 2 x (K, V)
  static constexpr int KV_SMEM = 6 * BT * LD * 4;                  // K, V; 2 x (Q, dO)
};

struct FwdParams {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;  // (B, H, Sq) or null
  const int* q_pos;
  const int* k_pos;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int Sq, Sk, D, causal, window;
  float scale;
};

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;  // (B, H, Sq)
  float* delta;      // (B, H, Sq): rowsum(dO * O), written by the dQ kernel
  float* dq;         // (B, H, Sq, D) contiguous
  float* dk;         // (B, H, Sk, D) contiguous
  float* dv;         // (B, H, Sk, D) contiguous
  const int* q_pos;
  const int* k_pos;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, g_sb, g_sh,
      g_ss;
  int H, Sq, Sk, D, causal, window;
  float scale;
};

__device__ __forceinline__ bool allowed(long long qp, long long kp, int causal, int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// ---- asynchronous copies ----
__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// 16 bytes from global to shared memory without the registers; zeros when !valid
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// rows [r0, r0 + ROWS) of an (n, D) matrix with row stride ss, into shared
// rows LD floats apart; rows at or past n are zero
template <int ROWS, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long ss, int r0,
                                          int n, int D) {
  constexpr int C4 = (LD - 4) / 4;  // 16-byte chunks of a DP-wide row
  for (int i = threadIdx.x; i < ROWS * C4; i += THREADS) {
    const int r = i / C4, c = (i % C4) * 4;
    if (c >= D) continue;
    const bool ok = r0 + r < n;
    cp16(dst + r * LD + c, ok ? src + (long long)(r0 + r) * ss + c : src, ok);
  }
}

// ---- 3xTF32 products on mma.sync m16n8k8 ----
// x rounded to TF32 to nearest, ties away from zero, as cvt.rna.tf32.f32
// rounds: half a unit of the last kept bit added to the magnitude, then the
// 13 bits below it dropped (two integer operations)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo + a rest below lo's last bit, hi and lo TF32 (rounded to
// nearest, ties away from zero)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// s[j] += A B_j^T over the columns [0, D): A the warp's 16 rows, B_j rows
// 8 j .. 8 j + 7 of Bm, both in shared memory LD floats apart.  s[j] is an
// m16n8 accumulator: lane (g, t) = (lane / 4, lane % 4) holds rows g and
// g + 8, columns 2 t and 2 t + 1.  An mma that waits on the one before it
// stalls the warp (two warps a scheduler here), so the k steps go two at a
// time into two partial sums, and each step's three products are issued
// term by term over the 2 NJ accumulators: no mma follows one it needs.
template <int NJ, int LD>
__device__ __forceinline__ void mma_abt(float (&s)[NJ][4], const float* A, const float* Bm,
                                        int D) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* a = A + g * LD + t;
  const float* bb = Bm + g * LD + t;
  float acc[2][NJ][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[h][j][0] = acc[h][j][1] = acc[h][j][2] = acc[h][j][3] = 0.f;
  for (int k0 = 0; k0 < D; k0 += 16) {  // D is a multiple of 16
    uint32_t ah[2][4], al[2][4], bh[2][NJ][2], bl[2][NJ][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = k0 + 8 * h;
      split(a[kk], ah[h][0], al[h][0]);
      split(a[8 * LD + kk], ah[h][1], al[h][1]);
      split(a[kk + 4], ah[h][2], al[h][2]);
      split(a[8 * LD + kk + 4], ah[h][3], al[h][3]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        split(bb[8 * j * LD + kk], bh[h][j][0], bl[h][j][0]);
        split(bb[8 * j * LD + kk + 4], bh[h][j][1], bl[h][j][1]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(acc[h][j], al[h], bh[h][j][0], bh[h][j][1]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(acc[h][j], ah[h], bl[h][j][0], bl[h][j][1]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(acc[h][j], ah[h], bh[h][j][0], bh[h][j][1]);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] += acc[0][j][c] + acc[1][j][c];
}

// o[n] += P B over the output columns [0, D): P the warp's 16 x 8 NJ
// accumulator tiles as mma_abt leaves them, B rows 0 .. 8 NJ - 1 of Bm.
// P's columns 2 t and 2 t + 1 of tile j become the A fragment's columns t
// and t + 4, so B's rows are read in that order: 8 j + 2 t and 8 j + 2 t + 1.
// The n-tiles go 8 at a time, each round's products issued term by term.
template <int NJ, int NT, int LD>
__device__ __forceinline__ void mma_pb(float (&o)[NT][4], const float (&pm)[NJ][4],
                                       const float* Bm, int D) {
  constexpr int G = NT < 8 ? NT : 8;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t ah[4], al[4];
    split(pm[j][0], ah[0], al[0]);
    split(pm[j][2], ah[1], al[1]);
    split(pm[j][1], ah[2], al[2]);
    split(pm[j][3], ah[3], al[3]);
    const float* b0 = Bm + (8 * j + 2 * t) * LD + g;
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += G) {
      if (8 * n0 >= D) continue;
      uint32_t bh[G][2], bl[G][2];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int n = n0 + i;
        split(b0[8 * n], bh[i][0], bl[i][0]);
        split(b0[LD + 8 * n], bh[i][1], bl[i][1]);
      }
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (8 * (n0 + i) < D) mma_tf32(o[n0 + i], al, bh[i][0], bh[i][1]);
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (8 * (n0 + i) < D) mma_tf32(o[n0 + i], ah, bl[i][0], bl[i][1]);
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (8 * (n0 + i) < D) mma_tf32(o[n0 + i], ah, bh[i][0], bh[i][1]);
    }
  }
}

// Lists, in order, the tiles c0 <= t < min(c0 + MAXT, nt) of TS positions
// (tile t: pos[t TS ..], n positions in all) that are not hidden from the
// block's own range [bmin, bmax]: with `keys` the tiles are key tiles and
// the block's range is of queries, else the other way round.  Entry
// {min, max, hole, t}: the tile's valid range, and whether a slot is a hole
// or past n.  Returns the count; every thread takes part.
template <int TS>
__device__ int list_tiles(const int* pos, int n, int nt, int c0, bool keys, int bmin, int bmax,
                          int causal, int window, int4* list, int* count) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c1 = min(nt, c0 + MAXT);
  for (int t = c0 + warp; t < c1; t += WARPS) {
    const int r = t * TS + lane;
    const bool in = lane < TS && r < n;
    const int v = in ? pos[r] : -1;
    const bool ok = in && (!keys || v >= 0);
    int mn = ok ? v : INT_MAX, mx = ok ? v : INT_MIN;
    warp_min_max(mn, mx);
    const int hole = __any_sync(FULL, lane < TS && !ok);
    const bool hidden = keys ? tile_hidden(mn, mx, bmin, bmax, causal, window)
                             : tile_hidden(bmin, bmax, mn, mx, causal, window);
    if (lane == 0) list[t - c0] = make_int4(mn, mx, hole, hidden ? -1 : t);
  }
  __syncthreads();
  if (warp == 0) {  // compact in place, in order
    int cnt = 0;
    for (int i0 = 0; i0 < c1 - c0; i0 += 32) {
      const int4 e = i0 + lane < c1 - c0 ? list[i0 + lane] : make_int4(0, 0, 0, -1);
      const unsigned vis = __ballot_sync(FULL, e.w >= 0);
      __syncwarp();
      if (e.w >= 0) list[cnt + __popc(vis & ((1u << lane) - 1))] = e;
      cnt += __popc(vis);
      __syncwarp();
    }
    if (lane == 0) *count = cnt;
  }
  __syncthreads();
  return *count;
}

// the min and max of q_pos over the block's rows [0, nq) and over row group
// rg's 16 of them (INT_MAX, INT_MIN if it has none)
__device__ __forceinline__ void query_ranges(const int* q_pos, int q0, int nq, int rg, int2& blk,
                                             int2& own) {
  const int lane = threadIdx.x % 32, w0 = rg * 16;
  int mn = INT_MAX, mx = INT_MIN;
  for (int r = lane; r < nq; r += 32) {
    const int v = q_pos[q0 + r];
    mn = min(mn, v);
    mx = max(mx, v);
  }
  warp_min_max(mn, mx);
  blk = make_int2(mn, mx);
  mn = INT_MAX;
  mx = INT_MIN;
  if (lane < 16 && w0 + lane < nq) mn = mx = q_pos[q0 + w0 + lane];
  warp_min_max(mn, mx);
  own = make_int2(mn, mx);
}

// the two warps of a row group (64 threads) meet at named barrier 1 + rg
__device__ __forceinline__ void group_sync(int rg) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rg) : "memory");
}

// A warp's accumulator tiles to and from shared memory in fragment order
// (16-byte stores and loads, lane after lane): how the two warps that
// split a tile's keys (or queries) add their partial sums at the end.
template <int NT>
__device__ __forceinline__ void stash(float4* buf, const float (&o)[NT][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < NT; ++n) buf[n * 32 + lane] = make_float4(o[n][0], o[n][1], o[n][2], o[n][3]);
}
template <int NT>
__device__ __forceinline__ void add_stash(float (&o)[NT][4], const float4* buf) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float4 x = buf[n * 32 + lane];
    o[n][0] += x.x;
    o[n][1] += x.y;
    o[n][2] += x.z;
    o[n][3] += x.w;
  }
}

// ---- forward ----
// One block of 8 warps per (64 queries, h, b).  Q is copied once; the key
// tiles the block may see go through a 2-stage cp.async ring of K and V
// (the next tile lands while this one computes).  Warps w and w + 4 share
// row group rg = w % 4 (16 rows) and split each 32-key tile: warp w + 4 kh
// takes keys 16 kh .. 16 kh + 15.  Per tile each computes S = Q K^T (3xTF32)
// over its keys, the mask (skipped on a tile every row of the group sees
// whole), its row maxima, which the pair swaps in shared memory so both use
// one running max m; then its p, its own running row sums and O += P V
// (3xTF32, P split in registers).  Two warps a scheduler: while one
// computes its softmax the other keeps the tensor cores busy.  At the end
// warp w + 4 hands its O and l to warp w, which adds them and writes.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1) fa_kernel(const FwdParams p) {
  using L = Shape<DP>;
  constexpr int LD = L::LD, NT = L::NT, NJ = BT / 16;
  extern __shared__ float4 smem4[];
  float* const Qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* const Rs = Qs + BQ * LD;  // stage s: K at Rs + 2 s BT LD, V BT LD after
  __shared__ int4 list[MAXT];
  __shared__ int kpos_s[2][BT];
  __shared__ float xmax[2][2][BQ];  // [tile parity][key half][row]: the pair's row maxima
  __shared__ float xl[BQ];
  __shared__ int count;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  const int rg = warp % 4, kh = warp / 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, D = p.D;
  const int nq = min(BQ, p.Sq - q0);
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  load_rows<BQ, LD>(Qs, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.Sq, D);
  cp_commit();
  int2 blk, own;
  query_ranges(p.q_pos, q0, nq, rg, blk, own);
  const int r0 = rg * 16 + g;  // this thread's rows: r0 and r0 + 8
  const long long qp[2] = {r0 < nq ? p.q_pos[q0 + r0] : 0, r0 + 8 < nq ? p.q_pos[q0 + r0 + 8] : 0};

  float o[NT][4], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const int nkt = (p.Sk + BT - 1) / BT;
  for (int c0 = 0; c0 < nkt; c0 += MAXT) {
    const int cnt = list_tiles<BT>(p.k_pos, p.Sk, nkt, c0, true, blk.x, blk.y, p.causal,
                                   p.window, list, &count);
    auto load = [&](int i) {
      const int k0 = list[i].w * BT, s = i & 1;
      float* K = Rs + 2 * s * BT * LD;
      load_rows<BT, LD>(K, kb, p.k_ss, k0, p.Sk, D);
      load_rows<BT, LD>(K + BT * LD, vb, p.v_ss, k0, p.Sk, D);
      if (tid < BT) kpos_s[s][tid] = k0 + tid < p.Sk ? p.k_pos[k0 + tid] : -1;
    };
    if (cnt > 0) load(0);
    cp_commit();
    for (int i = 0; i < cnt; ++i) {
      if (i + 1 < cnt) load(i + 1);
      cp_commit();
      cp_wait<1>();
      __syncthreads();  // tile i (and Q) landed for every thread
      const int4 e = list[i];
      if (!tile_hidden(e.x, e.y, own.x, own.y, p.causal, p.window)) {
        const bool whole = !e.z && (!p.causal || e.y <= own.x) &&
                           (p.window <= 0 || (long long)e.x > (long long)own.y - p.window);
        const float* K = Rs + 2 * (i & 1) * BT * LD + kh * 16 * LD;
        const int* kp = kpos_s[i & 1] + kh * 16;
        float s[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        mma_abt<NJ, LD>(s, Qs + rg * 16 * LD, K, D);
        // a masked score is -inf, so its p is exactly 0 and a row with no
        // key so far keeps m = NEG and l = 0
        float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float x = s[j][c] * p.scale;
            if (!whole && !allowed(qp[c / 2], kp[8 * j + 2 * t + (c & 1)], p.causal, p.window))
              x = neg_inf();
            s[j][c] = x;
            mx[c / 2] = fmaxf(mx[c / 2], x);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        }
        float* xm = xmax[i & 1][kh];
        if (t == 0) {
          xm[r0] = mx[0];
          xm[r0 + 8] = mx[1];
        }
        group_sync(rg);  // the pair's maxima are in; the buffer alternates by tile
        const float* other = xmax[i & 1][1 - kh];
        float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], fmaxf(mx[r], other[r0 + 8 * r]));
          alpha[r] = expf(m[r] - m_new);
          m[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[j][c] = expf(s[j][c] - m[c / 2]);
            sum[c / 2] += s[j][c];
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sum[r] += __shfl_xor_sync(FULL, sum[r], 1);
          sum[r] += __shfl_xor_sync(FULL, sum[r], 2);
          l[r] = l[r] * alpha[r] + sum[r];
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
        mma_pb<NJ, NT, LD>(o, s, K + BT * LD, D);
      }
      __syncthreads();  // every warp is done with stage i & 1 before it is refilled
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: the key halves' partial sums meet there
  float4* part = reinterpret_cast<float4*>(Rs) + rg * NT * 32;
  if (kh == 1) {
    stash(part, o);
    if (t == 0) {
      xl[r0] = l[0];
      xl[r0 + 8] = l[1];
    }
  }
  __syncthreads();
  if (kh == 1) return;
  add_stash(o, part);
  l[0] += xl[r0];
  l[1] += xl[r0 + 8];

  float* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= nq) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    float* dst = ob + (long long)(q0 + row) * p.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (8 * n < D)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(o[n][2 * r] / lr, o[n][2 * r + 1] / lr);
    // the row's log-sum-exp, -inf for a row with no key
    if (p.lse != nullptr && t == 0)
      p.lse[((size_t)b * gridDim.y + h) * p.Sq + q0 + row] =
          l[r] > 0.f ? m[r] + logf(l[r]) : neg_inf();
  }
}

// ---- backward: dQ (and delta) ----
// One block of 8 warps per (64 queries, h, b).  First the warps write delta
// = rowsum(dO * O) of the block's rows (the dK/dV kernel, launched next,
// reads it).  Then the key tiles the block may see go through a 2-stage
// ring of K and V (16 keys a tile at DP >= 128, where Q, dO and the ring
// fill 195 KB).  Warps w and w + 4 share row group rg = w % 4 and split
// the work by role: warp w computes S = Q K^T and P = exp(scale S - lse)
// under the masks, warp w + 4 dP = dO V^T (3xTF32, over the tile's keys);
// they swap P and dP in shared memory (fragment order), both form dS =
// P (dP - delta), and each adds dS K (3xTF32) into its half of dQ's
// columns: no partial sums to add at the end.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1) dq_kernel(const BwdParams p) {
  using L = Shape<DP>;
  constexpr int LD = L::LD, NT = L::NT, BK = L::DQ_BK, NJ = BK / 8;
  extern __shared__ float4 smem4[];
  float* const Qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* const Gs = Qs + BQ * LD;                     // dO [BQ][LD]
  float* const Rs = Gs + BQ * LD;  // stage s: K at Rs + 2 s BK LD, V BK LD after
  __shared__ int4 list[MAXT];
  __shared__ int kpos_s[2][BK];
  __shared__ float lse_s[BQ], dl_s[BQ];
  __shared__ float4 xs[4][2][NJ][32];  // each row group's P (role 0) and dP (role 1)
  __shared__ int count;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  const int rg = warp % 4, role = warp / 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, D = p.D, HD = D / 2;
  const int nq = min(BQ, p.Sq - q0);
  const size_t row0 = ((size_t)b * p.H + h) * p.Sq;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  load_rows<BQ, LD>(Qs, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.Sq, D);
  load_rows<BQ, LD>(Gs, p.dout + b * p.g_sb + h * p.g_sh, p.g_ss, q0, p.Sq, D);
  cp_commit();
  // every row's delta, also a row no key sees: the dK/dV kernel reads them all
  for (int r = warp; r < nq; r += WARPS) {
    const float* orow = p.o + b * p.o_sb + h * p.o_sh + (long long)(q0 + r) * p.o_ss;
    const float* grow = p.dout + b * p.g_sb + h * p.g_sh + (long long)(q0 + r) * p.g_ss;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc = fmaf(orow[d], grow[d], acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      p.delta[row0 + q0 + r] = acc;
      dl_s[r] = acc;
    }
  }
  if (tid < BQ) {  // +inf for a row with no key or past Sq: p = 0
    const float lv = tid < nq ? p.lse[row0 + q0 + tid] : neg_inf();
    lse_s[tid] = lv > neg_inf() ? lv : pos_inf();
    if (tid >= nq) dl_s[tid] = 0.f;
  }
  int2 blk, own;
  query_ranges(p.q_pos, q0, nq, rg, blk, own);
  const int r0 = rg * 16 + g;
  const long long qp[2] = {r0 < nq ? p.q_pos[q0 + r0] : 0, r0 + 8 < nq ? p.q_pos[q0 + r0 + 8] : 0};

  float acc[NT / 2][4];  // dQ's columns role * D / 2 ..
#pragma unroll
  for (int n = 0; n < NT / 2; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float ls[2], dl[2];
  bool first = true;

  const int nkt = (p.Sk + BK - 1) / BK;
  for (int c0 = 0; c0 < nkt; c0 += MAXT) {
    const int cnt = list_tiles<BK>(p.k_pos, p.Sk, nkt, c0, true, blk.x, blk.y, p.causal,
                                   p.window, list, &count);
    if (first) {  // lse_s and dl_s are visible past list_tiles' barriers
      first = false;
      ls[0] = lse_s[r0];
      ls[1] = lse_s[r0 + 8];
      dl[0] = dl_s[r0];
      dl[1] = dl_s[r0 + 8];
    }
    auto load = [&](int i) {
      const int k0 = list[i].w * BK, s = i & 1;
      float* K = Rs + 2 * s * BK * LD;
      load_rows<BK, LD>(K, kb, p.k_ss, k0, p.Sk, D);
      load_rows<BK, LD>(K + BK * LD, vb, p.v_ss, k0, p.Sk, D);
      if (tid < BK) kpos_s[s][tid] = k0 + tid < p.Sk ? p.k_pos[k0 + tid] : -1;
    };
    if (cnt > 0) load(0);
    cp_commit();
    for (int i = 0; i < cnt; ++i) {
      if (i + 1 < cnt) load(i + 1);
      cp_commit();
      cp_wait<1>();
      __syncthreads();
      const int4 e = list[i];
      if (!tile_hidden(e.x, e.y, own.x, own.y, p.causal, p.window)) {
        const float* K = Rs + 2 * (i & 1) * BK * LD;
        float s[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        if (role == 0) {
          const bool whole = !e.z && (!p.causal || e.y <= own.x) &&
                             (p.window <= 0 || (long long)e.x > (long long)own.y - p.window);
          const int* kp = kpos_s[i & 1];
          mma_abt<NJ, LD>(s, Qs + rg * 16 * LD, K, D);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const bool ok =
                  whole || allowed(qp[c / 2], kp[8 * j + 2 * t + (c & 1)], p.causal, p.window);
              s[j][c] = ok ? expf(s[j][c] * p.scale - ls[c / 2]) : 0.f;  // P
            }
        } else {
          mma_abt<NJ, LD>(s, Gs + rg * 16 * LD, K + BK * LD, D);  // dP
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          xs[rg][role][j][lane] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
        group_sync(rg);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 x = xs[rg][1 - role][j][lane];
          const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {  // dS = P (dP - delta), the same in both warps
            const float pr = role == 0 ? s[j][c] : xv[c], dp = role == 0 ? xv[c] : s[j][c];
            s[j][c] = pr * (dp - dl[c / 2]);
          }
        }
        mma_pb<NJ, NT / 2, LD>(acc, s, K + role * HD, HD);
      }
      __syncthreads();
    }
  }
  cp_wait<0>();

  float* dqb = p.dq + row0 * D + role * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= nq) continue;
    float* dst = dqb + (size_t)(q0 + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT / 2; ++n)
      if (8 * n < HD)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(acc[n][2 * r] * p.scale, acc[n][2 * r + 1] * p.scale);
  }
}

// ---- backward: dK, dV ----
// One block of 8 warps per (32 keys, h, b): K and V copied once, then the
// query tiles (32 rows) the keys may be seen by go through a 2-stage ring
// of Q and dO, with each row's position, lse and delta.  Keys are the rows
// of every product (S^T = K Q^T, dP^T = V dO^T), so P^T and dS^T land in
// the accumulator layout that mma_pb takes as A.  A 16 x D f32 accumulator
// is D / 2 registers a thread, so the warps split the work three ways:
// key group kg (16 keys), query half qh of each tile (16 queries), and
// role: role 0 computes S^T, P^T (handed over in shared memory, in
// fragment order) and dV += P^T dO; role 1 dP^T, then dS^T = P^T (dP^T -
// delta) and dK += dS^T Q.  At the end the two query halves' partial sums
// are added.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1) dkdv_kernel(const BwdParams p) {
  using L = Shape<DP>;
  constexpr int LD = L::LD, NT = L::NT, NJ = BT / 16;
  extern __shared__ float4 smem4[];
  float* const Ks = reinterpret_cast<float*>(smem4);  // [BT][LD]
  float* const Vs = Ks + BT * LD;
  float* const Rs = Vs + BT * LD;  // stage s: Q at Rs + 2 s BT LD, dO BT LD after
  __shared__ float4 pt[2][2][NJ][32];  // P^T of each (key group, query half), fragment order
  __shared__ int4 list[MAXT];
  __shared__ int qpos_s[2][BT];
  __shared__ float lse_s[2][BT], dl_s[2][BT];
  __shared__ int count;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  const int role = warp % 2, kg = warp / 2 % 2, qh = warp / 4;
  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z, D = p.D;
  const int nk = min(BT, p.Sk - k0);
  const size_t row0 = ((size_t)b * p.H + h) * p.Sq;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* gb = p.dout + b * p.g_sb + h * p.g_sh;
  load_rows<BT, LD>(Ks, p.k + b * p.k_sb + h * p.k_sh, p.k_ss, k0, p.Sk, D);
  load_rows<BT, LD>(Vs, p.v + b * p.v_sb + h * p.v_sh, p.v_ss, k0, p.Sk, D);
  cp_commit();
  // the valid key positions of the block and of this key group's 16 rows,
  // and whether the group holds a hole or a row past Sk
  int bmin = INT_MAX, bmax = INT_MIN;
  {
    const int v = lane < nk ? p.k_pos[k0 + lane] : -1;
    if (v >= 0) bmin = bmax = v;
    warp_min_max(bmin, bmax);
  }
  int wmin = INT_MAX, wmax = INT_MIN;
  const int v16 = lane < 16 && kg * 16 + lane < nk ? p.k_pos[k0 + kg * 16 + lane] : -1;
  if (v16 >= 0) wmin = wmax = v16;
  warp_min_max(wmin, wmax);
  const bool hole = __any_sync(FULL, lane < 16 && v16 < 0);
  const int r0 = kg * 16 + g;
  const long long kp[2] = {r0 < nk ? p.k_pos[k0 + r0] : -1,
                           r0 + 8 < nk ? p.k_pos[k0 + r0 + 8] : -1};

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int nqt = (p.Sq + BT - 1) / BT;
  for (int c0 = 0; c0 < nqt; c0 += MAXT) {
    const int cnt = list_tiles<BT>(p.q_pos, p.Sq, nqt, c0, false, bmin, bmax, p.causal,
                                   p.window, list, &count);
    auto load = [&](int i) {
      const int q0 = list[i].w * BT, s = i & 1;
      float* Q = Rs + 2 * s * BT * LD;
      load_rows<BT, LD>(Q, qb, p.q_ss, q0, p.Sq, D);
      load_rows<BT, LD>(Q + BT * LD, gb, p.g_ss, q0, p.Sq, D);
      if (tid < BT) {  // lse +inf (p = 0) for a row with no key or past Sq
        const int row = q0 + tid;
        const bool in = row < p.Sq;
        const float lv = in ? p.lse[row0 + row] : neg_inf();
        qpos_s[s][tid] = in ? p.q_pos[row] : 0;
        lse_s[s][tid] = lv > neg_inf() ? lv : pos_inf();
        dl_s[s][tid] = in ? p.delta[row0 + row] : 0.f;
      }
    };
    if (cnt > 0) load(0);
    cp_commit();
    for (int i = 0; i < cnt; ++i) {
      if (i + 1 < cnt) load(i + 1);
      cp_commit();
      cp_wait<1>();
      __syncthreads();
      const int4 e = list[i];
      const int st = i & 1, c16 = qh * 16;
      const float* Q = Rs + 2 * st * BT * LD + c16 * LD;  // this warp's 16 queries
      const float* G = Q + BT * LD;
      const bool seen = !tile_hidden(wmin, wmax, e.x, e.y, p.causal, p.window);
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if (seen) {
        if (role == 0) {
          const bool whole = !hole && (!p.causal || wmax <= e.x) &&
                             (p.window <= 0 || (long long)wmin > (long long)e.y - p.window);
          mma_abt<NJ, LD>(s, Ks + kg * 16 * LD, Q, D);  // S^T
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int col = c16 + 8 * j + 2 * t + (c & 1);
              const bool ok = whole || allowed(qpos_s[st][col], kp[c / 2], p.causal, p.window);
              s[j][c] = ok ? expf(s[j][c] * p.scale - lse_s[st][col]) : 0.f;
            }
            pt[kg][qh][j][lane] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
          }
        } else {
          mma_abt<NJ, LD>(s, Vs + kg * 16 * LD, G, D);  // dP^T
        }
      }
      __syncthreads();  // P^T handed over
      if (seen) {
        if (role == 0) {
          mma_pb<NJ, NT, LD>(acc, s, G, D);  // dV += P^T dO
        } else {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float4 pr = pt[kg][qh][j][lane];
            const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
            for (int c = 0; c < 4; ++c)
              s[j][c] = pv[c] * (s[j][c] - dl_s[st][c16 + 8 * j + 2 * t + (c & 1)]);  // dS^T
          }
          mma_pb<NJ, NT, LD>(acc, s, Q, D);  // dK += dS^T Q
        }
      }
      __syncthreads();  // stage i & 1 and P^T are free
    }
  }
  cp_wait<0>();
  // the ring is free (past the last barrier): the query halves' partial sums meet there
  float4* part = reinterpret_cast<float4*>(Rs) + (warp % 4) * NT * 32;
  if (qh == 1) stash(part, acc);
  __syncthreads();
  if (qh == 1) return;
  add_stash(acc, part);

  const float mul = role ? p.scale : 1.f;
  float* out = (role ? p.dk : p.dv) + (((size_t)b * p.H + h) * p.Sk) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= nk) continue;
    float* dst = out + (size_t)(k0 + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (8 * n < D)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
  }
}

template <int DP>
int launch_fwd(const FwdParams& p, int B, int H, cudaStream_t st) {
  constexpr int smem = Shape<DP>::FA_SMEM;
  const cudaError_t e =
      cudaFuncSetAttribute(fa_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  fa_kernel<DP><<<dim3((p.Sq + BQ - 1) / BQ, H, B), THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// two launches in stream order: dQ (which writes delta), then dK/dV
template <int DP>
int launch_bwd(const BwdParams& p, int B, cudaStream_t st) {
  using L = Shape<DP>;
  cudaError_t e =
      cudaFuncSetAttribute(dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::DQ_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dkdv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::KV_SMEM);
  if (e != cudaSuccess) return (int)e;
  dq_kernel<DP><<<dim3((p.Sq + BQ - 1) / BQ, p.H, B), THREADS, L::DQ_SMEM, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkdv_kernel<DP><<<dim3((p.Sk + BT - 1) / BT, p.H, B), THREADS, L::KV_SMEM, st>>>(p);
  return (int)cudaGetLastError();
}

// cp.async reads 16 bytes at a time: bases 16-byte aligned, strides in
// multiples of 4 floats (the wrapper copies a tensor that has neither)
bool aligned(std::initializer_list<const void*> ptrs, std::initializer_list<long long> strides) {
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (long long s : strides)
    if (s % 4) return false;
  return true;
}

}  // namespace tf

// ---------------------------------------------------------------------------
// bfloat16: wgmma kernel fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;                         // queries of a block
constexpr int BK = 64;                          // keys of a KV tile
constexpr int STAGES = 2;                       // K/V ring depth
constexpr int CONSUMERS = 2;                    // warpgroups of 64 query rows
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int ROW = 128;                        // bytes of a swizzled row: 64 bf16
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  __nv_bfloat16* o;
  float* lse;  // (B, H, Sq) or null
  const int* q_pos;
  const int* k_pos;
  long long o_sb, o_sh, o_ss;
  int Sq, Sk, D, causal, window, kv_heads, kv_batch;
  float scale;
};

// DP / 64 swizzle atoms of rows x 128 bytes each; Q once, K and V per stage
template <int DP> struct Layout {
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; lbo and sbo in bytes
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving accesses of r across a wgmma issue or wait
template <int N> __device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// operand lists of 32 accumulator registers: %o..%o+31, and d[o]..d[o+31]
#define WG_REGS_0 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_REGS_32 \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, " \
  "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_REGS_64 \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, " \
  "%81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define WG_REGS_96 \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, " \
  "%125, %126, %127"
#define WG_OUT32(d, o) \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]), "+f"(d[o + 8]), "+f"(d[o + 9]), \
      "+f"(d[o + 10]), "+f"(d[o + 11]), "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]), \
      "+f"(d[o + 15]), "+f"(d[o + 16]), "+f"(d[o + 17]), "+f"(d[o + 18]), "+f"(d[o + 19]), \
      "+f"(d[o + 20]), "+f"(d[o + 21]), "+f"(d[o + 22]), "+f"(d[o + 23]), "+f"(d[o + 24]), \
      "+f"(d[o + 25]), "+f"(d[o + 26]), "+f"(d[o + 27]), "+f"(d[o + 28]), "+f"(d[o + 29]), \
      "+f"(d[o + 30]), "+f"(d[o + 31])

// d (+)= A B, 64 x 64 x 16: A and B from shared memory, both K-major
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_REGS_0 "}, %32, %33, p, 1, 1, "
      "0, 0;\n}\n"
      : WG_OUT32(d, 0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, 64 x N x 16: A from registers, B from shared memory MN-major
// in N / 64 atoms of 64 columns, the leading byte offset apart
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_REGS_0 "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_REGS_0 ", " WG_REGS_32 "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d, 0), WG_OUT32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WG_REGS_0 ", " WG_REGS_32 ", "
      WG_REGS_64 ", " WG_REGS_96 "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d, 0), WG_OUT32(d, 32), WG_OUT32(d, 64), WG_OUT32(d, 96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the dynamic shared memory base rounded up to the 1024 bytes the
// 128-byte swizzle repeats over (the layouts reserve the slack)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
// the byte offset of step kk (16 columns) in a K-major tile of `rows` rows
__device__ __forceinline__ int kstep(int kk, int rows) {
  return (kk / 4) * rows * ROW + (kk % 4) * 32;
}
// an m64n64 accumulator in bf16 as the A fragments of four k16 steps: the
// columns 16 kk .. 16 kk + 15 are step kk's
__device__ __forceinline__ void to_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    fa_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, const Params p) {
  using L = Layout<DP>;
  constexpr int ATOMS = DP / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const Qs = align1024(smem_raw);
  uint8_t* const Ks = Qs + L::Q_BYTES;                // [STAGES][ATOMS][BK][ROW]
  uint8_t* const Vs = Ks + STAGES * L::KV_BYTES;      // [STAGES][ATOMS][BK][ROW]
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], qbar;
  __shared__ int qrange[4][2];  // min, max of q_pos over each 32 rows
  // per stage: the tile's index (nkt: no more tiles), its valid key range,
  // whether it holds a hole, and its 64 key positions (-1 past Sk)
  __shared__ int slot[STAGES][4];
  __shared__ int slot_kpos[STAGES][BK];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = p.kv_heads == 1 ? 0 : h, kvb = p.kv_batch == 1 ? 0 : b;
  const int nkt = (p.Sk + BK - 1) / BK;

  if (warp < 4) {
    int mn = INT_MAX, mx = INT_MIN;
    if (q0 + tid < p.Sq) mn = mx = p.q_pos[q0 + tid];
    warp_min_max(mn, mx);
    if (lane == 0) {
      qrange[warp][0] = mn;
      qrange[warp][1] = mx;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int bq_min = min(min(qrange[0][0], qrange[1][0]), min(qrange[2][0], qrange[3][0]));
  const int bq_max = max(max(qrange[0][1], qrange[1][1]), max(qrange[2][1], qrange[3][1]));

  if (warp >= CONSUMERS * 4) {
    // ---- producer warpgroup: one warp issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp != CONSUMERS * 4) return;
    if (lane == 0) {
      mbar_expect_tx(&qbar, L::Q_BYTES);
      for (int c = 0; c < ATOMS; ++c)
        tma_load(Qs + c * BQ * ROW, &qmap, &qbar, 64 * c, q0, h, b);
    }
    // each tile the block's queries may see goes to the next stage of the
    // ring with its slot; t == nkt closes the stream with a slot and no tile
    int n = 0;
    for (int t = 0; t <= nkt; ++t) {
      int kp0 = -1, kp1 = -1, mn = INT_MAX, mx = INT_MIN, hole = 0;
      if (t < nkt) {
        const int j = t * BK + lane;
        kp0 = j < p.Sk ? p.k_pos[j] : -1;
        kp1 = j + 32 < p.Sk ? p.k_pos[j + 32] : -1;
        mn = __reduce_min_sync(0xffffffffu, min(kp0 < 0 ? INT_MAX : kp0, kp1 < 0 ? INT_MAX : kp1));
        mx = __reduce_max_sync(0xffffffffu, max(kp0, kp1));
        hole = __reduce_or_sync(0xffffffffu, (kp0 < 0) | (kp1 < 0));
        if (mx < 0) mx = INT_MIN;  // no valid key
        if (tile_hidden(mn, mx, bq_min, bq_max, p.causal, p.window)) continue;
      }
      const int s = n % STAGES;
      if (lane == 0) mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
      __syncwarp();
      slot_kpos[s][lane] = kp0;
      slot_kpos[s][lane + 32] = kp1;
      if (lane == 0) {
        slot[s][0] = t;
        slot[s][1] = mn;
        slot[s][2] = mx;
        slot[s][3] = hole;
      }
      __syncwarp();
      if (lane == 0) {  // the arrival publishes the slot with the tile
        if (t == nkt) {
          mbar_arrive(&full[s]);
        } else {
          mbar_expect_tx(&full[s], 2 * L::KV_BYTES);
          for (int c = 0; c < ATOMS; ++c) {
            const int at = s * L::KV_BYTES + c * BK * ROW;
            tma_load(Ks + at, &kmap, &full[s], 64 * c, t * BK, kvh, kvb);
            tma_load(Vs + at, &vmap, &full[s], 64 * c, t * BK, kvh, kvb);
          }
        }
      }
      __syncwarp();
      ++n;
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp / 4, quad = lane % 4;
    const int wq_min = min(qrange[2 * wg][0], qrange[2 * wg + 1][0]);
    const int wq_max = max(qrange[2 * wg][1], qrange[2 * wg + 1][1]);
    // this thread's rows: r0 and r0 + 8 of the tile
    const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
    int hi[2], lo[2];  // key k is allowed for the row iff 0 <= k <= hi and k > lo
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + 8 * r;
      hi[r] = INT_MAX;
      lo[r] = INT_MIN;
      if (row < p.Sq) {
        const long long qp = p.q_pos[row];
        if (p.causal) hi[r] = (int)qp;
        if (p.window > 0) lo[r] = (int)max(qp - p.window, (long long)INT_MIN);
      }
    }
    const float sl2 = p.scale * LOG2E;
    float o[DP / 2];  // o[32 c + i]: the n64 layout of columns 64 c..
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this thread's partial row sums
    mbar_wait(&qbar, 0);

    for (int n = 0;; ++n) {
      const int s = n % STAGES;
      mbar_wait(&full[s], (n / STAGES) & 1);
      if (slot[s][0] == nkt) break;
      const int mn = slot[s][1], mx = slot[s][2], hole = slot[s][3];
      // this thread's columns 8 j + 2 quad + e; the quad covers all 64
      const int* kpos = slot_kpos[s] + 2 * quad;
      if (!tile_hidden(mn, mx, wq_min, wq_max, p.causal, p.window)) {
        const bool whole = !hole && (!p.causal || mx <= wq_min) &&
                           (p.window <= 0 || (long long)mn > (long long)wq_max - p.window);
        // descriptors of the tiles' starts; a step adds its byte offset / 16
        const uint64_t qd = sw128_desc(Qs + wg * 64 * ROW, 16, 1024);
        const uint64_t kd = sw128_desc(Ks + s * L::KV_BYTES, 16, 1024);
        const uint64_t vd = sw128_desc(Vs + s * L::KV_BYTES, BK * ROW, 1024);

        // S = Q K^T over DP / 16 steps of 16 columns
        float sc[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          mma_ss(sc, qd + (kstep(kk, BQ) >> 4), kd + (kstep(kk, BK) >> 4), kk > 0);
        wg_commit();
        wg_wait_all();
        reg_fence(sc);

        // scale to log2 units and mask; sc[4 j + 2 r + e] is row r0 + 8 r,
        // column 8 j + 2 quad + e
        float mx_row[2] = {neg_inf(), neg_inf()};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = sc[4 * j + 2 * r + e] * sl2;
              if (!whole) {
                const int k = kpos[8 * j + e];
                if (!(k >= 0 && k <= hi[r] && k > lo[r])) x = neg_inf();
              }
              sc[4 * j + 2 * r + e] = x;
              mx_row[r] = fmaxf(mx_row[r], x);
            }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx_row[r] = fmaxf(mx_row[r], __shfl_xor_sync(0xffffffffu, mx_row[r], 1));
          mx_row[r] = fmaxf(mx_row[r], __shfl_xor_sync(0xffffffffu, mx_row[r], 2));
          const float m_new = fmaxf(m[r], mx_row[r]);
          alpha[r] = exp2f(m[r] - m_new);
          m[r] = m_new;
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pr = exp2f(sc[4 * j + 2 * r + e] - m[r]);
              sc[4 * j + 2 * r + e] = pr;
              sum[r] += pr;
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int c = 0; c < ATOMS; ++c)
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                o[32 * c + 4 * j + 2 * r] *= alpha[r];
                o[32 * c + 4 * j + 2 * r + 1] *= alpha[r];
              }
        }

        // P in bf16 as the A fragments of O += P V
        uint32_t pa[4][4];
        to_a(sc, pa);

        // O += P V: V's rows are keys (K), its 128-byte rows hold 64 of D (N)
        reg_fence(o);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_rs<DP>(o, pa[kk], vd + ((kk * 16 * ROW) >> 4));
        wg_commit();
        wg_wait_all();
        reg_fence(o);
      }
      mbar_arrive(&empty[s]);
    }

    // out = O / l on rows < Sq and columns < D
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    // the rows' log-sum-exp in natural units (m is in log2 units), -inf
    // for a row with no key
    if (p.lse != nullptr && quad == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + r0 + 8 * r;
        if (row < p.Sq)
          p.lse[((size_t)b * gridDim.y + h) * p.Sq + row] =
              l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2 : neg_inf();
      }
    }
    // O / l in bf16 goes to this warpgroup's own rows of the Q tile (its S
    // products are done; the other warpgroup reads only its own rows), in
    // Q's swizzled layout, then out to device memory 16 bytes a thread,
    // each row's D * 2 bytes contiguous
    uint8_t* const Os = Qs + wg * 64 * ROW;  // atom c at Os + c * BQ * ROW
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = r0 % 64 + 8 * r;  // row within this warpgroup's 64
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < ATOMS; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(Os + c * BQ * ROW + rr * ROW +
                                             ((j ^ (rr % 8)) * 16) + 4 * quad) =
              __floats2bfloat162_rn(o[32 * c + 4 * j + 2 * r] * inv,
                                    o[32 * c + 4 * j + 2 * r + 1] * inv);
    }
    bar_sync(1 + wg, 128);
    __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
    const int chunks = p.D / 8;  // 16-byte chunks of a row
    for (int i = tid % 128; i < 64 * chunks; i += 128) {
      const int rr = i / chunks, k = i % chunks, row = q0 + wg * 64 + rr;
      if (row < p.Sq)
        *reinterpret_cast<uint4*>(ob + (long long)row * p.o_ss + 8 * k) =
            *reinterpret_cast<const uint4*>(Os + (k / 8) * BQ * ROW + rr * ROW +
                                            (((k % 8) ^ (rr % 8)) * 16));
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found at run time: no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

constexpr int ERR_NO_ENCODE = 100000;  // error codes of this file, beside cudaError_t's
constexpr int ERR_ENCODE = 100001;

// (B, H, S, D) bf16 with element strides (sb, sh, ss) and unit stride on
// D as a 4-D map (D, S, H, B); boxes of 64 columns x `rows` rows
int make_map(CUtensorMap* map, const void* base, int B, int H, int S, int D, long long sb,
             long long sh, long long ss, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <int DP>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, const Params& p,
           int B, int H, cudaStream_t st) {
  const int smem = Layout<DP>::SMEM;
  cudaError_t e =
      cudaFuncSetAttribute(fa_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, H, B);
  fa_wgmma<DP><<<grid, THREADS, smem, st>>>(qm, km, vm, p);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Backward, bfloat16: wgmma kernels fed by TMA
// ---------------------------------------------------------------------------

namespace tcb {

using tc::ROW;
using tc::LOG2E;
using tc::mbar_init;
using tc::mbar_expect_tx;
using tc::mbar_arrive;
using tc::mbar_wait;
using tc::tma_load;
using tc::sw128_desc;
using tc::wg_fence;
using tc::wg_commit;
using tc::wg_wait_all;
using tc::reg_fence;
using tc::mma_ss;
using tc::mma_rs;
using tc::align1024;
using tc::bar_sync;
using tc::bar_arrive;
using tc::kstep;
using tc::to_a;

constexpr int BM = 64;            // rows of every streamed tile: 64 queries or 64 keys
constexpr int QB = 128;           // queries of a dQ block: a warpgroup's 64 rows each
constexpr int STAGES = 2;         // ring depth: (Q, dO) tiles of dK/dV, K tiles of dQ
constexpr int THREADS = 384;      // two consumer warpgroups and the producer's
constexpr int PREP_THREADS = 256;
constexpr int READY = 1, FREE = 2;  // named barriers of dK/dV's P^T hand-over

struct Params {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;  // (B, H, Sq)
  float* delta;      // (B, H, Sq): rowsum(dO * O)
  int4* ranges;      // per 64-row tile, query tiles then key tiles: {min, max, hole, 0}
  __nv_bfloat16* dq;  // (B, H, Sq, D) contiguous
  __nv_bfloat16* dk;  // (B, H, Sk, D) contiguous
  __nv_bfloat16* dv;
  const int* q_pos;
  const int* k_pos;
  long long o_sb, o_sh, o_ss, g_sb, g_sh, g_ss;
  int H, Sq, Sk, D, causal, window, kv_heads, kv_batch;
  float scale;
};

// a row's lse in log2 units; +inf (p = 0, no gradient) past Sq or for a
// row with no key (lse = -inf)
__device__ __forceinline__ float lse2_of(const Params& p, size_t row0, int row) {
  if (row >= p.Sq) return __int_as_float(0x7f800000);
  const float l = p.lse[row0 + row];
  return l > neg_inf() ? l * LOG2E : __int_as_float(0x7f800000);
}

// Blocks below row_blocks: delta[b, h, i] = sum_d dO[i, d] O[i, d], a warp
// a row, 16 bytes a lane.  The rest (at b = h = 0): each 64-row tile's
// position range, a warp a tile: query tiles {min, max} of q_pos over rows
// < Sq; key tiles {min, max} of the valid k_pos (INT_MAX, INT_MIN if none)
// and whether a slot is a hole or past Sk.  Every block of the backward
// reads these instead of scanning the positions itself.
__global__ void __launch_bounds__(PREP_THREADS) prep_kernel(const Params p, int row_blocks) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int WARPS = PREP_THREADS / 32;
  if ((int)blockIdx.x < row_blocks) {
    const int i = blockIdx.x * WARPS + warp, h = blockIdx.y, b = blockIdx.z;
    if (i >= p.Sq) return;
    const __nv_bfloat16* o = p.o + b * p.o_sb + h * p.o_sh + i * p.o_ss;
    const __nv_bfloat16* g = p.dout + b * p.g_sb + h * p.g_sh + i * p.g_ss;
    float acc = 0.f;
    for (int c = lane; c < p.D / 8; c += 32) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + 8 * c);
      const uint4 d = *reinterpret_cast<const uint4*>(g + 8 * c);
      const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = __bfloat1622float2(ap[j]), y = __bfloat1622float2(dp[j]);
        acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) p.delta[((size_t)b * p.H + h) * p.Sq + i] = acc;
    return;
  }
  if (blockIdx.y != 0 || blockIdx.z != 0) return;
  const int nqt = (p.Sq + BM - 1) / BM, nkt = (p.Sk + BM - 1) / BM;
  const int t = ((int)blockIdx.x - row_blocks) * WARPS + warp;
  if (t >= nqt + nkt) return;
  const bool keys = t >= nqt;
  const int r0 = (keys ? t - nqt : t) * BM, n = keys ? p.Sk : p.Sq;
  const int* pos = keys ? p.k_pos : p.q_pos;
  int mn = INT_MAX, mx = INT_MIN, hole = 0;
  for (int j = lane; j < BM; j += 32) {
    const int r = r0 + j;
    const int v = r < n ? pos[r] : -1;
    if (keys ? v >= 0 : r < n) {
      mn = min(mn, v);
      mx = max(mx, v);
    } else {
      hole = 1;
    }
  }
  warp_min_max(mn, mx);
  hole = __any_sync(0xffffffffu, hole);
  if (lane == 0) p.ranges[t] = make_int4(mn, mx, keys ? hole : 0, 0);
}

// ---- dK, dV ----
// One block per (64-key tile, h, b).  The producer warp loads the K and V
// tiles once, then streams the query tiles the keys may be seen by (their
// Q and dO tiles, positions, lse and delta) through a 2-stage ring.  The
// products run transposed, keys as rows: S^T = K Q^T and dP^T = V dO^T,
// so P^T and dS^T land in registers as wgmma A fragments, and dV += P^T dO,
// dK += dS^T Q read dO and Q MN-major (the transpose bit) from the same
// tiles.  A 64 x DP f32 accumulator is DP / 2 registers a thread, so the
// warpgroups split the work: warpgroup 0 computes S^T, P^T (written to
// shared memory in f32, fragment order) and dV; warpgroup 1 dP^T, then dS^T
// from that P^T, and dK.  Each does two of the four products.
template <int DP> struct KVLayout {
  static constexpr int TILE = BM * DP * 2;   // one 64-row bf16 tile
  static constexpr int P_BYTES = BM * BM * 4;
  static constexpr int SMEM = 2 * TILE + STAGES * 2 * TILE + P_BYTES + 1024;  // + alignment
};

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    dkdv_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
               const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
               const Params p) {
  using L = KVLayout<DP>;
  constexpr int ATOMS = DP / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const Ks = align1024(smem_raw);  // [ATOMS][BM][ROW]
  uint8_t* const Vs = Ks + L::TILE;
  uint8_t* const Rs = Vs + L::TILE;  // stage s: Q at Rs + 2 s TILE, dO a TILE after
  float* const Ps = reinterpret_cast<float*>(Rs + STAGES * 2 * L::TILE);  // [32][128]
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], kvbar;
  __shared__ int slot[STAGES][4];        // query tile (-1: no more), q min, q max
  __shared__ int slot_qpos[STAGES][BM];  // 0 past Sq
  __shared__ float slot_lse[STAGES][BM];  // lse2_of
  __shared__ float slot_delta[STAGES][BM];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, k0 = kt * BM;
  const int kvh = p.kv_heads == 1 ? 0 : h, kvb = p.kv_batch == 1 ? 0 : b;
  const int nqt = (p.Sq + BM - 1) / BM;
  const size_t row0 = ((size_t)b * p.H + h) * p.Sq;
  const int4 kr = p.ranges[nqt + kt];  // the keys' valid min, max, and a hole

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_init(&kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroup: one warp issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp != 8) return;
    if (lane == 0) {
      mbar_expect_tx(&kvbar, 2 * L::TILE);
      for (int c = 0; c < ATOMS; ++c) {
        tma_load(Ks + c * BM * ROW, &kmap, &kvbar, 64 * c, k0, kvh, kvb);
        tma_load(Vs + c * BM * ROW, &vmap, &kvbar, 64 * c, k0, kvh, kvb);
      }
    }
    // the query tiles, 32 at a time: lane i tests tile t0 + i
    int n = 0;
    for (int t0 = 0; t0 < nqt; t0 += 32) {
      int4 qr = make_int4(INT_MAX, INT_MIN, 0, 0);
      if (t0 + lane < nqt) qr = p.ranges[t0 + lane];
      unsigned vis = __ballot_sync(
          0xffffffffu, !tile_hidden(kr.x, kr.y, qr.x, qr.y, p.causal, p.window));
      while (vis) {
        const int i = __ffs(vis) - 1;
        vis &= vis - 1;
        const int tt = t0 + i;
        const int qmin = __shfl_sync(0xffffffffu, qr.x, i);
        const int qmax = __shfl_sync(0xffffffffu, qr.y, i);
        int qp[2];
        float ls[2], dl[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = tt * BM + lane + 32 * e;
          qp[e] = row < p.Sq ? p.q_pos[row] : 0;
          ls[e] = lse2_of(p, row0, row);
          dl[e] = row < p.Sq ? p.delta[row0 + row] : 0.f;
        }
        const int s = n % STAGES;
        if (lane == 0) mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
        __syncwarp();
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          slot_qpos[s][lane + 32 * e] = qp[e];
          slot_lse[s][lane + 32 * e] = ls[e];
          slot_delta[s][lane + 32 * e] = dl[e];
        }
        if (lane == 0) {
          slot[s][0] = tt;
          slot[s][1] = qmin;
          slot[s][2] = qmax;
        }
        __syncwarp();
        if (lane == 0) {  // the arrival publishes the slot with the tiles
          uint8_t* const qs = Rs + s * 2 * L::TILE;
          mbar_expect_tx(&full[s], 2 * L::TILE);
          for (int c = 0; c < ATOMS; ++c) {
            tma_load(qs + c * BM * ROW, &qmap, &full[s], 64 * c, tt * BM, h, b);
            tma_load(qs + L::TILE + c * BM * ROW, &gmap, &full[s], 64 * c, tt * BM, h, b);
          }
        }
        __syncwarp();
        ++n;
      }
    }
    if (lane == 0) {  // a last slot with no tile ends the stream
      const int s = n % STAGES;
      mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
      slot[s][0] = -1;
      mbar_arrive(&full[s]);
    }
  } else {
    // ---- consumer warpgroups: the same 64 keys, two products each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp / 4, quad = lane % 4, t = tid % 128;
    const int r0 = (warp % 4) * 16 + lane / 4;  // this thread's keys: r0, r0 + 8
    // key r0 + 8 r is seen by query q iff qlo[r] <= q_pos[q] <= qhi[r]
    int qlo[2], qhi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + r0 + 8 * r;
      const int kp = key < p.Sk ? p.k_pos[key] : -1;
      qlo[r] = kp < 0 ? INT_MAX : (p.causal ? kp : INT_MIN);
      qhi[r] = kp < 0 ? INT_MIN
                      : (p.window > 0 ? (int)min((long long)kp + p.window - 1, (long long)INT_MAX)
                                      : INT_MAX);
    }
    const float sl2 = p.scale * LOG2E;
    float acc[DP / 2];  // warpgroup 0: dV; 1: dK before the scale
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    mbar_wait(&kvbar, 0);

    int n = 0;
    for (;; ++n) {
      const int s = n % STAGES;
      mbar_wait(&full[s], (n / STAGES) & 1);
      if (slot[s][0] < 0) break;
      uint8_t* const Qt = Rs + s * 2 * L::TILE;
      uint8_t* const Gt = Qt + L::TILE;
      uint32_t fa[4][4];  // P^T or dS^T in bf16: the A fragments of the update
      if (wg == 0) {
        // every (key, query) pair of the tile allowed: no per-element mask
        const bool whole = !kr.z && (!p.causal || kr.y <= slot[s][1]) &&
                           (p.window <= 0 || (long long)kr.x > (long long)slot[s][2] - p.window);
        const uint64_t ad = sw128_desc(Ks, 16, 1024), bd = sw128_desc(Qt, 16, 1024);
        float sc[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          mma_ss(sc, ad + (kstep(kk, BM) >> 4), bd + (kstep(kk, BM) >> 4), kk > 0);
        wg_commit();
        wg_wait_all();
        reg_fence(sc);
        // P^T: sc[4 j + 2 r + e] is key r0 + 8 r, query 8 j + 2 quad + e
        const int* qpos = slot_qpos[s] + 2 * quad;
        const float* ls = slot_lse[s] + 2 * quad;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = sc[4 * j + 2 * r + e] * sl2 - ls[8 * j + e];
              if (!whole) {
                const int qp = qpos[8 * j + e];
                if (!(qp >= qlo[r] && qp <= qhi[r])) x = neg_inf();
              }
              sc[4 * j + 2 * r + e] = exp2f(x);
            }
        // hand P^T to warpgroup 1 once it has read the last tile's
        if (n > 0) bar_sync(FREE, 256);
#pragma unroll
        for (int i = 0; i < 32; ++i) Ps[i * 128 + t] = sc[i];
        bar_arrive(READY, 256);
        to_a(sc, fa);
        // dV += P^T dO: dO's rows are queries (K), its 128-byte rows 64 of D (N)
        const uint64_t md = sw128_desc(Gt, BM * ROW, 1024);
        reg_fence(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_rs<DP>(acc, fa[kk], md + ((kk * 16 * ROW) >> 4));
      } else {
        const uint64_t ad = sw128_desc(Vs, 16, 1024), bd = sw128_desc(Gt, 16, 1024);
        float dp[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          mma_ss(dp, ad + (kstep(kk, BM) >> 4), bd + (kstep(kk, BM) >> 4), kk > 0);
        wg_commit();
        wg_wait_all();
        reg_fence(dp);
        // dS^T = P^T (dP^T - delta), P^T in f32 as warpgroup 0 left it
        const float* dl = slot_delta[s] + 2 * quad;
        bar_sync(READY, 256);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * r + e;
              dp[i] = Ps[i * 128 + t] * (dp[i] - dl[8 * j + e]);
            }
        bar_arrive(FREE, 256);
        to_a(dp, fa);
        // dK += dS^T Q, Q read MN-major
        const uint64_t md = sw128_desc(Qt, BM * ROW, 1024);
        reg_fence(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_rs<DP>(acc, fa[kk], md + ((kk * 16 * ROW) >> 4));
      }
      wg_commit();
      wg_wait_all();
      reg_fence(acc);
      mbar_arrive(&empty[s]);  // both warpgroups have read the stage's Q and dO
    }
    if (wg == 0 && n > 0) bar_sync(FREE, 256);  // warpgroup 1's last arrival

    // dV (warpgroup 0) or scale * dK (1) in bf16 to the K or V tile, which
    // only this warpgroup read, in its swizzled layout; then out 16 bytes a
    // thread, each key's D * 2 bytes contiguous
    uint8_t* const Os = wg == 0 ? Ks : Vs;
    const float mul = wg == 0 ? 1.f : p.scale;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = r0 + 8 * r;
#pragma unroll
      for (int c = 0; c < ATOMS; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(Os + c * BM * ROW + rr * ROW +
                                             ((j ^ (rr % 8)) * 16) + 4 * quad) =
              __floats2bfloat162_rn(acc[32 * c + 4 * j + 2 * r] * mul,
                                    acc[32 * c + 4 * j + 2 * r + 1] * mul);
    }
    bar_sync(3 + wg, 128);
    __nv_bfloat16* const out = (wg == 0 ? p.dv : p.dk) + ((size_t)b * p.H + h) * p.Sk * p.D;
    const int chunks = p.D / 8;
    for (int i = t; i < BM * chunks; i += 128) {
      const int rr = i / chunks, k = i % chunks, key = k0 + rr;
      if (key < p.Sk)
        *reinterpret_cast<uint4*>(out + (size_t)key * p.D + 8 * k) =
            *reinterpret_cast<const uint4*>(Os + (k / 8) * BM * ROW + rr * ROW +
                                            (((k % 8) ^ (rr % 8)) * 16));
    }
  }
}

// ---- dQ ----
// One block per (128-query tile, h, b): the forward's structure with a
// second product.  Q and dO stay resident (64 KB each at DP = 256); the
// producer streams the key tiles the queries may see, K through a 2-slot
// ring and V through one slot: V is released once dP is computed, so the
// next V loads while dS and dQ are, and K after dQ += dS K.  Two consumer
// warpgroups own 64 query rows each: S = Q K^T and dP = dO V^T on wgmma
// from shared memory, P and dS = P (dP - delta) in registers, dQ += dS K
// with K read MN-major.  Shared memory at DP = 256: 64 + 64 + 3 x 32 KB.
template <int DP> struct QLayout {
  static constexpr int TILE = BM * DP * 2;
  static constexpr int Q_BYTES = QB * DP * 2;
  static constexpr int SMEM = 2 * Q_BYTES + (STAGES + 1) * TILE + 1024;  // + alignment
};

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    dq_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
             const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
             const Params p) {
  using L = QLayout<DP>;
  constexpr int ATOMS = DP / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const Qs = align1024(smem_raw);  // [ATOMS][QB][ROW]
  uint8_t* const Gs = Qs + L::Q_BYTES;      // dO, the same
  uint8_t* const Ks = Gs + L::Q_BYTES;      // [STAGES] x [ATOMS][BM][ROW]
  uint8_t* const Vs = Ks + STAGES * L::TILE;
  __shared__ __align__(8) uint64_t kfull[STAGES], kempty[STAGES], vfull, vempty, qbar;
  // per K slot: the tile (-1: no more), its valid key range, whether it
  // holds a hole, and its 64 key positions (-1 past Sk)
  __shared__ int kslot[STAGES][4];
  __shared__ int kslot_kpos[STAGES][BM];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * QB, h = blockIdx.y, b = blockIdx.z;
  const int kvh = p.kv_heads == 1 ? 0 : h, kvb = p.kv_batch == 1 ? 0 : b;
  const int nqt = (p.Sq + BM - 1) / BM, nkt = (p.Sk + BM - 1) / BM;
  const int qt = 2 * blockIdx.x;
  const int4 qa = p.ranges[qt];
  const int4 qb = qt + 1 < nqt ? p.ranges[qt + 1] : make_int4(INT_MAX, INT_MIN, 0, 0);
  const int bq_min = min(qa.x, qb.x), bq_max = max(qa.y, qb.y);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], 2 * 128);
    }
    mbar_init(&vfull, 1);
    mbar_init(&vempty, 2 * 128);
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp != 8) return;
    if (lane == 0) {  // Q and dO, each as two boxes of 64 rows (one if 64 reach Sq)
      const int halves = q0 + BM < p.Sq ? 2 : 1;
      mbar_expect_tx(&qbar, halves * 2 * L::TILE);
      for (int c = 0; c < ATOMS; ++c)
        for (int e = 0; e < halves; ++e) {
          const int at = c * QB * ROW + e * BM * ROW;
          tma_load(Qs + at, &qmap, &qbar, 64 * c, q0 + e * BM, h, b);
          tma_load(Gs + at, &gmap, &qbar, 64 * c, q0 + e * BM, h, b);
        }
    }
    int n = 0;
    for (int t0 = 0; t0 < nkt; t0 += 32) {
      int4 kr = make_int4(INT_MAX, INT_MIN, 0, 0);
      if (t0 + lane < nkt) kr = p.ranges[nqt + t0 + lane];
      unsigned vis = __ballot_sync(
          0xffffffffu, !tile_hidden(kr.x, kr.y, bq_min, bq_max, p.causal, p.window));
      while (vis) {
        const int i = __ffs(vis) - 1;
        vis &= vis - 1;
        const int tt = t0 + i;
        const int kmin = __shfl_sync(0xffffffffu, kr.x, i);
        const int kmax = __shfl_sync(0xffffffffu, kr.y, i);
        const int hole = __shfl_sync(0xffffffffu, kr.z, i);
        const int j = tt * BM + lane;
        const int kp0 = j < p.Sk ? p.k_pos[j] : -1;
        const int kp1 = j + 32 < p.Sk ? p.k_pos[j + 32] : -1;
        const int s = n % STAGES;
        if (lane == 0) mbar_wait(&kempty[s], ((n / STAGES) & 1) ^ 1);
        __syncwarp();
        kslot_kpos[s][lane] = kp0;
        kslot_kpos[s][lane + 32] = kp1;
        if (lane == 0) {
          kslot[s][0] = tt;
          kslot[s][1] = kmin;
          kslot[s][2] = kmax;
          kslot[s][3] = hole;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(&kfull[s], L::TILE);
          for (int c = 0; c < ATOMS; ++c)
            tma_load(Ks + s * L::TILE + c * BM * ROW, &kmap, &kfull[s], 64 * c, tt * BM, kvh,
                     kvb);
          mbar_wait(&vempty, (n & 1) ^ 1);  // the last tile's dP is done
          mbar_expect_tx(&vfull, L::TILE);
          for (int c = 0; c < ATOMS; ++c)
            tma_load(Vs + c * BM * ROW, &vmap, &vfull, 64 * c, tt * BM, kvh, kvb);
        }
        __syncwarp();
        ++n;
      }
    }
    if (lane == 0) {
      const int s = n % STAGES;
      mbar_wait(&kempty[s], ((n / STAGES) & 1) ^ 1);
      kslot[s][0] = -1;
      mbar_arrive(&kfull[s]);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp / 4, quad = lane % 4;
    const int4 wr = wg == 0 ? qa : qb;  // this warpgroup's 64 rows' range
    const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;  // rows r0, r0 + 8 of the block
    const size_t row0 = ((size_t)b * p.H + h) * p.Sq;
    int hi[2], lo[2];  // key k is allowed for the row iff 0 <= k <= hi and k > lo
    float ls[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + 8 * r;
      hi[r] = INT_MAX;
      lo[r] = INT_MIN;
      if (row < p.Sq) {
        const long long qp = p.q_pos[row];
        if (p.causal) hi[r] = (int)qp;
        if (p.window > 0) lo[r] = (int)max(qp - p.window, (long long)INT_MIN);
      }
      ls[r] = lse2_of(p, row0, row);
      dl[r] = row < p.Sq ? p.delta[row0 + row] : 0.f;
    }
    const float sl2 = p.scale * LOG2E;
    float acc[DP / 2];  // dQ before the scale
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    mbar_wait(&qbar, 0);

    for (int n = 0;; ++n) {
      const int s = n % STAGES;
      mbar_wait(&kfull[s], (n / STAGES) & 1);
      if (kslot[s][0] < 0) break;
      const int mn = kslot[s][1], mx = kslot[s][2], hole = kslot[s][3];
      mbar_wait(&vfull, n & 1);
      if (!tile_hidden(mn, mx, wr.x, wr.y, p.causal, p.window)) {
        const bool whole = !hole && (!p.causal || mx <= wr.x) &&
                           (p.window <= 0 || (long long)mn > (long long)wr.y - p.window);
        const uint64_t qd = sw128_desc(Qs + wg * 64 * ROW, 16, 1024);
        const uint64_t gd = sw128_desc(Gs + wg * 64 * ROW, 16, 1024);
        const uint64_t kd = sw128_desc(Ks + s * L::TILE, 16, 1024);
        const uint64_t vd = sw128_desc(Vs, 16, 1024);
        float sc[32], dp[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          mma_ss(sc, qd + (kstep(kk, QB) >> 4), kd + (kstep(kk, BM) >> 4), kk > 0);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          mma_ss(dp, gd + (kstep(kk, QB) >> 4), vd + (kstep(kk, BM) >> 4), kk > 0);
        wg_commit();
        wg_wait_all();
        reg_fence(sc);
        reg_fence(dp);
        mbar_arrive(&vempty);
        // sc[4 j + 2 r + e] is row r0 + 8 r, key 8 j + 2 quad + e
        const int* kpos = kslot_kpos[s] + 2 * quad;
        uint32_t fa[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * r + e;
              float x = sc[i] * sl2 - ls[r];
              if (!whole) {
                const int k = kpos[8 * j + e];
                if (!(k >= 0 && k <= hi[r] && k > lo[r])) x = neg_inf();
              }
              dp[i] = exp2f(x) * (dp[i] - dl[r]);
            }
        to_a(dp, fa);
        // dQ += dS K: K's rows are keys (K), its 128-byte rows 64 of D (N)
        const uint64_t md = sw128_desc(Ks + s * L::TILE, BM * ROW, 1024);
        reg_fence(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_rs<DP>(acc, fa[kk], md + ((kk * 16 * ROW) >> 4));
        wg_commit();
        wg_wait_all();
        reg_fence(acc);
      } else {
        mbar_arrive(&vempty);
      }
      mbar_arrive(&kempty[s]);
    }

    // scale * dQ in bf16 to this warpgroup's own rows of the Q tile, then
    // out 16 bytes a thread
    uint8_t* const Os = Qs + wg * 64 * ROW;  // atom c at Os + c * QB * ROW
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = r0 % 64 + 8 * r;
#pragma unroll
      for (int c = 0; c < ATOMS; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(Os + c * QB * ROW + rr * ROW +
                                             ((j ^ (rr % 8)) * 16) + 4 * quad) =
              __floats2bfloat162_rn(acc[32 * c + 4 * j + 2 * r] * p.scale,
                                    acc[32 * c + 4 * j + 2 * r + 1] * p.scale);
    }
    bar_sync(1 + wg, 128);
    __nv_bfloat16* const out = p.dq + row0 * p.D;
    const int chunks = p.D / 8;
    for (int i = tid % 128; i < 64 * chunks; i += 128) {
      const int rr = i / chunks, k = i % chunks, row = q0 + wg * 64 + rr;
      if (row < p.Sq)
        *reinterpret_cast<uint4*>(out + (size_t)row * p.D + 8 * k) =
            *reinterpret_cast<const uint4*>(Os + (k / 8) * QB * ROW + rr * ROW +
                                            (((k % 8) ^ (rr % 8)) * 16));
    }
  }
}

// rowsum(dO * O) and the tiles' position ranges, then dK/dV, then dQ, in
// stream order
template <int DP>
int launch(const CUtensorMap& qm, const CUtensorMap& gm, const CUtensorMap& km,
           const CUtensorMap& vm, const Params& p, int B, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(dkdv_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       KVLayout<DP>::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             QLayout<DP>::SMEM);
  if (e != cudaSuccess) return (int)e;
  constexpr int WARPS = PREP_THREADS / 32;
  const int nqt = (p.Sq + BM - 1) / BM, nkt = (p.Sk + BM - 1) / BM;
  const int row_blocks = (p.Sq + WARPS - 1) / WARPS;
  const int range_blocks = (nqt + nkt + WARPS - 1) / WARPS;
  prep_kernel<<<dim3(row_blocks + range_blocks, p.H, B), PREP_THREADS, 0, st>>>(p, row_blocks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkdv_wgmma<DP><<<dim3(nkt, p.H, B), THREADS, KVLayout<DP>::SMEM, st>>>(qm, gm, km, vm, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_wgmma<DP><<<dim3((p.Sq + QB - 1) / QB, p.H, B), THREADS, QLayout<DP>::SMEM, st>>>(
      qm, gm, km, vm, p);
  return (int)cudaGetLastError();
}

}  // namespace tcb

}  // namespace

extern "C" {

const char* error_string(int code) {
  if (code == tc::ERR_NO_ENCODE) return "cuTensorMapEncodeTiled not found in the driver";
  if (code == tc::ERR_ENCODE) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// float32.  q, k, v, o: (B, H, S, D) with element strides (sb, sh, ss),
// unit stride on D, 16-byte aligned bases and strides in multiples of 4
// (the cp.async copies'); q_pos (Sq,), k_pos (Sk,) contiguous int32; lse
// null, or a contiguous (B, H, Sq) float32 buffer for the rows' log-sum-exp.
int flash_attention_f32_launch(const void* q, const void* k, const void* v, void* o,
                               void* lse, const void* q_pos, const void* k_pos, int B, int H,
                               int Sq, int Sk, int D, long long q_sb, long long q_sh, long long q_ss,
                               long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                               long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                               long long o_ss, int causal, int window, double scale,
                               void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || B > 65535 || H > 65535 || D < 16 || D > 256 ||
      D % 16 != 0 ||
      !tf::aligned({q, k, v, o}, {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,
                                  o_sh, o_ss}))
    return (int)cudaErrorInvalidValue;
  const tf::FwdParams p{static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<float*>(o),
                        static_cast<float*>(lse), static_cast<const int*>(q_pos),
                        static_cast<const int*>(k_pos),
                        q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                        Sq, Sk, D, causal, window, (float)scale};
  const cudaStream_t st = (cudaStream_t)stream;
  if (D <= 32) return tf::launch_fwd<32>(p, B, H, st);
  if (D <= 64) return tf::launch_fwd<64>(p, B, H, st);
  if (D <= 128) return tf::launch_fwd<128>(p, B, H, st);
  return tf::launch_fwd<256>(p, B, H, st);
}

// bfloat16.  q: (B, H, Sq, D); k, v: (Bk, Hk, Sk, D) with Bk in {1, B} and
// Hk in {1, H} (a length-1 axis is shared by every b or h); element
// strides (sb, sh, ss) each a multiple of 8 and 16-byte aligned bases; o
// like q with any strides; q_pos (Sq,), k_pos (Sk,) contiguous int32; lse
// as for the float32 kernel.
int flash_attention_bf16_launch(const void* q, const void* k, const void* v, void* o,
                                void* lse, const void* q_pos, const void* k_pos, int B, int H,
                                int Bk, int Hk, int Sq, int Sk, int D, long long q_sb, long long q_sh,
                                long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                                long long v_sb, long long v_sh, long long v_ss, long long o_sb,
                                long long o_sh, long long o_ss, int causal, int window,
                                double scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || B > 65535 || H > 65535 || D < 16 || D > 256 ||
      D % 16 != 0 || (Bk != 1 && Bk != B) || (Hk != 1 && Hk != H))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  int err = tc::make_map(&qm, q, B, H, Sq, D, q_sb, q_sh, q_ss, tc::BQ);
  if (!err) err = tc::make_map(&km, k, Bk, Hk, Sk, D, k_sb, k_sh, k_ss, tc::BK);
  if (!err) err = tc::make_map(&vm, v, Bk, Hk, Sk, D, v_sb, v_sh, v_ss, tc::BK);
  if (err) return err;
  const tc::Params p{static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
                     static_cast<const int*>(q_pos), static_cast<const int*>(k_pos), o_sb, o_sh,
                     o_ss, Sq, Sk, D, causal, window, Hk, Bk, (float)scale};
  const cudaStream_t st = (cudaStream_t)stream;
  if (D <= 64) return tc::launch<64>(qm, km, vm, p, B, H, st);
  if (D <= 128) return tc::launch<128>(qm, km, vm, p, B, H, st);
  return tc::launch<256>(qm, km, vm, p, B, H, st);
}

// The float32 backward.  q, o, dout: (B, H, Sq, D); k, v: (B, H, Sk, D);
// each with element strides (sb, sh, ss) (a stride-0 head axis allowed:
// every head's own dK, dV are written), unit stride on D and the forward's
// alignment; lse: the forward's (B, H, Sq) float32 log-sum-exp; delta:
// (B, H, Sq) float32 scratch; dq (B, H, Sq, D), dk and dv (B, H, Sk, D)
// contiguous float32.
int flash_attention_bwd_f32_launch(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, const void* q_pos,
                                   const void* k_pos, void* delta, void* dq, void* dk, void* dv,
                                   int B, int H, int Sq, int Sk, int D, long long q_sb,
                                   long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                                   long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                                   long long o_sb, long long o_sh, long long o_ss, long long g_sb,
                                   long long g_sh, long long g_ss, int causal, int window,
                                   double scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || B > 65535 || H > 65535 || D < 16 || D > 256 ||
      D % 16 != 0 ||
      !tf::aligned({q, k, v, dout, dq, dk, dv},
                   {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, g_sb, g_sh, g_ss}))
    return (int)cudaErrorInvalidValue;
  const tf::BwdParams p{static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<const float*>(o),
                        static_cast<const float*>(dout), static_cast<const float*>(lse),
                        static_cast<float*>(delta), static_cast<float*>(dq),
                        static_cast<float*>(dk), static_cast<float*>(dv),
                        static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
                        q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                        g_sb, g_sh, g_ss, H, Sq, Sk, D, causal, window, (float)scale};
  const cudaStream_t st = (cudaStream_t)stream;
  if (D <= 32) return tf::launch_bwd<32>(p, B, st);
  if (D <= 64) return tf::launch_bwd<64>(p, B, st);
  if (D <= 128) return tf::launch_bwd<128>(p, B, st);
  return tf::launch_bwd<256>(p, B, st);
}

// The bfloat16 backward.  q, o, dout: (B, H, Sq, D); k, v: (Bk, Hk, Sk, D)
// as for the forward (a length-1 axis shared); element strides each a
// multiple of 8 and 16-byte aligned bases (the TMA maps', and o's and
// dout's 16-byte loads); lse: the forward's (B, H, Sq) float32
// log-sum-exp; delta: (B, H, Sq) float32 scratch; ranges: int32 scratch of
// 4 * (ceil(Sq / 64) + ceil(Sk / 64)); dq (B, H, Sq, D), dk and dv (B, H,
// Sk, D) contiguous bfloat16, every head's dK and dV written.
int flash_attention_bwd_bf16_launch(const void* q, const void* k, const void* v, const void* o,
                                    const void* dout, const void* lse, const void* q_pos,
                                    const void* k_pos, void* delta, void* ranges, void* dq,
                                    void* dk, void* dv, int B, int H, int Bk, int Hk, int Sq,
                                    int Sk, int D, long long q_sb, long long q_sh, long long q_ss,
                                    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                                    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                                    long long o_ss, long long g_sb, long long g_sh, long long g_ss,
                                    int causal, int window, double scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || B > 65535 || H > 65535 || D < 16 || D > 256 ||
      D % 16 != 0 || (Bk != 1 && Bk != B) || (Hk != 1 && Hk != H))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, gm, km, vm;
  int err = tc::make_map(&qm, q, B, H, Sq, D, q_sb, q_sh, q_ss, tcb::BM);
  if (!err) err = tc::make_map(&gm, dout, B, H, Sq, D, g_sb, g_sh, g_ss, tcb::BM);
  if (!err) err = tc::make_map(&km, k, Bk, Hk, Sk, D, k_sb, k_sh, k_ss, tcb::BM);
  if (!err) err = tc::make_map(&vm, v, Bk, Hk, Sk, D, v_sb, v_sh, v_ss, tcb::BM);
  if (err) return err;
  const tcb::Params p{static_cast<const __nv_bfloat16*>(o),
                      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
                      static_cast<float*>(delta), static_cast<int4*>(ranges),
                      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
                      static_cast<__nv_bfloat16*>(dv), static_cast<const int*>(q_pos),
                      static_cast<const int*>(k_pos), o_sb, o_sh, o_ss, g_sb, g_sh, g_ss,
                      H, Sq, Sk, D, causal, window, Hk, Bk, (float)scale};
  const cudaStream_t st = (cudaStream_t)stream;
  if (D <= 64) return tcb::launch<64>(qm, gm, km, vm, p, B, st);
  if (D <= 128) return tcb::launch<128>(qm, gm, km, vm, p, B, st);
  return tcb::launch<256>(qm, gm, km, vm, p, B, st);
}

}  // extern "C"
