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
// fa_kernel, float32 (the exact path, 2e-5; TF32 would not hold it): one
// block of 256 threads per (64-query tile, h, b); KV tiles of 64 keys
// staged in shared memory (Q and K transposed, so the score loop reads
// both with float4 loads); f32 products on CUDA cores; each thread holds a
// 4 x 4 block of the scores and a 4 x (D / 16) block of the output
// accumulator; each warp runs the online softmax of 8 rows.  The same tile
// skip, tested against the block's 64 queries.  222,464 bytes of shared
// memory at D = 256.
//
// The backward (the port's own: the reference differentiates its jnp
// attention), three launches in stream order, also chosen by type.  With
// P = exp(scale S - lse) under the masks, delta = rowsum(dO * O) and dS =
// P (dP - delta): dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K.  Bound:
// 10 D operations a pair (S and dP recomputed, three updates); these
// kernels do 14 D, as the dQ kernel computes S and dP again.
// bfloat16 (tcb::): prep_kernel writes delta and each 64-row tile's
// position range; dkdv_wgmma<DP> (a block per 64-key tile: the keys' K and
// V once, the query tiles they may be seen by streamed through a ring)
// and dq_wgmma<DP> (a block per 128 queries over the key tiles they may
// see) run every product on wgmma fed by TMA, as fa_wgmma does; P^T, dS^T
// and dS are rounded to bf16 only as A operands, dS is formed from the f32
// P, every sum is f32.  float32 (bwd::): the same three steps on CUDA
// cores, 32 x 32 tiles, exact to float32 rounding.  Neither uses atomics:
// each accumulator sums its tiles in one fixed order, so two runs give the
// same bits.
#include <climits>
#include <cstdint>
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
// float32: CUDA-core kernel
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BQ = 64;        // queries of a block
constexpr int BK = 64;        // keys of a KV tile
constexpr int THREADS = 256;  // 16 x 16: ty owns rows 4ty..4ty+3
constexpr int QT_LD = BQ + 4;
constexpr int KT_LD = BK + 4;
constexpr int MAX_DC = 16;    // D / 16 output columns per thread

struct Params {
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

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)D * QT_LD + (size_t)D * KT_LD + (size_t)BK * D +
                          BQ * BK + 3 * BQ) + sizeof(int) * (BQ + BK);
}

__global__ void __launch_bounds__(THREADS, 1) fa_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int D = p.D;
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][QT_LD]
  float* Kt = Qt + (size_t)D * QT_LD;           // [D][KT_LD]
  float* Vs = Kt + (size_t)D * KT_LD;           // [BK][D]
  float* Ss = Vs + (size_t)BK * D;              // [BQ][BK] scores, then p
  float* m_s = Ss + BQ * BK;
  float* l_s = m_s + BQ;
  float* al_s = l_s + BQ;
  int* qpos_s = reinterpret_cast<int*>(al_s + BQ);
  int* kpos_s = qpos_s + BQ;
  __shared__ int range[4];  // q min, q max, valid k min, valid k max

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int nq = min(BQ, p.Sq - q0);
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  float* ob = p.o + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    Qt[d * QT_LD + r] = r < nq ? qb[(long long)(q0 + r) * p.q_ss + d] : 0.f;
  }
  if (tid < BQ) {
    qpos_s[tid] = tid < nq ? p.q_pos[q0 + tid] : 0;
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  if (warp == 0) {
    int mn = INT_MAX, mx = INT_MIN;
    for (int r = lane; r < nq; r += 32) {
      const int qp = p.q_pos[q0 + r];
      mn = min(mn, qp);
      mx = max(mx, qp);
    }
    warp_min_max(mn, mx);
    if (lane == 0) {
      range[0] = mn;
      range[1] = mx;
    }
  }
  __syncthreads();
  const int qmin = range[0], qmax = range[1];

  const int DC = D / 16;
  float o[4][MAX_DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAX_DC; ++j) o[i][j] = 0.f;

  for (int k0 = 0; k0 < p.Sk; k0 += BK) {
    const int nk = min(BK, p.Sk - k0);
    if (warp == 0) {
      int mn = INT_MAX, mx = INT_MIN;
      for (int c = lane; c < BK; c += 32) {
        const int kp = c < nk ? p.k_pos[k0 + c] : -1;
        kpos_s[c] = kp;
        if (kp >= 0) {
          mn = min(mn, kp);
          mx = max(mx, kp);
        }
      }
      warp_min_max(mn, mx);
      if (lane == 0) {
        range[2] = mn;
        range[3] = mx;
      }
    }
    __syncthreads();  // kpos_s and the key range are visible
    const bool skip = tile_hidden(range[2], range[3], qmin, qmax, p.causal, p.window);
    __syncthreads();  // every thread has read range[] before warp 0 rewrites it
    if (skip) continue;

    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      float kv = 0.f, vv = 0.f;
      if (c < nk) {
        kv = kb[(long long)(k0 + c) * p.k_ss + d];
        vv = vb[(long long)(k0 + c) * p.v_ss + d];
      }
      Kt[d * KT_LD + c] = kv;
      Vs[c * D + d] = vv;
    }
    __syncthreads();

    // scores of rows 4ty..4ty+3 and columns 4tx..4tx+3
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * QT_LD + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(Kt + d * KT_LD + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const long long qp = qpos_s[r];
      float s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kp = kpos_s[4 * tx + j];
        const bool ok = r < nq && kp >= 0 && (!p.causal || kp <= qp) &&
                        (p.window <= 0 || kp > qp - p.window);
        s[j] = ok ? acc[i][j] * p.scale : neg_inf();
      }
      *reinterpret_cast<float4*>(Ss + r * BK + 4 * tx) = make_float4(s[0], s[1], s[2], s[3]);
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w..8w+7; a masked score is -inf,
    // so its p is exactly 0 and a fully masked row keeps m and l
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const float s0 = Ss[r * BK + lane], s1 = Ss[r * BK + lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      Ss[r * BK + lane] = p0;
      Ss[r * BK + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        al_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // out = out * alpha + p @ v for rows 4ty..4ty+3, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = al_s[4 * ty + i];
#pragma unroll
      for (int j = 0; j < MAX_DC; ++j) o[i][j] *= alpha;
    }
    for (int c = 0; c < nk; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ss[(4 * ty + i) * BK + c];
#pragma unroll
      for (int j = 0; j < MAX_DC; ++j) {
        if (j < DC) {
          const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pr[i], vv, o[i][j]);
        }
      }
    }
    // the next tile's staging waits at its first barrier
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= nq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < MAX_DC; ++j)
      if (j < DC) ob[(long long)(q0 + r) * p.o_ss + tx + 16 * j] = o[i][j] / l;
    // the row's log-sum-exp, -inf for a row with no key
    if (p.lse != nullptr && tx == 0)
      p.lse[((size_t)b * gridDim.y + h) * p.Sq + q0 + r] =
          l_s[r] > 0.f ? m_s[r] + logf(l_s[r]) : neg_inf();
  }
}

}  // namespace f32

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
// Backward, float32: CUDA-core kernels
// ---------------------------------------------------------------------------

namespace bwd {

constexpr int BQ = 32;        // queries of a tile
constexpr int BK = 32;        // keys of a tile
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_C = 8;      // output columns d = lane + 32 c, c < D / 32 rounded up
constexpr int P_LD = BK + 4;  // row stride of the P / dS tiles (16-byte rows)

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;    // (B, H, Sq)
  float* delta;        // (B, H, Sq): rowsum(dO * O)
  float* dq;           // (B, H, Sq, D) contiguous
  float* dk;           // (B, H, Sk, D) contiguous
  float* dv;           // (B, H, Sk, D) contiguous
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

size_t smem_bytes(int D) {
  return sizeof(float) * (4 * (size_t)BQ * (D + 4) + 2 * BQ * P_LD + 2 * BQ) +
         sizeof(int) * (BQ + BK);
}

// delta[b, h, i] = sum_d dO[i, d] * O[i, d]: one warp a row
__global__ void __launch_bounds__(THREADS) delta_kernel(const Params p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * (THREADS / 32) + warp, h = blockIdx.y, b = blockIdx.z;
  if (i >= p.Sq) return;
  const float* o = p.o + b * p.o_sb + h * p.o_sh + i * p.o_ss;
  const float* g = p.dout + b * p.g_sb + h * p.g_sh + i * p.g_ss;
  float acc = 0.f;
  for (int d = lane; d < p.D; d += 32) acc = fmaf(o[d], g[d], acc);
  acc = warp_sum(acc);
  if (lane == 0) p.delta[((size_t)b * p.H + h) * p.Sq + i] = acc;
}

// rows [r0, r0 + n) of a (., D) tile with element stride ss into smem rows
// of stride ld; rows past n are zero
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, long long ss,
                                          int r0, int n, int D) {
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    dst[r * ld + d] = r < n ? src[(long long)(r0 + r) * ss + d] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T of one (32-query, 32-key) tile pair, then
// P = exp(scale * S - lse) under the masks and dS = P (dP - delta); thread
// (q = tid / 8, kk = tid % 8) owns keys kk + 8 j, so the 8 threads of a
// quarter warp read 8 different K rows (conflict-free with the padded
// stride) and one Q row (a broadcast).  Writes P and dS at ps[q * P_LD +
// k] and ds[q * ds_q + k * ds_k].
__device__ __forceinline__ void tile_p_ds(const float* Qs, const float* dOs, const float* Ks,
                                          const float* Vs, int ld, const float* lse_s,
                                          const float* dl_s, const int* qpos_s,
                                          const int* kpos_s, int nq, const Params& p, float* ps,
                                          float* ds, int ds_q, int ds_k) {
  const int q = threadIdx.x / 8, kk = threadIdx.x % 8;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d = 0; d < p.D; d += 4) {
    const float4 qv = *reinterpret_cast<const float4*>(Qs + q * ld + d);
    const float4 gv = *reinterpret_cast<const float4*>(dOs + q * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(Ks + (kk + 8 * j) * ld + d);
      const float4 vv = *reinterpret_cast<const float4*>(Vs + (kk + 8 * j) * ld + d);
      s[j] = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, fmaf(qv.z, kv.z, fmaf(qv.w, kv.w, s[j]))));
      dp[j] = fmaf(gv.x, vv.x, fmaf(gv.y, vv.y, fmaf(gv.z, vv.z, fmaf(gv.w, vv.w, dp[j]))));
    }
  }
  const long long qp = qpos_s[q];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = kk + 8 * j;
    const bool ok = q < nq && allowed(qp, kpos_s[k], p.causal, p.window);
    const float pr = ok ? expf(s[j] * p.scale - lse_s[q]) : 0.f;
    ps[q * P_LD + k] = pr;
    ds[q * ds_q + k * ds_k] = pr * (dp[j] - dl_s[q]);
  }
}

// the min and max of the valid positions (>= 0 for keys) of n entries
__device__ __forceinline__ void pos_range(const int* pos, int n, bool keys, int* out) {
  int mn = INT_MAX, mx = INT_MIN;
  for (int r = threadIdx.x; r < n; r += 32) {
    const int v = pos[r];
    if (!keys || v >= 0) {
      mn = min(mn, v);
      mx = max(mx, v);
    }
  }
  warp_min_max(mn, mx);
  if (threadIdx.x == 0) {
    out[0] = mn;
    out[1] = mx;
  }
}

// dK, dV of 32 keys: a loop over the query tiles the keys may be seen by.
// Thread (warp kr, lane) accumulates keys 4 kr .. 4 kr + 3 at columns
// lane + 32 c, in registers, summing the query tiles in order: no atomics.
__global__ void __launch_bounds__(THREADS, 1) dkdv_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int D = p.D, ld = D + 4;
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * ld;
  float* Qs = Vs + BK * ld;
  float* dOs = Qs + BQ * ld;
  float* Ps = dOs + BQ * ld;
  float* dSs = Ps + BQ * P_LD;
  float* lse_s = dSs + BQ * P_LD;
  float* dl_s = lse_s + BQ;
  int* qpos_s = reinterpret_cast<int*>(dl_s + BQ);
  int* kpos_s = qpos_s + BQ;
  __shared__ int range[4];  // valid key min, max; query min, max

  const int tid = threadIdx.x, lane = tid % 32, kr = tid / 32;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int nk = min(BK, p.Sk - k0);
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* gb = p.dout + b * p.g_sb + h * p.g_sh;
  const size_t row0 = ((size_t)b * p.H + h) * p.Sq;

  load_tile(Ks, ld, kb, p.k_ss, k0, nk, D);
  load_tile(Vs, ld, vb, p.v_ss, k0, nk, D);
  if (tid < BK) kpos_s[tid] = tid < nk ? p.k_pos[k0 + tid] : -1;
  __syncthreads();
  if (tid < 32) pos_range(kpos_s, BK, true, range);

  float dk[4][MAX_C], dv[4][MAX_C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int q0 = 0; q0 < p.Sq; q0 += BQ) {
    const int nq = min(BQ, p.Sq - q0);
    if (tid < BQ) {
      qpos_s[tid] = tid < nq ? p.q_pos[q0 + tid] : 0;
      lse_s[tid] = tid < nq ? p.lse[row0 + q0 + tid] : 0.f;
      dl_s[tid] = tid < nq ? p.delta[row0 + q0 + tid] : 0.f;
    }
    __syncthreads();
    if (tid < 32) pos_range(qpos_s, nq, false, range + 2);
    __syncthreads();
    const bool skip = tile_hidden(range[0], range[1], range[2], range[3], p.causal, p.window);
    if (skip) {
      __syncthreads();  // every thread has read range[] before it is rewritten
      continue;
    }
    load_tile(Qs, ld, qb, p.q_ss, q0, nq, D);
    load_tile(dOs, ld, gb, p.g_ss, q0, nq, D);
    __syncthreads();
    tile_p_ds(Qs, dOs, Ks, Vs, ld, lse_s, dl_s, qpos_s, kpos_s, nq, p, Ps, dSs, P_LD, 1);
    __syncthreads();
    for (int q = 0; q < nq; ++q) {
      const float4 pr = *reinterpret_cast<const float4*>(Ps + q * P_LD + 4 * kr);
      const float4 sr = *reinterpret_cast<const float4*>(dSs + q * P_LD + 4 * kr);
      const float pv[4] = {pr.x, pr.y, pr.z, pr.w}, sv[4] = {sr.x, sr.y, sr.z, sr.w};
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          const float g = dOs[q * ld + d], x = Qs[q * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][c] = fmaf(pv[i], g, dv[i][c]);
            dk[i][c] = fmaf(sv[i], x, dk[i][c]);
          }
        }
      }
    }
    __syncthreads();  // the next tile's loads overwrite Qs, dOs, P and dS
  }

  float* dkb = p.dk + (((size_t)b * p.H + h) * p.Sk) * D;
  float* dvb = p.dv + (((size_t)b * p.H + h) * p.Sk) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 4 * kr + i;
    if (k >= nk) continue;
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dkb[(size_t)(k0 + k) * D + d] = dk[i][c] * p.scale;
        dvb[(size_t)(k0 + k) * D + d] = dv[i][c];
      }
    }
  }
}

// dQ of 32 queries: a loop over the key tiles they may see.  Thread (warp
// qr, lane) accumulates queries 4 qr .. 4 qr + 3 at columns lane + 32 c;
// dS is staged transposed so a thread reads its 4 queries as one float4.
__global__ void __launch_bounds__(THREADS, 1) dq_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int D = p.D, ld = D + 4;
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BQ * ld;
  float* Ks = dOs + BQ * ld;
  float* Vs = Ks + BK * ld;
  float* Ps = Vs + BK * ld;
  float* dSt = Ps + BQ * P_LD;  // [key][query]
  float* lse_s = dSt + BK * P_LD;
  float* dl_s = lse_s + BQ;
  int* qpos_s = reinterpret_cast<int*>(dl_s + BQ);
  int* kpos_s = qpos_s + BQ;
  __shared__ int range[4];  // query min, max; valid key min, max

  const int tid = threadIdx.x, lane = tid % 32, qr = tid / 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int nq = min(BQ, p.Sq - q0);
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* gb = p.dout + b * p.g_sb + h * p.g_sh;
  const size_t row0 = ((size_t)b * p.H + h) * p.Sq;

  load_tile(Qs, ld, qb, p.q_ss, q0, nq, D);
  load_tile(dOs, ld, gb, p.g_ss, q0, nq, D);
  if (tid < BQ) {
    qpos_s[tid] = tid < nq ? p.q_pos[q0 + tid] : 0;
    lse_s[tid] = tid < nq ? p.lse[row0 + q0 + tid] : 0.f;
    dl_s[tid] = tid < nq ? p.delta[row0 + q0 + tid] : 0.f;
  }
  __syncthreads();
  if (tid < 32) pos_range(qpos_s, nq, false, range);

  float dq[4][MAX_C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) dq[i][c] = 0.f;

  for (int k0 = 0; k0 < p.Sk; k0 += BK) {
    const int nk = min(BK, p.Sk - k0);
    if (tid < BK) kpos_s[tid] = tid < nk ? p.k_pos[k0 + tid] : -1;
    __syncthreads();
    if (tid < 32) pos_range(kpos_s, BK, true, range + 2);
    __syncthreads();
    const bool skip = tile_hidden(range[2], range[3], range[0], range[1], p.causal, p.window);
    if (skip) {
      __syncthreads();  // every thread has read range[] before it is rewritten
      continue;
    }
    load_tile(Ks, ld, kb, p.k_ss, k0, nk, D);
    load_tile(Vs, ld, vb, p.v_ss, k0, nk, D);
    __syncthreads();
    tile_p_ds(Qs, dOs, Ks, Vs, ld, lse_s, dl_s, qpos_s, kpos_s, nq, p, Ps, dSt, 1, P_LD);
    __syncthreads();
    for (int k = 0; k < nk; ++k) {
      const float4 sr = *reinterpret_cast<const float4*>(dSt + k * P_LD + 4 * qr);
      const float sv[4] = {sr.x, sr.y, sr.z, sr.w};
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          const float x = Ks[k * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(sv[i], x, dq[i][c]);
        }
      }
    }
    __syncthreads();  // the next tile's loads overwrite K, V and dS
  }

  float* dqb = p.dq + row0 * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = 4 * qr + i;
    if (q >= nq) continue;
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dqb[(size_t)(q0 + q) * D + d] = dq[i][c] * p.scale;
    }
  }
}

int launch(const Params& p, int B, cudaStream_t st) {
  const size_t smem = smem_bytes(p.D);
  cudaError_t e = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  delta_kernel<<<dim3((p.Sq + THREADS / 32 - 1) / (THREADS / 32), p.H, B), THREADS, 0, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkdv_kernel<<<dim3((p.Sk + BK - 1) / BK, p.H, B), THREADS, smem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_kernel<<<dim3((p.Sq + BQ - 1) / BQ, p.H, B), THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace bwd

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

// float32.  q, k, v, o: (B, H, S, D) with element strides (sb, sh, ss) and
// unit stride on D; q_pos (Sq,), k_pos (Sk,) contiguous int32; lse null,
// or a contiguous (B, H, Sq) float32 buffer for the rows' log-sum-exp.
int flash_attention_f32_launch(const void* q, const void* k, const void* v, void* o,
                               void* lse, const void* q_pos, const void* k_pos, int B, int H,
                               int Sq, int Sk, int D, long long q_sb, long long q_sh, long long q_ss,
                               long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                               long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                               long long o_ss, int causal, int window, double scale,
                               void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || B > 65535 || H > 65535 || D < 16 ||
      D > 16 * f32::MAX_DC || D % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const f32::Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<float*>(o),
                      static_cast<float*>(lse), static_cast<const int*>(q_pos),
                      static_cast<const int*>(k_pos),
                      q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                      Sq, Sk, D, causal, window, (float)scale};
  const size_t smem = f32::smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(f32::fa_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + f32::BQ - 1) / f32::BQ, H, B);
  f32::fa_kernel<<<grid, f32::THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
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
// every head's own dK, dV are written) and unit stride on D; lse: the
// forward's (B, H, Sq) float32 log-sum-exp; delta: (B, H, Sq) float32
// scratch; dq (B, H, Sq, D), dk and dv (B, H, Sk, D) contiguous float32.
int flash_attention_bwd_f32_launch(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, const void* q_pos,
                                   const void* k_pos, void* delta, void* dq, void* dk, void* dv,
                                   int B, int H, int Sq, int Sk, int D, long long q_sb,
                                   long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                                   long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                                   long long o_sb, long long o_sh, long long o_ss, long long g_sb,
                                   long long g_sh, long long g_ss, int causal, int window,
                                   double scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || B > 65535 || H > 65535 || D < 16 ||
      D > 32 * bwd::MAX_C || D % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const bwd::Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<const float*>(o),
                      static_cast<const float*>(dout), static_cast<const float*>(lse),
                      static_cast<float*>(delta), static_cast<float*>(dq),
                      static_cast<float*>(dk), static_cast<float*>(dv),
                      static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
                      q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                      g_sb, g_sh, g_ss, H, Sq, Sk, D, causal, window, (float)scale};
  return bwd::launch(p, B, (cudaStream_t)stream);
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
