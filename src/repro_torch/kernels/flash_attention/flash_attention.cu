// Flash attention with position masks: for every (b, h) and query i,
//   out[i] = softmax_j(scale * q[i] . k[j] over the allowed j) @ v
// where key j is allowed for query i iff k_pos[j] >= 0 (-1 is a hole of a
// ring cache), k_pos[j] <= q_pos[i] when causal, and
// k_pos[j] > q_pos[i] - window when window > 0.  A query with no allowed
// key gives 0.  scale = D^-1/2.  q, k, v: (B, H, S, D) float32 or bf16 with
// any strides on B, H and S (a stride-0 head axis expands MQA's one KV
// head for free) and unit stride on D; out has q's type.  Any Sq and Sk;
// D a multiple of 16 up to 256.
//
// Replaces the Pallas TPU kernel _fa_kernel / flash_attention_pallas in
// src/repro/kernels/flash_attention/flash_attention.py (grid (B, H, nq,
// nk), the KV axis sequential, m, l and the accumulator in VMEM), without
// its padding of S to the block size.
//
// Bound: 4 D operations per allowed (query, key) pair against reading q,
// k and v and writing out once: at D = 256 the operations bound it by far
// (the tensor cores' bf16 rate).  This first kernel runs the products on
// CUDA cores in float32, as the Pallas kernel casts to float32, so it
// reaches at best the card's float32 rate, 1/15 of the bf16 tensor rate;
// mma.sync / wgmma on bf16 tiles is later work.
// Design: one block of 256 threads per (64-query tile, h, b); KV tiles of
// 64 keys staged in shared memory as float32 (Q and K transposed, so the
// score loop reads both with float4 loads; rows padded by 4 floats).  Each
// thread holds a 4 x 4 block of the 64 x 64 scores and a 4 x (D / 16)
// block of the float32 output accumulator in registers (64 floats at
// D = 256: the 64 KB accumulator of a 64-row tile lives in the registers
// of the whole block, not in one place).  Each warp runs the online
// softmax of 8 rows; m, l and the rescale factor live in shared memory.
// Before it loads a KV tile the block tests the tile's positions: a tile
// with no valid key, or whose keys all lie after the tile's last query
// (causal) or at or before its first query minus the window, is masked
// for every query of the tile, an exact no-op of the online softmax
// (m stays, alpha = 1, p = 0), so it is skipped.  At S = 4096 and window
// 2048 that leaves 39% of the tiles a full (nq, nk) grid visits.
// Shared memory at D = 256: 222,464 bytes, one block per SM.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // queries of a block
constexpr int BK = 64;        // keys of a KV tile
constexpr int THREADS = 256;  // 16 x 16: ty owns rows 4ty..4ty+3
constexpr int QT_LD = BQ + 4;
constexpr int KT_LD = BK + 4;
constexpr int MAX_DC = 16;    // D / 16 output columns per thread
constexpr float NEG = -0.7f * 3.4028234663852886e38f;  // the reference's

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* q_pos;
  const int* k_pos;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int Sq, Sk, D, causal, window;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)D * QT_LD + (size_t)D * KT_LD + (size_t)BK * D +
                          BQ * BK + 3 * BQ) + sizeof(int) * (BQ + BK);
}

template <typename T>
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
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    Qt[d * QT_LD + r] = r < nq ? to_f(qb[(long long)(q0 + r) * p.q_ss + d]) : 0.f;
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
  const long long qmin = range[0], qmax = range[1];

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
    const long long kmin = range[2], kmax = range[3];
    const bool skip = kmin > kmax || (p.causal && kmin > qmax) ||
                      (p.window > 0 && kmax <= qmin - p.window);
    __syncthreads();  // every thread has read range[] before warp 0 rewrites it
    if (skip) continue;

    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      float kv = 0.f, vv = 0.f;
      if (c < nk) {
        kv = to_f(kb[(long long)(k0 + c) * p.k_ss + d]);
        vv = to_f(vb[(long long)(k0 + c) * p.v_ss + d]);
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
      if (j < DC) ob[(long long)(q0 + r) * p.o_ss + tx + 16 * j] = from_f<T>(o[i][j] / l);
  }
}

template <typename T>
int launch(const Params& p, int B, int H, cudaStream_t st) {
  const size_t smem = smem_bytes(p.D);
  cudaError_t e = cudaFuncSetAttribute(fa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, H, B);
  fa_kernel<T><<<grid, THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, o: (B, H, S, D) with element strides (sb, sh, ss) and unit
// stride on D; q_pos (Sq,), k_pos (Sk,) contiguous int32; bf16 != 0 means
// every tensor is bf16, else float32.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           const void* q_pos, const void* k_pos, int B, int H, int Sq,
                           int Sk, int D, long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                           long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                           long long o_ss, int causal, int window, double scale, int bf16,
                           void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || B > 65535 || H > 65535 || D < 16 ||
      D > 16 * MAX_DC || D % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                 Sq, Sk, D, causal, window, (float)scale};
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(p, B, H, st) : launch<float>(p, B, H, st);
}

}  // extern "C"
