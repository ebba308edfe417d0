// Decode attention: one new query token a sequence against its ring cache.
// For every sequence b and query head h, with G = H / KVv query heads to a
// KV head (head h reads KV head h / G),
//   out[b, h] = softmax_j(scale * q[b, h] . k[b, j, h / G]) @ v[b, j, h / G]
// over the cache's slots j, where slot j is allowed iff k_pos[b, j] >= 0
// (-1 is an empty slot), k_pos[b, j] <= pos[b], and
// k_pos[b, j] > pos[b] - window when window > 0.  The cache is a ring, so
// the slots are in no position order: the mask is applied slot by slot.  A
// slot the mask hides scores NEG, as the plain version's torch.where does,
// so a row with no allowed slot averages v over every slot, as there.
// scale = hd^-1/2.  q (B, H, hd); k, v (B, Sc, KVv, hd) in the cache's
// type, read as they are stored (no head expansion, no float32 copy); any
// strides on B, Sc and KVv, unit stride on hd; out (B, H, hd) in q's type.
//
// Replaces no Pallas kernel: the reference computes decode attention in
// jnp (src/repro/models/attention.py, _decode_mha: both products in the
// cache's type with float32 sums, P rounded to the cache's type before
// P V).  Added because the port's plain version of it expanded the cache to
// H heads and copied it to float32 every layer of every step.
//
// Bound: the bytes of K and V, each read once: 4 hd operations a (query
// head, slot) pair against 2 hd elements of the slot, so G x 2 / sizeof(T)
// operations a byte (7 at qwen2-7b's G = 7 in bf16), far below the ~295 at
// which the H100's tensor cores would bound it.  So the design is about
// reading every K and V row once, from every SM at once, and doing little
// else per byte:
//
// * Grouped queries.  A block takes one (sequence, KV head, range of
//   slots) and holds the query heads of the group that read that KV head
//   (gb of them: the group rounded up to a power of two; in float32 at
//   most 8, a larger group cut into blocks of 8), so one read of a K or V
//   row serves every head of the group.
// * Split-KV (flash-decoding).  The Sc slots are cut into n_split ranges
//   (the wrapper picks n_split from B x KVv and Sc, so the blocks fill the
//   132 SMs once at the blocks an SM holds of the launched variant, from
//   decode_attention_blocks_per_sm: a partial second wave would be a
//   tail); each block keeps an online softmax over its range and writes its unnormalised float32 output with its running max
//   and sum, its warps merged in order through shared memory; the last
//   block of a (sequence, KV head) to finish, found by a counter (which it
//   leaves zero for the next launch), merges that column's ranges in a
//   fixed order and writes the output: one launch, the same bits whichever
//   block is last.
// * Loads.  Each of a block's 4 warps takes chunks of slots in turn and
//   keeps the next chunks of K, V and k_pos in flight through its own ring
//   of 16-byte cp.async copies in shared memory.
// * Scores pre-scaled by scale * log2 e; masked slots NEG, slots past the
//   range -inf; one max a head a chunk, exp2, the rows' sums of the f32 p;
//   P rounded to bf16 before P V for a bf16 cache (as the reference's
//   p.astype(v.dtype)); the accumulator rescaled only when a chunk raised a
//   head's max.
//
// bf16_kernel<HD> (the serving path): the products on the tensor cores,
// mma.sync m16n8k16 with float32 sums, so the card's instruction rate is
// far from the limit.  The group's heads (up to 16, zero rows past it) are
// the 16 rows of A: Q's fragments in registers for the whole range; a warp
// takes chunks of 16 slots, S = Q K^T from K rows read by ldmatrix, the
// softmax on S's fragments (a row's max and sum over the lanes of a quad),
// P packed to bf16 in registers as the A operand of O += P V, V read by
// ldmatrix.trans.  Shared rows are padded by 16 bytes, so ldmatrix's eight
// row reads fall in distinct banks.
//
// f32_kernel<HD, GB> (the reduced configurations): the float32 products on
// the CUDA cores (the tensor cores would round them to TF32).  A group of
// LPK lanes reads a slot's row (KPS = 32 / LPK slots a step); each lane
// keeps its DPL dims of the GB heads' q, q . k is DPL fused multiply-adds
// a head a lane and a reduce-scatter over the slot's lanes (GB - 1
// shuffles, not GB x log2 LPK) leaves each lane a head's score, which goes
// to shared memory for the chunk's max and exp2; O += P V per lane.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 4;  // warps a block
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -0.7f * 3.40282347e38f;  // the plain version's masked score
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SPLIT = 128;  // slot ranges a column at most (the merge's weights in shared memory)

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* k_pos;
  const int* pos;
  float* part;    // (B, H, n_split, HD + 4): each range's o, then its m and l (and 2 pad)
  void* out;      // (B, H, HD) in q's type
  int* counters;  // a column's finished ranges, zero between launches
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, kp_sb, o_sb, o_sh;
  int H, G, gb, Sc, n_split, split_len, window;
  float qscale;  // scale * log2 e
};

// What a block works on: grid (n_split, KVv x chunks of gb heads, B).
struct Work {
  int b, split, h0, ng, s0, s1, pos;
  __device__ explicit Work(const Params& p) {
    const int chunks = (p.G + p.gb - 1) / p.gb;
    const int kvh = blockIdx.y / chunks;
    b = blockIdx.z;
    split = blockIdx.x;
    h0 = kvh * p.G + (blockIdx.y % chunks) * p.gb;
    ng = min(p.gb, kvh * p.G + p.G - h0);
    s0 = split * p.split_len;
    s1 = min(p.Sc, s0 + p.split_len);
    pos = p.pos[b];
  }
  __device__ int kvh(const Params& p) const { return h0 / p.G; }
  __device__ bool allowed(const Params& p, int kp) const {
    return kp >= 0 && kp <= pos && (p.window <= 0 || kp > pos - p.window);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// 16 bytes from global to shared memory; zeros when !valid
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The warps' partial results, [NW][rows][HD + 2] floats (o, m, l) in
// shared memory, merged in warp order into the block's range of p.part
// (rows of HD + 4 floats, 16-byte aligned).
template <int HD>
__device__ __forceinline__ void merge_warps(const Params& p, const Work& w, const float* M,
                                            int rows) {
  for (int idx = threadIdx.x; idx < w.ng * (HD + 2); idx += NW * 32) {
    const int g = idx / (HD + 2), d = idx % (HD + 2);
    float mx = NEG;
#pragma unroll
    for (int x = 0; x < NW; ++x) mx = fmaxf(mx, M[(x * rows + g) * (HD + 2) + HD]);
    float val = mx;
    if (d != HD) {
      val = 0.f;
#pragma unroll
      for (int x = 0; x < NW; ++x)
        val += exp2f(M[(x * rows + g) * (HD + 2) + HD] - mx) * M[(x * rows + g) * (HD + 2) + d];
    }
    p.part[((long long)(w.b * p.H + w.h0 + g) * p.n_split + w.split) * (HD + 4) + d] = val;
  }
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// After merge_warps: the column's last block to finish merges its heads'
// ranges in order and writes o / l (reading the other blocks' parts from
// L2), and leaves the column's counter zero.  ``smem`` (the merge area,
// done with) takes each range's weight exp2(m - max m) a head.
template <typename T, int HD>
__device__ __forceinline__ void finish(const Params& p, const Work& w, float* smem) {
  __shared__ int last;
  __threadfence();  // this block's part reaches every block before its count
  __syncthreads();
  if (threadIdx.x == 0) {
    int* counter = p.counters + (long long)w.b * gridDim.y + blockIdx.y;
    last = atomicAdd(counter, 1) == p.n_split - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, ns = p.n_split;
  const float* col = p.part + (long long)(w.b * p.H + w.h0) * ns * (HD + 4);
  float* wt = smem;  // [ng][ns] weights
  float* lsum = smem + w.ng * ns;  // [ng] the merged row sums
  for (int g = warp; g < w.ng; g += NW) {  // a warp a head
    const float* r = col + (long long)g * ns * (HD + 4);
    float mx = NEG;
    for (int s = lane; s < ns; s += 32) mx = fmaxf(mx, __ldcg(r + s * (HD + 4) + HD));
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    float l = 0.f;
    for (int s = lane; s < ns; s += 32) {
      const float x = exp2f(__ldcg(r + s * (HD + 4) + HD) - mx);
      wt[g * ns + s] = x;
      l += x * __ldcg(r + s * (HD + 4) + HD + 1);
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) l += __shfl_xor_sync(FULL, l, o);
    if (lane == 0) lsum[g] = l;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < w.ng * (HD / 4); idx += NW * 32) {
    const int g = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
    const float* r = col + (long long)g * ns * (HD + 4) + d;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < ns; ++s) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(r + s * (HD + 4)));
      const float c = wt[g * ns + s];
      o.x += c * x.x;
      o.y += c * x.y;
      o.z += c * x.z;
      o.w += c * x.w;
    }
    const float inv = 1.f / lsum[g];
    T* out = static_cast<T*>(p.out) + w.b * p.o_sb + (w.h0 + g) * p.o_sh + d;
    out[0] = from_float<T>(o.x * inv);
    out[1] = from_float<T>(o.y * inv);
    out[2] = from_float<T>(o.z * inv);
    out[3] = from_float<T>(o.w * inv);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

namespace tcb {

constexpr int KEYS = 16;    // slots a warp's chunk
constexpr int ROWS = 16;    // heads a block at most: the rows of an m16 tile
constexpr int NSTAGE = 3;   // ring slots a warp: NSTAGE - 1 chunks in flight

template <int HD> struct Geo {
  static constexpr int RS = HD * 2 + 16;           // bytes a shared row, padded
  static constexpr int TILE = KEYS * RS;            // K (or V) of a chunk
  static constexpr int STAGE = 2 * TILE + KEYS * 4;  // K, V and k_pos
  static constexpr int NV = HD / 8;                 // 16-byte vectors a row
  static constexpr int SMEM = NW * NSTAGE * STAGE;
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  static_assert(NW * ROWS * (HD + 2) * 4 <= SMEM, "merge area outgrows the rings");
  static_assert((ROWS * MAX_SPLIT + ROWS) * 4 <= SMEM, "the merge's weights outgrow the rings");
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(addr)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(addr)));
}
// d += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 float32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// grid (n_split, KVv x chunks of gb heads, B), NW warps.  Lane (r, c) =
// (lane / 4, 2 (lane % 4)) holds S's and O's rows r and r + 8, columns
// c and c + 1 of each 8-wide tile (the m16n8 accumulator's layout).
template <int HD>
__global__ void __launch_bounds__(NW * 32) bf16_kernel(const Params p) {
  using Gm = Geo<HD>;
  constexpr int RS = Gm::RS, TILE = Gm::TILE, STAGE = Gm::STAGE, NV = Gm::NV;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = lane >> 2, c = (lane & 3) * 2;
  const Work w(p);
  using bf16 = __nv_bfloat16;
  const bf16* kb = static_cast<const bf16*>(p.k) + w.b * p.k_sb + w.kvh(p) * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + w.b * p.v_sb + w.kvh(p) * p.v_sh;
  const int* kpb = p.k_pos + w.b * p.kp_sb;
  unsigned char* ring = smem + warp * (NSTAGE * STAGE);
  const int n_chunks = (w.s1 - w.s0 + KEYS - 1) / KEYS;
  const int mine = n_chunks > warp ? (n_chunks - warp + NW - 1) / NW : 0;

  auto issue = [&](int i) {
    unsigned char* st = ring + (i % NSTAGE) * STAGE;
    const int first = w.s0 + (warp + NW * i) * KEYS;
#pragma unroll
    for (int u = lane; u < KEYS * NV; u += 32) {
      const int row = u / NV, vi = u % NV, key = first + row;
      const bool ok = key < w.s1;
      const long long j = ok ? key : w.s0;
      cp16(st + row * RS + vi * 16, kb + j * p.k_ss + vi * 8, ok);
      cp16(st + TILE + row * RS + vi * 16, vb + j * p.v_ss + vi * 8, ok);
    }
    if (lane < KEYS) {
      const bool ok = first + lane < w.s1;
      cp4(st + 2 * TILE + lane * 4, kpb + (ok ? first + lane : w.s0), ok);
    }
  };
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < mine) issue(i);
    cp_commit();
  }

  // Q's A fragments, zero past the block's heads
  uint32_t qa[HD / 16][4];
  {
    const bf16* qb = static_cast<const bf16*>(p.q) + w.b * p.q_sb;
    auto word = [&](int row, int col) -> uint32_t {
      return row < w.ng ? *reinterpret_cast<const uint32_t*>(qb + (w.h0 + row) * p.q_sh + col)
                        : 0u;
    };
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      qa[ks][0] = word(r, ks * 16 + c);
      qa[ks][1] = word(r + 8, ks * 16 + c);
      qa[ks][2] = word(r, ks * 16 + c + 8);
      qa[ks][3] = word(r + 8, ks * 16 + c + 8);
    }
  }

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};  // rows r, r + 8; l this lane's part

  for (int i = 0; i < mine; ++i) {
    if (i + NSTAGE - 1 < mine) issue(i + NSTAGE - 1);
    cp_commit();
    cp_wait<NSTAGE - 1>();
    __syncwarp();  // the chunk came through every lane's copies
    const unsigned char* st = ring + (i % NSTAGE) * STAGE;
    const int first = w.s0 + (warp + NW * i) * KEYS;
    const int j = lane >> 3;  // the 8 x 8 matrix this lane addresses for ldmatrix

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {  // matrices: slots 8 (j / 2).., dims 8 (j % 2)..
      uint32_t b[4];
      ldsm_x4(b, st + ((j >> 1) * 8 + (lane & 7)) * RS + (ks * 16 + (j & 1) * 8) * 2);
      mma(s[0], qa[ks], b[0], b[1]);
      mma(s[1], qa[ks], b[2], b[3]);
    }

    const int* KP = reinterpret_cast<const int*>(st + 2 * TILE);
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int slot = n * 8 + c + e;
        const bool inside = first + slot < w.s1, ok = w.allowed(p, KP[slot]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x = !inside ? neg_inf() : (ok ? s[n][2 * h + e] * p.qscale : NEG);
          s[n][2 * h + e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = exp2f(m_run[h] - m_new);
      m_run[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pr = exp2f(s[n][2 * h + e] - m_new);
          s[n][2 * h + e] = pr;
          sum += pr;
        }
      l_run[h] = l_run[h] * alpha[h] + sum;
    }
    if (__any_sync(FULL, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }
    // P (rows x 16 slots) as an A fragment, rounded to bf16
    const uint32_t pa[4] = {pack(s[0][0], s[0][1]), pack(s[0][2], s[0][3]),
                            pack(s[1][0], s[1][1]), pack(s[1][2], s[1][3])};
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {  // matrices: slots 8 (j % 2).., dims 8 (j / 2)..
      uint32_t b[4];
      ldsm_x4_t(b, st + TILE + ((j & 1) * 8 + (lane & 7)) * RS + (np * 16 + (j >> 1) * 8) * 2);
      mma(o[2 * np], pa, b[0], b[1]);
      mma(o[2 * np + 1], pa, b[2], b[3]);
    }
    __syncwarp();  // every lane has read the slot the next chunk's copies refill
  }
  cp_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(FULL, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(FULL, l_run[h], 2);
  }

  __syncthreads();  // the rings are done: the merge area takes their place
  float* M = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* row = M + (warp * ROWS + r + 8 * h) * (HD + 2);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      row[n * 8 + c] = o[n][2 * h];
      row[n * 8 + c + 1] = o[n][2 * h + 1];
    }
    if (c == 0) {
      row[HD] = m_run[h];
      row[HD + 1] = l_run[h];
    }
  }
  __syncthreads();
  merge_warps<HD>(p, w, M, ROWS);
  finish<__nv_bfloat16, HD>(p, w, M);
}

// Launches the kernel on p, or with p null writes the blocks an SM holds
// at once to *resident (its shared memory, registers and threads).
template <int HD> int run(const Params* p, int B, int KVv, cudaStream_t st, int* resident) {
  static bool sized = false;  // the kernel's shared memory attribute, set once
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<HD>::SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  if (!p)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, bf16_kernel<HD>,
                                                              NW * 32, Geo<HD>::SMEM);
  const int chunks = (p->G + p->gb - 1) / p->gb;
  bf16_kernel<HD><<<dim3(p->n_split, KVv * chunks, B), NW * 32, Geo<HD>::SMEM, st>>>(*p);
  return (int)cudaGetLastError();
}

}  // namespace tcb

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int NSTAGE = 4;  // ring slots a warp: NSTAGE - 1 chunks in flight

template <int HD> struct Geo {
  static constexpr int NV = HD / 4;                         // 16-byte vectors a row
  static constexpr int LPK = (NV & -NV) < 32 ? (NV & -NV) : 32;  // lanes a slot
  static constexpr int VPL = NV / LPK;                      // vectors a lane
  static constexpr int DPL = VPL * 4;                       // dims a lane
  static constexpr int KPS = 32 / LPK;                      // slots a warp step
  static constexpr int NSTEP = VPL >= 4 ? 1 : 4 / VPL;      // steps a chunk
  static constexpr int CK = NSTEP * KPS;                    // slots a chunk
  static constexpr int TILE = CK * HD * 4;                  // bytes of K (or V) a chunk
  static constexpr int STAGE = (2 * TILE + CK * 4 + 15) / 16 * 16;  // K, V, k_pos; aligned
  static_assert(NV * 4 == HD && LPK * VPL == NV, "hd must be a multiple of 4");
};

// the largest group a block holds at this hd: q and the accumulator take
// 2 x GB x DPL registers a lane
template <int HD> constexpr int max_group() {
  constexpr int fit = 64 / Geo<HD>::DPL;
  return fit >= 8 ? 8 : (fit >= 4 ? 4 : (fit >= 2 ? 2 : 1));
}

template <int HD, int GB> constexpr int smem_bytes() {
  return NW * (NSTAGE * Geo<HD>::STAGE + (Geo<HD>::CK * GB + 8) * 4);
}

// Sums each of v[0..N) over the LPK lanes of a slot (xor offsets below
// LPK), a stage an offset from LPK / 2 down.  While more than one value is
// left, a stage halves them: a lane sends the half its partner keeps; the
// lanes end with max(1, N / LPK) sums, v[i] the sum of value base + i, the
// lane's offsets adding to base.
template <int N, int LPK, int O = LPK / 2>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane, int& base) {
  if constexpr (O >= 1) {
    constexpr int C = (N * 2 * O) / LPK;  // values held before this stage
    if constexpr (C > 1) {
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < C / 2; ++i) {
        const float send = up ? v[i] : v[i + C / 2];
        const float keep = up ? v[i + C / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL, send, O);
      }
      if (up) base += C / 2;
    } else {
      v[0] += __shfl_xor_sync(FULL, v[0], O);
    }
    reduce_scatter<N, LPK, O / 2>(v, lane, base);
  }
}

__device__ __forceinline__ void load4(const uint4& x, float* f) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}

// grid (n_split, KVv x chunks of GB heads, B), NW warps
template <int HD, int GB>
__global__ void __launch_bounds__(NW * 32) f32_kernel(const Params p) {
  using Gm = Geo<HD>;
  constexpr int NV = Gm::NV, LPK = Gm::LPK, VPL = Gm::VPL, DPL = Gm::DPL, KPS = Gm::KPS,
                NSTEP = Gm::NSTEP, CK = Gm::CK, TILE = Gm::TILE, STAGE = Gm::STAGE;
  constexpr int NOUT = GB >= LPK ? GB / LPK : 1;  // scores a lane holds a step
  static_assert(NW * GB * (HD + 2) * 4 <= NW * NSTAGE * STAGE, "merge area outgrows the ring");
  static_assert((GB * MAX_SPLIT + GB) * 4 <= NW * NSTAGE * STAGE, "the merge's weights outgrow it");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kk = lane / LPK, lr = lane % LPK;
  const Work w(p);

  unsigned char* ring = smem + warp * (NSTAGE * STAGE);
  float* S = reinterpret_cast<float*>(smem + NW * NSTAGE * STAGE) + warp * (CK * GB + 8);
  float* A = S + CK * GB;  // each head's rescale factor for the chunk

  const float* kb = static_cast<const float*>(p.k) + w.b * p.k_sb + w.kvh(p) * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + w.b * p.v_sb + w.kvh(p) * p.v_sh;
  const int* kpb = p.k_pos + w.b * p.kp_sb;
  const int n_chunks = (w.s1 - w.s0 + CK - 1) / CK;
  const int mine = n_chunks > warp ? (n_chunks - warp + NW - 1) / NW : 0;

  auto issue = [&](int i) {
    unsigned char* st = ring + (i % NSTAGE) * STAGE;
    const int first = w.s0 + (warp + NW * i) * CK;
#pragma unroll
    for (int s = 0; s < NSTEP; ++s) {
      const int row = s * KPS + kk, key = first + row;
      const bool ok = key < w.s1;
      const long long j = ok ? key : w.s0;
#pragma unroll
      for (int t = 0; t < VPL; ++t) {
        const int vi = lr + t * LPK;
        cp16(st + (row * NV + vi) * 16, kb + j * p.k_ss + vi * 4, ok);
        cp16(st + TILE + (row * NV + vi) * 16, vb + j * p.v_ss + vi * 4, ok);
      }
      if (lr == 0) cp4(st + 2 * TILE + row * 4, kpb + j, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < mine) issue(i);
    cp_commit();
  }

  // this lane's dims of each head's q, pre-scaled by scale * log2 e
  float q[GB][DPL];
  {
    const float* qb = static_cast<const float*>(p.q) + w.b * p.q_sb;
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int t = 0; t < VPL; ++t) {
        float f[4] = {0.f, 0.f, 0.f, 0.f};
        if (g < w.ng)
          load4(*reinterpret_cast<const uint4*>(qb + (w.h0 + g) * p.q_sh + (lr + t * LPK) * 4), f);
#pragma unroll
        for (int e = 0; e < 4; ++e) q[g][t * 4 + e] = f[e] * p.qscale;
      }
  }

  float acc[GB][DPL];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
  float m_run = NEG, l_run = 0.f;  // head lane % GB: the warp's running max, this lane's sum

  for (int i = 0; i < mine; ++i) {
    if (i + NSTAGE - 1 < mine) issue(i + NSTAGE - 1);
    cp_commit();
    cp_wait<NSTAGE - 1>();
    __syncwarp();  // k_pos came through one lane of each slot's group
    const unsigned char* st = ring + (i % NSTAGE) * STAGE;
    const uint4* Ks = reinterpret_cast<const uint4*>(st);
    const uint4* Vs = reinterpret_cast<const uint4*>(st + TILE);
    const int* KP = reinterpret_cast<const int*>(st + 2 * TILE);
    const int first = w.s0 + (warp + NW * i) * CK;

#pragma unroll
    for (int s = 0; s < NSTEP; ++s) {
      const int row = s * KPS + kk;
      float kf[DPL];
#pragma unroll
      for (int t = 0; t < VPL; ++t) load4(Ks[row * NV + lr + t * LPK], kf + t * 4);
      float d[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) x = fmaf(q[g][e], kf[e], x);
        d[g] = x;
      }
      int base = 0;
      reduce_scatter<GB, LPK>(d, lane, base);
      const bool ok = w.allowed(p, KP[row]), inside = first + row < w.s1;
#pragma unroll
      for (int t = 0; t < NOUT; ++t)
        S[row * GB + base + t] = !inside ? neg_inf() : (ok ? d[t] : NEG);
    }
    __syncwarp();

    // one max a head over the chunk, p = exp2(score - max), the sums
    float cmax = neg_inf();
    for (int e = lane; e < CK * GB; e += 32) cmax = fmaxf(cmax, S[e]);
#pragma unroll
    for (int o = GB; o < 32; o <<= 1) cmax = fmaxf(cmax, __shfl_xor_sync(FULL, cmax, o));
    const float m_new = fmaxf(m_run, cmax);
    const float alpha = exp2f(m_run - m_new);
    float lsum = 0.f;
    for (int e = lane; e < CK * GB; e += 32) {
      const float pr = exp2f(S[e] - m_new);
      S[e] = pr;
      lsum += pr;
    }
    l_run = l_run * alpha + lsum;
    m_run = m_new;
    if (lane < GB) A[lane] = alpha;
    __syncwarp();

    float al[GB];
    bool rescale = false;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      al[g] = A[g];
      rescale |= al[g] != 1.f;
    }
    if (rescale) {
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] *= al[g];
    }
#pragma unroll
    for (int s = 0; s < NSTEP; ++s) {
      const int row = s * KPS + kk;
      float vf[DPL];
#pragma unroll
      for (int t = 0; t < VPL; ++t) load4(Vs[row * NV + lr + t * LPK], vf + t * 4);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float pg = S[row * GB + g];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(pg, vf[e], acc[g][e]);
      }
    }
    __syncwarp();  // the next chunk rewrites S and A and refills a ring slot
  }
  cp_wait<0>();

  // the warp's slot groups hold the same dims and heads over other slots,
  // under one running max: sum them; then each head's row sum
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], o);
#pragma unroll
  for (int o = GB; o < 32; o <<= 1) l_run += __shfl_xor_sync(FULL, l_run, o);

  __syncthreads();  // the rings are done: the merge area takes their place
  float* M = reinterpret_cast<float*>(smem);
  if (kk == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int t = 0; t < VPL; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          M[(warp * GB + g) * (HD + 2) + (lr + t * LPK) * 4 + e] = acc[g][t * 4 + e];
  }
  if (lane < GB) {
    M[(warp * GB + lane) * (HD + 2) + HD] = m_run;
    M[(warp * GB + lane) * (HD + 2) + HD + 1] = l_run;
  }
  __syncthreads();
  merge_warps<HD>(p, w, M, GB);
  finish<float, HD>(p, w, M);
}

// As tcb::run, for the kernel that holds GB heads a block.
template <int HD, int GB>
int run_group(const Params* p, int B, int KVv, cudaStream_t st, int* resident) {
  constexpr int SMEM = smem_bytes<HD, GB>();
  static bool sized = false;  // the kernel's shared memory attribute, set once
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        f32_kernel<HD, GB>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  if (!p)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, f32_kernel<HD, GB>,
                                                              NW * 32, SMEM);
  const int chunks = (p->G + GB - 1) / GB;
  f32_kernel<HD, GB><<<dim3(p->n_split, KVv * chunks, B), NW * 32, SMEM, st>>>(*p);
  return (int)cudaGetLastError();
}

template <int HD>
int run(const Params* p, int gb, int B, int KVv, cudaStream_t st, int* resident) {
  constexpr int MG = max_group<HD>();
  switch (gb) {
    case 1: return run_group<HD, 1>(p, B, KVv, st, resident);
    case 2: return MG >= 2 ? run_group<HD, (MG >= 2 ? 2 : 1)>(p, B, KVv, st, resident)
                           : (int)cudaErrorInvalidValue;
    case 4: return MG >= 4 ? run_group<HD, (MG >= 4 ? 4 : 1)>(p, B, KVv, st, resident)
                           : (int)cudaErrorInvalidValue;
    case 8: return MG >= 8 ? run_group<HD, 8>(p, B, KVv, st, resident)
                           : (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace f32

// Launches the kernel of this type and head dim on p, or with p null
// writes its blocks an SM holds at once, for gb heads a block, to *resident.
template <int HD>
int run_hd(const Params* p, bool bf16, int gb, int B, int KVv, cudaStream_t st, int* resident) {
  return bf16 ? tcb::run<HD>(p, B, KVv, st, resident)
              : f32::run<HD>(p, gb, B, KVv, st, resident);
}

int run(const Params* p, bool bf16, int hd, int gb, int B, int KVv, cudaStream_t st,
        int* resident) {
  switch (hd) {
    case 16: return run_hd<16>(p, bf16, gb, B, KVv, st, resident);
    case 64: return run_hd<64>(p, bf16, gb, B, KVv, st, resident);
    case 96: return run_hd<96>(p, bf16, gb, B, KVv, st, resident);
    case 128: return run_hd<128>(p, bf16, gb, B, KVv, st, resident);
    case 256: return run_hd<256>(p, bf16, gb, B, KVv, st, resident);
    default: return (int)cudaErrorInvalidValue;
  }
}

int max_group(bool bf16, int hd) {
  if (bf16) return hd % 16 == 0 ? tcb::ROWS : 0;
  switch (hd) {
    case 16: return f32::max_group<16>();
    case 64: return f32::max_group<64>();
    case 96: return f32::max_group<96>();
    case 128: return f32::max_group<128>();
    case 256: return f32::max_group<256>();
    default: return 0;
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The most query heads a block holds at head dim hd (bf16 = 1: bfloat16,
// else float32).
int decode_attention_max_group(int bf16, int hd) { return max_group(bf16 != 0, hd); }

// The blocks of the kernel for this type, head dim and gb heads a block
// that an SM of the current device holds at once, to *resident (what the
// wrapper's split plan fills the card with).
int decode_attention_blocks_per_sm(int bf16, int hd, int gb, int* resident) {
  if (gb < 1 || (gb & (gb - 1)) || gb > max_group(bf16 != 0, hd))
    return (int)cudaErrorInvalidValue;
  return run(nullptr, bf16 != 0, hd, gb, 0, 0, nullptr, resident);
}

// q (B, H, hd) with element strides (q_sb, q_sh); k, v (B, Sc, KVv, hd) with
// (sb, ss, sh); unit stride on hd, 16-byte aligned bases and strides in
// multiples of 16 bytes; k_pos (B, Sc) int32 with row stride kp_sb, unit
// along Sc; pos (B,) int32; part a float32 (B, H, n_split, hd + 4) scratch;
// counters B x KVv x (group chunks) int32 zeros, left zero; out (B, H, hd)
// in q's type with strides (o_sb, o_sh).  H = KVv x G; gb,
// the heads a block holds, a power of two up to decode_attention_max_group;
// the slots cut into n_split ranges of split_len (the last may be shorter,
// none empty).  hd is 16, 64, 96, 128 or 256.
int decode_attention_launch(const void* q, const void* k, const void* v, const void* k_pos,
                            const void* pos, void* part, void* counters, void* out, int bf16,
                            int B, int H,
                            int KVv, int Sc, int hd, int gb, int n_split, int split_len,
                            int window, long long q_sb, long long q_sh, long long k_sb,
                            long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                            long long v_sh, long long kp_sb, long long o_sb, long long o_sh,
                            double scale, void* stream) {
  const int vec = bf16 ? 8 : 4;
  const int G = KVv > 0 ? H / KVv : 0;
  const int chunks = gb > 0 ? (G + gb - 1) / gb : 0;
  if (B < 1 || B > 65535 || KVv < 1 || G < 1 || G * KVv != H || Sc < 1 || n_split < 1 ||
      split_len < 1 || (long long)n_split * split_len < Sc ||
      (long long)(n_split - 1) * split_len >= Sc || n_split > MAX_SPLIT || H > 65535 ||
      (long long)KVv * chunks > 65535 || gb < 1 || (gb & (gb - 1)) ||
      gb > max_group(bf16 != 0, hd) || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      q_sb % vec || q_sh % vec || k_sb % vec || k_ss % vec || k_sh % vec || v_sb % vec ||
      v_ss % vec || v_sh % vec)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, static_cast<const int*>(k_pos), static_cast<const int*>(pos),
                 static_cast<float*>(part), out, static_cast<int*>(counters), q_sb, q_sh, k_sb,
                 k_ss, k_sh, v_sb, v_ss, v_sh, kp_sb, o_sb, o_sh, H, G, gb, Sc, n_split,
                 split_len, window, (float)scale * LOG2E};
  return run(&p, bf16 != 0, hd, gb, B, KVv, (cudaStream_t)stream, nullptr);
}

}  // extern "C"
