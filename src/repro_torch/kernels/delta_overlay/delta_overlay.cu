// Fused h-way last-writer-wins delta overlay (Algorithm 1's node fold).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/delta_overlay/
// delta_overlay.py: _overlay_kernel / overlay_pallas (one fold) and
// _overlay_batch_kernel / overlay_batch_pallas (T folds over shared layers).
//
// Semantics, per slot (p, s), exactly those of _overlay_kernel:
//   acc = layer 0;  for i in 1..h-1:
//     if valid[i]: present <- present[i]; attrs[k] <- attrs[i][k] where != -1
//     if present == 0: attrs <- -1          (every step, valid or not)
//     valid |= valid[i]
// The clear runs on every step after a tombstone, which makes the fold
// non-associative across tombstones (tests/test_delta_properties.py pins
// that); it is kept as is.  The batch variant starts each timepoint t from
// the neutral accumulator (valid 0, present 0, attrs -1) and folds the layers
// i with tmask[i][t] != 0, the clear included from layer 0 on.
//
// Bound: both folds move bytes (a compare and a select per layer and
// attribute); the batch fold's outputs, T * (2 + 4K) bytes a slot, are
// most of them.
//
// overlay_kernel: one thread per slot, consecutive threads on consecutive
// slots, one walk of the h layers in order with all K attrs in registers
// (K = 4 compiled in, 8-wide passes otherwise), no padding of S (the last
// block masks the ragged edge), no shared memory.  The accumulator is
// layer 0 raw, as _overlay_kernel seeds it: its present and attrs are taken
// even where its valid byte is 0, and its attrs are not cleared where its
// present byte is 0.  The batch fold's skip rule (below) does not hold
// after that seed, so step 1 runs in full (its clear included, valid or
// not); invalid layers are skipped from step 2 on.  A thread reads each
// layer's valid byte once and, where it is set, the layer's present byte
// and its attrs once (one int4 load when K = 4), and stores its outputs
// straight to device memory (an int4 a slot when K = 4: a warp writes 512
// contiguous bytes).  With K = 4 the layers go 4 at a time: their valid
// bytes are loaded together, then the present bytes and attrs of the valid
// ones, then folded in order, so more bytes are in flight a thread.  The
// card moves more than the bound counts: L2 fetches 64-byte runs from
// HBM, so all of `present` and most of an invalid layer's attrs come in,
// and the time is near what those bytes take.  One layer at a time,
// staging the outputs, loading every layer, L2::256B hints, two slots a
// thread and a persistent grid were no faster (tools/overlay_designs.py,
// PERF.md).
//
// overlay_batch: a walk of all h layers for each timepoint, repeated for
// each attribute, is O(T * h * (K + 1)) steps a slot, where a timepoint
// of a wide group (the shared path plus its own eventlist layer) needs 3
// of 322 layers; and a thread per slot writing its T * K attrs stores at a
// stride of T * K * 4 bytes across the warp.  So:
//  - layer_lists_kernel, a pre-pass, writes for each t the ordered list of
//    the layers that feed it and their count (one warp per t, ballot and
//    popc keep index order; no host sync);
//  - overlay_batch_kernel folds a tile of 32 slots x TT timepoints (x all
//    K attrs): a warp takes 32 consecutive slots at one t, so it walks one
//    list with no divergence and its layer loads coalesce along slots;
//    a thread folds all K attrs in one walk of its list with K
//    accumulators in registers (K = 4 compiled in, a loop of 8-wide passes
//    otherwise).  Only the listed layers are read, and a layer whose valid
//    byte is 0 is skipped: after every step, present == 0 implies attrs
//    == -1, so a step that changes nothing may be left out, the clear
//    included.  Work per slot is O(sum_t |list_t| * (K + 1)).
//  - the tile's outputs are staged in shared memory (attrs at an odd row
//    stride, no bank conflicts) and written back as each slot's contiguous run of
//    TT timepoints x K attrs, a warp per run.
// The write-back alone runs at the rate of a plain fill of the outputs;
// the fold's steps are bound by instruction throughput (measured on the card:
// a fold with its loads replaced by arithmetic costs nearly as much), so
// a step is kept short: 32-bit indices where they fit, the step loop
// unrolled by 4, 32 registers.  Designs that did more a step lost to the
// occupancy they cost (PERF.md).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

// One warp per timepoint t: lists[t, :counts[t]] = the layers i with
// tmask[i, t] != 0 in index order, then -1 to the end of the row.
__global__ void layer_lists_kernel(const int32_t* __restrict__ tmask,
                                   int32_t* __restrict__ lists,
                                   int32_t* __restrict__ counts, int h, int T) {
  const int t = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= T) return;  // the whole warp
  int32_t* row = lists + (size_t)t * h;
  int count = 0;
  for (int i0 = 0; i0 < h; i0 += 32) {
    const int i = i0 + lane;
    const bool use = i < h && tmask[(size_t)i * T + t] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, use);
    if (use) row[count + __popc(m & ((1u << lane) - 1u))] = i;
    count += __popc(m);
  }
  for (int j = count + lane; j < h; j += 32) row[j] = -1;
  if (lane == 0) counts[t] = count;
}

constexpr int WARPS = 8;
constexpr int BATCH_THREADS = WARPS * 32;
constexpr int MAX_TT = 32;                // timepoints in a tile
constexpr int SMEM_BYTES = 48 * 1024;     // no opt-in needed

struct BatchArgs {
  const int8_t* valid;
  const int8_t* present;
  const int32_t* attrs;
  const int32_t* lists;
  const int32_t* counts;
  int8_t* o_valid;
  int8_t* o_present;
  int32_t* o_attrs;
  long long n;  // slots
  int h, K, T;
  int sg;  // groups of 32 slots in a tile; the warps of a group share its rows
  int tt;  // timepoints in a tile
  int kt;  // attrs in a tile: K, or a share of K when one timepoint's
           // K attrs for 32 slots do not fit in shared memory
  bool vec;  // K == 4 and attrs 16-byte aligned: one int4 load a layer
};

__host__ __device__ inline int stage_stride(int tt, int kt) { return (tt * kt) | 1; }

__host__ __device__ inline int stage_bytes(int sg, int tt, int kt) {
  return sg * 32 * (stage_stride(tt, kt) * 4 + 2 * tt);
}

// Copy `rows` runs of `cols` elements, run r from src + r * sstride to
// dst + r * dstride: a warp per run when runs are long, else one flat loop.
template <typename E>
__device__ void write_runs(E* dst, long long dstride, const E* src, int sstride,
                           int rows, int cols) {
  if (cols >= 16) {
    for (int r = threadIdx.x >> 5; r < rows; r += WARPS)
      for (int c = threadIdx.x & 31; c < cols; c += 32)
        dst[r * dstride + c] = src[r * sstride + c];
  } else {
    for (int q = threadIdx.x; q < rows * cols; q += BATCH_THREADS) {
      const int r = q / cols, c = q - r * cols;
      dst[r * dstride + c] = src[r * sstride + c];
    }
  }
}

// The attrs k .. k + KC - 1 of the layer slot at `off`, -1 from the
// `left`-th on (the last pass of a K that KC does not divide); `vec`: K ==
// 4 and attrs 16-byte aligned, one int4 load.
template <int KC, typename I>
__device__ __forceinline__ void load_attrs(const int32_t* __restrict__ attrs,
                                           I off, int K, int k, int left,
                                           bool vec, int32_t (&ai)[KC]) {
  const int32_t* src = attrs + (off * (I)K + (I)k);
  if (KC == 4 && vec) {
    const int4 v4 = __ldg(reinterpret_cast<const int4*>(src));
    ai[0] = v4.x; ai[1] = v4.y; ai[2] = v4.z; ai[3] = v4.w;
  } else {
#pragma unroll
    for (int q = 0; q < KC; ++q) ai[q] = q < left ? __ldg(src + q) : -1;
  }
}

// A valid layer's step, once its present byte p and attrs ai are in.
template <int KC>
__device__ __forceinline__ void merge(int32_t (&acc)[KC], const int32_t (&ai)[KC],
                                      int8_t p) {
#pragma unroll
  for (int q = 0; q < KC; ++q) {
    if (ai[q] != -1) acc[q] = ai[q];
    if (p == 0) acc[q] = -1;
  }
}

// The single fold.  KC == 4: K = 4 and 16-byte aligned attrs and outputs,
// an int4 a layer slot; KC == 8: any K, in passes of up to 8 attrs.  I as
// for the batch kernel below.
template <int KC, typename I>
__global__ void __launch_bounds__(256)
overlay_kernel(const int8_t* __restrict__ valid, const int8_t* __restrict__ present,
               const int32_t* __restrict__ attrs, int8_t* __restrict__ o_valid,
               int8_t* __restrict__ o_present, int32_t* __restrict__ o_attrs,
               int h, I n, int K) {
  constexpr int G = KC == 4 ? 4 : 1;  // layers whose loads go together
  if (KC == 4) K = 4;  // known here: one pass, unrolled
  const I s = (I)blockIdx.x * 256 + (I)threadIdx.x;
  if (s >= n) return;
  for (int kb = 0; kb == 0 || kb < K; kb += KC) {
    int acc_v = __ldg(valid + s) != 0;
    int8_t acc_p = __ldg(present + s);
    int32_t acc[KC];
    load_attrs<KC, I>(attrs, s, K, kb, K - kb, KC == 4, acc);
    for (int i0 = 1; i0 < h; i0 += G) {
      bool vi[G];
      int8_t pi[G];
      int32_t ai[G][KC];
#pragma unroll
      for (int q = 0; q < G; ++q) vi[q] = i0 + q < h && __ldg(valid + (i0 + q) * n + s) != 0;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if (!vi[q]) continue;
        const I off = (I)(i0 + q) * n + s;
        pi[q] = __ldg(present + off);
        load_attrs<KC, I>(attrs, off, K, kb, K - kb, KC == 4, ai[q]);
      }
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if (vi[q]) {
          acc_v = 1;
          acc_p = pi[q];
          merge<KC>(acc, ai[q], acc_p);
        } else if (i0 + q == 1 && acc_p == 0) {  // step 1's clear, layer 1 invalid
#pragma unroll
          for (int k = 0; k < KC; ++k) acc[k] = -1;
        }
      }
    }
    int32_t* dst = o_attrs + (s * (I)K + (I)kb);
    if (KC == 4) {
      *reinterpret_cast<int4*>(dst) = make_int4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int q = 0; q < KC; ++q)
        if (kb + q < K) dst[q] = acc[q];
    }
    o_valid[s] = (int8_t)acc_v;
    o_present[s] = acc_p;
  }
}

// KC accumulators a pass: KC == 4 is the K = 4 kernel (one pass, unrolled,
// held to 32 registers for 2048 threads an SM); KC == 8 covers any K in
// passes of up to 8 attrs.  I indexes the stacks: int when every index fits
// in 31 bits (fewer instructions a step), else long long.
template <int KC, typename I>
__global__ void __launch_bounds__(BATCH_THREADS, KC == 4 ? 8 : 1)
overlay_batch_kernel(const BatchArgs a) {
  extern __shared__ int32_t stage[];
  const int slots = a.sg * 32, stride = stage_stride(a.tt, a.kt);
  int8_t* s_valid = reinterpret_cast<int8_t*>(stage + slots * stride);
  int8_t* s_present = s_valid + slots * a.tt;
  const long long s0 = (long long)blockIdx.x * slots;
  const int t0 = blockIdx.y * a.tt, k0 = blockIdx.z * a.kt;
  const int tn = min(a.tt, a.T - t0), kn = min(a.kt, a.K - k0);
  const int sn = (int)min((long long)slots, a.n - s0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ls = (warp % a.sg) * 32 + lane;  // the thread's slot in the tile
  const long long s = s0 + ls;
  const bool live = ls < sn;

  for (int r = warp / a.sg; r < tn; r += WARPS / a.sg) {
    const int t = t0 + r;
    const int cnt = a.counts[t];
    const int32_t* list = a.lists + (size_t)t * a.h;
    int acc_v = 0;
    int8_t acc_p = 0;
    for (int kb = 0; kb == 0 || kb < kn; kb += KC) {
      int32_t acc[KC];
#pragma unroll
      for (int q = 0; q < KC; ++q) acc[q] = -1;
      acc_v = 0;
      acc_p = 0;
#pragma unroll 4
      for (int j = 0; live && j < cnt; ++j) {
        const I off = (I)__ldg(list + j) * (I)a.n + (I)s;
        if (__ldg(a.valid + off) == 0) continue;
        acc_v = 1;
        acc_p = __ldg(a.present + off);
        int32_t ai[KC];
        load_attrs<KC, I>(a.attrs, off, a.K, k0 + kb, kn - kb, a.vec, ai);
        merge<KC>(acc, ai, acc_p);
      }
      if (live) {
        int32_t* dst = stage + ls * stride + r * a.kt + kb;
#pragma unroll
        for (int q = 0; q < KC; ++q)
          if (kb + q < kn) dst[q] = acc[q];
      }
    }
    if (live) {
      s_valid[ls * a.tt + r] = (int8_t)acc_v;
      s_present[ls * a.tt + r] = acc_p;
    }
  }
  __syncthreads();

  // slot s's run: timepoints t0 .. t0 + tn, attrs k0 .. k0 + kn (tn == 1
  // whenever kn < K, so a run is contiguous in the output either way)
  const long long first = s0 * a.T + t0;
  write_runs(a.o_attrs + first * a.K + k0, (long long)a.T * a.K, stage, stride,
             sn, tn * kn);
  if (blockIdx.z == 0) {
    write_runs(a.o_valid + first, a.T, s_valid, a.tt, sn, tn);
    write_runs(a.o_present + first, a.T, s_present, a.tt, sn, tn);
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// valid/present: (h, n) int8 (bool bytes accepted); attrs: (h, n, K) int32;
// outputs (n,) and (n, K).  n = P * S slots.
int overlay_launch(const void* valid, const void* present, const void* attrs,
                   void* o_valid, void* o_present, void* o_attrs, int h,
                   long long n, int K, void* stream) {
  if (h < 1 || n < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + 255) / 256;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const auto v = (const int8_t*)valid;
  const auto p = (const int8_t*)present;
  const auto a = (const int32_t*)attrs;
  const auto ov = (int8_t*)o_valid;
  const auto op = (int8_t*)o_present;
  const auto oa = (int32_t*)o_attrs;
  const bool vec = K == 4 && (((uintptr_t)attrs | (uintptr_t)o_attrs) & 15) == 0;
  const bool narrow = (long long)h * n * (K > 1 ? K : 1) < (1LL << 31);
  const dim3 grid((unsigned)blocks);
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    if (narrow) overlay_kernel<4, int><<<grid, 256, 0, st>>>(v, p, a, ov, op, oa, h, (int)n, K);
    else overlay_kernel<4, long long><<<grid, 256, 0, st>>>(v, p, a, ov, op, oa, h, n, K);
  } else {
    if (narrow) overlay_kernel<8, int><<<grid, 256, 0, st>>>(v, p, a, ov, op, oa, h, (int)n, K);
    else overlay_kernel<8, long long><<<grid, 256, 0, st>>>(v, p, a, ov, op, oa, h, n, K);
  }
  return (int)cudaGetLastError();
}

// tmask: (h, T) int32 -> lists (T, h) int32 (-1 past each count) and
// counts (T,) int32.
int layer_lists_launch(const void* tmask, void* lists, void* counts, int h,
                       int T, void* stream) {
  if (h < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(((long long)T * 32 + 255) / 256);
  layer_lists_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tmask, (int32_t*)lists, (int32_t*)counts, h, T);
  return (int)cudaGetLastError();
}

// + tmask: (h, T) int32; lists: (T, h) int32 and counts: (T,) int32
// scratch; outputs (n, T) and (n, T, K).
int overlay_batch_launch(const void* valid, const void* present,
                         const void* attrs, const void* tmask, void* lists,
                         void* counts, void* o_valid, void* o_present,
                         void* o_attrs, int h, long long n, int K, int T,
                         void* stream) {
  if (h < 1 || n < 1 || K < 0 || T < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = layer_lists_launch(tmask, lists, counts, h, T, stream);
  if (err != 0) return err;
  // the tile: tt timepoints; 8 warps in sg groups of 32 slots, a group's
  // warps on rows t0, t0 + 8 / sg, ...
  int tt = T < MAX_TT ? T : MAX_TT;
  int rows = 1;
  while (rows < tt && rows < WARPS) rows *= 2;
  int sg = WARPS / rows, kt = K;
  if (stage_bytes(sg, tt, kt) > SMEM_BYTES) {  // large K: fewer per tile
    sg = 1;
    while (tt > 1 && stage_bytes(sg, tt, kt) > SMEM_BYTES) tt = (tt + 1) / 2;
    while (stage_bytes(sg, tt, kt) > SMEM_BYTES) kt = (kt + 1) / 2;
  }
  const long long gx = (n + sg * 32 - 1) / (sg * 32);
  const long long gy = (T + tt - 1) / tt, gz = K == 0 ? 1 : (K + kt - 1) / kt;
  if (gx > 2147483647LL || gy > 65535 || gz > 65535) return (int)cudaErrorInvalidValue;
  BatchArgs args{(const int8_t*)valid, (const int8_t*)present,
                 (const int32_t*)attrs, (const int32_t*)lists,
                 (const int32_t*)counts, (int8_t*)o_valid, (int8_t*)o_present,
                 (int32_t*)o_attrs, n, h, K, T, sg, tt, kt,
                 K == 4 && kt == 4 && ((uintptr_t)attrs & 15) == 0};
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);
  const int smem = stage_bytes(sg, tt, kt);
  const bool narrow = (long long)h * n * (K > 1 ? K : 1) < (1LL << 31);
  if (K == 4 && kt == 4) {
    if (narrow) overlay_batch_kernel<4, int><<<grid, BATCH_THREADS, smem, st>>>(args);
    else overlay_batch_kernel<4, long long><<<grid, BATCH_THREADS, smem, st>>>(args);
  } else {
    if (narrow) overlay_batch_kernel<8, int><<<grid, BATCH_THREADS, smem, st>>>(args);
    else overlay_batch_kernel<8, long long><<<grid, BATCH_THREADS, smem, st>>>(args);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
