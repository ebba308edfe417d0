// RG-LRU scan: the first-order linear recurrence
//   h[b, t, w] = exp(log_a[b, t, w]) * h[b, t-1, w] + x[b, t, w],  h[b, -1, w] = 0
// over float32 (B, S, W) tensors, for any B, S and W.
//
// Replaces the Pallas TPU kernel _rglru_kernel / rglru_pallas in
// src/repro/kernels/rglru_scan/rglru_scan.py, which streams (64, 128)
// tiles through VMEM and carries h across the sequential chunk axis.
//
// Bound: the function reads log_a and x once and writes h once (12 bytes
// per element) and does 3 float operations per element, so the bytes
// bound it.  To keep HBM busy the card needs far more loads in flight than
// one thread per (b, w) lane gives (B * W = 16,384 lanes on the serving
// path, about 124 threads per SM), so the sequence is cut too.
//
// Design: a single-pass chained chunk scan.  A block owns CHUNK steps of
// LANES lanes (one thread per lane, neighbouring threads on neighbouring
// w, so every load and store is coalesced):
//  1. it takes a ticket from an atomic counter and maps it chunk-major to
//     (chunk c, b, lane tile), so every block it waits on holds a smaller
//     ticket, is already running, and cannot wait on it: no deadlock
//     whatever the number of resident blocks;
//  2. it loads its chunk of log_a and x into registers, once, and computes
//     the chunk's aggregate from h = 0: the decay P = prod exp(log_a) and
//     the local scan's last value hl;
//  3. each thread waits for its lane's inclusive carry from chunk c - 1,
//     publishes P * carry_in + hl for chunk c + 1, and reruns its chunk
//     from carry_in on the values it holds, writing h once.
// A carry travels as one 64-bit word, (c + 1) << 32 | float bits, stored
// with st.release and polled with ld.acquire at gpu scope, so the value
// and its flag are seen together.  Each chunk waits only for its
// predecessor's inclusive carry (no look-back), so the sums are combined
// in one fixed order and two runs give the same bits.  The words and the
// ticket live in wrapper scratch, zeroed on the stream before each launch.
// A wait that sees no carry in 2^24 polls (seconds) traps, so a fault
// fails the launch instead of hanging the card.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;
constexpr int CHUNK = 64;  // keep ops.CHUNK equal

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__global__ void __launch_bounds__(LANES)
rglru_kernel(const float* __restrict__ log_a, const float* __restrict__ x,
             float* __restrict__ h, unsigned long long* __restrict__ carry,
             unsigned int* __restrict__ ticket, int S, int W, int tiles,
             int lane_tiles, int chunks) {
  __shared__ unsigned int s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1u);
  __syncthreads();
  const int c = (int)(s_ticket / (unsigned)lane_tiles);
  const int r = (int)(s_ticket % (unsigned)lane_tiles);
  const int b = r / tiles;
  const int w = (r % tiles) * LANES + threadIdx.x;
  if (w >= W) return;
  const int t0 = c * CHUNK;
  const int n = min(CHUNK, S - t0);  // the last chunk may be short
  const size_t base = ((size_t)b * S + t0) * W + w;

  // steps past the end get a = 1, x = 0, which leave h as it is
  float a[CHUNK], v[CHUNK];
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) {
    a[u] = u < n ? __ldg(log_a + base + (size_t)u * W) : 0.f;
    v[u] = u < n ? __ldg(x + base + (size_t)u * W) : 0.f;
  }
  float decay = 1.f, hl = 0.f;
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) {
    a[u] = expf(a[u]);
    hl = fmaf(a[u], hl, v[u]);
    decay *= a[u];
  }

  unsigned long long* word = carry + (size_t)b * W + w;
  float cin = 0.f;
  if (c > 0) {
    unsigned long long got = load_acquire(word);
    for (unsigned spins = 0; (unsigned)(got >> 32) != (unsigned)c; ++spins) {
      if (spins == 1u << 24) __trap();
      got = load_acquire(word);
    }
    cin = __uint_as_float((unsigned)got);
  }
  if (c + 1 < chunks)
    store_release(word, ((unsigned long long)(c + 1) << 32) |
                            __float_as_uint(fmaf(decay, cin, hl)));

  float hv = cin;
  float* out = h + base;
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) {
    hv = fmaf(a[u], hv, v[u]);
    if (u < n) out[(size_t)u * W] = hv;
  }
}

// Backward of the scan (the port's own: the reference trains through jnp
// autodiff and has no backward kernel).  With the total gradient
//   g[t] = dh[t] + exp(log_a[t+1]) * g[t+1],  g[S] = 0,
// it writes db[t] = g[t] and dlog_a[t] = g[t] * exp(log_a[t]) * h[t-1]
// (h[-1] = 0).  Bound: it reads log_a, h and dh and writes dlog_a and db
// once, 20 bytes per element, for a few float operations: bytes.
//
// Design: the forward's chained chunk scan run backwards in time, its
// inputs staged in shared memory.  The carry chunk c hands to chunk c - 1
// is e = exp(log_a[t0]) * g[t0] at its first step t0, which is P * e_in +
// el, P the chunk's decay and el the same quantity from e_in = 0.  The
// ticket maps chunk-major in reverse order: the LAST chunk takes tickets
// 0.., so every block a block waits on holds a smaller ticket and is
// running (handing chunk 0 the first tickets would make the first blocks
// wait on successors that may never be scheduled).  A carry word is
// (c' + 1) << 32 | float bits with c' = chunks - 1 - c the chunk's place
// in that order.  The same trap after 2^24 polls of the carry; a wait on
// the copies' barriers traps after about 4 s.  The kernel leaves its
// scratch as it found it, zero: chunk 0 clears each carry word it read and
// the block that takes the last ticket resets the counter, so the wrapper
// zeroes the scratch once, when it allocates it, and no memset is
// launched beside each call.
//
// A block owns BWD_CHUNK steps of BWD_LANES lanes.  At its start it puts
// three tiles in flight to shared memory: log_a and dh at steps t0 ..
// t0 + n - 1, and h at t0 - 1 .. t0 + n - 2 (h[t-1] beside step t), on two
// barriers: log_a and dh, which the first pass reads, and h, which only
// the second pass reads, so the block publishes its carry without waiting
// for h.  The second pass then has no dependent global load, and
// registers hold only the running values.  Two load paths fill the same
// tiles, chosen by the launcher (bwd_bulk):
//  - BULK (W % 4 == 0, 16-byte aligned bases: every row of the tile is 16-
//    byte aligned and a multiple of 16 bytes long): lanes 0..31 of warp 0
//    copy the tiles a row at a time with cp.async.bulk, completing on an
//    mbarrier that expects the bytes actually copied (rows past S, lanes
//    past W and chunk 0's h[-1] are not copied, and never read);
//  - otherwise each thread copies its own lane of each row with a 4-byte
//    cp.async, in two groups (log_a and dh; h).
// Each thread reads only its own lane of the tiles, so no barrier follows
// the copies.  The first pass overwrites log_a with exp(log_a) in place;
// the outputs go out with streaming stores (st.global.cs), which never
// hold up the walk.
constexpr int BWD_CHUNK = 64;  // the forward's: ops.CHUNK names both
// 64 lanes: four blocks an SM (tools/rglru_bwd_designs.py times 32 and 128)
constexpr int BWD_LANES = 64;
static_assert(BWD_CHUNK == CHUNK, "ops.CHUNK names both kernels' chunk");
constexpr int BWD_TILE = BWD_CHUNK * BWD_LANES;  // floats a tile
constexpr int BWD_SMEM = 3 * BWD_TILE * 4;       // 48 KB: four blocks an SM
static_assert(BWD_LANES % 32 == 0 && BWD_LANES <= 1024, "whole warps");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

// the barrier's one arrival, with the bytes its copies will complete
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// returns once the barrier's first phase has completed; traps after 2^32
// ns (try_wait may suspend the thread for a time of the hardware's
// choosing, so the wait is bounded by the clock and not by a poll count)
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  unsigned long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
    if (done) return;
    if (start == 0)
      start = now_ns();
    else if (now_ns() - start > (1ull << 32))
      __trap();
  }
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void lane_load(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void lane_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <bool BULK>
__global__ void __launch_bounds__(BWD_LANES)
rglru_bwd_kernel(const float* __restrict__ log_a, const float* __restrict__ h,
                 const float* __restrict__ dh, float* __restrict__ dlog_a,
                 float* __restrict__ db, unsigned long long* __restrict__ carry,
                 unsigned int* __restrict__ ticket, int S, int W, int tiles,
                 int lane_tiles, int chunks) {
  extern __shared__ __align__(128) float smem[];
  float* const sa = smem;            // log_a, then exp(log_a)
  float* const sd = sa + BWD_TILE;   // dh
  float* const sh = sd + BWD_TILE;   // h one step back
  __shared__ __align__(8) uint64_t bar[2];  // BULK: log_a and dh; h
  __shared__ unsigned int s_ticket;
  const int x = threadIdx.x;
  if (x == 0) {
    s_ticket = atomicAdd(ticket, 1u);
    // every other ticket is taken: leave the counter as it was found
    if (s_ticket == gridDim.x - 1) atomicExch(ticket, 0u);
    if (BULK) {
      mbar_init(&bar[0]);
      mbar_init(&bar[1]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();
  const int cr = (int)(s_ticket / (unsigned)lane_tiles);  // place in reverse order
  const int r = (int)(s_ticket % (unsigned)lane_tiles);
  const int c = chunks - 1 - cr;
  const int b = r / tiles;
  const int w0 = (r % tiles) * BWD_LANES;
  const int t0 = c * BWD_CHUNK;
  const int n = min(BWD_CHUNK, S - t0);
  const size_t base = ((size_t)b * S + t0) * W + w0;  // (b, t0, w0)
  const int lanes = min(BWD_LANES, W - w0);  // the tile's lanes inside W
  const uint32_t row = (uint32_t)lanes * 4;     // bytes of a tile's row
  if (BULK && x < 32) {
    if (x == 0) {
      mbar_expect_tx(&bar[0], 2 * n * row);
      mbar_expect_tx(&bar[1], (c > 0 ? n : n - 1) * row);  // chunk 0 has no h[-1]
    }
    __syncwarp();
    for (int u = x; u < n; u += 32) {
      bulk_load(sa + u * BWD_LANES, log_a + base + (size_t)u * W, row, &bar[0]);
      bulk_load(sd + u * BWD_LANES, dh + base + (size_t)u * W, row, &bar[0]);
    }
    for (int u = x; u < n; u += 32)
      if (t0 + u > 0) bulk_load(sh + u * BWD_LANES, h + base + (size_t)u * W - W, row, &bar[1]);
  }
  if (x < lanes) {
    if (!BULK) {
      for (int u = 0; u < n; ++u) {
        lane_load(sa + u * BWD_LANES + x, log_a + base + (size_t)u * W + x);
        lane_load(sd + u * BWD_LANES + x, dh + base + (size_t)u * W + x);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
      for (int u = t0 > 0 ? 0 : 1; u < n; ++u)
        lane_load(sh + u * BWD_LANES + x, h + base + (size_t)u * W - W + x);
      asm volatile("cp.async.commit_group;" ::: "memory");
      lane_wait<1>();
    } else {
      mbar_wait(&bar[0]);
    }
    // Steps past the end (the last chunk's, u >= n) act as a = 1, dh = 0,
    // which change no bit: the walks take no branch, so the shared-memory
    // loads of later steps are issued ahead of the chain.
    float decay = 1.f, el = 0.f;
#pragma unroll
    for (int u = BWD_CHUNK - 1; u >= 0; --u) {
      const int i = u * BWD_LANES + x;
      const float ea = expf(sa[i]), dv = sd[i];
      const float a = u < n ? ea : 1.f;
      sa[i] = a;
      el = a * ((u < n ? dv : 0.f) + el);
      decay *= a;
    }

    unsigned long long* word = carry + (size_t)b * W + w0 + x;
    float ein = 0.f;
    if (cr > 0) {
      unsigned long long got = load_acquire(word);
      for (unsigned spins = 0; (unsigned)(got >> 32) != (unsigned)cr; ++spins) {
        if (spins == 1u << 24) __trap();
        got = load_acquire(word);
      }
      ein = __uint_as_float((unsigned)got);
      if (c == 0) *word = 0ull;  // its last reader leaves it as it was found
    }
    if (c > 0)
      store_release(word, ((unsigned long long)(cr + 1) << 32) |
                              __float_as_uint(fmaf(decay, ein, el)));

    if (BULK)
      mbar_wait(&bar[1]);
    else
      lane_wait<0>();
    float e = ein;  // 0 in the last chunk, the one with steps past the end
    float* const odl = dlog_a + base + x;
    float* const odb = db + base + x;
#pragma unroll
    for (int u = BWD_CHUNK - 1; u >= 0; --u) {
      const int i = u * BWD_LANES + x;
      const float a = sa[i], dv = sd[i], hv = sh[i];
      const float g = (u < n ? dv : 0.f) + e;
      const float hp = t0 + u > 0 ? hv : 0.f;
      if (u < n) {
        __stcs(odb + (size_t)u * W, g);
        __stcs(odl + (size_t)u * W, g * a * hp);
      }
      e = a * g;
    }
  }
}

// Whether the backward stages rows of these inputs with bulk copies: W %
// 4 == 0 and 16-byte aligned bases (else a 4-byte cp.async per lane).
bool bwd_bulk(const void* log_a, const void* h, const void* dh, int W) {
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  return W % 4 == 0 && aligned(log_a) && aligned(h) && aligned(dh);
}

template <bool BULK>
cudaError_t bwd_attributes() {
  cudaError_t e = cudaFuncSetAttribute(rglru_bwd_kernel<BULK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(rglru_bwd_kernel<BULK>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// 1 when rglru_bwd_launch takes the bulk-copy path for these inputs, else 0
int rglru_bwd_path(const void* log_a, const void* h, const void* dh, int W) {
  return bwd_bulk(log_a, h, dh, W) ? 1 : 0;
}

// The backward kernel's resources on the current device, for the bulk
// path (bulk = 1) or the per-lane one: registers a thread, static and
// dynamic shared memory a block, resident blocks an SM, local bytes a
// thread (spills).
int rglru_bwd_resources(int bulk, int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = bulk ? bwd_attributes<true>() : bwd_attributes<false>();
  if (e == cudaSuccess)
    e = bulk ? cudaFuncGetAttributes(&fa, rglru_bwd_kernel<true>)
             : cudaFuncGetAttributes(&fa, rglru_bwd_kernel<false>);
  int blocks = 0;
  if (e == cudaSuccess)
    e = bulk ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rglru_bwd_kernel<true>,
                                                             BWD_LANES, BWD_SMEM)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rglru_bwd_kernel<false>,
                                                             BWD_LANES, BWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = BWD_SMEM;
  out[3] = blocks;
  out[4] = (int)fa.localSizeBytes;
  return 0;
}

// log_a, h, dh, dlog_a, db: contiguous (B, S, W) float32 on the device;
// scratch: at least B * W + 1 eight-byte words on the device, zero before
// the launch (as every launch leaves them) and used by no other stream.
int rglru_bwd_launch(const void* log_a, const void* h, const void* dh, void* dlog_a,
                     void* db, void* scratch, int B, int S, int W, void* stream) {
  if (B < 1 || S < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const bool bulk = bwd_bulk(log_a, h, dh, W);
  const cudaStream_t st = (cudaStream_t)stream;
  const long long words = (long long)B * W;
  const int tiles = (W + BWD_LANES - 1) / BWD_LANES;
  const int chunks = (S + BWD_CHUNK - 1) / BWD_CHUNK;
  const long long lane_tiles = (long long)B * tiles;
  const long long blocks = lane_tiles * chunks;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const cudaError_t err = bulk ? bwd_attributes<true>() : bwd_attributes<false>();
  if (err != cudaSuccess) return (int)err;
  unsigned long long* carry = (unsigned long long*)scratch;
  const auto kernel = bulk ? rglru_bwd_kernel<true> : rglru_bwd_kernel<false>;
  kernel<<<(unsigned)blocks, BWD_LANES, BWD_SMEM, st>>>(
      (const float*)log_a, (const float*)h, (const float*)dh, (float*)dlog_a, (float*)db,
      carry, (unsigned int*)(carry + words), S, W, tiles, (int)lane_tiles, chunks);
  return (int)cudaGetLastError();
}

// log_a, x, h: contiguous (B, S, W) float32 on the device; scratch: at
// least B * W + 1 eight-byte words on the device (carries, then ticket).
int rglru_launch(const void* log_a, const void* x, void* h, void* scratch,
                 int B, int S, int W, void* stream) {
  if (B < 1 || S < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long words = (long long)B * W;
  const int tiles = (W + LANES - 1) / LANES;
  const int chunks = (S + CHUNK - 1) / CHUNK;
  const long long lane_tiles = (long long)B * tiles;
  const long long blocks = lane_tiles * chunks;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)(words + 1) * 8, st);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* carry = (unsigned long long*)scratch;
  rglru_kernel<<<(unsigned)blocks, LANES, 0, st>>>(
      (const float*)log_a, (const float*)x, (float*)h, carry,
      (unsigned int*)(carry + words), S, W, tiles, (int)lane_tiles, chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
