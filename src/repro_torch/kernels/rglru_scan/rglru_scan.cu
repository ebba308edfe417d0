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
// Design: the forward's chained chunk scan run backwards in time.  The
// carry chunk c hands to chunk c - 1 is e = exp(log_a[t0]) * g[t0] at its
// first step t0, which is P * e_in + el, P the chunk's decay and el the
// same quantity from e_in = 0.  The ticket maps chunk-major in reverse
// order: the LAST chunk takes tickets 0.., so every block a block waits
// on holds a smaller ticket and is running (handing chunk 0 the first
// tickets would make the first blocks wait on successors that may never
// be scheduled).  A carry word is (c' + 1) << 32 | float bits with c' =
// chunks - 1 - c the chunk's place in that order.  The pass that writes
// reads h[t-1] beside each step as it goes (one coalesced load a step),
// so registers hold only the chunk's a and dh, as the forward holds a
// and x.  The same trap after 2^24 polls.
__global__ void __launch_bounds__(LANES)
rglru_bwd_kernel(const float* __restrict__ log_a, const float* __restrict__ h,
                 const float* __restrict__ dh, float* __restrict__ dlog_a,
                 float* __restrict__ db, unsigned long long* __restrict__ carry,
                 unsigned int* __restrict__ ticket, int S, int W, int tiles,
                 int lane_tiles, int chunks) {
  __shared__ unsigned int s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1u);
  __syncthreads();
  const int cr = (int)(s_ticket / (unsigned)lane_tiles);  // place in reverse order
  const int r = (int)(s_ticket % (unsigned)lane_tiles);
  const int c = chunks - 1 - cr;
  const int b = r / tiles;
  const int w = (r % tiles) * LANES + threadIdx.x;
  if (w >= W) return;
  const int t0 = c * CHUNK;
  const int n = min(CHUNK, S - t0);
  const size_t base = ((size_t)b * S + t0) * W + w;

  // steps past the end get a = 1, dh = 0: g stays 0 there
  float a[CHUNK], d[CHUNK];
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) {
    a[u] = u < n ? __ldg(log_a + base + (size_t)u * W) : 0.f;
    d[u] = u < n ? __ldg(dh + base + (size_t)u * W) : 0.f;
  }
  float decay = 1.f, el = 0.f;
#pragma unroll
  for (int u = CHUNK - 1; u >= 0; --u) {
    a[u] = expf(a[u]);
    el = a[u] * (d[u] + el);
    decay *= a[u];
  }

  unsigned long long* word = carry + (size_t)b * W + w;
  float ein = 0.f;
  if (cr > 0) {
    unsigned long long got = load_acquire(word);
    for (unsigned spins = 0; (unsigned)(got >> 32) != (unsigned)cr; ++spins) {
      if (spins == 1u << 24) __trap();
      got = load_acquire(word);
    }
    ein = __uint_as_float((unsigned)got);
  }
  if (c > 0)
    store_release(word, ((unsigned long long)(cr + 1) << 32) |
                            __float_as_uint(fmaf(decay, ein, el)));

  float e = ein;
#pragma unroll
  for (int u = CHUNK - 1; u >= 0; --u) {
    if (u < n) {
      const float g = d[u] + e;
      const size_t at = base + (size_t)u * W;
      const float hp = (t0 + u > 0) ? __ldg(h + at - W) : 0.f;
      db[at] = g;
      dlog_a[at] = g * a[u] * hp;
      e = a[u] * g;
    }
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// log_a, h, dh, dlog_a, db: contiguous (B, S, W) float32 on the device;
// scratch as for rglru_launch.
int rglru_bwd_launch(const void* log_a, const void* h, const void* dh, void* dlog_a,
                     void* db, void* scratch, int B, int S, int W, void* stream) {
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
  rglru_bwd_kernel<<<(unsigned)blocks, LANES, 0, st>>>(
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
