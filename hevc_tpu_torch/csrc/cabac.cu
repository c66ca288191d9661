// The CABAC arithmetic decoder (9.3.4.3) over independent rows, for Hopper
// (sm_90a).
//
// Plain C interface, loaded with ctypes (hevc_tpu_torch/build.py).  The
// launchers enqueue on the stream they are given, allocate nothing and
// return cudaGetLastError().  The plain PyTorch version
// (hevc_tpu_torch/cabac/rows.py:decode_rows_plain) defines the expected
// bins, including those of the padding after a row's end; int32 arithmetic
// wraps there as the JAX kernel's does, so range and offset are updated
// through unsigned arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// hevc_tpu_torch/cabac/rows.py mirrors the constants (a test holds them)
constexpr int kChunk = 128;       // bins of one staged chunk of the schedule
constexpr int kBlocksPerSm = 32;  // resident one-warp blocks an SM takes

// A chunk's bins eat at most kChunk bytes and the bit window reads up to 9
// ahead, so the byte cursor moves at most kAhead in a chunk
constexpr int kAhead = kChunk + 12;
// words of the bitstream ring: the bytes of the chunk after this one are
// asked for while this one is decoded, so 2 * kAhead + 3 words at most lie
// between the cursor and the last word in flight
constexpr int kDataRing = 512;
// cabac/rows.py:cabac_step_table: the 128 context states, then the two
// pseudo-states that let bypass and terminate bins take the same step
constexpr int kStepWords = 132 * 4;
constexpr int kTerminateState = 128;
constexpr int kBypassState = 130;
// context slots: rows.py MAX_CTX real ones, then the two pseudo-states'
constexpr int kMaxCtx = 256;
constexpr int kBypass = -1, kTerminate = -2;  // cabac/rows.py
constexpr unsigned kFull = 0xFFFFFFFFu;

static_assert(kDataRing >= 2 * kAhead + 4 && !(kDataRing & (kDataRing - 1)) &&
                  kChunk % 4 == 0,
              "the bitstream ring");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// device to shared memory without a register (cp.async, sm_80+); each
// thread waits for its own copies, a __syncwarp() then for the warp's
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// words the int32 pointer lies past a 16-byte boundary
__device__ __forceinline__ int misalign(const int32_t* p) {
  return (int)(((uintptr_t)p >> 2) & 3);
}

// The warp asks for words [a, b) of the row `src`; word j lands in
// ring[(m + j - shift) & mask], m = misalign(src) and shift a multiple of
// 4, so that 16 aligned bytes of device memory are 16 aligned bytes of the
// ring (mask = the ring's size - 1) or of a plain buffer (mask = -1, shift
// = the first word it holds): whole vectors go as one 16-byte copy, the up
// to 3 words before the first and after the last vector as 4-byte copies.
// Nothing outside [a, b) is read.
__device__ __forceinline__ void stage(int32_t* ring, int mask, int shift,
                                      const int32_t* src, int m, int a, int b,
                                      int lane) {
  if (a >= b) return;
  const int head = min((4 - ((m + a) & 3)) & 3, b - a);
  const int d = m - shift;
  if (lane < head) cp_async4(ring + ((d + a + lane) & mask), src + a + lane);
  const int v0 = a + head, nvec = (b - v0) >> 2;
  for (int v = lane; v < nvec; v += 32)
    cp_async16(ring + ((d + v0 + 4 * v) & mask), src + v0 + 4 * v);
  const int t0 = v0 + 4 * nvec;
  if (lane < b - t0)
    cp_async4(ring + ((d + t0 + lane) & mask), src + t0 + lane);
}

// The warp writes `len` bins (bytes in shared memory) to the int32 row at
// `q`: 16-byte vectors where q is aligned, single words around them.
__device__ __forceinline__ void write_bins(int32_t* q, const uint8_t* bb,
                                           int len, int lane) {
  const int head = min((4 - misalign(q)) & 3, len);
  if (lane < head) q[lane] = bb[lane];
  const int nvec = (len - head) >> 2;
  for (int v = lane; v < nvec; v += 32) {
    const uint8_t* b = bb + head + 4 * v;
    *reinterpret_cast<int4*>(q + head + 4 * v) =
        make_int4(b[0], b[1], b[2], b[3]);
  }
  const int t0 = head + 4 * nvec;
  if (lane < len - t0) q[t0 + lane] = bb[t0 + lane];
}

// doublings that bring the range to >= 256 (0 outside 1..255, as the
// plain version's table)
__device__ __forceinline__ int renorm_shift(int rng) {
  return rng > 0 && rng < 256 ? __clz(rng) - 23 : 0;
}

// Replaces hevc_tpu/tpu/cabac_pallas.py:_cabac_kernel (one grid step a
// row, every ref in SMEM).  A row is one dependent chain: bin i + 1 needs
// the range and offset bin i leaves, so the chain's latency bounds the
// kernel, not bytes or operations, and rows are the only parallelism.  A
// picture has 17 to 68 WPP rows, far fewer than the card has warp slots,
// so the design spends a warp on a row to keep the chain short:
//
// - A block is one warp and takes one row (more rows than resident blocks
//   are walked grid-stride), so R rows spread over min(R, 132) SMs.  Lane
//   0 runs the chain alone, so nothing diverges; the 32 lanes together
//   are the row's copy engine.
// - Nothing of device memory is in the chain.  Schedule and bitstream are
//   staged by cp.async into shared memory, as the int32 words they are,
//   one chunk ahead: while lane 0 decodes chunk c, chunk c + 1 of the
//   schedule and the bytes up to 2 * kAhead past the cursor are in
//   flight.  Lane 0 leaves its bins as bytes in shared memory and the
//   warp writes each finished chunk out as 16-byte vectors.
// - One step for the three kinds, without a branch in the chain (a branch
//   waits for the chain's predicate and stalls the lane's next bin).  A
//   bin reads one table word, indexed by the 7-bit state and the range
//   quarter: rangeTabLps, the state after an LPS (the MPS flip at state 0
//   folded in), the state after an MPS and the renormalisation shift
//   after an LPS.  Bypass and terminate bins take the same step through
//   two pseudo-states in the slots 255 and 254 of the context states
//   (rangeTabLps 0 and 2, a state that stays).  Both ranges a bin may
//   leave are renormalised while the offset is compared, so one select
//   follows the compare.  The next bin's kind and state are read before
//   this bin's state is stored (and patched when both use one slot), so
//   the table read is the only shared-memory round trip in the chain.
// - The bit window is 64 bits wide and is topped up to 32 or more once in
//   four bins (a bin eats at most 8), so that test leaves the chain too;
//   renormalisation is one __clz.
// What is left is the lane's own instruction rate: about 49 a bin,
// each waiting its fixed 1 to 6 clocks for the one before.
struct __align__(16) Shared {
  int32_t sslot[2][kChunk + 4];  // a chunk of the schedule each
  int32_t dring[kDataRing];      // the bitstream, one byte a word
  uint32_t tab[kStepWords];
  uint8_t bb[kChunk];            // the chunk's bins
  uint8_t st[kMaxCtx];           // context states and the pseudo-states
};

__global__ void __launch_bounds__(32)
cabac_kernel(const int32_t* __restrict__ data, int n_bytes,
             const int32_t* __restrict__ sched, int sched_stride, int n_bins,
             const int32_t* __restrict__ init, int n_ctx,
             const int32_t* __restrict__ step, int R,
             int32_t* __restrict__ bins) {
  __shared__ Shared sm;
  uint32_t* const tab = sm.tab;
  int32_t* const dring = sm.dring;
  uint8_t* const bb = sm.bb;
  uint8_t* const st = sm.st;
  const int lane = threadIdx.x;
  for (int k = lane; k < kStepWords; k += 32) tab[k] = (uint32_t)step[k];
  const int nchunks = (n_bins + kChunk - 1) / kChunk;

  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const int32_t* src = data + (size_t)r * n_bytes;
    const int32_t* sc = sched + (size_t)r * sched_stride;
    int32_t* out = bins + (size_t)r * n_bins;
    const int md = misalign(src), ms = misalign(sc);
    // the bytes asked for once the cursor stands at p, to a vector's end
    auto target = [&](int p) {
      return ((p + 2 * kAhead + md + 3) & ~3) - md;
    };
    // bytes [a, b) of the row into the ring, zeros past the row's end
    auto fill = [&](int a, int b) {
      stage(dring, kDataRing - 1, 0, src, md, a, min(b, n_bytes), lane);
      for (int j = max(a, n_bytes) + lane; j < b; j += 32)
        dring[(md + j) & (kDataRing - 1)] = 0;
    };
    auto byte_at = [&](int p) {
      return (uint32_t)dring[(md + p) & (kDataRing - 1)] & 0xFF;
    };
    __syncwarp();  // lane 0 is done with the previous row's states
    for (int c = lane; c < kMaxCtx; c += 32)
      st[c] = c < n_ctx ? (uint8_t)(init[(size_t)r * n_ctx + c] & 127)
                        : c == kMaxCtx - 1 ? kBypassState : kTerminateState;
    stage(sm.sslot[0], -1, 0, sc, ms, 0, min(kChunk, n_bins), lane);
    int filled = target(0);
    fill(0, filled);
    cp_async_wait_all();
    __syncwarp();

    // 9.3.2.2: range 510, offset = the first 9 bits
    const uint32_t b1 = byte_at(1);
    int rng = 510;
    int off = (int)(((byte_at(0) << 8) | b1) >> 7);
    // the unread bits, most significant first: `avail` of them in `win`
    uint64_t win = (uint64_t)(b1 & 0x7F) << 57;
    int avail = 7;
    int pos = 2;
    int kind = 0, s = 0;

    // one bin: kind and s are this bin's, read a step ahead
    auto bin = [&](const int32_t* sp, int k) {
      const int nk = sp[k + 1];
      int ns = st[nk & (kMaxCtx - 1)];
      const int pre = kind == kBypass ? 1 : 0;  // bypass shifts a bit in first
      off = (int)__funnelshift_l((uint32_t)(win >> 32), (uint32_t)off, pre);
      win <<= pre;
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
          reinterpret_cast<const char*>(tab) + ((s << 4) | ((rng >> 4) & 12)));
      const int rlps = (int)(w & 0xFF);
      const int cmp = (int)((uint32_t)rng - (uint32_t)rlps);
      const bool hit = off >= cmp;  // an LPS, or a bin of 1
      const int sn = (int)__byte_perm(w, 0, hit ? 0x4441 : 0x4442);
      st[kind & (kMaxCtx - 1)] = (uint8_t)sn;
      if (nk == kind) ns = sn;
      bb[k] = (uint8_t)((s & 1) ^ (int)hit);
      // what a hit takes off the offset (nothing at a row's end, a
      // terminate bin of 1) and both ranges the bin may leave,
      // renormalised, are ready before the compare is: an LPS leaves
      // rangeTabLps with the table's shift, a bypass or terminate bin of
      // 1 the range as it is, anything else cmp with its own shift
      const bool ctx = kind >= 0;
      const int sub = kind == kTerminate ? 0 : cmp;
      const int n_hit = ctx ? (int)(w >> 24) : 0;
      const int r_hit = ctx ? rlps << n_hit : cmp;
      const int n_miss = kind != kBypass ? renorm_shift(cmp) : 0;
      const int r_miss = (int)((uint32_t)cmp << n_miss);
      if (hit) off = (int)((uint32_t)off - (uint32_t)sub);
      rng = hit ? r_hit : r_miss;
      const int n = hit ? n_hit : n_miss;
      off = (int)__funnelshift_l((uint32_t)(win >> 32), (uint32_t)off, n);
      win <<= n;
      avail -= n + pre;
      kind = nk;
      s = ns;
    };

    for (int c = 0; c < nchunks; ++c) {
      const int len = min(kChunk, n_bins - c * kChunk);
      cp_async_wait_all();
      __syncwarp();  // chunk c and its bytes have landed; bb is complete
      if (c) write_bins(out + (c - 1) * kChunk, bb, kChunk, lane);
      __syncwarp();  // before lane 0 writes bb again
      stage(sm.sslot[(c + 1) & 1], -1, (c + 1) * kChunk, sc, ms,
            (c + 1) * kChunk, min((c + 2) * kChunk, n_bins), lane);
      const int want = target(__shfl_sync(kFull, pos, 0));
      fill(filled, want);
      filled = want;
      if (lane) continue;

      const int32_t* sp = sm.sslot[c & 1] + ms;
      kind = sp[0];
      s = st[kind & (kMaxCtx - 1)];
      for (int k0 = 0; k0 < len; k0 += 4) {
        if (avail < 32) {  // four more bytes: 32 to 63 bits for four bins
          const uint32_t x = byte_at(pos) << 24 | byte_at(pos + 1) << 16 |
                             byte_at(pos + 2) << 8 | byte_at(pos + 3);
          win |= (uint64_t)x << (32 - avail);
          avail += 32;
          pos += 4;
        }
        if (k0 + 4 <= len) {
#pragma unroll
          for (int j = 0; j < 4; ++j) bin(sp, k0 + j);
        } else {
          for (int k = k0; k < len; ++k) bin(sp, k);
        }
      }
    }
    __syncwarp();
    if (nchunks)
      write_bins(out + (nchunks - 1) * kChunk, bb,
                 n_bins - (nchunks - 1) * kChunk, lane);
  }
}

// The two latencies of the chain bound, in SM clocks times `iters`: out[0]
// for `iters` dependent loads from shared memory (a pointer chase through
// 32 words that hold byte offsets, so a load's result is the next one's
// address), out[1] for `iters` dependent 32-bit multiply-adds; out[2]
// keeps both results alive.
__global__ void chain_latency_kernel(int iters, int a, int b,
                                     long long* out) {
  __shared__ int ring[32];
  ring[threadIdx.x] = ((threadIdx.x + 1) & 31) * 4;
  __syncwarp();
  if (threadIdx.x) return;
  const char* base = reinterpret_cast<const char*>(ring);
  int p = 0, x = a;
  long long t0, t1, t2;
  asm volatile("mov.u64 %0, %%clock64;  // after %1"
               : "=l"(t0) : "r"(p) : "memory");
#pragma unroll 16
  for (int i = 0; i < iters; ++i) p = *reinterpret_cast<const int*>(base + p);
  asm volatile("mov.u64 %0, %%clock64;  // after %1"
               : "=l"(t1) : "r"(p) : "memory");
  x += p;
#pragma unroll 16
  for (int i = 0; i < iters; ++i) x = x * a + b;
  asm volatile("mov.u64 %0, %%clock64;  // after %1"
               : "=l"(t2) : "r"(x) : "memory");
  out[0] = t1 - t0;
  out[1] = t2 - t1;
  out[2] = x;
}

}  // namespace

extern "C" {

// rows the card decodes at once: kBlocksPerSm one-warp blocks on every SM
int hevc_cabac_resident_rows(int* rows) {
  int dev = 0, sms = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (!rc)
    rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
  *rows = sms * kBlocksPerSm;
  return rc;
}

int hevc_cabac_launch(const int32_t* data, int n_bytes,
                      const int32_t* sched, int sched_stride, int n_bins,
                      const int32_t* init, int n_ctx, const int32_t* step,
                      int R, int32_t* bins, void* stream) {
  if (R <= 0 || n_bins <= 0) return (int)cudaGetLastError();
  int resident = 0;
  int rc = hevc_cabac_resident_rows(&resident);
  // every SM's shared memory for the 5.4 KB blocks, so that kBlocksPerSm fit
  static bool carved = false;
  if (!rc && !carved) {
    rc = (int)cudaFuncSetAttribute(
        cabac_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    carved = !rc;
  }
  if (rc) return rc;
  cabac_kernel<<<R < resident ? R : resident, 32, 0, (cudaStream_t)stream>>>(
      data, n_bytes, sched, sched_stride, n_bins, init, n_ctx, step, R, bins);
  return (int)cudaGetLastError();
}

int hevc_chain_latency_launch(int iters, int a, int b, long long* out,
                              void* stream) {
  chain_latency_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(iters, a, b, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
