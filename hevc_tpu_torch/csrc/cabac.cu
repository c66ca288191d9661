// The CABAC arithmetic decoder (9.3.4.3) over independent rows, for Hopper
// (sm_90a).
//
// Plain C interface, loaded with ctypes (hevc_tpu_torch/build.py).  The
// launcher enqueues on the stream it is given, allocates nothing and
// returns cudaGetLastError().  The plain PyTorch version
// (hevc_tpu_torch/cabac.py:decode_rows_plain) defines the expected bins,
// including those of the padding after a row's end; int32 arithmetic
// wraps there as the JAX kernel's does, so the offset is updated through
// unsigned arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCabacThreads = 128;
constexpr int kTabSize = 256 + 64 + 64;  // rangeTabLps, transIdxLps, Mps
constexpr int kBypass = -1;  // and -2 terminate (cabac.py BYPASS, TERMINATE)

// doublings that bring the range to >= 256 (0 outside 1..255, as the
// plain version's table)
__device__ __forceinline__ int renorm_shift(int rng) {
  return rng > 0 && rng < 256 ? __clz(rng) - 23 : 0;
}

// Replaces hevc_tpu/tpu/cabac_pallas.py:_cabac_kernel.  One thread per
// row: the per-bin chain (table lookup, compare, renormalise) is serial
// by nature, so rows are the only parallelism.  Bound: the latency of
// that dependent chain, one schedule load and a shared-memory state
// access per bin.  Rows of a warp index different table entries and
// context slots, so the tables sit in shared memory (constant memory
// would serialise such accesses) and the context states of the block's
// threads are bytes in shared memory, interleaved so that the four
// states of one 32-bit word belong to one thread: word (c / 4) * blockDim
// + thread, byte c % 4.  Each thread of a warp then reads its own bank.
// Range, offset, a 32-bit bit window and the byte cursor stay in
// registers; bytes are read through each row's own cursor.
__global__ void __launch_bounds__(kCabacThreads)
cabac_kernel(const int32_t* __restrict__ data, int n_bytes,
             const int32_t* __restrict__ sched, int sched_stride, int n_bins,
             const int32_t* __restrict__ init, int n_ctx,
             const int32_t* __restrict__ tables, int R,
             int32_t* __restrict__ bins) {
  extern __shared__ uint8_t smem[];
  uint8_t* tab = smem;                       // [kTabSize]
  uint8_t* states = smem + kTabSize;         // [(n_ctx + 3) / 4 * 4 * bd]
  const int tid = threadIdx.x, bd = blockDim.x;
  for (int k = tid; k < kTabSize; k += bd) tab[k] = (uint8_t)tables[k];
  const int r = blockIdx.x * bd + tid;
  if (r < R)
    for (int c = 0; c < n_ctx; ++c)
      states[((c >> 2) * bd + tid) * 4 + (c & 3)] =
          (uint8_t)init[(size_t)r * n_ctx + c];
  __syncthreads();
  if (r >= R) return;
  const uint8_t* rtab = tab;
  const uint8_t* tlps = tab + 256;
  const uint8_t* tmps = tab + 320;
  const int32_t* src = data + (size_t)r * n_bytes;
  const int32_t* sc = sched + (size_t)r * sched_stride;
  int32_t* out = bins + (size_t)r * n_bins;

  // 9.3.2.2: range 510, offset = the first 9 bits
  const unsigned b0 = (unsigned)src[0] & 0xFF;
  const unsigned b1 = n_bytes > 1 ? (unsigned)src[1] & 0xFF : 0;
  int rng = 510;
  int off = (int)(((b0 << 8) | b1) >> 7);
  // the unread bits, most significant first: `avail` of them in `win`
  uint32_t win = (b1 & 0x7F) << 25;
  int avail = 7;
  int pos = 2;

  for (int i = 0; i < n_bins; ++i) {
    if (avail < 8) {  // refill to at least 25 bits; zeros past the end
      while (avail <= 24) {
        const uint32_t b = pos < n_bytes ? (uint32_t)src[pos] & 0xFF : 0;
        win |= b << (24 - avail);
        avail += 8;
        ++pos;
      }
    }
    const int kind = sc[i];
    int bit, n;
    if (kind >= 0) {
      uint8_t* sp = states + ((kind >> 2) * bd + tid) * 4 + (kind & 3);
      const int s = *sp, p = s >> 1, mps = s & 1;
      const int rlps = rtab[p * 4 + ((rng >> 6) & 3)];
      rng -= rlps;
      if (off >= rng) {
        bit = 1 - mps;
        off -= rng;
        rng = rlps;
        *sp = (uint8_t)((tlps[p] << 1) | (p == 0 ? 1 - mps : mps));
      } else {
        bit = mps;
        *sp = (uint8_t)((tmps[p] << 1) | mps);
      }
      n = renorm_shift(rng);
    } else if (kind == kBypass) {
      off = (int)(((uint32_t)off << 1) | (win >> 31));
      win <<= 1;
      --avail;
      bit = off >= rng;
      if (bit) off = (int)((uint32_t)off - (uint32_t)rng);
      n = 0;
    } else {  // terminate: no renormalisation when the bin is 1
      rng -= 2;
      bit = off >= rng;
      n = bit ? 0 : renorm_shift(rng);
    }
    if (n) {
      off = (int)(((uint32_t)off << n) | (win >> (32 - n)));
      win <<= n;
      avail -= n;
      rng <<= n;
    }
    out[i] = bit;
  }
}

}  // namespace

extern "C" {

int hevc_cabac_launch(const int32_t* data, int n_bytes,
                      const int32_t* sched, int sched_stride, int n_bins,
                      const int32_t* init, int n_ctx, const int32_t* tables,
                      int R, int32_t* bins, void* stream) {
  if (R > 0) {
    const int blocks = (R + kCabacThreads - 1) / kCabacThreads;
    const size_t smem = kTabSize + (size_t)(n_ctx + 3) / 4 * 4 * kCabacThreads;
    cabac_kernel<<<blocks, kCabacThreads, smem, (cudaStream_t)stream>>>(
        data, n_bytes, sched, sched_stride, n_bins, init, n_ctx, tables, R,
        bins);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
