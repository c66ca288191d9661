// Intra prediction and reconstruction of the wavefront chunks for Hopper
// (sm_90a): the device-side loop of the decoder's intra stage.
//
// Replaces hevc_tpu/tpu/intra.py:201 reconstruct_wavefront, a jitted
// lax.scan of :158 make_chunk_body over the chunks, which the reference
// computes in XLA (no Pallas kernel).  The plain PyTorch version,
// hevc_tpu_torch/intra.py:reconstruct_wavefront, defines the expected
// result bit for bit, its index clamps and its padding rule included.
//
// Plain C interface, loaded with ctypes (hevc_tpu_torch/build.py).  The
// launcher walks the chunks on the host and launches intra_chunk_kernel
// once per live chunk (one that holds a record, by the host's counts) on
// the stream it is given: one call from Python per picture, the chunks in
// order on one stream, so chunk k + 1 reads what chunk k wrote.  It
// allocates nothing and returns cudaGetLastError().
//
// One warp reconstructs one record of any size class (4, 8, 16, 32), four
// warps a block, all four classes' records of the chunk in one launch.  A
// record, in order: gathers its 4n + 1 neighbours from the flat int32
// canvas in the scan order of 8.4.4.2.2 (left bottom to top, corner, top
// left to right), substitutes the unavailable ones with a warp ballot and
// a running maximum of the last available index (32 positions a step),
// filters [1 2 1] along the same order (8.4.4.2.3; the bilinear strong
// smoothing for 32x32 under 1 << (bd - 5)), predicts with its own mode
// only (planar, DC with the edge filter, or angular with the
// inverse-angle extension and the mode-10/26 edge tweaks), adds its
// residual and clips, and writes its block into the canvas in place.
//
// Blocks of one chunk run in any order.  The pack gives each record a
// level one above every block its L-shaped band reads, so a sample that
// another record of the same chunk writes is never *available* to the
// reader, and substitution drops its value (tests/test_torch_intra_kernel.py
// checks this on the pack's output).  Padding records (cy == DUMP) and any
// record whose reads would leave the canvas write nothing: the plain
// version sends their writes to a trash area.
//
// What bounds it: a 1080p I picture has hundreds of dependent chunks of a
// few hundred records each, so the chain of launches, one a chunk, bounds
// it (the live chunks times the device time between two back-to-back
// launches, which hevc_launch_floor measures), not its bytes (4n + 1
// neighbours, n^2 residuals and n^2 writes a record: under 0.01 ms at
// 3.35 TB/s).  The design keeps a record's work inside one warp, with no
// block-wide barrier and its references in shared memory; a lane issues
// its gather's loads before the first ballot and its residual loads four
// pixels ahead.  One warp still does a whole 32x32 record, so a chunk
// takes its largest record's chain of dependent steps, several times the
// floor (PERF.md); splitting a record over warps is later work.

#include <cuda_runtime.h>
#include <stdint.h>

// One picture's records, per size class c (n = 4 << c): scal[c] int32
// [n_chunks, B[c], 8] (cy, cx, mode, slot, filt, strong, edge, avail
// corner), avail[c] bool [n_chunks, B[c], 128] (the left column's 64 then
// the top row's 64; the first 2n of each are read), resid[c] int32
// [npool[c], n, n] (slot 0 zeros).  External linkage: the launcher takes
// it (hevc_tpu_torch/intra_cuda.py mirrors it).
struct IntraParams {
  const int32_t* scal[4];
  const uint8_t* avail[4];
  const int32_t* resid[4];
  int B[4];
  int npool[4];
  int ch, cw, bd;
};

namespace {

constexpr int kWarps = 4;          // records (warps) a block
constexpr int kScan = 4 * 32 + 4;  // 4n + 1 references at n = 32, padded
constexpr int kExt = 3 * 32 + 4;   // angular reference ref[0 .. 3n + 2]

// H.265 Table 8-5 intraPredAngle by mode (0 for planar and DC) and
// Table 8-6 invAngle (modes 11-25).  tests/test_torch_intra_kernel.py holds
// both against hevc_tpu_torch/tables.py.
__constant__ int c_angle[35] = {
    0,   0,   32,  26,  21,  17,  13,  9,   5,   2,  0,  -2,
    -5,  -9,  -13, -17, -21, -26, -32, -26, -21, -17, -13, -9,
    -5,  -2,  0,   2,   5,   9,   13,  17,  21,  26,  32};
__constant__ int c_invangle[35] = {
    0,    0,    0,    0,    0,     0,     0,     0,     0,    0,    0,   -4096,
    -1638, -910, -630, -482, -390, -315, -256, -315, -390, -482, -630, -910,
    -1638, -4096, 0,   0,    0,     0,     0,     0,     0,    0,    0};

struct WarpRefs {
  int a[kScan];    // gathered, then filtered
  int b[kScan];    // substituted
  int ext[kExt];   // angular reference
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kWarps * 32)
intra_chunk_kernel(int32_t* __restrict__ canvas,
                   const __grid_constant__ IntraParams p, int chunk,
                   int mask) {
  __shared__ WarpRefs smem[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this warp's record: the live classes' slots of the chunk, in order
  int w = blockIdx.x * kWarps + warp;
  int c = 0;
  for (; c < 4; ++c) {
    if (!((mask >> c) & 1)) continue;
    if (w < p.B[c]) break;
    w -= p.B[c];
  }
  if (c == 4) return;
  const int n = 4 << c, n2 = 2 * n, L = 4 * n + 1, log2n = c + 2;
  const size_t rec = (size_t)chunk * p.B[c] + w;
  const int32_t* s = p.scal[c] + rec * 8;
  const int cy = s[0], cx = s[1];
  const int ch = p.ch, cw = p.cw;
  // padding (cy == DUMP), or reads that would leave the canvas: the plain
  // version's trash area, so nothing is written
  if (cy < 1 || cx < 1 || cy + n2 > ch || cx + n2 > cw) return;
  const int mode = s[2];
  const int slot = clampi(s[3], 0, p.npool[c] - 1);
  const bool filt = s[4] != 0, strong = s[5] != 0, edge = s[6] != 0;
  const bool avc = s[7] != 0;
  const uint8_t* av = p.avail[c] + rec * 128;
  WarpRefs& r = smem[warp];

  // gather in scan order (every load of the lane issued before the first
  // ballot) and substitute (8.4.4.2.2): position j takes the last
  // available position <= j, else the first available one, else
  // 1 << (bd - 1); `src` keeps the former per step of 32 positions
  const int steps = (L + 31) >> 5;
  bool has[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    const int j = t * 32 + lane;
    bool a = false;
    if (t < steps && j < L) {
      int v;
      if (j < n2) {
        const int i = n2 - 1 - j;
        v = canvas[(size_t)(cy + i) * cw + cx - 1];
        a = av[i] != 0;
      } else if (j == n2) {
        v = canvas[(size_t)(cy - 1) * cw + cx - 1];
        a = avc;
      } else {
        const int i = j - n2 - 1;
        v = canvas[(size_t)(cy - 1) * cw + cx + i];
        a = av[64 + i] != 0;
      }
      r.a[j] = v;
    }
    has[t] = a;
  }
  int src[5];
  int carry = -1, first = -1;
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    if (t >= steps) break;
    const unsigned m = __ballot_sync(0xffffffffu, has[t]);
    const unsigned le = m & (0xffffffffu >> (31 - lane));
    src[t] = le ? t * 32 + 31 - __clz(le) : carry;
    if (m) {
      carry = t * 32 + 31 - __clz(m);
      if (first < 0) first = t * 32 + __ffs(m) - 1;
    }
  }
  __syncwarp();
  const int half = 1 << (p.bd - 1);
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    if (t >= steps) break;
    const int j = t * 32 + lane;
    if (j < L) r.b[j] = first < 0 ? half : r.a[src[t] >= 0 ? src[t] : first];
  }
  __syncwarp();

  // filter (8.4.4.2.3): [1 2 1] along the scan order with both ends kept;
  // for 32x32 under `strong`, the bilinear ramps between the corner and
  // the last samples when both edges are flat
  const int* f = r.b;
  if (filt) {
    bool flat = false;
    int c0 = 0, l63 = 0, t63 = 0;
    if (c == 3 && strong) {
      c0 = r.b[n2];
      l63 = r.b[0];
      t63 = r.b[L - 1];
      const int thr = 1 << (p.bd - 5);
      flat = abs(c0 + t63 - 2 * r.b[n2 + 1 + n - 1]) < thr &&
             abs(c0 + l63 - 2 * r.b[n2 - 1 - (n - 1)]) < thr;
    }
    for (int j = lane; j < L; j += 32) {
      int v = r.b[j];
      if (flat) {
        if (j < n2) {
          const int i = n2 - 1 - j;
          if (i < n2 - 1) v = ((62 - i) * c0 + (i + 1) * l63 + 32) >> 6;
        } else if (j > n2) {
          const int i = j - n2 - 1;
          if (i < n2 - 1) v = ((62 - i) * c0 + (i + 1) * t63 + 32) >> 6;
        }
      } else if (j > 0 && j < L - 1) {
        v = (r.b[j - 1] + 2 * v + r.b[j + 1] + 2) >> 2;
      }
      r.a[j] = v;
    }
    __syncwarp();
    f = r.a;
  }
  // left[i] = f[n2 - 1 - i], corner = f[n2], top[i] = f[n2 + 1 + i]
  const int* left = f + n2 - 1;   // left[i] at left[-i]
  const int* top = f + n2 + 1;
  const int corner = f[n2];

  const int maxv = (1 << p.bd) - 1;
  const int32_t* __restrict__ res = p.resid[c] + (size_t)slot * n * n;
  int32_t* dst = canvas + (size_t)cy * cw + cx;
  const int npx = n * n;
  if (mode == 0) {           // planar (8.4.4.2.5)
    const int tn = top[n], ln = left[-n];
#pragma unroll 4
    for (int q = lane; q < npx; q += 32) {
      const int y = q >> log2n, x = q & (n - 1);
      const int v = ((n - 1 - x) * left[-y] + (x + 1) * tn +
                     (n - 1 - y) * top[x] + (y + 1) * ln + n) >> (log2n + 1);
      dst[(size_t)y * cw + x] = clampi(v + __ldg(res + q), 0, maxv);
    }
  } else if (mode == 1) {    // DC (8.4.4.2.5), edge filter below 32x32
    const int part = lane < n ? top[lane] + left[-lane] : 0;
    const int dc = (__reduce_add_sync(0xffffffffu, part) + n) >> (log2n + 1);
    const bool tweak = n < 32 && edge;
#pragma unroll 4
    for (int q = lane; q < npx; q += 32) {
      const int y = q >> log2n, x = q & (n - 1);
      int v = dc;
      if (tweak) {
        if (y == 0 && x == 0)
          v = (left[0] + 2 * dc + top[0] + 2) >> 2;
        else if (y == 0)
          v = (top[x] + 3 * dc + 2) >> 2;
        else if (x == 0)
          v = (left[-y] + 3 * dc + 2) >> 2;
      }
      dst[(size_t)y * cw + x] = clampi(v + __ldg(res + q), 0, maxv);
    }
  } else {                   // angular (8.4.4.2.6)
    const int m = clampi(mode, 0, 34);
    const int angle = c_angle[m], inv = c_invangle[m];
    const bool vert = mode >= 18;
    // ref[n + k] for k in [-n, 2n + 2): the side references projected by
    // invAngle below the corner, the corner, the main references, the
    // last one repeated and a 0
    for (int t = lane; t < 3 * n + 3; t += 32) {
      int v;
      if (t < n) {
        const int k = n - t;
        const int sidx = ((-k * inv + 128) >> 8) - 1;
        const int i = clampi(sidx, 0, n2 - 1);
        v = sidx < 0 ? corner : (vert ? left[-i] : top[i]);
      } else if (t == n) {
        v = corner;
      } else if (t <= 3 * n + 1) {
        const int i = min(t - n - 1, n2 - 1);
        v = vert ? top[i] : left[-i];
      } else {
        v = 0;
      }
      r.ext[t] = v;
    }
    __syncwarp();
    const int last = 3 * n + 2;
#pragma unroll 4
    for (int q = lane; q < npx; q += 32) {
      const int y = q >> log2n, x = q & (n - 1);
      const int prod = ((vert ? y : x) + 1) * angle;
      const int iidx = prod >> 5, ifact = prod & 31;
      const int pos = clampi(n + (vert ? x : y) + iidx + 1, 0, last);
      int v = ((32 - ifact) * r.ext[pos] + ifact * r.ext[min(pos + 1, last)] +
               16) >> 5;
      if (edge && mode == 26 && x == 0)
        v = clampi(top[0] + ((left[-y] - corner) >> 1), 0, maxv);
      else if (edge && mode == 10 && y == 0)
        v = clampi(left[0] + ((top[x] - corner) >> 1), 0, maxv);
      dst[(size_t)y * cw + x] = clampi(v + __ldg(res + q), 0, maxv);
    }
  }
}

__global__ void empty_kernel() {}

// holds the stream for `ns` nanoseconds of the card's global timer, so
// that the launches queued behind it run back to back on the device
__global__ void spin_kernel(long long ns) {
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  do {
    __nanosleep(1000);
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  } while ((long long)(t - t0) < ns);
}

}  // namespace

extern "C" {

// Reconstruct every live chunk of the picture in order: counts is the
// host's int32 [n_chunks, 4] live records per chunk and class; a chunk
// with none is skipped, a live chunk launches one block of kWarps records
// per kWarps slots of its live classes.  *launched: the launches made.
int hevc_intra_launch(int32_t* canvas, const IntraParams* p,
                      const int32_t* counts, int n_chunks, void* stream,
                      int* launched) {
  int done = 0;
  for (int k = 0; k < n_chunks; ++k) {
    int mask = 0, warps = 0;
    for (int c = 0; c < 4; ++c)
      if (counts[4 * k + c] > 0) {
        mask |= 1 << c;
        warps += p->B[c];
      }
    if (!mask || !warps) continue;
    intra_chunk_kernel<<<(warps + kWarps - 1) / kWarps, kWarps * 32, 0,
                         (cudaStream_t)stream>>>(canvas, *p, k, mask);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) {
      *launched = done;
      return (int)e;
    }
    ++done;
  }
  *launched = done;
  return (int)cudaGetLastError();
}

// The floor of one dependent step: *ms is the device time of n empty
// launches back to back on the stream, from an event after a first empty
// launch to one after the last.  With spin_ns > 0 the launches queue
// behind a kernel that holds the stream that long, so the card, not the
// host's launch rate, sets their pace; with 0 they run as the host issues
// them.  Synchronises on its own event.
int hevc_launch_floor(void* stream, int n, long long spin_ns, float* ms) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  if (spin_ns > 0) spin_kernel<<<1, 1, 0, s>>>(spin_ns);
  empty_kernel<<<1, 32, 0, s>>>();
  cudaEventRecord(e0, s);
  for (int i = 0; i < n; ++i) empty_kernel<<<1, 32, 0, s>>>();
  cudaEventRecord(e1, s);
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return (int)cudaGetLastError();
}

}  // extern "C"
