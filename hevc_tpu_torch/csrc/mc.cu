// Inter-prediction kernels for Hopper (sm_90a): motion compensation and
// the inter residual add of the decoder's frame program.
//
// Plain C interface, loaded with ctypes (hevc_tpu_torch/build.py).  Each
// launcher enqueues on the stream it is given, allocates nothing and
// returns cudaGetLastError() so that a refused launch surfaces at once.
// The arithmetic is the codec's exact int32 arithmetic; the plain PyTorch
// versions in hevc_tpu_torch/mc.py define the expected result bit for bit,
// including the JAX package's handling of padding rows (window origins
// clamped into the source, out-of-canvas pixels dropped).
//
// Both kernels take their small per-launch tables as one __grid_constant__
// struct (McParams, ResidParams): the launch needs no upload and the
// kernel indexes the tables in the parameter space without a local copy.

#include <cuda_runtime.h>
#include <stdint.h>

// The parameter structs have external linkage: the extern "C" launchers
// take them, and a launcher whose parameter type is file-local would be
// file-local too (not exported from the library).

constexpr int kMaxGroups = 256;    // (is_ch, bi, wp, w, h) groups a launch

// One launch's geometry and group table.  Group g holds rows
// [row_start[g], row_start[g+1]) of the row table, all of one
// code = is_ch | bi << 1 | wp << 2 | w << 3 | h << 10; each of its PUs is
// ceil(w/16) x ceil(h/16) work units, numbered from unit_start[g].
struct McParams {
  int ch, cw;                 // canvas
  int nl, hl, wl;             // luma reference stack [nl, hl, wl]
  int nc, hc, wc;             // chroma reference stack
  int bd;
  int vec_l, vec_c, vec_out;  // refs_l / refs_c / canvas rows 16 B aligned
  int win_stride;             // ints per staged window row (multiple of 4)
  int warp_smem;              // ints of shared memory per warp
  int ngroups;
  int code[kMaxGroups];
  int row_start[kMaxGroups + 1];
  int unit_start[kMaxGroups + 1];
};

// The four TU classes (s = 4, 8, 16, 32) of one launch: class c has n[c]
// rows (cy, cx, slot) at rows[c] into pool[c] [npool[c], s, s].  Its TUs
// are cut into 4-pixel row segments, numbered from seg_start[c].
struct ResidParams {
  const int32_t* rows[4];
  const int32_t* pool[4];
  int n[4];
  int npool[4];
  int seg_start[5];
  int vec_pool[4];            // pool[c] 16 B aligned
  int ch, cw, bd;
  int vec_out;                // canvas rows 16 B aligned
};

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int shl(int v, int s) {
  return (int)((unsigned)v << s);
}

// ---------------------------------------------------------------------------
// motion compensation
// ---------------------------------------------------------------------------

constexpr int kMcWarps = 4;        // work units (warps) per CTA
constexpr int kSub = 16;           // a PU is filtered in sub-blocks <= 16x16
constexpr int kMcCols = 17;        // production row columns (int16)

// row columns (hevc_tpu/tpu/pipeline.py:_mc_tile_phase)
enum { F_CY = 10, F_CX = 11, F_W0 = 12, F_O0 = 13, F_W1 = 14, F_O1 = 15,
       F_LWD = 16 };

// Interpolation taps, row 0 the unit tap 64 at the centre (H.265 8.5.3.3.3:
// Table 8-11 luma fL, Table 8-12 chroma fC).  tests/test_torch_mc.py holds
// these rows against hevc_tpu_torch/ops/mc.py.
__constant__ int c_qpel[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};
__constant__ int c_epel[8][4] = {
    {0, 64, 0, 0},  {-2, 58, 10, -2}, {-4, 54, 16, -2}, {-6, 46, 28, -4},
    {-4, 36, 36, -4}, {-4, 28, 46, -6}, {-2, 16, 54, -4}, {-2, 10, 58, -2}};

// 16 B from device to shared memory without a register (cp.async, sm_80+);
// each thread waits for its own copies, a __syncwarp() then for the warp's.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Stage the (hb+NT-1) x (wb+NT-1) window at (wy, wx) of one reference plane
// in shared memory.  A row moves as 16 B vectors from the aligned
// x0 = wx & ~3 (the rule of the TMA window probe: an unaligned inner offset
// takes aligned boxes and a shift); the shift wx - x0 is applied when the
// horizontal pass reads the window.  Lanes map to (row, vector) as
// (lane >> 3, lane & 7): a row needs at most 7 vectors.  The vectors go
// by cp.async, so all of a lane's (up to 6) are in flight at once.
template <int NT>
__device__ __forceinline__ void stage_window(
    const int32_t* __restrict__ plane, int wp, bool vec, int wy, int wx,
    int rows, int cols, int* win, int ws, int lane) {
  const int x0 = wx & ~3;
  const int nvec = (wx - x0 + cols + 3) >> 2;
  const int v = lane & 7;
  if (v >= nvec) return;
  for (int y = lane >> 3; y < rows; y += 4) {
    const int32_t* src = plane + (size_t)(wy + y) * wp + x0 + 4 * v;
    int* dst = win + y * ws + 4 * v;
    if (vec) {
      cp_async16(dst, src);
    } else {
      // rows not 16 B aligned: the same words, read one by one and only
      // where they lie inside the plane's row
      const int x = x0 + 4 * v;
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j] = x + j < wp ? __ldg(src + j) : 0;
    }
  }
  cp_async_wait_all();
}

// SEG consecutive ints of shared memory, as one vector access
template <int SEG>
struct Seg;
template <>
struct Seg<4> {
  __device__ static void load(const int* p, int* v) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ static void store(int* p, const int* v) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Seg<2> {
  __device__ static void load(const int* p, int* v) {
    const int2 q = *reinterpret_cast<const int2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
  __device__ static void store(int* p, const int* v) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  }
};

// One prediction of a work unit's hb x wb sub-block, left in `out`:
// out[it][j] is the 14-bit sample at row (lane >> 2) + 8 * it, column
// SEG * (lane & 3) + j.  NT taps, SEG output columns per lane.
template <int NT, int SEG>
__device__ __forceinline__ void predict(
    const int32_t* __restrict__ refs, int nref, int hp, int wp, bool vec,
    const int16_t* f, int o, int w, int h, int xo, int yo, int wb, int hb,
    int bd, int* win, int ws, int* tmp, int lane, int (&out)[2][SEG]) {
  const int nfrac = NT == 8 ? 4 : 8;
  const int sel = clampi(f[o], 0, nref - 1);
  // the window origin of the whole PU, clamped as jax dynamic_slice does
  const int by = clampi(f[o + 1], 0, hp - (h + NT - 1));
  const int bx = clampi(f[o + 2], 0, wp - (w + NT - 1));
  const int fx = clampi(f[o + 3], 0, nfrac - 1);
  const int fy = clampi(f[o + 4], 0, nfrac - 1);
  int th[NT], tv[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    th[i] = NT == 8 ? c_qpel[fx][i] : c_epel[fx][i];
    tv[i] = NT == 8 ? c_qpel[fy][i] : c_epel[fy][i];
  }
  const int rows = hb + NT - 1;
  const int wx = bx + xo;
  __syncwarp();  // the previous prediction is done with the warp's memory
  stage_window<NT>(refs + (size_t)sel * hp * wp, wp, vec, by + yo, wx, rows,
                   wb + NT - 1, win, ws, lane);
  __syncwarp();
  // horizontal pass: tmp[rows][16], >> (bd - 8)
  const int sh = wx - (wx & ~3);
  const int xs = SEG * (lane & 3);
  const int shift1 = bd - 8;
  if (xs < wb) {
    for (int y = lane >> 2; y < rows; y += 8) {
      const int* wr = win + y * ws + sh + xs;
      int a[NT + SEG - 1];
#pragma unroll
      for (int i = 0; i < NT + SEG - 1; ++i) a[i] = wr[i];
      int t[SEG];
#pragma unroll
      for (int j = 0; j < SEG; ++j) {
        int s = 0;
#pragma unroll
        for (int i = 0; i < NT; ++i) s += th[i] * a[i + j];
        t[j] = s >> shift1;
      }
      Seg<SEG>::store(tmp + y * kSub + xs, t);
    }
  }
  __syncwarp();
  // vertical pass: >> 6, kept in registers; a lane reads its SEG columns
  // of a temporary row as one vector (8 lanes cover 2 rows: no bank
  // conflict)
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int y = (lane >> 2) + 8 * it;
    if (xs < wb && y < hb) {
      int s[SEG] = {};
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        int t[SEG];
        Seg<SEG>::load(tmp + (y + i) * kSub + xs, t);
#pragma unroll
        for (int j = 0; j < SEG; ++j) s[j] += tv[i] * t[j];
      }
#pragma unroll
      for (int j = 0; j < SEG; ++j) out[it][j] = s[j] >> 6;
    }
  }
}

// Weighted (or default) combination, clip and store of one work unit.
template <int NT, int SEG>
__device__ __forceinline__ void mc_unit(
    int32_t* __restrict__ canvas, const int32_t* __restrict__ refs, int nref,
    int hp, int wp, bool vec, const McParams& p, const int16_t* f, int bi,
    int wpf, int w, int h, int xo, int yo, int* win, int* tmp, int lane) {
  const int wb = min(kSub, w - xo), hb = min(kSub, h - yo);
  const int cy = f[F_CY] + yo, cx = f[F_CX] + xo;
  if (cy >= p.ch || cx >= p.cw || cy + hb <= 0 || cx + wb <= 0) return;
  int p0[2][SEG], p1[2][SEG];
  predict<NT, SEG>(refs, nref, hp, wp, vec, f, 0, w, h, xo, yo, wb, hb, p.bd,
                   win, p.win_stride, tmp, lane, p0);
  if (bi)
    predict<NT, SEG>(refs, nref, hp, wp, vec, f, 5, w, h, xo, yo, wb, hb,
                     p.bd, win, p.win_stride, tmp, lane, p1);
  const int bd = p.bd, maxv = (1 << bd) - 1;
  const int w0 = f[F_W0], o0 = f[F_O0], w1 = f[F_W1], o1 = f[F_O1];
  const int lwd = f[F_LWD];
  const int xs = SEG * (lane & 3);
  if (xs >= wb) return;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int y = (lane >> 2) + 8 * it;
    if (y >= hb) continue;
    int v[SEG];
#pragma unroll
    for (int j = 0; j < SEG; ++j) {
      int t;
      if (bi) {
        if (wpf) {
          t = (p0[it][j] * w0 + p1[it][j] * w1 + shl(o0 + o1 + 1, lwd)) >>
              (lwd + 1);
        } else {
          const int shift = 15 - bd;
          t = (p0[it][j] + p1[it][j] + (1 << (shift - 1))) >> shift;
        }
      } else if (wpf) {
        t = lwd >= 1 ? ((p0[it][j] * w0 + (1 << (lwd - 1))) >> lwd) + o0
                     : p0[it][j] * w0 + o0;
      } else {
        const int shift = 14 - bd;
        t = (p0[it][j] + (1 << (shift - 1))) >> shift;
      }
      v[j] = clampi(t, 0, maxv);
    }
    const int yy = cy + y, xx = cx + xs;
    if (yy < 0 || yy >= p.ch) continue;
    int32_t* dst = canvas + (size_t)yy * p.cw + xx;
    if (SEG == 4 && p.vec_out && (xx & 3) == 0 && xx >= 0 && xx + 4 <= p.cw) {
      *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[SEG > 1 ? 1 : 0],
                                                v[SEG > 2 ? 2 : 0],
                                                v[SEG > 3 ? 3 : 0]);
    } else {
#pragma unroll
      for (int j = 0; j < SEG; ++j)
        if (xx + j >= 0 && xx + j < p.cw) dst[j] = v[j];
    }
  }
}

// Replaces hevc_tpu/tpu/mc_pallas.py:_mc_kernel.  One launch per picture
// over every PU row of every (luma/chroma, uni/bi, WP, w x h) group.
// Bound: bytes — the reference windows read and the predicted blocks
// written, int32, at a few int32 multiply-adds per byte.
// Design: a warp filters one work unit, a sub-block of at most 16x16 of
// one PU (a 64x64 PU is 16 units, spread over 4 warps of a CTA and their
// neighbours), so small PUs no longer leave a 256-thread CTA idle.  Each
// warp stages its window in its own slice of dynamic shared memory, sized
// by the launch's largest window (4,048 B a warp for luma), runs the
// horizontal pass into a shared temporary and the vertical pass in
// registers, and stores 4 pixels a lane as one 16 B vector where the row
// is aligned.  The window arrives by cp.async, so a lane's loads are all
// in flight at once and cost no registers.  Work is assigned without division per element: lanes map
// to (row, column segment) by shifts; only the group lookup (a binary
// search over the group table) and the unit's (PU, sub-block) split are
// computed once per warp.  PUs of one picture are pixel-disjoint, so each
// unit writes its pixels straight to the canvas.
__global__ void __launch_bounds__(kMcWarps * 32)
mc_kernel(int32_t* __restrict__ canvas, const int32_t* __restrict__ refs_l,
          const int32_t* __restrict__ refs_c, const int16_t* __restrict__ rows,
          const __grid_constant__ McParams p) {
  extern __shared__ int4 smem_v[];
  int* smem = reinterpret_cast<int*>(smem_v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = blockIdx.x * kMcWarps + warp;
  if (u >= p.unit_start[p.ngroups]) return;
  int lo = 0, hi = p.ngroups - 1;  // last group with unit_start <= u
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.unit_start[mid] <= u) lo = mid; else hi = mid - 1;
  }
  const int g = lo, code = p.code[g];
  const int is_ch = code & 1, bi = (code >> 1) & 1, wpf = (code >> 2) & 1;
  const int w = (code >> 3) & 127, h = (code >> 10) & 127;
  const int nsx = (w + kSub - 1) / kSub, nsb = nsx * ((h + kSub - 1) / kSub);
  const int local = u - p.unit_start[g];
  const int pu = local / nsb, sb = local - pu * nsb;
  const int sy = sb / nsx, sx = sb - sy * nsx;
  const int16_t* f = rows + (size_t)(p.row_start[g] + pu) * kMcCols;
  int* win = smem + warp * p.warp_smem;
  int* tmp = win + (kSub + 7) * p.win_stride;
  if (!is_ch)
    mc_unit<8, 4>(canvas, refs_l, p.nl, p.hl, p.wl, p.vec_l, p, f, bi, wpf,
                  w, h, kSub * sx, kSub * sy, win, tmp, lane);
  else if ((w & 3) == 0)
    mc_unit<4, 4>(canvas, refs_c, p.nc, p.hc, p.wc, p.vec_c, p, f, bi, wpf,
                  w, h, kSub * sx, kSub * sy, win, tmp, lane);
  else
    mc_unit<4, 2>(canvas, refs_c, p.nc, p.hc, p.wc, p.vec_c, p, f, bi, wpf,
                  w, h, kSub * sx, kSub * sy, win, tmp, lane);
}

// ---------------------------------------------------------------------------
// inter residual add
// ---------------------------------------------------------------------------

// Replaces hevc_tpu/tpu/mc_pallas.py:_resid_kernel.  One launch per
// picture over all four classes: canvas = clip(canvas + pool[slot]).
// Bound: bytes — the canvas tiles read and written and the residual
// blocks read, 12 B a pixel.
// Design: a thread moves one 4-pixel row segment, neighbouring threads
// neighbouring segments of a TU row (a 32-wide TU row is 8 threads, 128
// contiguous bytes), as one 16 B vector load of the canvas and of the
// residual and one 16 B store.  Segment -> (class, TU, row, column) is
// three compares and shifts.  One launch for all classes is exact because
// a TU inside the canvas reads only the pixels it writes and the TUs of a
// picture are pixel-disjoint: no TU reads what another writes.  The pack
// places every TU inside its plane's region, PAD and TAIL away from the
// canvas edge (pack.region_offsets); tests/test_torch_pipeline.py checks
// both facts on decoded streams.  A TU that straddles the canvas edge
// anyway reads, as JAX does, from its clamped origin, so it reads pixels
// it also writes at another place: one thread moves it whole, in the
// order that reads each pixel before the TU overwrites it (as memmove
// does); an unaligned row takes a scalar path.
__global__ void __launch_bounds__(256)
resid_add_kernel(int32_t* __restrict__ canvas,
                 const __grid_constant__ ResidParams p) {
  const int gsg = blockIdx.x * blockDim.x + threadIdx.x;
  if (gsg >= p.seg_start[4]) return;
  const int c = (gsg >= p.seg_start[1]) + (gsg >= p.seg_start[2]) +
                (gsg >= p.seg_start[3]);
  const int s = 4 << c;
  const int local = gsg - p.seg_start[c];
  const int t = local >> (2 * c + 2);                 // s*s/4 segments a TU
  const int seg = local & ((1 << (2 * c + 2)) - 1);
  const int32_t* r = p.rows[c] + (size_t)t * 3;
  const int cy = r[0], cx = r[1];
  const int ch = p.ch, cw = p.cw;
  if (cy >= ch || cx >= cw || cy + s <= 0 || cx + s <= 0) return;  // padding
  const int slot = clampi(r[2], 0, p.npool[c] - 1);
  const int ry = clampi(cy, 0, ch - s), rx = clampi(cx, 0, cw - s);
  const int32_t* blk = p.pool[c] + (size_t)slot * s * s;
  const int maxv = (1 << p.bd) - 1;
  if (ry != cy || rx != cx) {  // straddles the edge: segment 0 moves it
    if (seg) return;
    const int dy = cy - ry, dx = cx - rx;
    for (int k = 0; k < s; ++k) {
      const int y = dy > 0 ? s - 1 - k : k;
      if (cy + y < 0 || cy + y >= ch) continue;
      for (int m = 0; m < s; ++m) {
        const int x = dy == 0 && dx > 0 ? s - 1 - m : m;
        if (cx + x < 0 || cx + x >= cw) continue;
        canvas[(size_t)(cy + y) * cw + cx + x] = clampi(
            canvas[(size_t)(ry + y) * cw + rx + x] + blk[y * s + x], 0, maxv);
      }
    }
    return;
  }
  const int y = seg >> c, x = (seg & ((1 << c) - 1)) << 2;
  const int32_t* res = blk + y * s + x;
  int32_t* dst = canvas + (size_t)(cy + y) * cw + cx + x;
  if (p.vec_out && p.vec_pool[c] && (cx & 3) == 0) {
    const int4 a = *reinterpret_cast<const int4*>(dst);
    const int4 b = __ldcs(reinterpret_cast<const int4*>(res));
    *reinterpret_cast<int4*>(dst) =
        make_int4(clampi(a.x + b.x, 0, maxv), clampi(a.y + b.y, 0, maxv),
                  clampi(a.z + b.z, 0, maxv), clampi(a.w + b.w, 0, maxv));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[j] = clampi(dst[j] + res[j], 0, maxv);
  }
}

}  // namespace

extern "C" {

int hevc_mc_launch(int32_t* canvas, const int32_t* refs_l,
                   const int32_t* refs_c, const int16_t* rows,
                   const McParams* p, void* stream) {
  const int units = p->unit_start[p->ngroups];
  // at most 4 x 4,048 B of shared memory: under the 48 KB that needs no
  // opt-in
  if (units > 0)
    mc_kernel<<<(units + kMcWarps - 1) / kMcWarps, kMcWarps * 32,
                (size_t)kMcWarps * p->warp_smem * sizeof(int),
                (cudaStream_t)stream>>>(canvas, refs_l, refs_c, rows, *p);
  return (int)cudaGetLastError();
}

int hevc_resid_add_launch(int32_t* canvas, const ResidParams* p,
                          void* stream) {
  const int segs = p->seg_start[4];
  if (segs > 0)
    resid_add_kernel<<<(segs + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        canvas, *p);
  return (int)cudaGetLastError();
}

const char* hevc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
