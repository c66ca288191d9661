// In-loop filters for Hopper (sm_90a): deblocking (8.7.2) and SAO (8.7.3)
// of one picture's planes in three launches.
//
// Replaces the frame program's eager filter stage: hevc_tpu_torch/filters.py
// deblock / deblock_luma / sao_plane, ports of hevc_tpu/tpu/filters.py
// deblock_jax and sao_plane_jax, which the reference computes in XLA (no
// Pallas kernel).  Those plain versions define the expected result bit for
// bit; a 1080p picture took ~1,400 eager PyTorch ops there, each a
// full-frame pass of a few microseconds that the host has to enqueue.
//
// Plain C interface, loaded with ctypes (hevc_tpu_torch/build.py,
// hevc_tpu_torch/filters_cuda.py).  hevc_deblock_launch enqueues two
// launches, hevc_sao_launch one, on the stream they are given; they
// allocate nothing and return cudaGetLastError().
//
// 1. deblock_kernel<false>: the vertical edges of every plane.  Edges lie
//    on the 8-sample grid and each changes at most 3 samples on either
//    side, so no two edges of a pass touch the same sample: one thread a
//    4-line segment of one edge, in place.  A luma segment decides once,
//    from its lines 0 and 3 (8.7.2.5.3); a chroma segment filters each
//    line where the boundary strength is 2 (8.7.2.5.5).
// 2. deblock_kernel<true>: the horizontal edges, reading launch 1's output
//    (the plain version's transpose becomes strided access).
// 3. sao_kernel: band offsets and the four edge classes, chosen per CTB,
//    with the slice/tile edge restrictions and picture-edge validity; a
//    thread a sample, writing a new plane, so that every sample reads its
//    neighbours as deblocking left them.
// blockIdx.y picks the plane.  Samples that PCM/TQB exempt from the loop
// filters (the per-4x4 nf map) are never written.  The maps are read where
// they lie: per-4x4 QP, boundary strength, offsets and nf, per-CTB SAO
// parameters and edge flags; nothing is upsampled to samples.
//
// What bounds it: each pass reads and writes the int32 planes once (a
// 1080p 4:2:0 picture: 12.4 MB each way, ~75 MB over the three passes, ~22
// us at 3.35 TB/s); the maps are a few percent of that.  The point of the
// design is the host: three launches a picture in place of ~1,400.
//
// The per-item functions below are plain C++ as well: compiled by a host
// compiler (no __CUDACC__), the file exports hevc_deblock_host and
// hevc_sao_host, which run the same items in loops on host memory, so the
// CPU tests hold this arithmetic against the plain versions.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FDEV __device__ __forceinline__
#define FHD __host__ __device__ __forceinline__
#define FTABLE __constant__
#else
#define FDEV static inline
#define FHD static inline
#define FTABLE static const
#endif

// One plane of a call.  src: the plane (deblocking filters it in place,
// SAO reads it), rows `stride` samples apart; dst: SAO's output plane.
// sy / sx: log2 of the plane's row and column subsampling against luma
// (the per-4x4 maps are on the luma grid); lh / lw: log2 of a CTB's height
// and width in the plane's samples.  qp_off: a chroma plane's QP offset
// (one int32 on the device), null for luma.  sao_*: the plane's per-CTB
// SAO type (0 off, 1 band, 2 edge), band position, edge class [cth, ctw]
// and offsets [cth, ctw, 4].  External linkage: the launchers take it
// (hevc_tpu_torch/filters_cuda.py mirrors it field for field).
struct FilterPlane {
  int32_t* src;
  int32_t* dst;
  int stride, dst_stride;
  int h, w;
  int sy, sx;
  int lh, lw;
  const int32_t* qp_off;
  const int32_t* sao_type;
  const int32_t* sao_band;
  const int32_t* sao_eo;
  const int32_t* sao_offs;
};

// One call: the planes (1 for 4:0:0, else 3), the bit depth, the per-4x4
// maps [h4, w4] (QP, boundary strengths of the vertical and horizontal
// edges, beta and tc offsets of the slice holding each edge's q sample, or
// one int32 each where beta_map / tc_map is 0, and the nf map or null),
// chroma_tab (1: 4:2:0's Table 8-10, 0: Min(qPi, 51)), the CTB columns and
// the per-CTB SAO edge flags (ops/boundaries.py SAO_* bits) or null.
struct FilterParams {
  FilterPlane pl[3];
  int nplanes, bd;
  int h4, w4, ctw;
  int chroma_tab, beta_map, tc_map;
  const int32_t* qp4;
  const int32_t* bs_v;
  const int32_t* bs_h;
  const int32_t* beta_off;
  const int32_t* tc_off;
  const int32_t* nf4;
  const int32_t* sao_flags;
};

namespace {

constexpr int kThreads = 256;

// H.265 Table 8-12 (beta', tC') and Table 8-10 (QpC of qPi for 4:2:0).
// tests/test_torch_loop_filter.py holds them against hevc_tpu_torch/tables.py.
FTABLE int c_beta[52] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  6,  7,
    8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32,
    34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
FTABLE int c_tc[54] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,  4,
    4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};
FTABLE int c_qpc[58] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14,
    15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
    29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37, 38,
    39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51};
// SAO edge classes: the (dy, dx) of neighbours a and b (8.7.3, Table 8-13)
FTABLE int c_eo[4][4] = {{0, -1, 0, 1}, {-1, 0, 1, 0}, {-1, -1, 1, 1},
                         {1, -1, -1, 1}};

FHD int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

FHD int iabs(int v) { return v < 0 ? -v : v; }

FHD int sgn(int v) { return (v > 0) - (v < 0); }

// The segments and edges of one plane's pass: a segment is 4 lines (rows
// for the vertical edges, columns for the horizontal ones); an edge is
// filtered where its whole window (4 samples a side for luma, 2 for
// chroma) lies in the plane, the picture's own border excluded.
FHD int pass_items(const FilterPlane& q, bool luma, bool horizontal,
                   int* n_edges) {
  const int len = horizontal ? q.h : q.w;
  const int across = horizontal ? q.w : q.h;
  const int n_e = luma ? (len - 4) >> 3 : (len - 2) >> 3;
  *n_edges = n_e > 0 ? n_e : 0;
  return (across >> 2) * *n_edges;
}

FHD int sao_items(const FilterPlane& q) { return q.h * q.w; }

// whether plane sample (row, col) is exempt from the loop filters
FDEV bool exempt(const FilterParams& p, const FilterPlane& q, int row,
                 int col) {
  return p.nf4 && p.nf4[((row << q.sy) >> 2) * p.w4 + ((col << q.sx) >> 2)];
}

// 8.7.2.5.3 / 8.7.2.5.7 on one luma segment.  e: q0 of line 0; line i
// starts ls samples on, sample k of a line ss samples on (p_k at
// -(k + 1) * ss, q_k at k * ss).  nfp / nfq: per line, whether its p / q
// samples are exempt.
FDEV void luma_segment(int32_t* e, int ls, int ss, int beta, int tc,
                       int maxv, const bool* nfp, const bool* nfq) {
  int P[4][4], Q[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      P[i][k] = e[i * ls - (k + 1) * ss];
      Q[i][k] = e[i * ls + k * ss];
    }
  const int dp0 = iabs(P[0][2] - 2 * P[0][1] + P[0][0]);
  const int dp3 = iabs(P[3][2] - 2 * P[3][1] + P[3][0]);
  const int dq0 = iabs(Q[0][2] - 2 * Q[0][1] + Q[0][0]);
  const int dq3 = iabs(Q[3][2] - 2 * Q[3][1] + Q[3][0]);
  const int dpq0 = dp0 + dq0, dpq3 = dp3 + dq3;
  if (dpq0 + dpq3 >= beta) return;
  const int tc5 = (5 * tc + 1) >> 1;
  const bool strong =
      2 * dpq0 < (beta >> 2) &&
      iabs(P[0][3] - P[0][0]) + iabs(Q[0][0] - Q[0][3]) < (beta >> 3) &&
      iabs(P[0][0] - Q[0][0]) < tc5 && 2 * dpq3 < (beta >> 2) &&
      iabs(P[3][3] - P[3][0]) + iabs(Q[3][0] - Q[3][3]) < (beta >> 3) &&
      iabs(P[3][0] - Q[3][0]) < tc5;
  const int side = (beta + (beta >> 1)) >> 3;
  const bool dep = dp0 + dp3 < side, deq = dq0 + dq3 < side;
  const int t2 = 2 * tc, tc2 = tc >> 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p0 = P[i][0], p1 = P[i][1], p2 = P[i][2], p3 = P[i][3];
    const int q0 = Q[i][0], q1 = Q[i][1], q2 = Q[i][2], q3 = Q[i][3];
    int32_t* l = e + i * ls;
    if (strong) {
      if (!nfp[i]) {
        l[-ss] = clampi((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                        p0 - t2, p0 + t2);
        l[-2 * ss] = clampi((p2 + p1 + p0 + q0 + 2) >> 2, p1 - t2, p1 + t2);
        l[-3 * ss] = clampi((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                            p2 - t2, p2 + t2);
      }
      if (!nfq[i]) {
        l[0] = clampi((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                      q0 - t2, q0 + t2);
        l[ss] = clampi((p0 + q0 + q1 + q2 + 2) >> 2, q1 - t2, q1 + t2);
        l[2 * ss] = clampi((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3,
                           q2 - t2, q2 + t2);
      }
      continue;
    }
    int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
    if (iabs(delta) >= 10 * tc) continue;
    delta = clampi(delta, -tc, tc);
    if (!nfp[i]) {
      l[-ss] = clampi(p0 + delta, 0, maxv);
      if (dep)
        l[-2 * ss] = clampi(
            p1 + clampi((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1, -tc2, tc2),
            0, maxv);
    }
    if (!nfq[i]) {
      l[0] = clampi(q0 - delta, 0, maxv);
      if (deq)
        l[ss] = clampi(
            q1 + clampi((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1, -tc2, tc2),
            0, maxv);
    }
  }
}

// 8.7.2.5.5 on one chroma segment (p1 p0 q0 q1 a line), as luma_segment
FDEV void chroma_segment(int32_t* e, int ls, int ss, int tc, int maxv,
                         const bool* nfp, const bool* nfq) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int32_t* l = e + i * ls;
    const int p1 = l[-2 * ss], p0 = l[-ss], q0 = l[0], q1 = l[ss];
    const int delta =
        clampi((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc, tc);
    if (!nfp[i]) l[-ss] = clampi(p0 + delta, 0, maxv);
    if (!nfq[i]) l[0] = clampi(q0 - delta, 0, maxv);
  }
}

// One segment of one edge of plane `plane`'s pass.  The maps are read at
// the edge's q 4x4 (the P side's QP one 4x4 back): for the vertical edge
// j of segment m at map row m << sy and column (2j + 2) << sx; for the
// horizontal pass the same with rows and columns exchanged.
template <bool kHorizontal>
FDEV void deblock_item(const FilterParams& p, int plane, int item) {
  const FilterPlane& q = p.pl[plane];
  const bool luma = plane == 0;
  int n_e;
  if (item >= pass_items(q, luma, kHorizontal, &n_e)) return;
  const int w4 = p.w4;
  int m, j, mr, mc, mr_p, mc_p;
  if (kHorizontal) {
    const int segs = q.w >> 2;
    j = item / segs;
    m = item - j * segs;
    mr = (2 * j + 2) << q.sy;
    mc = m << q.sx;
    mr_p = mr - 1;
    mc_p = mc;
  } else {
    m = item / n_e;
    j = item - m * n_e;
    mr = m << q.sy;
    mc = (2 * j + 2) << q.sx;
    mr_p = mr;
    mc_p = mc - 1;
  }
  const int at = mr * w4 + mc;
  const int bs = (kHorizontal ? p.bs_h : p.bs_v)[at];
  if (luma ? bs <= 0 : bs != 2) return;
  const int qp_p = p.qp4[mr_p * w4 + mc_p], qp_q = p.qp4[at];
  const int tc_off = p.tc_off[p.tc_map ? at : 0];
  const int shift = p.bd - 8, maxv = (1 << p.bd) - 1;
  // the edge's q0 in the plane: line 0 of segment m
  const int e = 8 * (j + 1);
  const int row0 = kHorizontal ? e : 4 * m, col0 = kHorizontal ? 4 * m : e;
  int32_t* q0 = q.src + (size_t)row0 * q.stride + col0;
  const int ls = kHorizontal ? 1 : q.stride, ss = kHorizontal ? q.stride : 1;
  bool nfp[4], nfq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = kHorizontal ? row0 : row0 + i;
    const int c = kHorizontal ? col0 + i : col0;
    nfp[i] = exempt(p, q, kHorizontal ? r - 1 : r, kHorizontal ? c : c - 1);
    nfq[i] = exempt(p, q, r, c);
  }
  if (luma) {
    const int qp = (qp_p + qp_q + 1) >> 1;
    const int beta_off = p.beta_off[p.beta_map ? at : 0];
    const int beta = c_beta[clampi(qp + beta_off, 0, 51)] << shift;
    const int tc = c_tc[clampi(qp + 2 * (bs - 1) + tc_off, 0, 53)] << shift;
    luma_segment(q0, ls, ss, beta, tc, maxv, nfp, nfq);
  } else {
    const int qpi = clampi(((qp_p + qp_q + 1) >> 1) + *q.qp_off, 0, 57);
    const int qpc = p.chroma_tab ? c_qpc[qpi] : (qpi < 51 ? qpi : 51);
    const int tc = c_tc[clampi(qpc + 2 + tc_off, 0, 53)] << shift;
    chroma_segment(q0, ls, ss, tc, maxv, nfp, nfq);
  }
}

// Whether an edge-class-k sample at (y, x) stays unfiltered at a
// restricted slice/tile border (the CTB's flags fl): whole border rows and
// columns, except the corners whose diagonal neighbour stays legal
// (hevc_tpu_torch/filters.py _restricted).
FDEV bool restricted(int k, int fl, int y, int x, int h, int w, int lh,
                     int lw) {
  const int cw = 1 << lw, chh = 1 << lh;
  const int xm = x & (cw - 1), ym = y & (chh - 1);
  const bool cl = xm == 0, ct = ym == 0;
  const bool cr = xm == cw - 1 || x == w - 1;
  const bool cb = ym == chh - 1 || y == h - 1;
  const bool atl = x < cw, att = y < chh;
  const bool atr = (x >> lw) == ((w - 1) >> lw);
  const bool atb = (y >> lh) == ((h - 1) >> lh);
  const bool ve0 = fl & 1, ve1 = fl & 2, he0 = fl & 4, he1 = fl & 8;
  const bool d0 = fl & 16, d1 = fl & 32, d2 = fl & 64, d3 = fl & 128;
  const bool sul = k == 2 && !d0 && !atl && !att;
  const bool sur = k == 3 && !d1 && !att && !atr;
  const bool slr = k == 2 && !d2 && !atr && !atb;
  const bool sll = k == 3 && !d3 && !atl && !atb;
  bool r = false;
  if (k != 1) {
    r |= ve0 && cl && !(ct && sul) && !(cb && sll);
    r |= ve1 && cr && !(ct && sur) && !(cb && slr);
  }
  if (k != 0) {
    r |= he0 && ct && !(cl && sul) && !(cr && sur);
    r |= he1 && cb && !(cl && sll) && !(cr && slr);
  }
  if (k == 2) r |= (d0 && ct && cl) || (d2 && cb && cr);
  if (k == 3) r |= (d1 && ct && cr) || (d3 && cb && cl);
  return r;
}

// SAO of one sample of plane `plane` (8.7.3.2), into its output plane
FDEV void sao_item(const FilterParams& p, int plane, int item) {
  const FilterPlane& q = p.pl[plane];
  if (item >= sao_items(q)) return;
  const int y = item / q.w, x = item - y * q.w;
  const int32_t* src = q.src + (size_t)y * q.stride + x;
  const int v = *src;
  int32_t* out = q.dst + (size_t)y * q.dst_stride + x;
  const int c = (y >> q.lh) * p.ctw + (x >> q.lw);
  const int type = q.sao_type[c];
  if (exempt(p, q, y, x) || (type != 1 && type != 2)) {
    *out = v;
    return;
  }
  const int maxv = (1 << p.bd) - 1;
  const int32_t* offs = q.sao_offs + 4 * c;
  int off = 0;
  if (type == 1) {
    const int k = ((v >> (p.bd - 5)) - q.sao_band[c]) & 31;
    if (k < 4) off = offs[k];
  } else {
    const int k = q.sao_eo[c];
    if (k < 0 || k > 3) {
      *out = v;
      return;
    }
    const int ay = y + c_eo[k][0], ax = x + c_eo[k][1];
    const int by = y + c_eo[k][2], bx = x + c_eo[k][3];
    if (ay < 0 || ay >= q.h || ax < 0 || ax >= q.w || by < 0 ||
        by >= q.h || bx < 0 || bx >= q.w ||
        (p.sao_flags &&
         restricted(k, p.sao_flags[c], y, x, q.h, q.w, q.lh, q.lw))) {
      *out = v;
      return;
    }
    const int a = src[(ay - y) * q.stride + (ax - x)];
    const int b = src[(by - y) * q.stride + (bx - x)];
    const int idx = 2 + sgn(v - a) + sgn(v - b);
    const int cat = idx == 2 ? 0 : (idx < 2 ? idx + 1 : idx);
    if (cat) off = offs[cat - 1];
  }
  *out = clampi(v + off, 0, maxv);
}

FHD int max_items(const FilterParams& p, int pass) {
  int most = 0;
  for (int k = 0; k < p.nplanes; ++k) {
    int n_e;
    const int n = pass == 2 ? sao_items(p.pl[k])
                            : pass_items(p.pl[k], k == 0, pass == 1, &n_e);
    most = n > most ? n : most;
  }
  return most;
}

#ifdef __CUDACC__

template <bool kHorizontal>
__global__ void __launch_bounds__(kThreads)
deblock_kernel(const __grid_constant__ FilterParams p) {
  if ((int)blockIdx.y >= p.nplanes) return;
  deblock_item<kHorizontal>(p, blockIdx.y, blockIdx.x * kThreads +
                                               threadIdx.x);
}

__global__ void __launch_bounds__(kThreads)
sao_kernel(const __grid_constant__ FilterParams p) {
  if ((int)blockIdx.y >= p.nplanes) return;
  sao_item(p, blockIdx.y, blockIdx.x * kThreads + threadIdx.x);
}

dim3 launch_grid(const FilterParams& p, int pass) {
  const int blocks = (max_items(p, pass) + kThreads - 1) / kThreads;
  return dim3(blocks > 0 ? blocks : 1, p.nplanes);
}

#endif

}  // namespace

extern "C" {

#ifdef __CUDACC__

// Deblock the planes in place: the vertical edges, then the horizontal
// edges, two launches on the stream.
int hevc_deblock_launch(const FilterParams* p, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  deblock_kernel<false><<<launch_grid(*p, 0), kThreads, 0, s>>>(*p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  deblock_kernel<true><<<launch_grid(*p, 1), kThreads, 0, s>>>(*p);
  return (int)cudaGetLastError();
}

// SAO of the planes into their dst planes, one launch on the stream.
int hevc_sao_launch(const FilterParams* p, void* stream) {
  sao_kernel<<<launch_grid(*p, 2), kThreads, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

#else

// The same items on host memory, in loops: what the kernels compute, for
// the CPU tests (a host compiler builds this file without __CUDACC__).
int hevc_deblock_host(const FilterParams* p) {
  for (int pass = 0; pass < 2; ++pass)
    for (int k = 0; k < p->nplanes; ++k)
      for (int i = 0, n = max_items(*p, pass); i < n; ++i) {
        if (pass)
          deblock_item<true>(*p, k, i);
        else
          deblock_item<false>(*p, k, i);
      }
  return 0;
}

int hevc_sao_host(const FilterParams* p) {
  for (int k = 0; k < p->nplanes; ++k)
    for (int i = 0, n = max_items(*p, 2); i < n; ++i) sao_item(*p, k, i);
  return 0;
}

#endif

}  // extern "C"
