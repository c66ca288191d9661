// The residual stage for Hopper (sm_90a): dequantisation (8.6.2-8.6.3),
// the inverse transforms (8.6.4), transform skip, transquant bypass and the
// range-extension tools (4x4 rotation, RDPCM, cross-component prediction)
// of every TU of a picture, all four size classes, in one launch.
//
// Replaces the frame program's eager residual stage: hevc_tpu_torch/recon.py
// residuals over transforms.py residual_batch, the port of
// hevc_tpu/tpu/recon.py _residuals, which the reference computes in XLA (no
// Pallas kernel).  Those plain versions define the expected result bit for
// bit; a 1080p picture took ~300 eager launches there (a dequantisation,
// two float64 matmuls with their casts, the skips and the range-extension
// branch for each class), each a few microseconds of host time.
//
// Plain C interface, loaded with ctypes (hevc_tpu_torch/build.py,
// hevc_tpu_torch/resid_cuda.py).  hevc_resid_tx_launch enqueues one launch
// on the stream it is given; it allocates nothing and returns
// cudaGetLastError().
//
// Layout.  A class of n x n TUs (n = 4, 8, 16, 32) has its records' int16
// levels [N, n, n] and their rows [N, 9] = (qp, dst, ts, raw, mtx + 1,
// rot, rdpcm, ccp_alpha, ccp_slot), read where the pack's upload left them,
// a scaling bank [7, n, n] (0 flat, 1..6 the matrices) and an output pool
// [1 + N, n, n] whose slot 0 is zeros and slot s the record s - 1's
// residual.  A unit is 32 / n consecutive slots of one class; the units of
// the four classes are numbered one after the other, and a warp takes one.
//
// A warp's lanes are (TU t, line x) = (lane / n, lane % n).  With a TU's
// scratch in shared memory (rows n + 1 apart, so that neither a row nor a
// column access conflicts):
// 1. lane (t, x) reads column x of its TU's levels and scales it; a
//    transformed TU runs the first (vertical) pass down the column into the
//    scratch, with (e + 64) >> 7 and the 16-bit clip; a skipped or bypassed
//    TU writes its residual column as it is;
// 2. lane (t, x) runs the second pass along row x of the scratch, into
//    registers, then writes the row back;
// 3. lane (t, x) reads line x of the residual, rotated where the record
//    says so, along the RDPCM direction (a column for vertical RDPCM, else a
//    row) and accumulates it with the int16 wrap where RDPCM is on;
// 4. where a lane of the warp has a nonzero ccp_alpha, the warp computes
//    the source slots' residuals (steps 1-3 again, source slot for source
//    slot: another record's, never this unit's output, so no block waits
//    for another) and adds (alpha * source) >> 3 with the wrap;
// 5. the lines go back to the scratch and the unit's slots are stored in
//    one coalesced pass, slot 0 and all.
// Main-profile records have zero range-extension columns, so steps 3 and 4
// reduce to a copy; no flag is needed.  The accumulators are int32 and
// exact: |sum| <= 32 * 90 * 32768 < 2^31.
//
// What bounds it: a 1080p picture's levels read (~2.5 M int16) and pools
// written (int32), ~15 MB, ~5 us at 3.35 TB/s; at most 64 multiply-adds a
// coefficient, ~6 us at 33.5 TOP/s.  The point of the design is the host:
// one launch a picture in place of ~300.
//
// The per-lane steps below are plain C++ as well: compiled by a host
// compiler (no __CUDACC__), the file exports hevc_residuals_host, which
// runs the same steps lane by lane in loops on host memory, so the CPU
// tests hold this arithmetic against the plain version and the JAX
// package's.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FHD __host__ __device__ __forceinline__
#define FTABLE __constant__
#else
#define FHD static inline
#define FTABLE static const
#endif

// One size class of a call.  lv: the int16 levels [n, s, s]; rm: the rows
// [n, 9]; bank: the scaling matrices [7, s, s]; out: the pool [1 + n, s,
// s]; n: the records; unit0: the class's first unit.  External linkage: the
// launcher takes it (hevc_tpu_torch/resid_cuda.py mirrors it field for
// field).
struct ResidClass {
  const int16_t* lv;
  const int32_t* rm;
  const int32_t* bank;
  int32_t* out;
  int n, unit0;
};

// One call: the classes of 4x4 to 32x32 TUs, the bit depth and the units
// of all classes.
struct ResidParams {
  ResidClass cls[4];
  int bd, units;
};

namespace {

constexpr int kWarps = 4;
constexpr int kScratch = 32 * 33;  // one warp's TUs, rows n + 1 apart

// H.265 8.6.4.2: the 32-point DCT (the n-point one is rows 0, 32 / n, ... of
// its first n columns) and the 4-point DST-VII; 8.6.3's levelScale.
// tests/test_torch_resid_kernel.py holds them against hevc_tpu_torch/tables.py.
FTABLE int c_dct[32][32] = {
    {64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64,
     64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64},
    {90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4,
     -4, -13, -22, -31, -38, -46, -54, -61, -67, -73, -78, -82, -85, -88, -90, -90},
    {90, 87, 80, 70, 57, 43, 25, 9, -9, -25, -43, -57, -70, -80, -87, -90,
     -90, -87, -80, -70, -57, -43, -25, -9, 9, 25, 43, 57, 70, 80, 87, 90},
    {90, 82, 67, 46, 22, -4, -31, -54, -73, -85, -90, -88, -78, -61, -38, -13,
     13, 38, 61, 78, 88, 90, 85, 73, 54, 31, 4, -22, -46, -67, -82, -90},
    {89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89,
     89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89},
    {88, 67, 31, -13, -54, -82, -90, -78, -46, -4, 38, 73, 90, 85, 61, 22,
     -22, -61, -85, -90, -73, -38, 4, 46, 78, 90, 82, 54, 13, -31, -67, -88},
    {87, 57, 9, -43, -80, -90, -70, -25, 25, 70, 90, 80, 43, -9, -57, -87,
     -87, -57, -9, 43, 80, 90, 70, 25, -25, -70, -90, -80, -43, 9, 57, 87},
    {85, 46, -13, -67, -90, -73, -22, 38, 82, 88, 54, -4, -61, -90, -78, -31,
     31, 78, 90, 61, 4, -54, -88, -82, -38, 22, 73, 90, 67, 13, -46, -85},
    {83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83,
     83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83},
    {82, 22, -54, -90, -61, 13, 78, 85, 31, -46, -90, -67, 4, 73, 88, 38,
     -38, -88, -73, -4, 67, 90, 46, -31, -85, -78, -13, 61, 90, 54, -22, -82},
    {80, 9, -70, -87, -25, 57, 90, 43, -43, -90, -57, 25, 87, 70, -9, -80,
     -80, -9, 70, 87, 25, -57, -90, -43, 43, 90, 57, -25, -87, -70, 9, 80},
    {78, -4, -82, -73, 13, 85, 67, -22, -88, -61, 31, 90, 54, -38, -90, -46,
     46, 90, 38, -54, -90, -31, 61, 88, 22, -67, -85, -13, 73, 82, 4, -78},
    {75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75,
     75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75},
    {73, -31, -90, -22, 78, 67, -38, -90, -13, 82, 61, -46, -88, -4, 85, 54,
     -54, -85, 4, 88, 46, -61, -82, 13, 90, 38, -67, -78, 22, 90, 31, -73},
    {70, -43, -87, 9, 90, 25, -80, -57, 57, 80, -25, -90, -9, 87, 43, -70,
     -70, 43, 87, -9, -90, -25, 80, 57, -57, -80, 25, 90, 9, -87, -43, 70},
    {67, -54, -78, 38, 85, -22, -90, 4, 90, 13, -88, -31, 82, 46, -73, -61,
     61, 73, -46, -82, 31, 88, -13, -90, -4, 90, 22, -85, -38, 78, 54, -67},
    {64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64,
     64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64},
    {61, -73, -46, 82, 31, -88, -13, 90, -4, -90, 22, 85, -38, -78, 54, 67,
     -67, -54, 78, 38, -85, -22, 90, 4, -90, 13, 88, -31, -82, 46, 73, -61},
    {57, -80, -25, 90, -9, -87, 43, 70, -70, -43, 87, 9, -90, 25, 80, -57,
     -57, 80, 25, -90, 9, 87, -43, -70, 70, 43, -87, -9, 90, -25, -80, 57},
    {54, -85, -4, 88, -46, -61, 82, 13, -90, 38, 67, -78, -22, 90, -31, -73,
     73, 31, -90, 22, 78, -67, -38, 90, -13, -82, 61, 46, -88, 4, 85, -54},
    {50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50,
     50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50},
    {46, -90, 38, 54, -90, 31, 61, -88, 22, 67, -85, 13, 73, -82, 4, 78,
     -78, -4, 82, -73, -13, 85, -67, -22, 88, -61, -31, 90, -54, -38, 90, -46},
    {43, -90, 57, 25, -87, 70, 9, -80, 80, -9, -70, 87, -25, -57, 90, -43,
     -43, 90, -57, -25, 87, -70, -9, 80, -80, 9, 70, -87, 25, 57, -90, 43},
    {38, -88, 73, -4, -67, 90, -46, -31, 85, -78, 13, 61, -90, 54, 22, -82,
     82, -22, -54, 90, -61, -13, 78, -85, 31, 46, -90, 67, 4, -73, 88, -38},
    {36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36,
     36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36},
    {31, -78, 90, -61, 4, 54, -88, 82, -38, -22, 73, -90, 67, -13, -46, 85,
     -85, 46, 13, -67, 90, -73, 22, 38, -82, 88, -54, -4, 61, -90, 78, -31},
    {25, -70, 90, -80, 43, 9, -57, 87, -87, 57, -9, -43, 80, -90, 70, -25,
     -25, 70, -90, 80, -43, -9, 57, -87, 87, -57, 9, 43, -80, 90, -70, 25},
    {22, -61, 85, -90, 73, -38, -4, 46, -78, 90, -82, 54, -13, -31, 67, -88,
     88, -67, 31, 13, -54, 82, -90, 78, -46, 4, 38, -73, 90, -85, 61, -22},
    {18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18,
     18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18},
    {13, -38, 61, -78, 88, -90, 85, -73, 54, -31, 4, 22, -46, 67, -82, 90,
     -90, 82, -67, 46, -22, -4, 31, -54, 73, -85, 90, -88, 78, -61, 38, -13},
    {9, -25, 43, -57, 70, -80, 87, -90, 90, -87, 80, -70, 57, -43, 25, -9,
     -9, 25, -43, 57, -70, 80, -87, 90, -90, 87, -80, 70, -57, 43, -25, 9},
    {4, -13, 22, -31, 38, -46, 54, -61, 67, -73, 78, -82, 85, -88, 90, -90,
     90, -90, 88, -85, 82, -78, 73, -67, 61, -54, 46, -38, 31, -22, 13, -4},
};
FTABLE int c_dst4[4][4] = {
    {29, 55, 74, 84}, {74, 74, 0, -74}, {84, -29, -74, 55}, {55, -84, 74, -29}};
FTABLE int c_level_scale[6] = {40, 45, 51, 57, 64, 72};

FHD int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

FHD int clip16(int v) { return clampi(v, -32768, 32767); }

// int16 wraparound: the reference's coefficient buffers are int16
FHD int wrap16(int v) { return (int)(int16_t)(uint16_t)(uint32_t)v; }

// v << s with int32 wraparound, 0 from a shift of 32 on (torch's and
// XLA's left shift)
FHD int shl(int v, int s) {
  return s >= 32 ? 0 : (int)((uint32_t)v << s);
}

// the multiply of int32 tensors, with their wraparound
FHD int mul(int a, int b) { return (int)((uint32_t)a * (uint32_t)b); }

template <int S>
constexpr int log2_of() {
  return S == 4 ? 2 : (S == 8 ? 3 : (S == 16 ? 4 : 5));
}

// T[k][i] of the transform a TU of size S uses (DST-VII: 4x4 with dst set)
template <int S>
FHD int coef(bool dst, int k, int i) {
  return (S == 4 && dst) ? c_dst4[k][i] : c_dct[k * (32 / S)][i];
}

// One lane's record and its line of the TU's residual.  slot: the pool
// slot (0 and past the pool: zeros); the row's columns as the plain
// version reads them (mtx clamped into the bank).
template <int S>
struct Lane {
  int slot, live;
  int qp, dst, ts, raw, mtx, rot, rd, alpha, src;
  int v[S];
};

template <int S>
FHD void lane_record(const ResidClass& k, int slot, Lane<S>& L) {
  L.slot = slot;
  L.live = slot >= 1 && slot <= k.n;
  const int32_t* m = k.rm + (size_t)(L.live ? slot - 1 : 0) * 9;
  L.qp = L.live ? m[0] : 0;
  L.dst = L.live && m[1] != 0;
  L.ts = L.live && m[2] != 0;
  L.raw = L.live && m[3] != 0;
  L.mtx = L.live ? clampi(m[4], 0, 6) : 0;
  L.rot = L.live && m[5] != 0;
  L.rd = L.live ? m[6] : 0;
  L.alpha = L.live ? m[7] : 0;
  L.src = L.live ? m[8] : 0;
}

template <int S>
FHD bool transformed(const Lane<S>& L) {
  return L.live && !L.raw && !L.ts;
}

// step 1 for lane (t, x): column x of the TU's levels, scaled (8.6.3, the
// refactored product of transforms.dequant_batch), then the first pass, the
// transform skip or the bypass, into the TU's scratch ``tu``
template <int S>
FHD void columns(const ResidClass& k, int bd, const Lane<S>& L, int x,
                 int32_t* tu) {
  if (!L.live) {
#pragma unroll
    for (int i = 0; i < S; ++i) tu[i * (S + 1) + x] = 0;
    return;
  }
  const int16_t* lv = k.lv + (size_t)(L.slot - 1) * S * S + x;
  int d[S];
#pragma unroll
  for (int i = 0; i < S; ++i) d[i] = lv[i * S];
  if (L.raw) {
#pragma unroll
    for (int i = 0; i < S; ++i) tu[i * (S + 1) + x] = d[i];
    return;
  }
  constexpr int lg = log2_of<S>();
  const int q6 = L.qp >= 0 ? L.qp / 6 : -((5 - L.qp) / 6);  // floor
  const int ls = c_level_scale[L.qp - 6 * q6];
  const int sh2 = bd + lg - 5 - q6;
  const int32_t* m = k.bank + (size_t)L.mtx * S * S + x;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int num = mul(d[i], mul(ls, m[i * S]));
    d[i] = clip16(sh2 > 0 ? (num + (1 << (sh2 - 1))) >> sh2
                          : shl(clampi(num, -(1 << 24), 1 << 24), -sh2));
  }
  if (L.ts) {
    const int tsh = 15 - bd - lg;
#pragma unroll
    for (int i = 0; i < S; ++i)
      tu[i * (S + 1) + x] = clip16(
          tsh > 0 ? (d[i] + (1 << (tsh - 1))) >> tsh : shl(d[i], -tsh));
    return;
  }
#pragma unroll
  for (int i = 0; i < S; ++i) {
    int acc = 0;
#pragma unroll
    for (int j = 0; j < S; ++j) acc += coef<S>(L.dst, j, i) * d[j];
    tu[i * (S + 1) + x] = clip16((acc + 64) >> 7);
  }
}

// step 2 for lane (t, x): the second pass along row x, into L.v
template <int S>
FHD void rows(int bd, Lane<S>& L, int x, const int32_t* tu) {
  if (!transformed(L)) return;
  int e[S];
#pragma unroll
  for (int j = 0; j < S; ++j) e[j] = tu[x * (S + 1) + j];
  const int sh = 20 - bd;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    int acc = 0;
#pragma unroll
    for (int j = 0; j < S; ++j) acc += e[j] * coef<S>(L.dst, j, i);
    L.v[i] = clip16((acc + (1 << (sh - 1))) >> sh);
  }
}

// ... and row x back into the scratch
template <int S>
FHD void put_row(const Lane<S>& L, int x, int32_t* tu) {
  if (!transformed(L)) return;
#pragma unroll
  for (int i = 0; i < S; ++i) tu[x * (S + 1) + i] = L.v[i];
}

// (row, column) of sample i of line x: a column for vertical RDPCM, else a
// row
template <int S>
FHD int at(const Lane<S>& L, int x, int i) {
  return L.rd == 2 ? i * (S + 1) + x : x * (S + 1) + i;
}

// step 3 for lane (t, x): line x of the rotated residual, accumulated where
// RDPCM is on, into L.v
template <int S>
FHD void line(Lane<S>& L, int x, const int32_t* tu) {
  const bool acc_on = L.rd == 1 || L.rd == 2;
  int acc = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    int a = at(L, x, i);
    if (L.rot) a = (S - 1) * (S + 2) - a;  // (S-1-row, S-1-col)
    int v = tu[a];
    if (acc_on) {
      acc += v;
      v = wrap16(acc);
    }
    L.v[i] = v;
  }
}

// L.v back into the scratch, where line() read it from
template <int S>
FHD void put_line(const Lane<S>& L, int x, int32_t* tu) {
#pragma unroll
  for (int i = 0; i < S; ++i) tu[at(L, x, i)] = L.v[i];
}

// step 4 for lane (t, x): the cross-component add from the source slot's
// residual in the scratch
template <int S>
FHD void ccp(Lane<S>& L, int x, const int32_t* tu) {
  if (!L.alpha) return;
#pragma unroll
  for (int i = 0; i < S; ++i)
    L.v[i] = wrap16(L.v[i] + (mul(L.alpha, tu[at(L, x, i)]) >> 3));
}

// step 5 for one lane: the unit's slots from the warp's scratch ``sc`` to
// the pool, 32 consecutive int32 a pass
template <int S>
FHD void store(const ResidClass& k, int u, int lane, const int32_t* sc) {
  constexpr int per = 32 / S;
  const int first = u * per;
  const int slots = k.n + 1 - first < per ? k.n + 1 - first : per;
  int32_t* out = k.out + (size_t)first * S * S;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int idx = q * 32 + lane;
    const int t = idx / (S * S), w = idx % (S * S);
    if (t < slots) out[idx] = sc[t * S * (S + 1) + (w / S) * (S + 1) + w % S];
  }
}

// the scratch of lane's TU and its line
template <int S>
FHD int32_t* tu_of(int32_t* sc, int lane) {
  return sc + (lane / S) * S * (S + 1);
}

#ifdef __CUDACC__

// Steps 1-3 of the warp for the records of L (one a lane)
template <int S>
__device__ __forceinline__ void residual(const ResidClass& k, int bd,
                                         Lane<S>& L, int x, int32_t* tu) {
  columns(k, bd, L, x, tu);
  __syncwarp();
  rows(bd, L, x, tu);
  __syncwarp();
  put_row(L, x, tu);
  __syncwarp();
  line(L, x, tu);
}

template <int S>
__device__ void unit(const ResidParams& p, const ResidClass& k, int u,
                     int32_t* sc) {
  const int lane = threadIdx.x & 31, x = lane % S;
  int32_t* tu = tu_of<S>(sc, lane);
  Lane<S> L;
  lane_record(k, u * (32 / S) + lane / S, L);
  residual(k, p.bd, L, x, tu);
  if (__any_sync(0xffffffffu, L.alpha != 0)) {
    Lane<S> Q;
    lane_record(k, L.alpha ? L.src : -1, Q);
    __syncwarp();
    residual(k, p.bd, Q, x, tu);
    __syncwarp();
    put_line(Q, x, tu);
    __syncwarp();
    ccp(L, x, tu);
  }
  __syncwarp();
  put_line(L, x, tu);
  __syncwarp();
  store<S>(k, u, lane, sc);
}

__global__ void __launch_bounds__(32 * kWarps)
resid_tx_kernel(const __grid_constant__ ResidParams p) {
  __shared__ int32_t sc[kWarps][kScratch];
  const int warp = threadIdx.x >> 5;
  const int u = blockIdx.x * kWarps + warp;
  if (u >= p.units) return;
  int c = 3;
  while (c > 0 && u < p.cls[c].unit0) --c;
  const ResidClass& k = p.cls[c];
  switch (c) {
    case 0: unit<4>(p, k, u - k.unit0, sc[warp]); break;
    case 1: unit<8>(p, k, u - k.unit0, sc[warp]); break;
    case 2: unit<16>(p, k, u - k.unit0, sc[warp]); break;
    default: unit<32>(p, k, u - k.unit0, sc[warp]); break;
  }
}

#else

// The warp's steps lane by lane, each step over all 32 lanes before the
// next (the kernel's __syncwarp between them)
template <int S>
void residual_host(const ResidClass& k, int bd, Lane<S>* L, int32_t* sc) {
  for (int l = 0; l < 32; ++l) columns(k, bd, L[l], l % S, tu_of<S>(sc, l));
  for (int l = 0; l < 32; ++l) rows(bd, L[l], l % S, tu_of<S>(sc, l));
  for (int l = 0; l < 32; ++l) put_row(L[l], l % S, tu_of<S>(sc, l));
  for (int l = 0; l < 32; ++l) line(L[l], l % S, tu_of<S>(sc, l));
}

template <int S>
void unit_host(const ResidParams& p, const ResidClass& k, int u,
               int32_t* sc) {
  Lane<S> L[32], Q[32];
  bool any = false;
  for (int l = 0; l < 32; ++l) {
    lane_record(k, u * (32 / S) + l / S, L[l]);
  }
  residual_host(k, p.bd, L, sc);
  for (int l = 0; l < 32; ++l) any |= L[l].alpha != 0;
  if (any) {
    for (int l = 0; l < 32; ++l)
      lane_record(k, L[l].alpha ? L[l].src : -1, Q[l]);
    residual_host(k, p.bd, Q, sc);
    for (int l = 0; l < 32; ++l) put_line(Q[l], l % S, tu_of<S>(sc, l));
    for (int l = 0; l < 32; ++l) ccp(L[l], l % S, tu_of<S>(sc, l));
  }
  for (int l = 0; l < 32; ++l) put_line(L[l], l % S, tu_of<S>(sc, l));
  for (int l = 0; l < 32; ++l) store<S>(k, u, l, sc);
}

#endif

}  // namespace

extern "C" {

#ifdef __CUDACC__

// The residual pools of the four classes, one launch on the stream.
int hevc_resid_tx_launch(const ResidParams* p, void* stream) {
  const int blocks = (p->units + kWarps - 1) / kWarps;
  resid_tx_kernel<<<blocks > 0 ? blocks : 1, 32 * kWarps, 0,
                    (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

#else

// The same units on host memory, in loops: what the kernel computes, for
// the CPU tests (a host compiler builds this file without __CUDACC__).
int hevc_residuals_host(const ResidParams* p) {
  int32_t sc[kScratch];
  for (int c = 0; c < 4; ++c) {
    const ResidClass& k = p->cls[c];
    const int end = c < 3 ? p->cls[c + 1].unit0 : p->units;
    for (int u = 0; u < end - k.unit0; ++u) {
      switch (c) {
        case 0: unit_host<4>(*p, k, u, sc); break;
        case 1: unit_host<8>(*p, k, u, sc); break;
        case 2: unit_host<16>(*p, k, u, sc); break;
        default: unit_host<32>(*p, k, u, sc); break;
      }
    }
  }
  return 0;
}

#endif

}  // extern "C"
