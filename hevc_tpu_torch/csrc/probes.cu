// Probes of Hopper's copy engines for the MC kernel's design, for sm_90a:
// the counterparts of the Mosaic probes in tools/probe_roll.py and
// tools/probe_dma.py.  They answer for shared memory and the Tensor Memory
// Accelerator (TMA) what those answered for VMEM and the TPU's DMA: can a
// tile be shifted or cut at offsets known only on the device, which window
// shapes and offsets a bulk tensor copy takes, and what an aligned
// read-and-write-back pipeline of 48x256 int32 blocks costs.
//
// Plain C interface, loaded with ctypes (hevc_tpu_torch/build.py).  The
// launchers enqueue on the stream they are given, allocate nothing and
// return 0 or a cudaError_t.  The TMA launchers take tensor maps that
// hevc_tma_encode made: 128 bytes the caller owns and may keep for every
// later launch on the same plane and box, so a launch encodes nothing.
// hevc_tma_encode returns 0 or an error code and sets `stage`: 1 =
// cuTensorMapEncodeTiled refused the box (the code is its CUresult), 3 =
// libcuda has no cuTensorMapEncodeTiled (the code is a cudaError_t).
// The plain PyTorch versions are in hevc_tpu_torch/probes.py.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// tile_shift_kernel's launch for one tile shape and mode
// (probes.ShiftParams): the (h, w) tile, the (oh, ow) output and the grid
struct ShiftParams {
  int h, w, mode, oh, ow, blocks;
};

// tma_window_kernel's plan for one window (probes.WindowParams): the
// window's shape and origin, the columns of the box before the window, and
// the box (bh, bw) that each of the `bands` CTAs loads
struct WindowParams {
  int wh, ww, oy, ox, lead, bh, bw, bands;
};

namespace {

constexpr int kRing = 4;            // stages of tma_pipe_kernel's ring
constexpr int kShiftThreads = 128;  // tile_shift_kernel: 16 B of output each
constexpr int kWindowRows = 4;      // tma_window_kernel: a warp a row, 4 rows
constexpr int kWindowThreads = 32 * kWindowRows;

enum { kStageEncode = 1, kStageEntry = 3 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared buffer rounded up to the 128 B that TMA wants
__device__ __forceinline__ uint8_t* align128(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 127u) & ~127u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(phase) : "memory");
  } while (!done);
}

// 2-D TMA load of the box at (x, y) (innermost coordinate first)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x),
         "r"(y), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(x),
         "r"(y)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Replaces tools/probe_roll.py:dynroll_kern (mode 0) and :dynslice_kern
// (mode 1): the (h, w) tile rolled by (sy, sx), or its (oh, ow) window at
// (sy, sx) with the start taken as jax.lax.dynamic_slice takes it (a
// negative one counts from the end, then it is clamped into the tile).
// The shifts are read from a device tensor, the counterpart of scalar
// prefetch.  Both modes are one gather: out(y, x) = x((y + oy) mod h,
// (x + ox) mod w), with (oy, ox) the shift negated modulo the tile (roll)
// or the clamped start (slice, which never wraps).
//
// Bound: one read and one write of each element, so device memory's rate
// once the tile outgrows L2, and a launch and two dependent loads (the
// shift, then the tile) at the probe's 48 KB.  Nothing goes through shared
// memory and the tile has no size limit: each thread owns one 16-byte
// segment of the flat output (a 4-int32 piece of one row when ow is a
// multiple of 4; across two rows otherwise, and a scalar tail past the
// last whole segment), so a (48, 256) roll runs 24 CTAs of 128 threads.
// A thread reduces the shifts and finds its row once, then walks its four
// source columns with a compare each (the wrap point); the scalar loads of
// a warp cover neighbouring addresses and coalesce (two aligned 16-byte
// loads and a shift instead were slower at the probe's tile and within a
// few percent at the 8K plane).  kShiftThreads and the grid are mirrored
// by probes.tile_shift_grid and probes.tile_shift_sources.
__global__ void __launch_bounds__(kShiftThreads)
tile_shift_kernel(const int32_t* __restrict__ x, int h, int w,
                  const int32_t* __restrict__ shift, int mode, int oh,
                  int ow, int32_t* __restrict__ out) {
  const int n = oh * ow;
  const int e0 = 4 * (blockIdx.x * kShiftThreads + threadIdx.x);
  if (e0 >= n) return;
  int oy = shift[0], ox = shift[1];
  if (mode == 0) {  // roll: source = destination - shift, modulo the tile
    oy = -(oy % h);
    ox = -(ox % w);
    oy += oy < 0 ? h : 0;
    ox += ox < 0 ? w : 0;
  } else {
    oy = min(max(oy < 0 ? oy + h : oy, 0), h - oh);
    ox = min(max(ox < 0 ? ox + w : ox, 0), w - ow);
  }
  int y = e0 / ow, c = e0 - y * ow;
  int sr = y + oy, sc = c + ox;
  sr -= sr >= h ? h : 0;
  sc -= sc >= w ? w : 0;
  const int cnt = min(4, n - e0);
  int v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < cnt) v[j] = __ldg(x + (size_t)sr * w + sc);
    if (++c == ow) {  // the next output row
      c = 0;
      sr = sr + 1 == h ? 0 : sr + 1;
      sc = ox;
    } else {
      sc = sc + 1 == w ? 0 : sc + 1;
    }
  }
  if (cnt == 4) {
    *reinterpret_cast<int4*>(out + e0) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < cnt; ++j) out[e0 + j] = v[j];
  }
}

// the four words that start `lead` words into the aligned pair (a, b)
__device__ __forceinline__ int4 words_from(int4 a, int4 b, int lead) {
  switch (lead) {
    case 0: return a;
    case 1: return make_int4(a.y, a.z, a.w, b.x);
    case 2: return make_int4(a.z, a.w, b.x, b.y);
    default: return make_int4(a.w, b.x, b.y, b.z);
  }
}

// Replaces the kernels of tools/probe_dma.py:try_case (read) and
// :try_write (write): the (wh, ww) window at (oy, ox) of a plane, moved by
// TMA.  A TMA copy takes any row but faults (illegal instruction, a sticky
// error) when its inner coordinate is not 16-byte aligned.  The plan
// (WindowParams, mirrored by probes.window_plan and probes.window_boxes):
// the window's rows split into bands of bh (4 rows, probes.WINDOW_BAND:
// taller bands, with fewer CTAs, and two boxes of ww in place of one of
// ww + 4 were slower; python -m hevc_tpu_torch.probes --plans times each),
// one CTA a band, each with its own mbarrier and its own (bh, bw) box at row oy + min(b * bh, wh - bh)
// (the last band's box ends at the window's last row and may overlap the
// band before it); the box starts at the aligned x0 = ox - lead.  With
// lead 0 the box is the band's part of the window (bw = ww).  Otherwise
// one box of bw = ww + 4 columns holds it (ww * 4 is a multiple of 16, or
// the encoder refused the window's box, so (ww + 4) * 4 is too), or, for
// ww + 4 > 256 (a box's largest extent), two boxes of ww at x0 and x0 + 4.
// Every box lies inside the plane.  With lead 0 and a box at an unaligned
// ox (probes.tma_window with split=False), the load faults: the probe's
// question.  Read: the loads complete on the band's mbarrier with
// expect-tx, then each thread moves 16-byte segments of a window row out
// of shared memory (two aligned 16-byte shared loads and a shift by lead)
// into `out` with one 16-byte store, no division.  Write: the threads set
// the window's part of the boxes to 7 in shared memory (after loading them
// when they reach past the window), fence it to the async proxy, and TMA
// stores write the boxes back in place; overlapping boxes carry equal
// values.  Bound: a launch and one bulk-copy round trip a band, in
// parallel over the bands; the bytes (2 * wh * ww * 4, 40 KB for the
// probe's (40, 128) read) would take 0.012 us at device memory's rate.
__global__ void __launch_bounds__(kWindowThreads)
tma_window_kernel(const __grid_constant__ CUtensorMap map,
                  const WindowParams p, int write, int32_t* __restrict__ out) {
  extern __shared__ uint8_t raw[];
  __shared__ __align__(8) uint64_t bar;
  const int nbox = p.lead && p.bw == p.ww ? 2 : 1;
  const int box_words = (p.bh * p.bw + 31) & ~31;  // 128-byte aligned boxes
  int32_t* box0 = reinterpret_cast<int32_t*>(align128(raw));
  int32_t* box1 = box0 + box_words;
  const int r0 = blockIdx.x * p.bh, r1 = min(r0 + p.bh, p.wh);
  const int ys = min(r0, p.wh - p.bh);  // the box's first window row
  const int x0 = p.ox - p.lead;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const bool load = !write || p.lead;
  if (tx == 0 && ty == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
    if (load) {
      mbar_expect_tx(&bar, (uint32_t)(nbox * p.bh * p.bw) * 4);
      tma_load(box0, &map, &bar, x0, p.oy + ys);
      if (nbox == 2) tma_load(box1, &map, &bar, x0 + 4, p.oy + ys);
    }
  }
  __syncthreads();
  if (load) mbar_wait(&bar, 0);
  if (!write) {
    const int nseg = p.ww >> 2;
    for (int r = r0 + ty; r < r1; r += kWindowRows) {
      const int32_t* row0 = box0 + (r - ys) * p.bw;
      const int32_t* row1 = box1 + (r - ys) * p.bw - 4;
      int4* dst = reinterpret_cast<int4*>(out + (size_t)r * p.ww);
      for (int s = tx; s < nseg; s += 32) {
        // a segment's words [4s, 4s + 8) of the columns from x0; box 1
        // holds them from column 4 on
        const int32_t* src = nbox == 2 && s ? row1 + 4 * s : row0 + 4 * s;
        const int4 a = *reinterpret_cast<const int4*>(src);
        dst[s] = p.lead ? words_from(a, *reinterpret_cast<const int4*>(
                                            src + 4), p.lead)
                        : a;
      }
    }
    return;
  }
  for (int b = 0; b < nbox; ++b) {
    int32_t* box = b ? box1 : box0;
    const int c0 = p.lead - 4 * b;  // the window's first column in this box
    for (int r = ty; r < p.bh; r += kWindowRows)
      for (int j = tx; j < p.bw; j += 32)
        if (j >= c0 && j < c0 + p.ww) box[r * p.bw + j] = 7;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tx == 0 && ty == 0) {
    tma_store(&map, box0, x0, p.oy + ys);
    if (nbox == 2) tma_store(&map, box1, x0 + 4, p.oy + ys);
    tma_store_wait();
  }
}

// Replaces tools/probe_roll.py:pipe_kern.  One persistent CTA per SM walks
// the block origins blockIdx.x, blockIdx.x + gridDim.x, ...; its one
// working thread keeps a ring of kRing (bh, bw) int32 tiles in dynamic
// shared memory: TMA loads run ahead into the free stages, each arrived
// tile is stored by TMA to the same box of `out`, and a stage is loaded
// again once its store has read it.  Bound: the bandwidth of one read and
// one write of each box; at the probe's (1024, 1536) int32 plane both
// planes (12.6 MB) stay in L2, so it is L2's, not device memory's.
// Overlapping boxes carry equal values, so the result is determined.
__global__ void __launch_bounds__(32)
tma_pipe_kernel(const __grid_constant__ CUtensorMap src,
                const __grid_constant__ CUtensorMap dst,
                const int32_t* __restrict__ origins, int n,
                uint32_t box_bytes) {
  extern __shared__ uint8_t raw[];
  __shared__ __align__(8) uint64_t full[kRing];
  if (threadIdx.x != 0) return;
  uint8_t* ring = align128(raw);
  const int nk = blockIdx.x < n ? (n - blockIdx.x + gridDim.x - 1) / gridDim.x
                                : 0;
  for (int s = 0; s < kRing; ++s) mbar_init(&full[s], 1);
  mbar_init_fence();
  auto load = [&](int k) {
    const int j = blockIdx.x + k * gridDim.x, s = k % kRing;
    mbar_expect_tx(&full[s], box_bytes);
    tma_load(ring + (size_t)s * box_bytes, &src, &full[s], origins[2 * j + 1],
             origins[2 * j]);
  };
  for (int k = 0; k < kRing && k < nk; ++k) load(k);
  for (int k = 0; k < nk; ++k) {
    const int j = blockIdx.x + k * gridDim.x, s = k % kRing;
    mbar_wait(&full[s], (k / kRing) & 1);
    tma_store(&dst, ring + (size_t)s * box_bytes, origins[2 * j + 1],
              origins[2 * j]);
    if (k + kRing < nk) {
      tma_store_wait_read();
      load(k + kRing);
    }
  }
  tma_store_wait();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime already loaded
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// tensor map of a row-major int32 (H, W) plane with an (bh, bw) box
int encode_plane(CUtensorMap* map, const int32_t* plane, int H, int W, int bh,
                 int bw, int* stage) {
  EncodeTiled fn = encode_tiled();
  if (!fn) {
    *stage = kStageEntry;
    return (int)cudaErrorSymbolNotFound;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)W, (cuuint64_t)H};
  const cuuint64_t strides[1] = {(cuuint64_t)W * 4};
  const cuuint32_t box[2] = {(cuuint32_t)bw, (cuuint32_t)bh};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, (void*)plane,
                        dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) *stage = kStageEncode;
  return (int)r;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// `params` from probes.tile_shift_plan: `blocks` CTAs of kShiftThreads
int hevc_tile_shift_launch(const int32_t* x, const int32_t* shift,
                           int32_t* out, const ShiftParams* params,
                           void* stream) {
  const ShiftParams p = *params;
  tile_shift_kernel<<<p.blocks, kShiftThreads, 0, (cudaStream_t)stream>>>(
      x, p.h, p.w, shift, p.mode, p.oh, p.ow, out);
  return (int)cudaGetLastError();
}

// The tensor map of the row-major int32 (H, W) plane with a (bh, bw) box,
// into the 128 bytes at `map`.
int hevc_tma_encode(void* map, const int32_t* plane, int H, int W, int bh,
                    int bw, int* stage) {
  CUtensorMap m;
  const int rc = encode_plane(&m, plane, H, W, bh, bw, stage);
  if (!rc) memcpy(map, &m, sizeof m);
  return rc;
}

// `params` is the plan of probes.window_plan; `map` the plane's tensor map
// with its (bh, bw) box
int hevc_tma_window_launch(const void* map, const WindowParams* params,
                           int write, int32_t* out, void* stream) {
  CUtensorMap m;
  memcpy(&m, map, sizeof m);
  const WindowParams p = *params;
  const int nbox = p.lead && p.bw == p.ww ? 2 : 1;
  const size_t smem = (size_t)nbox * ((p.bh * p.bw + 31) & ~31) * 4 + 128;
  const int rc = set_smem(tma_window_kernel, smem);
  if (rc) return rc;
  tma_window_kernel<<<p.bands, dim3(32, kWindowRows), smem,
                      (cudaStream_t)stream>>>(m, p, write, out);
  return (int)cudaGetLastError();
}

int hevc_tma_pipe_launch(const void* src_map, const void* dst_map,
                         const int32_t* origins, int n, int bh, int bw,
                         void* stream) {
  CUtensorMap src, dst;
  memcpy(&src, src_map, sizeof src);
  memcpy(&dst, dst_map, sizeof dst);
  int dev = 0, sms = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (!rc)
    rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
  const uint32_t box_bytes = (uint32_t)bh * bw * 4;
  const size_t smem = (size_t)kRing * box_bytes + 128;
  if (!rc) rc = set_smem(tma_pipe_kernel, smem);
  if (rc) return rc;
  tma_pipe_kernel<<<sms, 32, smem, (cudaStream_t)stream>>>(src, dst, origins,
                                                            n, box_bytes);
  return (int)cudaGetLastError();
}

// waits for the stream: the error of a kernel that faulted, or 0
int hevc_stream_sync(void* stream) {
  return (int)cudaStreamSynchronize((cudaStream_t)stream);
}

}  // extern "C"
