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

namespace {

constexpr int kRing = 4;  // stages of tma_pipe_kernel's ring

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
// (mode 1).  One CTA stages the (h, w) tile in shared memory and writes
// it rolled by (sy, sx) or the (oh, ow) window at (sy, sx), the start
// taken as jax.lax.dynamic_slice takes it (a negative one counts from the
// end, then it is clamped into the tile); the shifts are read from a
// device tensor, the counterpart of scalar prefetch.  Bound: one read
// and one write of the tile; the gather out of shared memory takes any
// offset, where Mosaic's roll wanted static or aligned ones.
__global__ void tile_shift_kernel(const int32_t* __restrict__ x, int h, int w,
                                  const int32_t* __restrict__ shift, int mode,
                                  int oh, int ow, int32_t* __restrict__ out) {
  extern __shared__ int32_t tile[];
  for (int k = threadIdx.x; k < h * w; k += blockDim.x) tile[k] = x[k];
  __syncthreads();
  int sy = shift[0], sx = shift[1];
  if (mode == 0) {
    sy = ((sy % h) + h) % h;
    sx = ((sx % w) + w) % w;
    for (int k = threadIdx.x; k < h * w; k += blockDim.x) {
      const int y = k / w, xx = k - y * w;
      const int yy = y - sy < 0 ? y - sy + h : y - sy;
      const int xs = xx - sx < 0 ? xx - sx + w : xx - sx;
      out[k] = tile[yy * w + xs];
    }
  } else {
    sy = min(max(sy < 0 ? sy + h : sy, 0), h - oh);
    sx = min(max(sx < 0 ? sx + w : sx, 0), w - ow);
    for (int k = threadIdx.x; k < oh * ow; k += blockDim.x) {
      const int y = k / ow, xx = k - y * ow;
      out[k] = tile[(sy + y) * w + sx + xx];
    }
  }
}

// Replaces the kernels of tools/probe_dma.py:try_case (read) and
// :try_write (write): the (wh, ww) window at (oy, ox) of a plane, moved by
// TMA with the tensor map's box equal to the window.  With `split` 0 it
// is one box at (oy, ox), whatever ox is: the probe's question.  A TMA
// copy takes any row but faults (illegal instruction, a sticky error) when
// its inner coordinate is not 16-byte aligned, so with `split` 1 a window
// whose ox is not a multiple of 4 int32 moves as two boxes at the aligned
// x0 = ox & ~3 and x0 + ww (ww * 4 is a multiple of 16, or the encoder
// refused the box), and the threads shift it in shared memory.  Read: TMA
// loads complete on an mbarrier with expect-tx, the threads copy the
// window out.  Write:
// the threads set the window to 7 in shared memory (after loading the
// boxes when they reach past it), fence it to the async proxy, and TMA
// stores write the boxes into the plane in place.  Bound: one or two
// boxes, so the latency of the bulk copies.
__global__ void tma_window_kernel(const __grid_constant__ CUtensorMap map,
                                  int wh, int ww, int oy, int ox, int split,
                                  int write, int32_t* __restrict__ out) {
  extern __shared__ uint8_t raw[];
  __shared__ __align__(8) uint64_t bar;
  int32_t* boxes = reinterpret_cast<int32_t*>(align128(raw));
  const int n = wh * ww, lead = split ? ox & 3 : 0, x0 = ox - lead;
  const int nbox = lead ? 2 : 1;
  // element (y, x) of the window: box 0 holds columns [x0, x0 + ww),
  // box 1 the next ww
  auto at = [&](int k) -> int32_t& {
    const int y = k / ww, c = k - y * ww + lead, b = c >= ww;
    return boxes[b * n + y * ww + c - b * ww];
  };
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (!write || lead) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bar, (uint32_t)(nbox * n) * 4);
      for (int b = 0; b < nbox; ++b)
        tma_load(boxes + b * n, &map, &bar, x0 + b * ww, oy);
    }
    mbar_wait(&bar, 0);
  }
  if (!write) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) out[k] = at(k);
    return;
  }
  for (int k = threadIdx.x; k < n; k += blockDim.x) at(k) = 7;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int b = 0; b < nbox; ++b)
      tma_store(&map, boxes + b * n, x0 + b * ww, oy);
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

int hevc_tile_shift_launch(const int32_t* x, int h, int w,
                           const int32_t* shift, int mode, int oh, int ow,
                           int32_t* out, void* stream) {
  const size_t smem = (size_t)h * w * 4;
  int rc = set_smem(tile_shift_kernel, smem);
  if (rc) return rc;
  tile_shift_kernel<<<1, 256, smem, (cudaStream_t)stream>>>(x, h, w, shift,
                                                           mode, oh, ow, out);
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

int hevc_tma_window_launch(const void* map, int wh, int ww, int oy, int ox,
                           int split, int write, int32_t* out, void* stream) {
  CUtensorMap m;
  memcpy(&m, map, sizeof m);
  const size_t smem = (size_t)(split && (ox & 3) ? 2 : 1) * wh * ww * 4 + 128;
  const int rc = set_smem(tma_window_kernel, smem);
  if (rc) return rc;
  tma_window_kernel<<<1, 256, smem, (cudaStream_t)stream>>>(
      m, wh, ww, oy, ox, split, write, out);
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
