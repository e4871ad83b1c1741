// Hopper (sm_90a) primitives shared by the bf16 kernels of the 3x3 stride-1
// SAME convolution (conv3x3.cu, conv3x3_tout.cu, conv3x3_patch.cu,
// conv3x3_wgrad.cu, conv3x3_wgrad_tout.cu) and of the MIL pooling
// (mil_pool.cu): barriers in shared memory, cp.async and TMA copies, the
// register-budget helpers, the
// wgmma instructions (m64n64k16, m64n192k16) and their shared-memory
// descriptors, the cp.async loaders for the shapes TMA does not take, the
// persistent grid, the tensor-map encoders looked up through the runtime,
// the halo kernel (namespace halo) that conv3x3.cu and conv3x3_tout.cu each
// instantiate with their own products and epilogue, and the weight-gradient
// kernel (namespace wgrad) that conv3x3_wgrad.cu and conv3x3_wgrad_tout.cu
// each instantiate with their own operand roles and epilogue.
//
// Every kernel built on these is warp-specialised the same way: one producer
// warp fills a ring of stages in shared memory and signals `full` barriers;
// consumer warpgroups wait on them, queue `wgmma`s reading both operands from
// shared memory, and release each stage on its `empty` barrier once its
// products have retired.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- barriers in shared memory
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// arrives once this thread's cp.async copies so far have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// the registers of each thread of this warpgroup raised or lowered to N:
// a warp-specialised kernel moves them from its producer to its consumers
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --- copies
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// TMA's im2col mode over an NHWC tensor (the map made by encode_im2col):
// the map's pixels-per-column consecutive pixels of its bounding box, from
// (w, h, n) on, each one's channels-per-pixel channels from c on, read at
// the pixel shifted by (dw, dh); zeros outside the tensor.
__device__ __forceinline__ void tma_load_im2col_4d(void* dst, const CUtensorMap* map,
                                                   uint64_t* bar, int c, int w, int h, int n,
                                                   uint16_t dw, uint16_t dh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"(dw), "h"(dh)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's TMA stores have finished reading shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the generic proxy's writes to shared memory (cp.async, stores) made
// visible to the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128 threads of warpgroup wg (barrier 0 is __syncthreads')
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// --- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products
template <int R, int N>
__device__ __forceinline__ void fence_acc(float (&acc)[R][N]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+f"(acc[i][j])::"memory");
}

// A shared-memory matrix descriptor: start address, LBO and SBO in bytes,
// the swizzle (1: 128-byte, 3: 32-byte).  The base-offset field stays 0 even
// where the start is not on the swizzle pattern's boundary: the card applies
// the swizzle from the address bits themselves, as TMA wrote them (setting
// the field to the start's phase gave wrong products on the H100).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)swizzle << 62;
}

// d (64 x 64 fp32, the warpgroup's fragment) += A (64 x 16) * B (16 x 64),
// both bf16 from shared memory, m64n64k16.  TA = 0: A K-major, 1: M-major
// (transposed); TB = 0: B K-major, 1: N-major (transposed).  Warp q of the warpgroup holds rows 16 q + lane / 4 and + 8,
// columns 8 j + 2 (lane % 4) and + 1 of each group j of 8: d[4 j], d[4 j +
// 1] the first row, d[4 j + 2], d[4 j + 3] the second.
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 192 fp32, the warpgroup's fragment) += A (64 x 16) * B (16 x 192),
// m64n192k16, both bf16 from shared memory; TA, TB as for the m64n64k16
// above.  Warp q holds rows 16 q + lane / 4 and + 8, columns 8 j + 2 (lane %
// 4) and + 1 of each group j of 8 (j < 24): d[4 j], d[4 j + 1] the first
// row, d[4 j + 2], d[4 j + 3] the second.  96 accumulator registers.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// The loader for shapes TMA does not take (C or F not a multiple of 8): the
// producer warp's 32 threads copy one chunk of KC input channels from c0 on,
// the halo of HR x HC pixels from (h0 - 1, w0 - 1) on and the 9 x KC x FT
// slab of k from output channel f0 on, into the layout TMA would write: the
// halo at xs, 32 bytes (16 channels) a pixel, 32-byte swizzled (the two
// 16-byte halves of pixel p swapped where bit 2 of p is set); k at ws,
// [tap][channel][FT output channels], 128 bytes a row, 128-byte swizzled
// (16-byte group j of row r at j ^ (r % 8)).  16 bytes a cp.async where they
// are aligned and inside, element by element (zeros outside) elsewhere.
template <int HR, int HC, int KC, int FT>
__device__ void load_halo_chunk_cp_async(bf16* xs, bf16* ws, const bf16* xn, const bf16* k,
                                         int h0, int w0, int f0, int c0, int H, int W, int C,
                                         int F, int lane) {
  static_assert(KC * 2 == 32 && FT * 2 == 128, "the swizzles assume these widths");
  const bool x_vec = C % 8 == 0;   // every pixel starts on 16 bytes
  for (int i = lane; i < HR * HC * (KC / 8); i += 32) {
    const int v = i % (KC / 8), p = i / (KC / 8);
    const int h = h0 + p / HC - 1, wd = w0 + p % HC - 1;
    const int c = c0 + v * 8;
    const bool inside = h >= 0 && h < H && wd >= 0 && wd < W;
    bf16* dst = xs + p * KC + ((v ^ (p >> 2)) & 1) * 8;
#ifdef CONV3X3_SKIP_X
    if (c0 > 0) continue;
#endif
    if (inside && x_vec && c + 8 <= C) {
      cp_async16(dst, xn + ((size_t)h * W + wd) * C + c);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      if (inside) {
        const bf16* src = xn + ((size_t)h * W + wd) * C;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j < C) dst[j] = src[c + j];
      }
    }
  }
  const bool w_vec = F % 8 == 0;
  for (int i = lane; i < 9 * KC * (FT / 8); i += 32) {
    const int fg = i % (FT / 8), r = i / (FT / 8);   // r = tap * KC + channel
    const int c = c0 + r % KC, f = f0 + fg * 8;
    const size_t row = ((size_t)(r / KC) * C + c) * F;
    bf16* dst = ws + r * FT + ((fg ^ r) & 7) * 8;
#ifdef CONV3X3_SKIP_W
    if (c0 > 0) continue;
#endif
    if (c < C && w_vec && f + 8 <= F) {
      cp_async16(dst, k + row + f);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      if (c < C) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (f + j < F) dst[j] = k[row + f + j];
      }
    }
  }
}

// --- host side

// As many blocks as the card runs at once, at most one a tile.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem, long long tiles,
                            unsigned int* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const long long resident = (long long)sms * per_sm;
  *grid = (unsigned int)(tiles < resident ? tiles : resident);
  return cudaSuccess;
}

// A libcuda function looked up through the runtime
// (cudaGetDriverEntryPoint), so that the library needs no link against
// libcuda; Fn is the function's own type, from cuda.h's declaration.
template <typename Fn>
cudaError_t libcuda_entry(const char* name, Fn* fn) {
  if (*fn != nullptr) return cudaSuccess;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
  cudaError_t err = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
  if (err != cudaSuccess) return err;
  if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
  *fn = reinterpret_cast<Fn>(p);
  return cudaSuccess;
}

// A bf16 tensor map of the tiled mode: boxes of `box` elements, the zero
// fill outside the tensor.
inline cudaError_t encode(CUtensorMap* map, const void* ptr, cuuint32_t rank,
                          const cuuint64_t* dims, const cuuint64_t* strides,
                          const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  static decltype(&cuTensorMapEncodeTiled) fn = nullptr;
  cudaError_t err = libcuda_entry("cuTensorMapEncodeTiled", &fn);
  if (err != cudaSuccess) return err;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                        strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A bf16 tensor map of TMA's im2col mode over an NHWC tensor (dims C, W, H,
// N innermost first): a load brings `pixels` consecutive pixels of the
// bounding box, `channels` channels each, 128-byte swizzled.  The bounding
// box runs from `lower` to the last pixel plus `upper` in W and in H; for a
// 3x3 SAME convolution both are -1, so that output pixel (w, h) starts at
// input pixel (w - 1, h - 1) and the tap (dc, dr) is the load's offset.
inline cudaError_t encode_im2col(CUtensorMap* map, const void* ptr, const cuuint64_t* dims,
                                 const cuuint64_t* strides, int lower, int upper,
                                 cuuint32_t channels, cuuint32_t pixels) {
  static decltype(&cuTensorMapEncodeIm2col) fn = nullptr;
  cudaError_t err = libcuda_entry("cuTensorMapEncodeIm2col", &fn);
  if (err != cudaSuccess) return err;
  const int lo[2] = {lower, lower}, hi[2] = {upper, upper};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, lo, hi, channels, pixels, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// --- the halo kernel: a 3x3 SAME convolution's nine taps as shifted windows
// of one staged halo (conv3x3.cu's taps, conv3x3_tout.cu's tout)
//
// A block owns TH x TW output pixels (rows of 64: a `wgmma` operand's 64
// pixels must lie in one halo row) and FT = 64 output channels, and is two
// consumer warpgroups and one producer warp; warpgroup w owns output rows
// ROWS w .. ROWS w + ROWS - 1, one 64 x 64 fp32 accumulator a row.  The
// input channels pass in chunks of KC = 16, one k16 step: a chunk's stage is
// the tile's halo of x, (TH + 2) x (TW + 2) pixels, 32 bytes (16 channels) a
// pixel, 32-byte swizzled (the two 16-byte halves of pixel p swapped where
// bit 2 of p is set), and the 9 x 16 x 64 slab of k, [tap][channel][64
// output channels], 128 bytes a row, 128-byte swizzled (16-byte group j of
// row r at j ^ (r % 8)).  Each of the 9 x ROWS products of a chunk reads a
// tap's window of the halo, the 64 pixels from halo pixel (row + dr, dc) on,
// 8 of them 256 bytes (SBO) whatever the shift, and the tap's 16 rows of k.
// The Op says which operand is which and writes the output:
//
//   Op::products(acc, stage, wg)   the warpgroup's 9 x ROWS wgmmas of a
//                                  staged chunk;
//   Op::stage_out(acc, out)        its rows rounded to bf16 into its output
//                                  tile, as Op's y map reads it;
//   Op::store_tma(ymap, out, n, h, w0, f0, H)
//                                  that tile's TMA stores (one thread; h is
//                                  the warpgroup's first row);
//   Op::store_direct(acc, y, n, h, w0, f0, N, H, W, F)
//                                  its rows written directly, masked;
//   Op::takes_tma(C, F, W)         whether the shape takes TMA;
//   Op::encode_y(map, y, N, H, W, F)  y's tensor map.
namespace halo {

constexpr int TH = 8, TW = 64;           // output pixels of a block
constexpr int KC = 16;                   // input channels a chunk: one k16 step
constexpr int FT = 64;                   // output channels of a block
constexpr int ROWS = TH / 2;             // output rows of a consumer warpgroup
constexpr int THREADS = 288;             // two consumer warpgroups + 1 warp
constexpr int PRODUCER = 256;            // its first thread
constexpr int STAGES = 4;
constexpr int HR = TH + 2, HC = TW + 2;  // halo rows and columns
// One stage, as TMA writes it: the halo, then k, each on 1024 bytes.  Sizes
// in elements.
constexpr uint32_t X_BYTES = sizeof(bf16) * HR * HC * KC;
constexpr uint32_t K_BYTES = sizeof(bf16) * 9 * KC * FT;
constexpr int XS = (X_BYTES + 1023) / 1024 * 1024 / sizeof(bf16);
constexpr int STAGE = XS + 9 * KC * FT;
constexpr uint32_t STAGE_BYTES = sizeof(bf16) * STAGE;
// The output tile of a warpgroup, ROWS x TW pixels x FT channels.
constexpr int OUT = ROWS * TW * FT;
constexpr size_t SMEM_OUT = sizeof(bf16) * 2 * OUT;
// + 1024: room to align the output tiles; + the full and empty barriers
constexpr size_t SMEM = 1024 + SMEM_OUT + (size_t)STAGES * STAGE_BYTES + 2 * STAGES * 8;
static_assert(SMEM <= 232448, "the ring exceeds an SM's shared memory");
static_assert(XS * 2 % 1024 == 0 && STAGE_BYTES % 1024 == 0,
              "swizzled tiles start on 1024 bytes");
static_assert(KC * 2 == 32 && FT * 2 == 128, "the swizzles assume these widths");

// Warp-specialised and persistent.  Block b takes tiles b, b + gridDim.x,
// ...; tile t is output-channel tile t % f_tiles (fastest), then the column
// tile, the row tile, the image, so that an input gradient's channel tiles
// (F = 192) run at once on neighbouring SMs and read the same halo from L2.
// Its last warp is the producer: it walks the chunks of all of the block's
// tiles and fills stage g % STAGES with chunk g once both warpgroups have
// released that stage's previous chunk (`empty`, one arrival a consumer
// warp), signalling `full` when the bytes have landed (TMA: one thread,
// transaction bytes; cp.async: 32 arrivals).  The two warpgroups each wait
// for `full`, issue the chunk's 9 x ROWS products, and release the chunk
// before it once those have retired, so that one chunk's products are
// always queued behind the running ones.  At a tile's end each writes its
// rows: with TMA it stages them in shared memory and one thread stores them
// asynchronously, so the next tile's products start while the store drains.
template <class Op, bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap kmap,
       const __grid_constant__ CUtensorMap ymap, const bf16* __restrict__ x,
       const bf16* __restrict__ k, bf16* __restrict__ y, int N, int H, int W, int C, int F,
       int tiles_h, int tiles_w, int f_tiles, unsigned int total_tiles) {
  extern __shared__ __align__(1024) unsigned char halo_smem[];
  // the swizzled output tiles want 1024-byte alignment
  unsigned char* base = halo_smem + ((1024 - smem_u32(halo_smem) % 1024) % 1024);
  bf16* out = reinterpret_cast<bf16*>(base);
  bf16* ring = reinterpret_cast<bf16*>(base + SMEM_OUT);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + SMEM_OUT + (size_t)STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int n_chunks = (C + KC - 1) / KC;
  if (blockIdx.x >= total_tiles) return;
  const unsigned int my_tiles = (total_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const unsigned int my_chunks = my_tiles * n_chunks;
  auto place = [&](unsigned int t, int& h0, int& w0, int& f0, int& n) {
    t = blockIdx.x + t * gridDim.x;
    f0 = (int)(t % f_tiles) * FT;
    t /= f_tiles;
    w0 = (int)(t % tiles_w) * TW;
    t /= tiles_w;
    h0 = (int)(t % tiles_h) * TH;
    n = (int)(t / tiles_h);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], TMA ? 1 : 32);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= PRODUCER) {           // ------------------ producer --
    const int lane = threadIdx.x - PRODUCER;
    if (TMA && lane != 0) return;
    for (unsigned int g = 0; g < my_chunks; ++g) {
      const int s = g % STAGES;
      if (g >= STAGES) mbar_wait(&empty[s], (g / STAGES - 1) & 1);
      int h0, w0, f0, n;
      place(g / n_chunks, h0, w0, f0, n);
      const int c0 = (int)(g % n_chunks) * KC;
      bf16* xs = ring + s * STAGE;
      if (TMA) {
        bool load_x = true, load_k = true;
#ifdef CONV3X3_SKIP_X
        load_x = c0 == 0;
#endif
#ifdef CONV3X3_SKIP_W
        load_k = c0 == 0;
#endif
        mbar_expect_tx(&full[s], (load_x ? X_BYTES : 0) + (load_k ? K_BYTES : 0));
        if (load_x) tma_load_4d(xs, &xmap, &full[s], c0, w0 - 1, h0 - 1, n);
        if (load_k) tma_load_3d(xs + XS, &kmap, &full[s], f0, c0, 0);
      } else {
        load_halo_chunk_cp_async<HR, HC, KC, FT>(xs, xs + XS, x + (size_t)n * H * W * C, k, h0,
                                                 w0, f0, c0, H, W, C, F, lane);
        fence_proxy_async();               // the zeros written by hand
        mbar_arrive_cp_async(&full[s]);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers --
  const int wg = threadIdx.x >> 7;
  const bool warp_leader = (threadIdx.x & 31) == 0;
  const bool wg_leader = (threadIdx.x & 127) == 0;
  bf16* my_out = out + wg * OUT;
  float acc[ROWS][32];
  unsigned int g = 0;
  for (unsigned int t = 0; t < my_tiles; ++t) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[i][j] = 0.0f;
    fence_acc(acc);
    int held = -1;                         // stage of the chunk still in flight
    for (int c = 0; c < n_chunks; ++c, ++g) {
      const int s = g % STAGES;
      mbar_wait(&full[s], (g / STAGES) & 1);
      if (!TMA) fence_proxy_async();       // cp.async's writes, for wgmma
#ifndef CONV3X3_SKIP_MMA
      wgmma_fence();
      Op::products(acc, ring + s * STAGE, wg);
      wgmma_commit();
      wgmma_wait<1>();                     // the chunk before has retired
#endif
      if (held >= 0 && warp_leader) mbar_arrive(&empty[held]);
      held = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (warp_leader) mbar_arrive(&empty[held]);
    int h0, w0, f0, n;
    place(t, h0, w0, f0, n);
#ifdef CONV3X3_SKIP_STORE
    if (h0 >= 0) continue;                 // never stores
#endif
    const int h = h0 + wg * ROWS;          // the warpgroup's first row
    if (TMA) {
      if (wg_leader) tma_store_wait_read();   // the last stores have left my_out
      warpgroup_sync(wg);
      Op::stage_out(acc, my_out);
      fence_proxy_async();                 // the staged tile, for TMA
      warpgroup_sync(wg);
      if (wg_leader) Op::store_tma(&ymap, my_out, n, h, w0, f0, H);
    } else {
      Op::store_direct(acc, y, n, h, w0, f0, N, H, W, F);
    }
  }
  if (TMA && wg_leader) tma_store_wait();
}

// The loader and the store are chosen by shape (Op::takes_tma: TMA needs
// 16-byte strides in device memory); other shapes take the cp.async loader
// and direct stores.  Neither is a fallback for the other: a launch that
// fails returns its error.  The tensor maps are built here for each call: x
// (C, W, H, N) in boxes of KC x HC x HR pixels, 32-byte swizzled, whose
// zero fill outside the tensor is the SAME padding and the ragged edges; k
// (F, C, 9 taps) in boxes of FT x KC x 9, 128-byte swizzled; y as Op says.
template <class Op>
cudaError_t launch(const void* x, const void* k, void* y, int N, int H, int W, int C, int F,
                   cudaStream_t stream) {
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const int f_tiles = (F + FT - 1) / FT;
  const long long tiles = (long long)N * tiles_h * tiles_w * f_tiles;
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  const bool tma = Op::takes_tma(C, F, W);
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  cudaError_t err = cudaSuccess;
  if (tma) {
    const cuuint64_t e = sizeof(bf16);
    const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
    const cuuint64_t xs[3] = {C * e, (cuuint64_t)W * C * e, (cuuint64_t)H * W * C * e};
    const cuuint32_t xb[4] = {KC, HC, HR, 1};
    const cuuint64_t kd[3] = {(cuuint64_t)F, (cuuint64_t)C, 9};
    const cuuint64_t ks[2] = {F * e, (cuuint64_t)C * F * e};
    const cuuint32_t kb[3] = {FT, KC, 9};
    if ((err = encode(&maps[0], x, 4, xd, xs, xb, CU_TENSOR_MAP_SWIZZLE_32B)) != cudaSuccess ||
        (err = encode(&maps[1], k, 3, kd, ks, kb, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
        (err = Op::encode_y(&maps[2], y, N, H, W, F)) != cudaSuccess)
      return err;
  }
  auto kern = tma ? kernel<Op, true> : kernel<Op, false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  unsigned int grid = 0;
  err = persistent_grid(kern, THREADS, SMEM, tiles, &grid);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const bf16*>(x), static_cast<const bf16*>(k),
      static_cast<bf16*>(y), N, H, W, C, F, tiles_h, tiles_w, f_tiles, (unsigned int)tiles);
  return cudaGetLastError();
}

}  // namespace halo

// --- the weight-gradient kernel: dw[dr, dc, c, f] = sum over the pixels of
// x[h + dr - 1, w + dc - 1, c] * dy[h, w, f], the pixels (the GEMM's K) cut
// into `splits` contiguous ranges (conv3x3_wgrad.cu's taps, which writes dw
// as (9C, F), conv3x3_wgrad_tout.cu's tout, which writes dw^T as (F, 9C))
//
// A unit of work is one tile of CT = 64 input channels, one of FT = 64
// output channels and one range of pixel tiles of TH x TW = 4 x 64 pixels;
// a block is three consumer warpgroups and one producer warp, warpgroup dr
// owning the taps (dr, 0..2): three 64 x 64 fp32 accumulators (96 registers
// a thread) that it keeps across the whole range and writes once, to the
// range's slice of a workspace.  A stage is a tile's halo of x, (TH + 2) x
// (TW + 2) pixels, and its TH x TW pixels of dy, each 128 bytes (64
// channels) a pixel, 128-byte swizzled (16-byte group j of pixel p at j ^
// (p % 8)).  A k16 step is 16 consecutive pixels of one output row; tap
// (dr, dc)'s window of x starts dr halo rows and dc pixels further on.  Both
// operands have the pixels as their strided axis, so both are MN-major
// (`wgmma`'s transpose flags): 8 pixels are 1024 bytes (SBO), all 64
// channels lie in a pixel's 128 bytes (LBO unused).  A window starts
// (dr (TW + 2) + dc) x 128 bytes into a 1024-byte swizzle pattern; the card
// swizzles from the address bits, as TMA wrote them, so the descriptor's
// base offset stays 0 there too.  The Op says which operand is which and
// where the partial goes:
//
//   Op::product(acc, xd, dd)      acc += the product of one k16 step, from
//                                 the descriptors of x's window and of dy;
//   Op::store(acc, part, dr, c0, f0, C, F)
//                                 the warpgroup's three taps into the
//                                 range's partial, masked at C and F.
//
// The partials are added by `reduce` in the order of the ranges, so two
// runs give the same bits and no float atomics are needed.
namespace wgrad {

constexpr int TH = 4, TW = 64;           // pixels of a tile: TH rows of 64
constexpr int CT = 64;                   // input channels of a unit
constexpr int FT = 64;                   // output channels of a unit
constexpr int HR = TH + 2, HC = TW + 2;  // halo rows and columns
constexpr int THREADS = 416;             // three consumer warpgroups + 1 warp
constexpr int PRODUCER = 384;            // its first thread
// One stage, as TMA writes it: the halo, then dy, each on 1024 bytes.
constexpr uint32_t X_BYTES = sizeof(bf16) * HR * HC * CT;
constexpr uint32_t D_BYTES = sizeof(bf16) * TH * TW * FT;
constexpr int XS = (X_BYTES + 1023) / 1024 * 1024 / sizeof(bf16);
constexpr int STAGE = XS + TH * TW * FT;
constexpr uint32_t STAGE_BYTES = sizeof(bf16) * STAGE;
// Two stages of 82 KB: a consumer releases each stage once its products
// have retired, so that the producer fills it while the other is
// multiplied.  Tiles of 3 or 2 rows with three or four stages (x read 1.72
// or 2.06 times) are eval/probe_wgrad_ranges.py's variants (PERF.md).
constexpr int STAGES = 2;
constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES + 2 * STAGES * 8;
// Pixel tiles a range holds at most: 32768 pixels, chains of 2048 k16 steps
// in an accumulator.  The error of `wgmma`'s fp32 accumulation grows with
// the chain's length linearly, as a truncating adder's would, not as its
// square root: ranges twice as long came within a factor 1.5 of
// chip_smoke.py's WGRAD_TOL at the trunk's shape on an H100, for a few per
// cent less time (eval/probe_wgrad_ranges.py, PERF.md).
constexpr long long MAX_RANGE_TILES = 32768 / (TH * TW);
static_assert(SMEM <= 232448, "the ring exceeds an SM's shared memory");
static_assert(XS * 2 % 1024 == 0 && STAGE_BYTES % 1024 == 0,
              "swizzled tiles start on 1024 bytes");
static_assert(CT * 2 == 128 && FT * 2 == 128, "the swizzle assumes 128-byte pixels");

// The loader for shapes TMA does not take (C or F not a multiple of 8): the
// producer warp's 32 threads copy the ROWS x COLS pixels from (h0, w0) on
// of image src (H x W pixels of `channels` channels), channels ch0 .. ch0 +
// 63 of each, into dst as TMA writes a 128-byte-swizzled box of them.  16
// bytes a cp.async where they are aligned and inside, element by element
// (zeros outside the image and past the channels) elsewhere.
template <int ROWS, int COLS>
__device__ void load_box_cp_async(bf16* dst, const bf16* src, int h0, int w0, int ch0, int H,
                                  int W, int channels, int lane) {
  const bool vec = channels % 8 == 0;    // every pixel starts on 16 bytes
  for (int i = lane; i < ROWS * COLS * 8; i += 32) {
    const int v = i % 8, p = i / 8;
    const int h = h0 + p / COLS, wd = w0 + p % COLS;
    const int ch = ch0 + v * 8;
    const bool inside = h >= 0 && h < H && wd >= 0 && wd < W;
    bf16* d = dst + p * 64 + ((v ^ p) & 7) * 8;
    if (inside && vec && ch + 8 <= channels) {
      cp_async16(d, src + ((size_t)h * W + wd) * channels + ch);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      if (inside) {
        const bf16* px = src + ((size_t)h * W + wd) * channels;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (ch + j < channels) d[j] = px[ch + j];
      }
    }
  }
}

// Warpgroup dr's products of one staged tile: for each of its TH x TW / 16
// k16 steps, one m64n64k16 a tap (dr, dc).  The descriptors of the stage's
// windows differ from the first ones by constants (a descriptor's low bits
// are the address / 16).
template <class Op>
__device__ __forceinline__ void products(float (&acc)[3][32], const bf16* stage, int dr) {
  const uint64_t x0 = smem_desc(smem_u32(stage) + dr * HC * CT * 2, 16, 1024, 1);
  const uint64_t d0 = smem_desc(smem_u32(stage + XS), 16, 1024, 1);
#pragma unroll
  for (int i = 0; i < TH; ++i)
#pragma unroll
    for (int k = 0; k < TW / 16; ++k) {
      const uint64_t dd = d0 + (uint64_t)((i * TW + 16 * k) * FT * 2 / 16);
#pragma unroll
      for (int dc = 0; dc < 3; ++dc)
        Op::product(acc[dc], x0 + (uint64_t)((i * HC + dc + 16 * k) * CT * 2 / 16), dd);
    }
}

// The shape of a call: pixel tiles and channel tiles.
struct Plan {
  int tiles_h, tiles_w, c_tiles, f_tiles;
  long long pixel_tiles;
};

inline Plan plan(int N, int H, int W, int C, int F) {
  Plan p;
  p.tiles_h = (H + TH - 1) / TH;
  p.tiles_w = (W + TW - 1) / TW;
  p.c_tiles = (C + CT - 1) / CT;
  p.f_tiles = (F + FT - 1) / FT;
  p.pixel_tiles = (long long)N * p.tiles_h * p.tiles_w;
  return p;
}

// Warp-specialised and persistent.  Block b takes units b, b + gridDim.x,
// ...; unit u is channel tile u % c_tiles (fastest), then the output-channel
// tile, then the range, so that the blocks of one range run side by side on
// neighbouring SMs and read its dy from L2.  Pixel tile t of a range is the
// column tile t % tiles_w (fastest), then the row tile, the image.  The
// producer walks the tiles of all of the block's units and fills stage g %
// STAGES with the g-th once the consumers have released that stage's
// previous tile (`empty`, one arrival a consumer warp), signalling `full`
// when the bytes have landed (TMA: one thread, transaction bytes; cp.async:
// 32 arrivals).  x's box starts at (c0, w0 - 1, h0 - 1): its zero fill
// outside the tensor is the SAME padding; dy's pixels past H or W arrive as
// zeros, so a ragged tile adds nothing whatever its halo holds.
template <class Op, bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dmap,
       const bf16* __restrict__ x, const bf16* __restrict__ dy, float* __restrict__ ws, int H,
       int W, int C, int F, Plan p, int splits, unsigned int units) {
  extern __shared__ __align__(1024) unsigned char wgrad_smem[];
  unsigned char* base = wgrad_smem + ((1024 - smem_u32(wgrad_smem) % 1024) % 1024);
  bf16* ring = reinterpret_cast<bf16*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + (size_t)STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  if (blockIdx.x >= units) return;
  const unsigned int my_units = (units - blockIdx.x + gridDim.x - 1) / gridDim.x;
  // unit i of this block: its channel tiles and its range of pixel tiles
  auto unit = [&](unsigned int i, int& c0, int& f0, int& s, long long& first,
                  long long& count) {
    unsigned int u = blockIdx.x + i * gridDim.x;
    c0 = (int)(u % p.c_tiles) * CT;
    u /= p.c_tiles;
    f0 = (int)(u % p.f_tiles) * FT;
    s = (int)(u / p.f_tiles);
    first = p.pixel_tiles * s / splits;
    count = p.pixel_tiles * (s + 1) / splits - first;
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], TMA ? 1 : 32);
      mbar_init(&empty[st], 12);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= PRODUCER) {           // ------------------ producer --
    const int lane = threadIdx.x - PRODUCER;
    if (TMA && lane != 0) return;
    unsigned int g = 0;
    for (unsigned int i = 0; i < my_units; ++i) {
      int c0, f0, s;
      long long first, count;
      unit(i, c0, f0, s, first, count);
      for (long long j = 0; j < count; ++j, ++g) {
        const int st = g % STAGES;
        if (g >= STAGES) mbar_wait(&empty[st], (g / STAGES - 1) & 1);
        long long t = first + j;
        const int w0 = (int)(t % p.tiles_w) * TW;
        t /= p.tiles_w;
        const int h0 = (int)(t % p.tiles_h) * TH;
        const int n = (int)(t / p.tiles_h);
        bf16* xs = ring + st * STAGE;
        bool load_x = true, load_d = true;
#ifdef CONV3X3_SKIP_X
        load_x = j == 0;
#endif
#ifdef CONV3X3_SKIP_W
        load_d = j == 0;
#endif
        if (TMA) {
          mbar_expect_tx(&full[st], (load_x ? X_BYTES : 0) + (load_d ? D_BYTES : 0));
          if (load_x) tma_load_4d(xs, &xmap, &full[st], c0, w0 - 1, h0 - 1, n);
          if (load_d) tma_load_4d(xs + XS, &dmap, &full[st], f0, w0, h0, n);
        } else {
          if (load_x)
            load_box_cp_async<HR, HC>(xs, x + (size_t)n * H * W * C, h0 - 1, w0 - 1, c0, H, W, C,
                                      lane);
          if (load_d)
            load_box_cp_async<TH, TW>(xs + XS, dy + (size_t)n * H * W * F, h0, w0, f0, H, W, F,
                                      lane);
          fence_proxy_async();             // the zeros written by hand
          mbar_arrive_cp_async(&full[st]);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers --
  const int dr = threadIdx.x >> 7;
  const bool warp_leader = (threadIdx.x & 31) == 0;
  float acc[3][32];
  unsigned int g = 0;
  for (unsigned int i = 0; i < my_units; ++i) {
    int c0, f0, s;
    long long first, count;
    unit(i, c0, f0, s, first, count);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 32; ++b) acc[a][b] = 0.0f;
    fence_acc(acc);
    for (long long j = 0; j < count; ++j, ++g) {
      const int st = g % STAGES;
      mbar_wait(&full[st], (g / STAGES) & 1);
      if (!TMA) fence_proxy_async();       // cp.async's writes, for wgmma
#ifndef CONV3X3_SKIP_MMA
      wgmma_fence();
      products<Op>(acc, ring + st * STAGE, dr);
      wgmma_commit();
      wgmma_wait<0>();
#endif
      if (warp_leader) mbar_arrive(&empty[st]);
    }
    fence_acc(acc);
#ifdef CONV3X3_SKIP_STORE
    if (s >= 0) continue;                  // never stores
#endif
    Op::store(acc, ws + (size_t)s * 9 * C * F, dr, c0, f0, C, F);
  }
}

// dw[e] = the sum over the splits of ws[s][e], in the order of s: two runs
// give the same bits.
__global__ void reduce(const float* __restrict__ ws, float* __restrict__ dw, long long count,
                       int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < count;
       e += (long long)gridDim.x * blockDim.x) {
    float sum = 0.0f;
    for (int s = 0; s < splits; ++s) sum += ws[(size_t)s * count + e];
    dw[e] = sum;
  }
}

inline cudaError_t launch_reduce(const float* ws, float* dw, long long count, int splits,
                                 cudaStream_t stream) {
  const long long want = (count + 255) / 256;
  const unsigned int grid = (unsigned int)(want < 4096 ? want : 4096);
  reduce<<<grid, 256, 0, stream>>>(ws, dw, count, splits);
  return cudaGetLastError();
}

// TMA needs 16-byte strides in device memory: C and F multiples of 8 (every
// shape of the trunk).  Other shapes take the cp.async loader; neither is a
// fallback for the other.
inline bool takes_tma(int C, int F) { return C % 8 == 0 && F % 8 == 0; }

// The kernel a shape takes, its dynamic shared memory set.
using Kernel = void (*)(CUtensorMap, CUtensorMap, const bf16*, const bf16*, float*, int, int, int,
                        int, Plan, int, unsigned int);

template <class Op>
cudaError_t kernel_for(int C, int F, Kernel* kern) {
  *kern = takes_tma(C, F) ? kernel<Op, true> : kernel<Op, false>;
  return cudaFuncSetAttribute(*kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
}

// Pixel ranges: whole waves of units (as many as the card runs blocks at
// once, one block an SM), enough waves that no range holds more than
// MAX_RANGE_TILES tiles, and no more ranges than there are pixel tiles.
template <class Op>
cudaError_t choose_splits(int N, int H, int W, int C, int F, int* splits) {
  const Plan p = plan(N, H, W, C, F);
  Kernel kern = nullptr;
  cudaError_t err = kernel_for<Op>(C, F, &kern);
  if (err != cudaSuccess) return err;
  unsigned int resident = 0;
  err = persistent_grid(kern, THREADS, SMEM, 1LL << 30, &resident);
  if (err != cudaSuccess) return err;
  const long long per_range = (long long)p.c_tiles * p.f_tiles;
  const long long per_wave = ((long long)resident + per_range - 1) / per_range;
  long long waves = (p.pixel_tiles + MAX_RANGE_TILES * per_wave - 1) / (MAX_RANGE_TILES * per_wave);
  if (waves < 1) waves = 1;
  long long s = waves * per_wave;
  if (s > p.pixel_tiles) s = p.pixel_tiles;
  if (s < 1) s = 1;
  if (s * per_range > 2147483647LL) return cudaErrorInvalidConfiguration;
  *splits = (int)s;
  return cudaSuccess;
}

// The partials into ws (splits x 9 x C x F floats, as Op lays them out),
// then their sum into dw.  The tensor maps are built here for each call: x
// (C, W, H, N) in boxes of CT x HC x HR pixels and dy (F, W, H, N) in boxes
// of FT x TW x TH, both 128-byte swizzled.
template <class Op>
cudaError_t launch(const void* x, const void* dy, void* ws, void* dw, int N, int H, int W, int C,
                   int F, int splits, cudaStream_t stream) {
  const Plan p = plan(N, H, W, C, F);
  if (splits < 1 || splits > p.pixel_tiles) return cudaErrorInvalidValue;
  const long long units = (long long)splits * p.c_tiles * p.f_tiles;
  if (units > 2147483647LL) return cudaErrorInvalidConfiguration;
  CUtensorMap maps[2];
  memset(maps, 0, sizeof(maps));
  cudaError_t err = cudaSuccess;
  if (takes_tma(C, F)) {
    const cuuint64_t e = sizeof(bf16);
    const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
    const cuuint64_t xs[3] = {C * e, (cuuint64_t)W * C * e, (cuuint64_t)H * W * C * e};
    const cuuint32_t xb[4] = {CT, HC, HR, 1};
    const cuuint64_t dd[4] = {(cuuint64_t)F, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
    const cuuint64_t ds[3] = {F * e, (cuuint64_t)W * F * e, (cuuint64_t)H * W * F * e};
    const cuuint32_t db[4] = {FT, TW, TH, 1};
    if ((err = encode(&maps[0], x, 4, xd, xs, xb, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
        (err = encode(&maps[1], dy, 4, dd, ds, db, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess)
      return err;
  }
  Kernel kern = nullptr;
  if ((err = kernel_for<Op>(C, F, &kern)) != cudaSuccess) return err;
  unsigned int grid = 0;
  if ((err = persistent_grid(kern, THREADS, SMEM, units, &grid)) != cudaSuccess) return err;
  kern<<<grid, THREADS, SMEM, stream>>>(maps[0], maps[1], static_cast<const bf16*>(x),
                                         static_cast<const bf16*>(dy), static_cast<float*>(ws),
                                         H, W, C, F, p, splits, (unsigned int)units);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_reduce(static_cast<const float*>(ws), static_cast<float*>(dw), 9LL * C * F,
                       splits, stream);
}

}  // namespace wgrad

}  // namespace sm90
