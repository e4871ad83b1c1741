// 3x3 stride-1 SAME convolution of an NHWC tensor with the output transposed,
// for Hopper (sm_90a):
//
//   yt (F, P) = k^T (F, 9C) . patch^T (9C, P),   P = N*H*W pixels,
//   patch[p, (dr*3 + dc)*C + c] = x[n, h + dr - 1, w + dc - 1, c]   (0 outside)
//
// products in x's type, fp32 accumulation, yt in x's type.  The caller
// transposes yt back to NHWC (one copy outside the kernel, as the JAX package
// transposes outside its kernel).
//
// Replaces the Pallas TPU kernel `_tout_kernel` of
// llmmil_tpu/ops/pallas/conv3x3.py (`_conv_fwd(mode="tout")`, also its input
// gradient on the rotated, transposed kernel).  On the TPU the point of the
// transposed product is to put the pixel axis on the matrix unit's 128 output
// lanes, which 64 output channels would fill only half.  Here it is a GEMM
// whose M axis is the output channels (64, or 192 as an input gradient) and
// whose N axis is the pixels.
//
// bf16: the taps kernel with the operands' roles swapped, on `wgmma`, fed
// by TMA, warp-specialised: both are conv3x3_sm90.cuh's halo kernel, which
// stages, a chunk of 16 input channels, the tile's halo of x and the 9 x 16
// x 64 slab of k through a ring of `mbarrier`-signalled stages filled by a
// producer warp, on a persistent grid with output-channel tiles fastest (so
// the input gradient's three channel tiles, F = 192, read the same halo
// from L2).  This file supplies the products and the epilogue (struct Tout).
// A block owns 8 rows x 64 columns of output pixels and 64 output channels;
// each of its two consumer warpgroups owns 4 rows, one m64n64 fp32
// accumulator a row: 64 channels x 64 pixels of yt.  Each tap is one
// `wgmma.mma_async m64n64k16` a row and chunk:
//   - A, k^T of the tap (64 output channels x 16 input channels), is the
//     tap's 16 x 64 slab of k staged as it lies in k, 128 bytes (64 output
//     channels) a row, 128-byte swizzled: M-major, `wgmma`'s transpose flag
//     on A;
//   - B, patch^T of the tap (16 channels x 64 pixels), is the window of the
//     staged halo shifted by (dr, dc): pixel-major, 32 bytes (16 channels) a
//     pixel, 32-byte swizzled, which is K-major, B's own layout.  The 64
//     pixels of one output row lie in one halo row, 8 of them 256 bytes
//     (SBO) whatever the shift; the start lies off the swizzle's 256-byte
//     pattern and the descriptor's base offset stays 0, as in conv3x3.cu.
//   At a tile's end each warpgroup rounds its rows into boxes of 64 channel
//   rows of 64 pixels (128 bytes, 128-byte swizzled; a channel's row is
//   16-byte groups of one output row, so the eight channels a store
//   instruction writes fall on different banks) and one thread stores each
//   box with TMA into yt viewed as (F, N, H, W): an output row's 64 pixels
//   are 64 consecutive columns of yt, and TMA clips the box at W and F.
//   A tile of 4 x 128 pixels on m64n128k16 (half as many reads of A a
//   product, but 18 % more halo and a ring of 3 stages) ran 4-5 % slower
//   on the H100 (PERF.md) and is not kept.
//   Which loader, by shape: TMA needs 16-byte strides in device memory, so C,
//   F and W multiples of 8 take TMA loads and stores; other shapes take the
//   cp.async loader in the producer warp (conv3x3_sm90.cuh), writing the
//   same swizzled layout, and direct stores.
//
// What bounds it: 2*P*9*C*F operations against x read once and yt written
// once (at (160,128,128,192) -> 64 in bf16: 5.8e11 operations, 0.59 ms at the
// 989 TFLOP/s peak, against 1.34 GB, 0.40 ms at 3.35 TB/s): operations; the
// transpose back to NHWC outside moves y twice more.  From L2 it reads what
// the taps kernel reads: each tile's halo and its slab of k once, 2.43 GB a
// call.
//
// fp32: plain FMAs, 4 channels x 4 pixels a thread (parity only, no TF32),
// over explicit im2col tiles (one tap, KC channels) gathered with cp.async
// (conv3x3_im2col.cuh) beside the matching rows of k, through a ring of
// stages.
//
// Builds that skip one phase each (the CONV3X3_SKIP_* macros, driven by
// `eval/probe_conv3x3.py --kernel tout`) split the bf16 kernel's time
// between the loads of x and of k, the products and the stores.
//
// Plain C interface, no allocation, no synchronisation: the caller hands in
// the output and the stream to launch on.

#include "conv3x3_im2col.cuh"
#include "conv3x3_sm90.cuh"

namespace {

using im2col::Geo;
using namespace sm90;

template <typename T>
struct Tile;

template <>
struct Tile<float> {
  static constexpr int BF = 64;
  static constexpr int BP = 64;
  static constexpr int KC = 16;
  static constexpr int THREADS = 256;
  static constexpr int STAGES = 3;      // 9.3 KB each
  static constexpr int P_LD = KC + 4;
  static constexpr int K_LD = BF + 4;
  static constexpr int PS = BP * P_LD;
  static constexpr int KS = KC * K_LD;
};

template <typename T>
struct Acc;

// fp32: plain FMAs.  Thread (tp, tf) of 16 x 16 owns channels 4 tf .. 4 tf +
// 3 and pixels tp, tp + 16, tp + 32, tp + 48: neighbouring threads store
// neighbouring pixels of a row of yt.
template <>
struct Acc<float> {
  using G = Tile<float>;
  float c[4][4];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.0f;
  }

  __device__ void chunk(const float* ps, const float* ks) {
    const int tp = threadIdx.x & 15, tf = threadIdx.x >> 4;
#pragma unroll 4
    for (int k = 0; k < G::KC; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(ks + k * G::K_LD + tf * 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = ps[(tp + 16 * j) * G::P_LD + k];
        c[0][j] = fmaf(a.x, b, c[0][j]);
        c[1][j] = fmaf(a.y, b, c[1][j]);
        c[2][j] = fmaf(a.z, b, c[2][j]);
        c[3][j] = fmaf(a.w, b, c[3][j]);
      }
    }
  }

  __device__ void store(float* yt, float*, long long p0, int f0, long long P, int F) const {
    const int tp = threadIdx.x & 15, tf = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = f0 + tf * 4 + i;
      if (f >= F) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long p = p0 + tp + 16 * j;
        if (p < P) yt[(size_t)f * P + p] = c[i][j];
      }
    }
  }
};

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * Tile<T>::STAGES * (Tile<T>::PS + Tile<T>::KS);
}

// Block b: output-channel tile b % f_tiles, pixels (b / f_tiles) * BP ...
// The 9 * c_chunks K-chunks pass through a ring of STAGES stages, STAGES - 1
// in flight ahead of the one being multiplied.
template <typename T>
__global__ void __launch_bounds__(Tile<T>::THREADS)
conv3x3_tout_kernel(const T* __restrict__ x, const T* __restrict__ k, T* __restrict__ yt,
                    Geo g, int F, int c_chunks, int f_tiles) {
  using G = Tile<T>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  constexpr int STAGE = G::PS + G::KS;
  const int f0 = (int)(blockIdx.x % f_tiles) * G::BF;
  const long long p0 = (long long)(blockIdx.x / f_tiles) * G::BP;
  const int n_chunks = 9 * c_chunks;

  auto start_loads = [&](int q) {
    T* st = ring + (q % G::STAGES) * STAGE;
    const int tap = q / c_chunks, c0 = (q % c_chunks) * G::KC;
    im2col::load_patch<T, G::BP, G::KC, G::P_LD, G::THREADS>(st, x, p0, tap, c0, g);
    im2col::load_kernel<T, G::KC, G::BF, G::K_LD, G::THREADS>(st + G::PS, k, tap, c0, f0, g.C,
                                                              F);
    __pipeline_commit();
  };

  for (int q = 0; q < G::STAGES - 1 && q < n_chunks; ++q) start_loads(q);
  Acc<T> acc;
  acc.init();
  for (int q = 0; q < n_chunks; ++q) {
    im2col::wait_stage<G::STAGES>(q, n_chunks);
    __syncthreads();
    if (q + G::STAGES - 1 < n_chunks) start_loads(q + G::STAGES - 1);
    const T* st = ring + (q % G::STAGES) * STAGE;
    acc.chunk(st, st + G::PS);
  }
  __syncthreads();              // the ring is free for the output tile
  acc.store(yt, ring, p0, f0, g.P, F);
}

template <typename T>
cudaError_t launch(const void* x, const void* k, void* yt, int N, int H, int W, int C, int F,
                   cudaStream_t stream) {
  using G = Tile<T>;
  const Geo g{H, W, C, (long long)N * H * W};
  const int c_chunks = (C + G::KC - 1) / G::KC;
  const int f_tiles = (F + G::BF - 1) / G::BF;
  const long long blocks = (g.P + G::BP - 1) / G::BP * f_tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(conv3x3_tout_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  conv3x3_tout_kernel<T><<<(unsigned int)blocks, G::THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<T*>(yt), g, F, c_chunks,
      f_tiles);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16 --

namespace bf {

using namespace halo;

// The tout kernel on conv3x3_sm90.cuh's halo kernel, the taps kernel's
// operands swapped: M is the 64 output channels, N a row's 64 pixels.
struct Tout {
  // Warpgroup wg's products of one staged chunk: for each tap, its ROWS
  // output rows, one m64n64k16 each.  A, M-major (transpose flag), 128-byte
  // swizzle: the tap's 16 rows of k, 8 of them 1024 bytes (SBO), all 64
  // output channels in a row (LBO unused).  B, K-major, 32-byte swizzle: the
  // 64 pixels from halo pixel (row + dr, dc) on, 8 of them 256 bytes (SBO),
  // the whole k16 step in a pixel's 32 bytes.
  static __device__ __forceinline__ void products(float (&acc)[ROWS][32], const bf16* xs,
                                                  int wg) {
    const uint32_t x0 = smem_u32(xs), k0 = smem_u32(xs + XS);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dr = tap / 3, dc = tap % 3;
      const uint64_t a = smem_desc(k0 + tap * KC * FT * 2, 16, 1024, 1);
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        wgmma<1, 0>(acc[i], a,
                    smem_desc(x0 + ((wg * ROWS + i + dr) * HC + dc) * KC * 2, 16, 256, 3));
    }
  }

  // Warp q of a warpgroup holds output channels 16 q + lane / 4 and + 8 of
  // each of its rows, pixels 8 j + 2 (lane % 4) and + 1 of each group j of 8.

  // The warpgroup's rows rounded to bf16 into its output tile in shared
  // memory: box i holds row i, one 128-byte row of 64 pixels a channel
  // whose 16-byte groups are swizzled as TMA reads them (group j of row f at
  // j ^ (f % 8): the eight channels a store instruction writes fall on
  // different banks).
  static __device__ __forceinline__ void stage_out(const float (&acc)[ROWS][32], bf16* out) {
    const int q = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    char* base = reinterpret_cast<char*>(out);
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int f = q * 16 + g + half * 8;   // f % 8 == g
        char* row = base + (i * FT + f) * 128 + 4 * t;
#pragma unroll
        for (int j = 0; j < TW / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(row + ((j ^ g) << 4)) =
              __floats2bfloat162_rn(acc[i][4 * j + 2 * half], acc[i][4 * j + 2 * half + 1]);
      }
  }

  // The tile, one box of 64 pixels x FT channels a row into yt viewed as
  // (W, H, N, F): an output row's 64 pixels are 64 consecutive columns of
  // yt; TMA clips each box at W and F.
  static __device__ __forceinline__ void store_tma(const CUtensorMap* ymap, const bf16* out,
                                                   int n, int h1, int w0, int f0, int H) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      if (h1 + i < H) tma_store_4d(ymap, out + i * TW * FT, w0, h1 + i, n, f0);
  }

  // The warpgroup's rows written to yt directly (the cp.async loader's
  // shapes), masked at every edge.
  static __device__ __forceinline__ void store_direct(const float (&acc)[ROWS][32], bf16* yt,
                                                      int n, int h1, int w0, int f0, int N,
                                                      int H, int W, int F) {
    const int q = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const long long P = (long long)N * H * W;
    bf16* yn = yt + (size_t)n * H * W;     // yt's column of pixel (n, 0, 0)
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int h = h1 + i;
      if (h >= H) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int f = f0 + q * 16 + g + half * 8;
        if (f >= F) continue;
        bf16* row = yn + (size_t)f * P + (size_t)h * W;
#pragma unroll
        for (int j = 0; j < TW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int wd = w0 + j * 8 + 2 * t + e;
            if (wd < W) row[wd] = __float2bfloat16(acc[i][4 * j + 2 * half + e]);
          }
      }
    }
  }

  // C, F and W multiples of 8: yt's rows, W pixels of an image row apart,
  // need 16-byte strides too.
  static bool takes_tma(int C, int F, int W) { return C % 8 == 0 && F % 8 == 0 && W % 8 == 0; }

  // yt viewed as (W, H, N, F) in boxes of 64 pixels x 1 x 1 x FT, 128-byte
  // swizzled.
  static cudaError_t encode_y(CUtensorMap* map, void* yt, int N, int H, int W, int F) {
    const cuuint64_t e = sizeof(bf16);
    const cuuint64_t yd[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)F};
    const cuuint64_t ys[3] = {W * e, (cuuint64_t)H * W * e, (cuuint64_t)N * H * W * e};
    const cuuint32_t yb[4] = {TW, 1, 1, FT};
    return encode(map, yt, 4, yd, ys, yb, CU_TENSOR_MAP_SWIZZLE_128B);
  }
};

cudaError_t launch(const void* x, const void* k, void* yt, int N, int H, int W, int C, int F,
                   cudaStream_t stream) {
  return halo::launch<Tout>(x, k, yt, N, H, W, C, F, stream);
}

}  // namespace bf

}  // namespace

// x: (N, H, W, C) of dtype (0 = float32, 1 = bfloat16), contiguous; k:
// (3, 3, C, F) of the same type, contiguous; yt: (F, N*H*W) of the same type;
// all three 16-byte aligned.  Any N, H, W, C, F >= 1.  Returns 0, a
// cudaError_t, or -1 for a shape or type the kernel does not take.
extern "C" int conv3x3_tout_fwd(const void* x, const void* k, void* yt, int N, int H, int W,
                                int C, int F, int dtype, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, k, yt, N, H, W, C, F, s);
  if (dtype == 1) return (int)bf::launch(x, k, yt, N, H, W, C, F, s);
  return -1;
}
