// 3x3 stride-1 SAME convolution of an NHWC tensor for Hopper (sm_90a).
//
//   y[n, h, w, f] = sum_{dr, dc, c} x[n, h + dr - 1, w + dc - 1, c] * k[dr, dc, c, f]
//
// with x read as zero outside the image, products in x's type, fp32
// accumulation, y in x's type.  The input gradient is this same function of
// g on the rotated, transposed kernel (ops/kernels/conv3x3.py), so one bf16
// design serves the trunk's forward, C = 192 -> F = 64, and its input
// gradient, C = 64 -> F = 192.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// llmmil_tpu/ops/pallas/conv3x3.py (`_conv_fwd(mode="taps")`, also run as
// the input gradient of its custom VJP).  That kernel pads the tensor in
// device memory first and keeps one whole padded image resident in fast
// memory across its row blocks.  An SM has 227 KB of shared memory, so here
// a block owns a tile of output pixels and FT output channels and walks the
// input channels in chunks of KC; per chunk it stages the tile's halo of x
// and the 9 x KC x FT slab of k, and the nine taps are nine shifted windows
// of the same staged halo, so no im2col matrix exists anywhere.  Pixels
// outside the image, channels past C and columns past F are staged as
// zeros: the SAME padding and every ragged edge are the kernel's, nothing is
// padded or copied in device memory.
//
// bf16: `wgmma`, fed by TMA, warp-specialised: conv3x3_sm90.cuh's halo
// kernel, which conv3x3_tout.cu shares, with this file's products and
// epilogue (struct Taps).  A block owns 8 rows x 64 columns of output
// pixels and 64 output channels, and is two consumer warpgroups and one
// producer warp; warpgroup w owns rows 4w .. 4w + 3, one m64n64 fp32
// accumulator a row (128 registers a thread).  Each tap is one
// `wgmma.mma_async m64n64k16` a row and chunk (KC = 16 = one k16 step):
//   - A, the 64 pixels of one output row at one tap, is read from the staged
//     halo.  A `wgmma` operand is a grid of 8-row core matrices at uniform
//     strides, so 64 pixels of M must lie in one halo row: a tile is rows of
//     64 pixels, not a square patch.  The halo is staged pixel-major, 32
//     bytes (16 channels) a pixel, 32-byte swizzled, K-major: the 8 pixels
//     from any pixel on are one core-matrix group 256 bytes long (SBO), so a
//     tap's A is the descriptor of pixel (r + dr, dc), whatever the shift.
//     The start then lies off the swizzle's 256-byte pattern; the card
//     swizzles by address bits, so the descriptor's base offset stays 0.
//   - B, the tap's 16 x 64 slab of k, is staged as it lies in k, 128 bytes
//     (64 output channels) a row, 128-byte swizzled, MN-major with
//     `wgmma`'s transpose flag.
//   Swizzled operands meet no bank conflicts in `wgmma`'s reads.  A first
//   version staged both without swizzle (16-byte rows: 8 channels a pixel
//   in one plane a channel group, 8 output channels a row of k); its TMA
//   boxes then moved 16 bytes a row, half of each 32-byte L2 sector, and
//   the loads alone took as long as the whole kernel.
//   Loads: the producer's one thread issues, a chunk, one TMA box of the
//   halo, (16 channels, 66 columns, 10 rows) of x from (c0, w0 - 1, h0 - 1)
//   on, whose zero fill outside the tensor is the SAME padding and every
//   ragged edge, and one box (64, 16, 9) of k, into a ring of 4 stages of
//   39 KB, signalled on `mbarrier`s (`full`: bytes landed; `empty`: both
//   warpgroups have retired the stage's products).  The consumers never
//   meet at a block barrier: each waits for its chunk, queues its 36
//   products behind the running ones and releases the chunk before.  At a
//   tile's end each warpgroup rounds its rows into a 128-byte-swizzled
//   tile in shared memory and one thread stores it with TMA, so the next
//   tile's products start while the store drains.  The grid is persistent
//   (one block an SM), tile t being output-channel tile t % f_tiles
//   (fastest), then the column tile, the row tile, the image, so that the
//   input gradient's three channel tiles (F = 192) run at once on
//   neighbouring SMs and read the same halo from L2.  That is the choice
//   against one N = 192 tile, which would stage each halo once but hold a
//   third as many pixels a block (96 accumulator registers a row) and so
//   read k from L2 three times as often: 2.43 GB a call against ~3.3 GB.
//   Which loader, by shape: TMA needs 16-byte strides in device memory, so
//   C and F multiples of 8 (every shape of the trunk); other shapes (C = 20
//   or F = 70 in chip_smoke.py) take a cp.async loader in the producer
//   warp, writing the same swizzled layout, and direct stores.
//
// What bounds it: at (160,128,128,192) -> 64 in bf16 it does 5.8e11
// operations (0.59 ms at the 989 TFLOP/s peak) against 1.34 GB moved (0.40
// ms at 3.35 TB/s): operations.  From L2 it reads, a call, each tile's halo
// (10 x 66 pixels for 8 x 64) and its slab of k once: 5120 tiles x (253 KB
// + 221 KB) = 2.43 GB at the forward's shape, the same at the input
// gradient's (15360 tiles x (84 KB + 74 KB)); the mma.sync design it
// replaced read ~3.5 GB with 16 x 16 tiles.  k is still read once a tile;
// TMA multicast across a cluster would share it.
//
// fp32: plain FMAs, 4 pixels x 4 channels a thread (parity only, no TF32),
// through a ring of `cp.async` stages with a (TH+2) x (TW+2) x KC halo patch
// (pixel stride X_LD) and a 9 x KC x FT slab of k (row stride W_LD), on a
// persistent grid, three blocks an SM.
//
// Builds that skip one phase each (the CONV3X3_SKIP_* macros, here and in
// the halo kernel, driven by eval/probe_conv3x3.py) split the time between
// the loads of x and of k, the products and the stores.  On an H100 (700
// W), forward at
// (160,128,128,192) -> 64: whole 0.75 ms, products alone 0.66 (89 % of the
// bf16 peak), loads alone 0.44, without the stores 0.72; as the input
// gradient, 64 -> 192: 0.80, 0.67, 0.39, 0.71.  The products bound it, the
// loads and the stores hide behind them all but ~0.1 ms.
//
// Plain C interface, no allocation, no synchronisation: the caller hands in
// the output and the stream to launch on.

#include <cuda_pipeline.h>

#include "conv3x3_sm90.cuh"

namespace {

using namespace sm90;

// The tile of one block for tensors of type T, and one stage of its ring in
// shared memory: the halo patch (pixel stride X_LD), then the slab of k (row
// stride W_LD).
template <typename T>
struct Tile;

template <>
struct Tile<float> {
  static constexpr int TH = 8, TW = 16;
  static constexpr int KC = 16;
  static constexpr int FT = 32;
  static constexpr int THREADS = 256;
  static constexpr int STAGES = 2;        // 33 KB each
  static constexpr int BLOCKS_PER_SM = 3;
  static constexpr int X_LD = KC + 4;     // 4 neighbouring pixels on 4 banks
  static constexpr int W_LD = FT;
  static constexpr int XS = (TH + 2) * (TW + 2) * X_LD;
  static constexpr int WS = 9 * KC * W_LD;
};

// One chunk of KC input channels from c0 on: the block's halo patch of image
// xn and its slab of k, into one stage, asynchronously where 16 bytes are
// aligned and inside, element by element (zeros outside) elsewhere.
template <typename T>
__device__ __forceinline__ void load_chunk(T* xs, const T* xn, const T* k,
                                           int h0, int w0, int f0, int c0,
                                           int H, int W, int C, int F) {
  using G = Tile<T>;
  T* ws = xs + G::XS;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int XV = G::KC / VEC;
  const bool x_vec = C % VEC == 0;       // every pixel starts on 16 bytes
  for (int i = threadIdx.x; i < (G::TH + 2) * (G::TW + 2) * XV; i += G::THREADS) {
    const int v = i % XV, p = i / XV;
    const int h = h0 + p / (G::TW + 2) - 1, wd = w0 + p % (G::TW + 2) - 1;
    const int c = c0 + v * VEC;
    const bool inside = h >= 0 && h < H && wd >= 0 && wd < W;
    T* dst = xs + p * G::X_LD + v * VEC;
#ifdef CONV3X3_SKIP_X
    if (c0 > 0) continue;
#endif
    if (inside && x_vec && c + VEC <= C) {
      __pipeline_memcpy_async(dst, xn + ((size_t)h * W + wd) * C + c, 16);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      if (inside) {
        const T* src = xn + ((size_t)h * W + wd) * C;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (c + j < C) dst[j] = src[c + j];
      }
    }
  }
  constexpr int WV = G::FT / VEC;
  const bool w_vec = F % VEC == 0;
  for (int i = threadIdx.x; i < 9 * G::KC * WV; i += G::THREADS) {
    const int v = i % WV, r = i / WV;    // r = tap * KC + channel of the chunk
    const int tap = r / G::KC, c = c0 + r % G::KC;
    const int f = f0 + v * VEC;
    T* dst = ws + r * G::W_LD + v * VEC;
#ifdef CONV3X3_SKIP_W
    if (c0 > 0) continue;
#endif
    if (c < C && w_vec && f + VEC <= F) {
      __pipeline_memcpy_async(dst, k + ((size_t)tap * C + c) * F + f, 16);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      if (c < C) {
        const T* src = k + ((size_t)tap * C + c) * F;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (f + j < F) dst[j] = src[f + j];
      }
    }
  }
  __pipeline_commit();
}

// A block's accumulators: chunk() adds one staged chunk's nine tap products,
// store() writes the tile.
template <typename T>
struct Acc;


// fp32: plain FMAs.  Thread (tp, tf) of 32 x 8 owns channels 4 tf .. 4 tf + 3
// and the four pixels (row tp / 16 + 2 j, column tp % 16), j = 0..3.
template <>
struct Acc<float> {
  using G = Tile<float>;
  float c[4][4];

  __device__ void init() {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[j][q] = 0.0f;
  }

  __device__ void chunk(const float* xs, const float* ws) {
    const int tf = threadIdx.x & 7, tp = threadIdx.x >> 3;
    const int pr = tp >> 4, pc = tp & 15;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dr = tap / 3, dc = tap % 3;
      const float* xb = xs + ((pr + dr) * (G::TW + 2) + pc + dc) * G::X_LD;
      const float* wb = ws + tap * G::KC * G::W_LD + tf * 4;
#pragma unroll 4
      for (int k = 0; k < G::KC; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(wb + k * G::W_LD);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float xv = xb[2 * j * (G::TW + 2) * G::X_LD + k];
          c[j][0] = fmaf(xv, wv.x, c[j][0]);
          c[j][1] = fmaf(xv, wv.y, c[j][1]);
          c[j][2] = fmaf(xv, wv.z, c[j][2]);
          c[j][3] = fmaf(xv, wv.w, c[j][3]);
        }
      }
    }
  }

  __device__ void store(float* yn, int h0, int w0, int f0, int H, int W, int F) const {
    const int tf = threadIdx.x & 7, tp = threadIdx.x >> 3;
    const int wd = w0 + (tp & 15);
    if (wd >= W) return;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = h0 + (tp >> 4) + 2 * j;
      if (h >= H) continue;
      float* px = yn + ((size_t)h * W + wd) * F;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int f = f0 + tf * 4 + q;
        if (f < F) px[f] = c[j][q];
      }
    }
  }
};

// The grid is persistent: block b takes tiles b, b + gridDim.x, ... so that
// the blocks running at one moment work on neighbouring tiles and find each
// other's halo pixels and slab of k in L2.  Tile t is channel tile
// t % f_tiles (fastest), then the patch column, the patch row and the image.
// The chunks of all of a block's tiles form one stream through a ring of
// STAGES stages: the loads of a tile's first chunks are in flight while the
// tile before it finishes its products and writes its output.
template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * Tile<T>::STAGES * (Tile<T>::XS + Tile<T>::WS);
}

template <typename T>
__global__ void __launch_bounds__(Tile<T>::THREADS, Tile<T>::BLOCKS_PER_SM)
conv3x3_fwd_kernel(const T* __restrict__ x, const T* __restrict__ k, T* __restrict__ y,
                   int H, int W, int C, int F, int tiles_h, int tiles_w, int f_tiles,
                   unsigned int total_tiles) {
  using G = Tile<T>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  constexpr int STAGE = G::XS + G::WS;
  const int n_chunks = (C + G::KC - 1) / G::KC;
  if (blockIdx.x >= total_tiles) return;
  const unsigned int my_tiles = (total_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const unsigned int my_chunks = my_tiles * n_chunks;

  // where tile t lies
  auto place = [&](unsigned int t, int& h0, int& w0, int& f0, size_t& n) {
    f0 = (int)(t % f_tiles) * G::FT;
    t /= f_tiles;
    w0 = (int)(t % tiles_w) * G::TW;
    t /= tiles_w;
    h0 = (int)(t % tiles_h) * G::TH;
    n = t / tiles_h;
  };
  // start the loads of chunk g of this block's stream into its stage
  auto start_loads = [&](unsigned int g) {
    int h0, w0, f0;
    size_t n;
    place(blockIdx.x + (g / n_chunks) * gridDim.x, h0, w0, f0, n);
    load_chunk<T>(ring + (g % G::STAGES) * STAGE, x + n * H * W * C, k, h0, w0, f0,
                  (int)(g % n_chunks) * G::KC, H, W, C, F);
  };

  // STAGES - 1 chunks are in flight ahead of the one being multiplied
  for (unsigned int g = 0; g < G::STAGES - 1 && g < my_chunks; ++g) start_loads(g);
  Acc<T> acc;
  unsigned int g = 0;
  for (unsigned int t = 0; t < my_tiles; ++t) {
    acc.init();
    for (int c = 0; c < n_chunks; ++c, ++g) {
      // chunk g has landed once only the younger groups are still in flight
      if (g + G::STAGES - 1 <= my_chunks) {
        __pipeline_wait_prior(G::STAGES - 2);
      } else {
        __pipeline_wait_prior(0);
      }
      // after this barrier every thread sees chunk g and has finished the
      // products of chunk g - 1, whose stage the next load may now overwrite
      __syncthreads();
      if (g + G::STAGES - 1 < my_chunks) start_loads(g + G::STAGES - 1);
      const T* xs = ring + (g % G::STAGES) * STAGE;
#ifndef CONV3X3_SKIP_MMA
      acc.chunk(xs, xs + G::XS);
#endif
    }
    int h0, w0, f0;
    size_t n;
    place(blockIdx.x + t * gridDim.x, h0, w0, f0, n);
#ifndef CONV3X3_SKIP_STORE
    acc.store(y + n * H * W * F, h0, w0, f0, H, W, F);
#else
    if (h0 < 0) acc.store(y + n * H * W * F, h0, w0, f0, H, W, F);  // never
#endif
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* k, void* y, int N, int H, int W,
                   int C, int F, cudaStream_t stream) {
  using G = Tile<T>;
  const int tiles_h = (H + G::TH - 1) / G::TH;
  const int tiles_w = (W + G::TW - 1) / G::TW;
  const int f_tiles = (F + G::FT - 1) / G::FT;
  const long long tiles = (long long)N * tiles_h * tiles_w * f_tiles;
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(conv3x3_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  unsigned int grid = 0;
  err = persistent_grid(conv3x3_fwd_kernel<T>, G::THREADS, smem, tiles, &grid);
  if (err != cudaSuccess) return err;
  conv3x3_fwd_kernel<T><<<grid, G::THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<T*>(y),
      H, W, C, F, tiles_h, tiles_w, f_tiles, (unsigned int)tiles);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16 --

namespace bf {

using namespace halo;

// The taps kernel on conv3x3_sm90.cuh's halo kernel: M is a row's 64 pixels,
// N the 64 output channels.
struct Taps {
  // Warpgroup wg's products of one staged chunk: for each tap, its ROWS
  // output rows, one m64n64k16 each.  A, K-major, 32-byte swizzle: the 64
  // pixels from (row + dr, dc) on, 8 of them 256 bytes (SBO), the whole k16
  // step in a pixel's 32 bytes; its start moves with the tap by whole
  // pixels, off the swizzle's 256-byte pattern, which the card allows.  B,
  // MN-major (transpose flag), 128-byte swizzle: the tap's 16 rows of k, 8
  // of them 1024 bytes (SBO), all 64 output channels in a row (LBO unused).
  static __device__ __forceinline__ void products(float (&acc)[ROWS][32], const bf16* xs,
                                                  int wg) {
    const uint32_t a0 = smem_u32(xs), b0 = smem_u32(xs + XS);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dr = tap / 3, dc = tap % 3;
      const uint64_t b = smem_desc(b0 + tap * KC * FT * 2, 16, 1024, 1);
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        wgmma<0, 1>(acc[i],
                    smem_desc(a0 + ((wg * ROWS + i + dr) * HC + dc) * KC * 2, 16, 256, 3), b);
    }
  }

  // Warp q of a warpgroup holds pixels 16 q + lane / 4 and + 8 of each of
  // its rows, output channels 8 j + 2 (lane % 4) and + 1 of each group j of
  // 8.

  // The warpgroup's rows rounded to bf16 into its output tile in shared
  // memory, one 128-byte row a pixel whose 16-byte groups are swizzled as
  // TMA reads them (group j of row r at j ^ (r % 8): the eight pixels a
  // store instruction writes fall on different banks).
  static __device__ __forceinline__ void stage_out(const float (&acc)[ROWS][32], bf16* out) {
    const int q = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    char* base = reinterpret_cast<char*>(out);
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = i * TW + q * 16 + g + half * 8;   // r % 8 == g
        char* row = base + r * 128 + 4 * t;
#pragma unroll
        for (int j = 0; j < FT / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(row + ((j ^ g) << 4)) =
              __floats2bfloat162_rn(acc[i][4 * j + 2 * half], acc[i][4 * j + 2 * half + 1]);
      }
  }

  // The tile, one box of FT channels x TW pixels x ROWS rows into y (F, W,
  // H, N), clipped by TMA at the edges.
  static __device__ __forceinline__ void store_tma(const CUtensorMap* ymap, const bf16* out,
                                                   int n, int h, int w0, int f0, int H) {
    if (h < H) tma_store_4d(ymap, out, f0, w0, h, n);
  }

  // The warpgroup's rows written to y directly (the cp.async loader's
  // shapes), masked at every edge.
  static __device__ __forceinline__ void store_direct(const float (&acc)[ROWS][32], bf16* y,
                                                      int n, int h1, int w0, int f0, int,
                                                      int H, int W, int F) {
    const int q = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const bool pairs = (F & 1) == 0;       // a pair of channels is 4-byte aligned
    bf16* yn = y + (size_t)n * H * W * F;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int h = h1 + i;
      if (h >= H) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int wd = w0 + q * 16 + g + half * 8;
        if (wd >= W) continue;
        bf16* px = yn + ((size_t)h * W + wd) * F;
#pragma unroll
        for (int j = 0; j < FT / 8; ++j) {
          const int f = f0 + j * 8 + 2 * t;
          const float v0 = acc[i][4 * j + 2 * half], v1 = acc[i][4 * j + 2 * half + 1];
          if (pairs && f + 1 < F) {
            *reinterpret_cast<__nv_bfloat162*>(px + f) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (f < F) px[f] = __float2bfloat16(v0);
            if (f + 1 < F) px[f + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
  }

  // C and F multiples of 8: every shape of the trunk.  Other shapes (C = 20
  // or F = 70 in chip_smoke.py) take the cp.async loader.
  static bool takes_tma(int C, int F, int) { return C % 8 == 0 && F % 8 == 0; }

  // y (F, W, H, N) in boxes of FT x TW x ROWS, 128-byte swizzled.
  static cudaError_t encode_y(CUtensorMap* map, void* y, int N, int H, int W, int F) {
    const cuuint64_t e = sizeof(bf16);
    const cuuint64_t yd[4] = {(cuuint64_t)F, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
    const cuuint64_t ys[3] = {F * e, (cuuint64_t)W * F * e, (cuuint64_t)H * W * F * e};
    const cuuint32_t yb[4] = {FT, TW, ROWS, 1};
    return encode(map, y, 4, yd, ys, yb, CU_TENSOR_MAP_SWIZZLE_128B);
  }
};

cudaError_t launch(const void* x, const void* k, void* y, int N, int H, int W, int C, int F,
                   cudaStream_t stream) {
  return halo::launch<Taps>(x, k, y, N, H, W, C, F, stream);
}

}  // namespace bf

}  // namespace

// x: (N, H, W, C) of dtype (0 = float32, 1 = bfloat16), contiguous; k:
// (3, 3, C, F) and y: (N, H, W, F) of the same type, contiguous; all three
// 16-byte aligned.  Any N, H, W, C, F >= 1.  Returns 0, a cudaError_t, or -1
// for a shape or type the kernel does not take.
extern "C" int conv3x3_fwd(const void* x, const void* k, void* y, int N, int H,
                           int W, int C, int F, int dtype, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, k, y, N, H, W, C, F, s);
  if (dtype == 1) return (int)bf::launch(x, k, y, N, H, W, C, F, s);
  return -1;
}
