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
// bf16: `wgmma`, fed by TMA, warp-specialised.  A block owns 8 rows x 64
// columns of output pixels and 64 output channels, and is two consumer
// warpgroups and one producer warp; warpgroup w owns rows 4w .. 4w + 3, one
// m64n64 fp32 accumulator a row (128 registers a thread).  Each tap is one
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
// Builds that skip one phase each (the CONV3X3_SKIP_* macros below, driven
// by eval/probe_conv3x3.py) split the time between the loads of x and of k,
// the products and the stores.  On an H100 (700 W), forward at
// (160,128,128,192) -> 64: whole 0.75 ms, products alone 0.66 (89 % of the
// bf16 peak), loads alone 0.44, without the stores 0.72; as the input
// gradient, 64 -> 192: 0.80, 0.67, 0.39, 0.71.  The products bound it, the
// loads and the stores hide behind them all but ~0.1 ms.
//
// Plain C interface, no allocation, no synchronisation: the caller hands in
// the output and the stream to launch on.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

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

using bf16 = __nv_bfloat16;

constexpr int TH = 8, TW = 64;           // output pixels of a block
constexpr int KC = 16;                   // input channels a chunk: one k16 step
constexpr int FT = 64;                   // output channels of a block: N
constexpr int ROWS = TH / 2;             // accumulators of a consumer thread
constexpr int THREADS = 288;             // two consumer warpgroups + 1 warp
constexpr int PRODUCER = 256;            // its first thread
constexpr int STAGES = 4;
constexpr int HR = TH + 2, HC = TW + 2;  // halo rows and columns
// One stage, as TMA writes it: the halo, [halo row][halo column][KC
// channels], 32 bytes a pixel, 32-byte swizzled (the two 16-byte halves of
// pixel p swapped where bit 2 of p is set); then k, [tap][channel][FT output
// channels], 128 bytes a row, 128-byte swizzled (16-byte group j of row r
// at j ^ (r % 8)).  Each starts on 1024 bytes.  Sizes in elements.
constexpr uint32_t X_BYTES = sizeof(bf16) * HR * HC * KC;
constexpr uint32_t K_BYTES = sizeof(bf16) * 9 * KC * FT;
constexpr int XS = (X_BYTES + 1023) / 1024 * 1024 / sizeof(bf16);
constexpr int STAGE = XS + 9 * KC * FT;
constexpr uint32_t STAGE_BYTES = sizeof(bf16) * STAGE;
// The output tile of a warpgroup, ROWS x TW pixels x FT channels, staged for
// its TMA store in 128-byte-swizzled rows of one pixel's FT channels.
constexpr int OUT = ROWS * TW * FT;
constexpr size_t SMEM_OUT = sizeof(bf16) * 2 * OUT;
// + 1024: room to align the output tiles; + the full and empty barriers
constexpr size_t SMEM = 1024 + SMEM_OUT + (size_t)STAGES * STAGE_BYTES + 2 * STAGES * 8;
static_assert(SMEM <= 232448, "the ring exceeds an SM's shared memory");
static_assert(XS * 2 % 1024 == 0 && STAGE_BYTES % 1024 == 0,
              "swizzled tiles start on 1024 bytes");
static_assert(KC * 2 == 32 && FT * 2 == 128, "the swizzles assume these widths");

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
__device__ __forceinline__ void fence_acc(float (&acc)[ROWS][32]) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < 32; ++j) asm volatile("" : "+f"(acc[i][j])::"memory");
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

// d (64 x 64 fp32, the warpgroup's fragment) += A (64 x 16, K-major) *
// B (16 x 64, MN-major: transpose flag set), both from shared memory.
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// The loader for shapes TMA does not take (C or F not a multiple of 8): the
// producer warp's 32 threads copy a chunk into the layout TMA would write,
// 16 bytes a cp.async where they are aligned and inside, element by element
// (zeros outside) elsewhere.
__device__ void load_chunk_cp_async(bf16* xs, const bf16* xn, const bf16* k, int h0, int w0,
                                    int f0, int c0, int H, int W, int C, int F, int lane) {
  bf16* ws = xs + XS;
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

// Warpgroup wg's products of one staged chunk: for each tap, its ROWS output
// rows, one m64n64k16 each.  A, K-major, 32-byte swizzle: the 64 pixels
// from (row + dr, dc) on, 8 of them 256 bytes (SBO), the whole k16 step in
// a pixel's 32 bytes; its start moves with the tap by whole pixels, off the
// swizzle's 256-byte pattern, which the card allows.  B, MN-major (transpose
// flag), 128-byte swizzle: the tap's 16 rows of k, 8 of them 1024 bytes
// (SBO), all 64 output channels in a row (LBO unused).
__device__ __forceinline__ void products(float (&acc)[ROWS][32], const bf16* xs, int wg) {
  const uint32_t a0 = smem_u32(xs), b0 = smem_u32(xs + XS);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dr = tap / 3, dc = tap % 3;
    const uint64_t b = smem_desc(b0 + tap * KC * FT * 2, 16, 1024, 1);
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      wgmma_64x64(acc[i], smem_desc(a0 + ((wg * ROWS + i + dr) * HC + dc) * KC * 2, 16, 256, 3),
                  b);
  }
}

// Warp q of a warpgroup holds pixels 16 q + lane / 4 and + 8 of each of its
// rows, output channels 8 j + 2 (lane % 4) and + 1 of each group j of 8.

// The warpgroup's rows rounded to bf16 into its output tile in shared
// memory, one 128-byte row a pixel whose 16-byte groups are swizzled as TMA
// reads them (group j of row r at j ^ (r % 8): the eight pixels a store
// instruction writes fall on different banks).
__device__ __forceinline__ void stage_out(const float (&acc)[ROWS][32], bf16* out) {
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

// The warpgroup's rows written to y directly (the cp.async loader's shapes),
// masked at every edge.
__device__ __forceinline__ void store_direct(const float (&acc)[ROWS][32], bf16* yn, int h0,
                                             int w0, int f0, int H, int W, int F, int wg) {
  const int q = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (F & 1) == 0;       // a pair of channels is 4-byte aligned
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int h = h0 + wg * ROWS + i;
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

// Warp-specialised and persistent.  Block b takes tiles b, b + gridDim.x,
// ...; tile t is output-channel tile t % f_tiles (fastest), then the column
// tile, the row tile, the image.  Its last warp is the producer: it walks
// the chunks of all of the block's tiles and fills stage g % STAGES with
// chunk g once both warpgroups have released that stage's previous chunk
// (`empty`, one arrival a consumer warp), signalling `full` when the bytes
// have landed (TMA: one thread, transaction bytes; cp.async: 32 arrivals).
// The two warpgroups each wait for `full`, issue the chunk's 36 products,
// and release the chunk before it once those have retired, so that one
// chunk's products are always queued behind the running ones.  At a tile's
// end each writes its rows: with TMA it stages them in shared memory and
// one thread stores them asynchronously, so the next tile's products start
// while the store drains.
template <bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_fwd_wgmma(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap ymap, const bf16* __restrict__ x,
                  const bf16* __restrict__ k, bf16* __restrict__ y, int H, int W, int C, int F,
                  int tiles_h, int tiles_w, int f_tiles, unsigned int total_tiles) {
  extern __shared__ __align__(1024) unsigned char bf_smem[];
  // the swizzled output tiles want 1024-byte alignment
  unsigned char* base = bf_smem + ((1024 - smem_u32(bf_smem) % 1024) % 1024);
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
        load_chunk_cp_async(xs, x + (size_t)n * H * W * C, k, h0, w0, f0, c0, H, W, C, F,
                            lane);
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
      products(acc, ring + s * STAGE, wg);
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
    if (TMA) {
      if (wg_leader) tma_store_wait_read();   // the last store has left my_out
      warpgroup_sync(wg);
      stage_out(acc, my_out);
      fence_proxy_async();                 // the staged tile, for TMA
      warpgroup_sync(wg);
      if (wg_leader && h0 + wg * ROWS < H) tma_store_4d(&ymap, my_out, f0, w0, h0 + wg * ROWS, n);
    } else {
      store_direct(acc, y + (size_t)n * H * W * F, h0, w0, f0, H, W, F, wg);
    }
  }
  if (TMA && wg_leader) tma_store_wait();
}

// cuTensorMapEncodeTiled, looked up through the runtime
// (cudaGetDriverEntryPoint), so that the library needs no link against
// libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode(CUtensorMap* map, const void* ptr, cuuint32_t rank, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                        strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The loader and the store are chosen by shape: TMA needs 16-byte strides in
// device memory, so C and F multiples of 8 (every shape of the trunk) take
// the TMA kernel; other shapes take the cp.async loader and direct stores.
// Neither is a fallback for the other: a launch that fails returns its
// error.  The tensor maps are built here for each call: x (C, W, H, N) in
// boxes of 8 channels x HC x HR pixels, whose zero fill outside the tensor
// is the SAME padding and the ragged edges; k (F, C, 9 taps) in boxes of 8
// output channels x KC x 9; y (F, W, H, N) in boxes of FT x TW x ROWS,
// 128-byte swizzled, clipped at the edges.
cudaError_t launch(const void* x, const void* k, void* y, int N, int H, int W, int C, int F,
                   cudaStream_t stream) {
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const int f_tiles = (F + FT - 1) / FT;
  const long long tiles = (long long)N * tiles_h * tiles_w * f_tiles;
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  const bool tma = C % 8 == 0 && F % 8 == 0;
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
    const cuuint64_t yd[4] = {(cuuint64_t)F, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
    const cuuint64_t ys[3] = {F * e, (cuuint64_t)W * F * e, (cuuint64_t)H * W * F * e};
    const cuuint32_t yb[4] = {FT, TW, ROWS, 1};
    if ((err = encode(&maps[0], x, 4, xd, xs, xb, CU_TENSOR_MAP_SWIZZLE_32B)) != cudaSuccess ||
        (err = encode(&maps[1], k, 3, kd, ks, kb, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
        (err = encode(&maps[2], y, 4, yd, ys, yb, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess)
      return err;
  }
  auto kernel = tma ? conv3x3_fwd_wgmma<true> : conv3x3_fwd_wgmma<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  unsigned int grid = 0;
  err = persistent_grid(kernel, THREADS, SMEM, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const bf16*>(x), static_cast<const bf16*>(k),
      static_cast<bf16*>(y), H, W, C, F, tiles_h, tiles_w, f_tiles, (unsigned int)tiles);
  return cudaGetLastError();
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
