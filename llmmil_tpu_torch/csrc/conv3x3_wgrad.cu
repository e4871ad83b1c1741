// Weight gradient of the 3x3 stride-1 SAME convolution of an NHWC tensor, for
// Hopper (sm_90a).
//
//   dw[dr, dc, c, f] = sum_{n, h, w} x[n, h + dr - 1, w + dc - 1, c] * dy[n, h, w, f]
//
// with x read as zero outside the image, x and dy in one type (bf16 or fp32),
// products exact in fp32, fp32 accumulation, dw in fp32.
//
// Replaces the Pallas TPU kernel `_wgrad_kernel` of
// llmmil_tpu/ops/pallas/conv3x3.py (`_conv_wgrad(mode="taps")`).  That kernel
// walks its grid in order on one core and adds every row block into one
// VMEM-resident (9C, F) accumulator.  Here blocks run in parallel and in no
// order, and the reduction is huge against a tiny output (2.6M pixels per
// CT volume against a 1728 x 64 result), so the pixel axis (the GEMM's K) is
// cut into `splits` contiguous ranges, each block keeps its partial in
// registers across a range, and a second kernel adds the partials of each
// element in a fixed order: no float atomics, two runs give the same bits.
// Nothing is padded or copied in device memory: pixels outside the image,
// channels past C and columns past F are staged as zeros.
//
// bf16: `wgmma`, fed by TMA, warp-specialised: conv3x3_sm90.cuh's
// weight-gradient kernel (namespace wgrad), which conv3x3_wgrad_tout.cu
// shares, with this file's operand roles and epilogue (struct Taps).  A
// unit of work is 64 input channels, 64 output channels and a range of
// pixel tiles of 4 x 64 pixels (at most 128 tiles, whole waves of units);
// per tile the producer warp stages the tile's halo of x (6 x 66 pixels of
// 64 channels, one TMA box whose zero fill is the SAME padding) and its dy
// (4 x 64 pixels of 64 output channels), both 128-byte swizzled, and each
// of three consumer warpgroups (tap row dr) runs, a k16 step of 16 pixels,
// one `wgmma.mma_async m64n64k16` a tap (dr, dc): A, 64 channels x 16
// pixels, is the window of the halo shifted by (dr, dc); B, 16 pixels x 64
// output channels, is dy.  Both have the pixels as their strided axis
// (MN-major, the transpose flags).  At the range's end each warpgroup
// writes its three taps' 64 x 64 partials into [split][tap * C + c][f].
// Shapes whose C or F is not a multiple of 8 take a cp.async loader in the
// producer warp that writes the same layout.
//
// What bounds it: at (160,128,128,192) x (..,64) in bf16 it does 5.8e11
// operations (0.59 ms at the 989 TFLOP/s peak) against 1.34 GB moved (0.40 ms
// at 3.35 TB/s): operations.  From L2 it reads the halo, 1.55 times x, and
// dy once a channel tile (three times at C = 192): ~2.6 GB a call.  The
// three channel tiles of a range are neighbours in the grid, so dy's second
// and third reads hit L2; TMA multicast of dy across a cluster of them
// would make them one.
//
// fp32: plain FMAs, 8 channels x 8 output channels a thread (parity only, no
// TF32), over a (8+2) x (16+2) x 32 halo patch and an 8 x 16 x 64 tile of
// dy staged with cp.async through a ring of stages; warp w (of 9) owns tap
// w; ranges of at most 128 such tiles.
//
// Builds that skip one phase each (the CONV3X3_SKIP_* macros of the shared
// kernel, driven by `eval/probe_conv3x3.py --kernel wgrad`) split the bf16
// kernel's time between the loads of x and of dy, the products and the
// stores of the partials.
//
// Plain C interface, no allocation, no synchronisation: the caller hands in
// the workspace, the output and the stream to launch on.

#include <cuda_pipeline.h>

#include "conv3x3_sm90.cuh"

namespace {

// The work of one block for tensors of type T, and one stage of its ring in
// shared memory: the halo patch of x (pixel stride X_LD), then the tile of dy
// (pixel stride D_LD).
template <typename T>
struct Tile;

template <>
struct Tile<float> {
  static constexpr int TH = 8, TW = 16;
  static constexpr int KC = 32;
  static constexpr int FT = 64;
  static constexpr int THREADS = 288;
  static constexpr int STAGES = 2;        // 59 KB each
  static constexpr int BLOCKS_PER_SM = 1;
  static constexpr int X_LD = KC + 4;     // float4 loads stay 16-byte aligned
  static constexpr int D_LD = FT + 4;
  static constexpr int XS = (TH + 2) * (TW + 2) * X_LD;
  static constexpr int DS = TH * TW * D_LD;
};

// One pixel tile with its top-left output pixel (h0, w0) of image n: the halo
// patch of x for channels c0.., the tile of dy for output channels f0.., into
// one stage, asynchronously where 16 bytes are aligned and inside, element
// by element (zeros outside) elsewhere.
template <typename T>
__device__ __forceinline__ void load_tile(T* xs, const T* xn, const T* dyn, int h0, int w0,
                                          int c0, int f0, int H, int W, int C, int F) {
  using G = Tile<T>;
  T* ds = xs + G::XS;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int XV = G::KC / VEC;
  const bool x_vec = C % VEC == 0;       // every pixel starts on 16 bytes
  for (int i = threadIdx.x; i < (G::TH + 2) * (G::TW + 2) * XV; i += G::THREADS) {
    const int v = i % XV, p = i / XV;
    const int h = h0 + p / (G::TW + 2) - 1, wd = w0 + p % (G::TW + 2) - 1;
    const int c = c0 + v * VEC;
    const bool inside = h >= 0 && h < H && wd >= 0 && wd < W;
    T* dst = xs + p * G::X_LD + v * VEC;
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
  constexpr int DV = G::FT / VEC;
  const bool d_vec = F % VEC == 0;
  for (int i = threadIdx.x; i < G::TH * G::TW * DV; i += G::THREADS) {
    const int v = i % DV, p = i / DV;
    const int h = h0 + p / G::TW, wd = w0 + p % G::TW;
    const int f = f0 + v * VEC;
    const bool inside = h < H && wd < W;
    T* dst = ds + p * G::D_LD + v * VEC;
    if (inside && d_vec && f + VEC <= F) {
      __pipeline_memcpy_async(dst, dyn + ((size_t)h * W + wd) * F + f, 16);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      if (inside) {
        const T* src = dyn + ((size_t)h * W + wd) * F;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (f + j < F) dst[j] = src[f + j];
      }
    }
  }
  __pipeline_commit();
}

// A block's partial: tile() adds one staged pixel tile's products, store()
// writes the partial into the workspace ([tap][c][f], fp32).
template <typename T>
struct Acc;

// fp32: plain FMAs.  Warp w owns tap w; lane (cg, fg) of 4 x 8 owns channels
// 8 cg .. 8 cg + 7 and output channels 8 fg .. 8 fg + 7.
template <>
struct Acc<float> {
  using G = Tile<float>;
  float c[8][8];

  __device__ void init() {
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) c[a][b] = 0.0f;
  }

  __device__ void tile(const float* xs, const float* ds) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int dr = warp / 3, dc = warp % 3;
    const int cg = lane >> 3, fg = lane & 7;
#pragma unroll 2
    for (int p = 0; p < G::TH * G::TW; ++p) {
      const int i = p / G::TW, j = p % G::TW;
      const float* xp = xs + ((i + dr) * (G::TW + 2) + j + dc) * G::X_LD + cg * 8;
      const float* dp = ds + p * G::D_LD + fg * 8;
      const float4 x0 = *reinterpret_cast<const float4*>(xp);
      const float4 x1 = *reinterpret_cast<const float4*>(xp + 4);
      const float4 d0 = *reinterpret_cast<const float4*>(dp);
      const float4 d1 = *reinterpret_cast<const float4*>(dp + 4);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) c[a][b] = fmaf(xv[a], dv[b], c[a][b]);
    }
  }

  __device__ void store(float* part, int c0, int f0, int C, int F) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int cg = lane >> 3, fg = lane & 7;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int ch = c0 + cg * 8 + a;
      if (ch >= C) continue;
      float* row = part + ((size_t)warp * C + ch) * F;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int f = f0 + fg * 8 + b;
        if (f < F) row[f] = c[a][b];
      }
    }
  }
};

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * Tile<T>::STAGES * (Tile<T>::XS + Tile<T>::DS);
}

// Block b: channel chunk b % c_chunks (fastest), output-channel tile, then
// the pixel range, so that the blocks of one range run side by side and find
// its dy tiles and halo patches in L2.  Pixel tile t is the tile column
// t % tiles_w (fastest), then the tile row and the image.  The tiles of the
// range form one stream through a ring of STAGES stages.
template <typename T>
__global__ void __launch_bounds__(Tile<T>::THREADS, Tile<T>::BLOCKS_PER_SM)
conv3x3_wgrad_partial(const T* __restrict__ x, const T* __restrict__ dy,
                      float* __restrict__ ws, int N, int H, int W, int C, int F,
                      int tiles_h, int tiles_w, int c_chunks, int f_tiles, int splits) {
  using G = Tile<T>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  constexpr int STAGE = G::XS + G::DS;
  const int cc = blockIdx.x % c_chunks;
  const int ft = (blockIdx.x / c_chunks) % f_tiles;
  const int s = blockIdx.x / (c_chunks * f_tiles);
  const long long total = (long long)N * tiles_h * tiles_w;
  const long long t_begin = total * s / splits;
  const int my_tiles = (int)(total * (s + 1) / splits - t_begin);
  const int c0 = cc * G::KC, f0 = ft * G::FT;

  // start the loads of the g-th tile of this block's range into its stage
  auto start_loads = [&](int g) {
    long long t = t_begin + g;
    const int tw = (int)(t % tiles_w);
    t /= tiles_w;
    const int th = (int)(t % tiles_h);
    const size_t n = (size_t)(t / tiles_h);
    load_tile<T>(ring + (g % G::STAGES) * STAGE, x + n * H * W * C, dy + n * H * W * F,
                 th * G::TH, tw * G::TW, c0, f0, H, W, C, F);
  };

  Acc<T> acc;
  acc.init();
  // STAGES - 1 tiles are in flight ahead of the one being multiplied
  for (int g = 0; g < G::STAGES - 1 && g < my_tiles; ++g) start_loads(g);
  for (int g = 0; g < my_tiles; ++g) {
    // tile g has landed once only the younger groups are still in flight
    if (g + G::STAGES - 1 <= my_tiles) {
      __pipeline_wait_prior(G::STAGES - 2);
    } else {
      __pipeline_wait_prior(0);
    }
    // after this barrier every thread sees tile g and has finished the
    // products of tile g - 1, whose stage the next load may now overwrite
    __syncthreads();
    if (g + G::STAGES - 1 < my_tiles) start_loads(g + G::STAGES - 1);
    const T* xs = ring + (g % G::STAGES) * STAGE;
    acc.tile(xs, xs + G::XS);
  }
  acc.store(ws + (size_t)s * 9 * C * F, c0, f0, C, F);
}

struct Plan {
  int tiles_h, tiles_w, c_chunks, f_tiles;
  long long pixel_tiles;
};

template <typename T>
Plan plan(int N, int H, int W, int C, int F) {
  using G = Tile<T>;
  Plan p;
  p.tiles_h = (H + G::TH - 1) / G::TH;
  p.tiles_w = (W + G::TW - 1) / G::TW;
  p.c_chunks = (C + G::KC - 1) / G::KC;
  p.f_tiles = (F + G::FT - 1) / G::FT;
  p.pixel_tiles = (long long)N * p.tiles_h * p.tiles_w;
  return p;
}

// Pixel ranges: whole waves of the blocks the card runs at a time, enough
// waves that no range holds more than MAX_RANGE_TILES tiles (a thread's fp32
// sum then runs over at most 16k products, which keeps its rounding error
// near that of a pairwise sum of the partials), and no more ranges than
// there are pixel tiles.
constexpr long long MAX_RANGE_TILES = 128;

template <typename T>
cudaError_t choose_splits(int N, int H, int W, int C, int F, int* splits) {
  using G = Tile<T>;
  const Plan p = plan<T>(N, H, W, C, F);
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgrad_partial<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3x3_wgrad_partial<T>,
                                                      G::THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const long long per_range = (long long)p.c_chunks * p.f_tiles;
  const long long per_wave = ((long long)sms * per_sm + per_range - 1) / per_range;
  long long waves = (p.pixel_tiles + MAX_RANGE_TILES * per_wave - 1) / (MAX_RANGE_TILES * per_wave);
  if (waves < 1) waves = 1;
  long long s = waves * per_wave;
  if (s > p.pixel_tiles) s = p.pixel_tiles;
  if (s < 1) s = 1;
  if (s * per_range > 2147483647LL) return cudaErrorInvalidConfiguration;
  *splits = (int)s;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, void* ws, void* dw, int N, int H, int W,
                   int C, int F, int splits, cudaStream_t stream) {
  using G = Tile<T>;
  const Plan p = plan<T>(N, H, W, C, F);
  if (splits < 1 || splits > p.pixel_tiles) return cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgrad_partial<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)splits * p.c_chunks * p.f_tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  conv3x3_wgrad_partial<T><<<(unsigned int)blocks, G::THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<float*>(ws), N, H, W,
      C, F, p.tiles_h, p.tiles_w, p.c_chunks, p.f_tiles, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return sm90::wgrad::launch_reduce(static_cast<const float*>(ws), static_cast<float*>(dw),
                                    9LL * C * F, splits, stream);
}

// ------------------------------------------------------------------ bf16 --

namespace bf {

using namespace sm90;

// The taps weight gradient on conv3x3_sm90.cuh's wgrad kernel: M is the 64
// input channels (x's window), N the 64 output channels (dy).
struct Taps {
  static __device__ __forceinline__ void product(float (&acc)[32], uint64_t xd, uint64_t dd) {
    wgmma<1, 1>(acc, xd, dd);
  }

  // Warp q of a warpgroup holds channels 16 q + lane / 4 and + 8 of each
  // tap, output channels 8 j + 2 (lane % 4) and + 1 of each group j of 8;
  // the tap (dr, dc)'s values go to rows tap * C + c of the partial (9C, F).
  static __device__ __forceinline__ void store(const float (&acc)[3][32], float* part, int dr,
                                               int c0, int f0, int C, int F) {
    const int q = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int dc = 0; dc < 3; ++dc)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = c0 + q * 16 + g + half * 8;
        if (c >= C) continue;
        float* row = part + ((size_t)(dr * 3 + dc) * C + c) * F;
#pragma unroll
        for (int j = 0; j < wgrad::FT / 8; ++j) {
          const int f = f0 + j * 8 + 2 * t;
          if (f < F) row[f] = acc[dc][4 * j + 2 * half];
          if (f + 1 < F) row[f + 1] = acc[dc][4 * j + 2 * half + 1];
        }
      }
  }
};

}  // namespace bf

}  // namespace

// The number of pixel ranges the kernel splits (N, H, W) into for this shape
// and type on the current device; the workspace holds splits x 9 x C x F
// floats.  Returns 0, a cudaError_t, or -1 for a shape or type the kernel does
// not take.
extern "C" int conv3x3_wgrad_splits(int N, int H, int W, int C, int F, int dtype,
                                    int* splits) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0) return -1;
  if (dtype == 0) return (int)choose_splits<float>(N, H, W, C, F, splits);
  if (dtype == 1) return (int)sm90::wgrad::choose_splits<bf::Taps>(N, H, W, C, F, splits);
  return -1;
}

// x: (N, H, W, C) and dy: (N, H, W, F) of dtype (0 = float32, 1 = bfloat16),
// contiguous, 16-byte aligned; ws: splits x 9 x C x F float32; dw: (3, 3, C,
// F) float32.  Any N, H, W, C, F >= 1.  Returns 0, a cudaError_t, or -1 for
// a shape or type the kernel does not take.
extern "C" int conv3x3_wgrad(const void* x, const void* dy, void* ws, void* dw, int N,
                             int H, int W, int C, int F, int splits, int dtype,
                             void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, dy, ws, dw, N, H, W, C, F, splits, s);
  if (dtype == 1)
    return (int)sm90::wgrad::launch<bf::Taps>(x, dy, ws, dw, N, H, W, C, F, splits, s);
  return -1;
}
