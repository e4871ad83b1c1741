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
// CT volume against a 1728 x 64 result), so:
//
//   - the pixel axis (the GEMM's K) is cut into `splits` contiguous ranges of
//     at most 128 8 x 16-pixel tiles, whole waves of them (see
//     choose_splits).  A block owns one range, one chunk of KC = 32 input
//     channels and FT = 64 output channels, and keeps its 9 x KC x FT partial
//     in registers: warp w (of 9) owns tap w, i.e. two m16 tiles of channels
//     by eight n8 tiles of output channels, 64 fp32 accumulators a thread;
//   - per pixel tile it stages the (8+2) x (16+2) x KC halo patch of x and
//     the 8 x 16 x FT tile of dy in shared memory, 16 bytes a copy with
//     cp.async, through a ring of stages.  Pixels outside the image, channels
//     past C and columns past F are written as zeros: the SAME padding and
//     every ragged edge are the kernel's, nothing is padded or copied in
//     device memory.  The nine taps are shifted windows of the one patch, so
//     no im2col exists anywhere;
//   - bf16: one tile row of 16 pixels is one k16 step.  The pixel axis is the
//     contracted one, so A (channels x pixels) is the transpose of the
//     staged patch and B (pixels x output channels) is dy as staged: both
//     come through `ldmatrix.x4.trans` and feed `mma.sync m16n8k16` with fp32
//     accumulation.  dy's fragments serve all 9 taps' warps; a warp loads 2
//     A and 4 B fragments for 16 mma a step.  fp32: plain FMAs, 8 channels x
//     8 output channels a thread (parity only, no TF32);
//   - no float atomics: every block writes its partial to a workspace, and a
//     second kernel adds the `splits` partials of each element in a fixed
//     order, so two runs give the same bits.
//
// What bounds it: at (160,128,128,192) x (..,64) in bf16 it does 5.8e11
// operations (0.59 ms at the 989 TFLOP/s peak) against 1.34 GB moved (0.40 ms
// at 3.35 TB/s): operations.  Still open: `mma.sync` cannot reach the
// card's full tensor-core rate (`wgmma` can), the halo is read 1.4 times and
// dy once per channel chunk (from L2, since the blocks of one pixel range are
// neighbours in the grid).
//
// Plain C interface, no allocation, no synchronisation: the caller hands in
// the workspace, the output and the stream to launch on.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The work of one block for tensors of type T, and one stage of its ring in
// shared memory: the halo patch of x (pixel stride X_LD), then the tile of dy
// (pixel stride D_LD).
template <typename T>
struct Tile;

template <>
struct Tile<__nv_bfloat16> {
  static constexpr int TH = 8, TW = 16;   // pixels of a pixel tile; TW = k16
  static constexpr int KC = 32;           // input channels of a block
  static constexpr int FT = 64;           // output channels of a block
  static constexpr int THREADS = 288;     // 9 warps, one a tap
  static constexpr int STAGES = 3;        // 32 KB each
  static constexpr int BLOCKS_PER_SM = 2;
  static constexpr int X_LD = KC + 8;     // +16 bytes: ldmatrix's 8 rows fall
  static constexpr int D_LD = FT + 8;     // on 32 different banks
  static constexpr int XS = (TH + 2) * (TW + 2) * X_LD;
  static constexpr int DS = TH * TW * D_LD;
};

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

// bf16: warp w owns tap (w / 3, w % 3), channels c0 .. c0 + 31 (two m16
// tiles) and output channels f0 .. f0 + 63 (eight n8 tiles).  In a 16x8 tile
// a thread holds channels g = lane / 4 and g + 8, output channels 2t and
// 2t + 1 (t = lane % 4).
template <>
struct Acc<__nv_bfloat16> {
  using G = Tile<__nv_bfloat16>;
  float c[2][8][4];

  __device__ void init() {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[m][n][j] = 0.0f;
  }

  // four 8x8 b16 matrices loaded transposed; lane i names row i%8 of
  // matrix i/8 as it lies in shared memory
  static __device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }

  __device__ void tile(const __nv_bfloat16* xs, const __nv_bfloat16* ds) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int dr = warp / 3, dc = warp % 3;
    // A (16 channels x 16 pixels) lies pixel-major: matrices (pixels 0-7,
    // channels 0-7), (pixels 0-7, channels 8-15), (pixels 8-15, channels
    // 0-7), (pixels 8-15, channels 8-15), each read transposed
    const int a_px = (lane & 7) + ((lane >> 4) << 3);
    const int a_ch = ((lane >> 3) & 1) * 8;
    // B (16 pixels x output channels), row-major, read transposed: matrices
    // (pixels 0-7, n 0-7), (pixels 8-15, n 0-7), (pixels 0-7, n 8-15),
    // (pixels 8-15, n 8-15): two 16x8 tiles
    const int b_px = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int b_n = (lane >> 4) * 8;
#pragma unroll 2
    for (int i = 0; i < G::TH; ++i) {     // tile row i: one k16 step
      uint32_t b[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ldsm_x4_trans(b[j], ds + (i * G::TW + b_px) * G::D_LD + j * 16 + b_n);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        uint32_t a[4];
        ldsm_x4_trans(a, xs + ((i + dr) * (G::TW + 2) + dc + a_px) * G::X_LD + m * 16 + a_ch);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma(c[m][2 * j], a, b[j][0], b[j][1]);
          mma(c[m][2 * j + 1], a, b[j][2], b[j][3]);
        }
      }
    }
  }

  __device__ void store(float* part, int c0, int f0, int C, int F) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ch = c0 + m * 16 + g + half * 8;
        if (ch >= C) continue;
        float* row = part + ((size_t)warp * C + ch) * F;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int f = f0 + n * 8 + 2 * t;
          if (f < F) row[f] = c[m][n][half * 2];
          if (f + 1 < F) row[f + 1] = c[m][n][half * 2 + 1];
        }
      }
  }
};

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

// dw[e] = sum over the splits of ws[s][e], in the order of s: deterministic.
__global__ void conv3x3_wgrad_reduce(const float* __restrict__ ws, float* __restrict__ dw,
                                     long long count, int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < count;
       e += (long long)gridDim.x * blockDim.x) {
    float sum = 0.0f;
    for (int s = 0; s < splits; ++s) sum += ws[(size_t)s * count + e];
    dw[e] = sum;
  }
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
  const long long count = 9LL * C * F;
  const long long want = (count + 255) / 256;
  const unsigned int grid = (unsigned int)(want < 4096 ? want : 4096);
  conv3x3_wgrad_reduce<<<grid, 256, 0, stream>>>(static_cast<const float*>(ws),
                                                  static_cast<float*>(dw), count, splits);
  return cudaGetLastError();
}

}  // namespace

// The number of pixel ranges the kernel splits (N, H, W) into for this shape
// and type on the current device; the workspace holds splits x 9 x C x F
// floats.  Returns 0, a cudaError_t, or -1 for a shape or type the kernel does
// not take.
extern "C" int conv3x3_wgrad_splits(int N, int H, int W, int C, int F, int dtype,
                                    int* splits) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0) return -1;
  if (dtype == 0) return (int)choose_splits<float>(N, H, W, C, F, splits);
  if (dtype == 1) return (int)choose_splits<__nv_bfloat16>(N, H, W, C, F, splits);
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
    return (int)launch<__nv_bfloat16>(x, dy, ws, dw, N, H, W, C, F, splits, s);
  return -1;
}
