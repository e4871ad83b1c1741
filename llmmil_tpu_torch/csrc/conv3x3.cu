// 3x3 stride-1 SAME convolution of an NHWC tensor for Hopper (sm_90a).
//
//   y[n, h, w, f] = sum_{dr, dc, c} x[n, h + dr - 1, w + dc - 1, c] * k[dr, dc, c, f]
//
// with x read as zero outside the image, products in x's type, fp32
// accumulation, y in x's type.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// llmmil_tpu/ops/pallas/conv3x3.py (`_conv_fwd(mode="taps")`).  That kernel
// pads the tensor in device memory first and keeps one whole padded image
// resident in fast memory across its row blocks.  An SM has 227 KB of shared
// memory, so here a block owns a TH x TW patch of output pixels and FT output
// channels (a "tile"), and walks the input channels in chunks of KC:
//
//   - per chunk it stages the (TH+2) x (TW+2) x KC halo patch of x and the
//     9 x KC x FT slab of k in shared memory, 16 bytes a copy with cp.async,
//     through a ring of stages so that later chunks load while this one
//     multiplies.  Pixels outside the image, channels past C and columns
//     past F are written as zeros: the SAME padding and every ragged edge are
//     the kernel's, nothing is padded or copied in device memory;
//   - the nine taps are nine shifted windows of the same staged patch, so no
//     im2col matrix exists anywhere.  bf16: each of 8 warps owns 4 rows of 16
//     pixels and 32 channels; a row of 16 pixels at one column shift is one
//     `ldmatrix.x4` A operand (pixel stride KC+8 keeps the 8 rows on 32
//     banks) that serves the three row taps, k comes through
//     `ldmatrix.x4.trans`, the products run on the tensor cores through
//     `mma.sync m16n8k16` into 64 fp32 accumulators a thread.  fp32: plain
//     FMAs, 4 pixels x 4 channels a thread (parity only, no TF32);
//   - the epilogue rounds the accumulators to y's type and masks rows,
//     columns and channels past the edge;
//   - the grid is persistent: as many blocks as the card holds at once (two
//     an SM for bf16), each taking every gridDim.x-th tile, the chunks of all
//     its tiles in one stream through the ring.
//
// What bounds it: at (160,128,128,192) -> 64 in bf16 it does 5.8e11
// operations (0.59 ms at the 989 TFLOP/s peak) against 1.34 GB moved (0.40 ms
// at 3.35 TB/s): operations.  Builds that skip one phase each (the
// CONV3X3_SKIP_* macros below, driven by eval/probe_conv3x3.py) show the
// products from shared memory alone at about four fifths of the kernel's time
// and the loads and stores alone at about two thirds.  Still open: `mma.sync`
// cannot reach the card's full tensor-core rate (`wgmma` can), and every tile
// reads its 221 KB slab of k and its halo from L2 again (3.5 GB in all; TMA
// with multicast across a cluster would share them).
//
// Plain C interface, no allocation, no synchronisation: the caller hands in
// the output and the stream to launch on.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The tile of one block for tensors of type T, and one stage of its ring in
// shared memory: the halo patch (pixel stride X_LD), then the slab of k (row
// stride W_LD).
template <typename T>
struct Tile;

template <>
struct Tile<__nv_bfloat16> {
  static constexpr int TH = 16, TW = 16;  // output pixels of a block
  static constexpr int KC = 16;           // input channels a chunk
  static constexpr int FT = 64;           // output channels of a block
  static constexpr int THREADS = 256;
  static constexpr int STAGES = 3;         // 36 KB each
  static constexpr int BLOCKS_PER_SM = 2;
  static constexpr int X_LD = KC + 8;     // +16 bytes: ldmatrix's 8 rows fall
  static constexpr int W_LD = FT + 8;     // on 32 different banks
  static constexpr int XS = (TH + 2) * (TW + 2) * X_LD;
  static constexpr int WS = 9 * KC * W_LD;
};

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

// bf16: warp (wm, wn) of 4 x 2 owns pixel rows 4 wm .. 4 wm + 3 of the tile
// (one m16 tile a row) and channels 32 wn .. 32 wn + 31 (four n8 tiles).  In
// a 16x8 tile a thread holds pixels g = lane / 4 and g + 8, channels 2t and
// 2t + 1 (t = lane % 4).
template <>
struct Acc<__nv_bfloat16> {
  using G = Tile<__nv_bfloat16>;
  float c[4][4][4];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][n][j] = 0.0f;
  }

  // four 8x8 b16 matrices; lane i names row i%8 of matrix i/8
  static __device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
  }
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

  __device__ void chunk(const __nv_bfloat16* xs, const __nv_bfloat16* ws) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp & 3, wn = warp >> 2;
    // A (16 pixels of one row x k, pixel-major): matrices (pixels 0-7, k 0-7),
    // (pixels 8-15, k 0-7), (pixels 0-7, k 8-15), (pixels 8-15, k 8-15)
    const int a_off = (lane & 15) * G::X_LD + (lane >> 4) * 8;
    // B (k x channels, row-major, loaded transposed): matrices (k 0-7, n 0-7),
    // (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15): two 16x8 tiles
    const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * G::W_LD + wn * 32 + (lane >> 4) * 8;
    // An input row feeds three output rows (dr = 0, 1, 2), so for each
    // k-step and column shift dc the warp's six input rows are loaded once
    // and each serves up to three of its four output rows: 18 A loads for
    // 144 mma, not 36.
#pragma unroll
    for (int kk = 0; kk < G::KC; kk += 16) {
#pragma unroll
      for (int dc = 0; dc < 3; ++dc) {
        uint32_t a[6][4];
#pragma unroll
        for (int r = 0; r < 6; ++r)
          ldsm_x4(a[r], xs + ((wm * 4 + r) * (G::TW + 2) + dc) * G::X_LD + a_off + kk);
#pragma unroll
        for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t b[4];
            ldsm_x4_trans(b, ws + ((dr * 3 + dc) * G::KC + kk) * G::W_LD + b_off + j * 16);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              mma(c[i][2 * j], a[i + dr], b[0], b[1]);
              mma(c[i][2 * j + 1], a[i + dr], b[2], b[3]);
            }
          }
        }
      }
    }
  }

  __device__ void store(__nv_bfloat16* yn, int h0, int w0, int f0, int H, int W, int F) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp & 3, wn = warp >> 2;
    const int g = lane >> 2, t = lane & 3;
    const bool pairs = (F & 1) == 0;       // a pair of channels is 4-byte aligned
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = h0 + wm * 4 + i;
      if (h >= H) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int wd = w0 + g + half * 8;
        if (wd >= W) continue;
        __nv_bfloat16* px = yn + ((size_t)h * W + wd) * F;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int f = f0 + wn * 32 + n * 8 + 2 * t;
          const float v0 = c[i][n][half * 2], v1 = c[i][n][half * 2 + 1];
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
};

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
  // as many blocks as the card runs at once
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3x3_fwd_kernel<T>,
                                                      G::THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const long long resident = (long long)sms * per_sm;
  const unsigned int grid = (unsigned int)(tiles < resident ? tiles : resident);
  conv3x3_fwd_kernel<T><<<grid, G::THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<T*>(y),
      H, W, C, F, tiles_h, tiles_w, f_tiles, (unsigned int)tiles);
  return cudaGetLastError();
}

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
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, k, y, N, H, W, C, F, s);
  return -1;
}
