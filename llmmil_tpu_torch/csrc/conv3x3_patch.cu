// 3x3 stride-1 SAME convolution of an NHWC tensor as ONE long-K product over
// an im2col matrix staged in shared memory, for Hopper (sm_90a):
//
//   y (P, F) = patch (P, 9C) . k (9C, F),   P = N*H*W pixels,
//   patch[p, (dr*3 + dc)*C + c] = x[n, h + dr - 1, w + dc - 1, c]   (0 outside)
//
// products in x's type, fp32 accumulation, y in x's type.
//
// Replaces the Pallas TPU kernel `_fwd_patch_kernel` of
// llmmil_tpu/ops/pallas/conv3x3.py (`_conv_fwd(mode="patch")`, also its input
// gradient on the rotated, transposed kernel).  That kernel writes the whole
// (bh*W, 9C) im2col block of a row block into VMEM (9 shifted copies), then
// runs one GEMM with K = 9C.  At the trunk's shape that block is 128 pixels x
// 1728 x 2 bytes = 442 KB, twice what an SM's shared memory holds, so here
// the same product runs as one GEMM loop over K = 9C whose K-chunks are
// explicit im2col tiles:
//
//   - a block owns BM consecutive pixels (of the flattened N*H*W axis, so H
//     and W need not divide any tile) and BN output channels;
//   - K-chunk q is tap q / c_chunks and channels (q % c_chunks)*KC ..: the
//     block gathers that (BM x KC) tile of the im2col matrix from x and the
//     matching (KC x BN) rows of k into one stage of a ring, 16 bytes a copy
//     with cp.async, zeros for the SAME padding and every ragged edge
//     (conv3x3_im2col.cuh).  Unlike the taps kernel (conv3x3.cu), which
//     stages one halo patch and reads its nine taps as shifted ldmatrix
//     windows, the patch tile here is materialised row by row: each tile row
//     is one pixel's KC channels at one tap;
//   - bf16: 8 warps as 4 (pixels) x 2 (channels), a warp 32 pixels x 32
//     channels, A through ldmatrix.x4 from the patch tile, B through
//     ldmatrix.x4.trans from the k tile, mma.sync m16n8k16, 32 fp32
//     accumulators a thread.  fp32: plain FMAs, 4 pixels x 4 channels a
//     thread (parity only, no TF32).
//
// What bounds it: 2*P*9*C*F operations against x read once and y written once
// (at (160,128,128,192) -> 64 in bf16: 5.8e11 operations, 0.59 ms at the 989
// TFLOP/s peak, against 1.34 GB, 0.40 ms at 3.35 TB/s): operations.  The
// design pays for the materialised tile: every pixel's channels are gathered
// nine times (once a tap) from L2, and each tile holds only KC = 32 of the
// 1728 columns, so a block passes 54 chunks through its ring; mma.sync cannot
// reach the card's full tensor-core rate (wgmma can).
//
// Plain C interface, no allocation, no synchronisation: the caller hands in
// the output and the stream to launch on.

#include "conv3x3_im2col.cuh"

namespace {

using im2col::Geo;

template <typename T>
struct Tile;

template <>
struct Tile<__nv_bfloat16> {
  static constexpr int BM = 128;        // pixels of a block
  static constexpr int BN = 64;         // output channels of a block
  static constexpr int KC = 32;         // input channels of a K-chunk
  static constexpr int THREADS = 256;
  static constexpr int STAGES = 4;      // 14.5 KB each
  static constexpr int A_LD = KC + 8;   // +16 bytes: ldmatrix's 8 rows fall
  static constexpr int B_LD = BN + 8;   // on 32 different banks
  static constexpr int AS = BM * A_LD;
  static constexpr int BS = KC * B_LD;
};

template <>
struct Tile<float> {
  static constexpr int BM = 64;
  static constexpr int BN = 64;
  static constexpr int KC = 16;
  static constexpr int THREADS = 256;
  static constexpr int STAGES = 3;      // 9.3 KB each
  static constexpr int A_LD = KC + 4;
  static constexpr int B_LD = BN + 4;
  static constexpr int AS = BM * A_LD;
  static constexpr int BS = KC * B_LD;
};

template <typename T>
struct Acc;

// bf16: warp (wm, wn) of 4 x 2 owns pixels 32 wm .. 32 wm + 31 of the block
// (two m16 tiles) and channels 32 wn .. 32 wn + 31 (four n8 tiles).  In a
// 16x8 tile a thread holds pixels g = lane / 4 and g + 8, channels 2t and
// 2t + 1 (t = lane % 4).
template <>
struct Acc<__nv_bfloat16> {
  using G = Tile<__nv_bfloat16>;
  float c[2][4][4];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][n][j] = 0.0f;
  }

  __device__ void chunk(const __nv_bfloat16* as, const __nv_bfloat16* bs) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp & 3, wn = warp >> 2;
    // A (pixels x k, row-major): matrices (pixels 0-7, k 0-7), (8-15, 0-7),
    // (0-7, 8-15), (8-15, 8-15)
    const int a_off = (wm * 32 + (lane & 15)) * G::A_LD + (lane >> 4) * 8;
    // B (k x channels, row-major, read transposed): matrices (k 0-7, n 0-7),
    // (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15): two n8 tiles
    const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * G::B_LD + wn * 32 + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < G::KC; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) im2col::ldsm_x4(a[i], as + a_off + i * 16 * G::A_LD + kk);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b[4];
        im2col::ldsm_x4_trans(b, bs + b_off + kk * G::B_LD + j * 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          im2col::mma(c[i][2 * j], a[i], b[0], b[1]);
          im2col::mma(c[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  __device__ void store(__nv_bfloat16* y, long long p0, int f0, long long P, int F) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp & 3, wn = warp >> 2;
    const int g = lane >> 2, t = lane & 3;
    const bool pairs = (F & 1) == 0;     // a pair of channels is 4-byte aligned
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long p = p0 + wm * 32 + i * 16 + g + half * 8;
        if (p >= P) continue;
        __nv_bfloat16* row = y + (size_t)p * F;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int f = f0 + wn * 32 + n * 8 + 2 * t;
          const float v0 = c[i][n][half * 2], v1 = c[i][n][half * 2 + 1];
          if (pairs && f + 1 < F) {
            *reinterpret_cast<__nv_bfloat162*>(row + f) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (f < F) row[f] = __float2bfloat16(v0);
            if (f + 1 < F) row[f + 1] = __float2bfloat16(v1);
          }
        }
      }
  }
};

// fp32: plain FMAs.  Thread (tp, tf) of 16 x 16 owns pixels 4 tp .. 4 tp + 3
// and channels 4 tf .. 4 tf + 3.
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

  __device__ void chunk(const float* as, const float* bs) {
    const int tf = threadIdx.x & 15, tp = threadIdx.x >> 4;
#pragma unroll 4
    for (int k = 0; k < G::KC; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(bs + k * G::B_LD + tf * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = as[(tp * 4 + i) * G::A_LD + k];
        c[i][0] = fmaf(a, b.x, c[i][0]);
        c[i][1] = fmaf(a, b.y, c[i][1]);
        c[i][2] = fmaf(a, b.z, c[i][2]);
        c[i][3] = fmaf(a, b.w, c[i][3]);
      }
    }
  }

  __device__ void store(float* y, long long p0, int f0, long long P, int F) const {
    const int tf = threadIdx.x & 15, tp = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long p = p0 + tp * 4 + i;
      if (p >= P) continue;
      float* row = y + (size_t)p * F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = f0 + tf * 4 + j;
        if (f < F) row[f] = c[i][j];
      }
    }
  }
};

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * Tile<T>::STAGES * (Tile<T>::AS + Tile<T>::BS);
}

// Block b: output-channel tile b % f_tiles, pixels (b / f_tiles) * BM ...
// The 9 * c_chunks K-chunks pass through a ring of STAGES stages, STAGES - 1
// in flight ahead of the one being multiplied.
template <typename T>
__global__ void __launch_bounds__(Tile<T>::THREADS)
conv3x3_patch_kernel(const T* __restrict__ x, const T* __restrict__ k, T* __restrict__ y,
                     Geo g, int F, int c_chunks, int f_tiles) {
  using G = Tile<T>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  constexpr int STAGE = G::AS + G::BS;
  const int f0 = (int)(blockIdx.x % f_tiles) * G::BN;
  const long long p0 = (long long)(blockIdx.x / f_tiles) * G::BM;
  const int n_chunks = 9 * c_chunks;

  auto start_loads = [&](int q) {
    T* st = ring + (q % G::STAGES) * STAGE;
    const int tap = q / c_chunks, c0 = (q % c_chunks) * G::KC;
    im2col::load_patch<T, G::BM, G::KC, G::A_LD, G::THREADS>(st, x, p0, tap, c0, g);
    im2col::load_kernel<T, G::KC, G::BN, G::B_LD, G::THREADS>(st + G::AS, k, tap, c0, f0, g.C,
                                                              F);
    __pipeline_commit();
  };

  for (int q = 0; q < G::STAGES - 1 && q < n_chunks; ++q) start_loads(q);
  Acc<T> acc;
  acc.init();
  for (int q = 0; q < n_chunks; ++q) {
    im2col::wait_stage<G::STAGES>(q, n_chunks);
    // every thread sees chunk q and has finished the products of chunk
    // q - 1, whose stage the next load may now overwrite
    __syncthreads();
    if (q + G::STAGES - 1 < n_chunks) start_loads(q + G::STAGES - 1);
    const T* st = ring + (q % G::STAGES) * STAGE;
    acc.chunk(st, st + G::AS);
  }
  acc.store(y, p0, f0, g.P, F);
}

template <typename T>
cudaError_t launch(const void* x, const void* k, void* y, int N, int H, int W, int C, int F,
                   cudaStream_t stream) {
  using G = Tile<T>;
  const Geo g{H, W, C, (long long)N * H * W};
  const int c_chunks = (C + G::KC - 1) / G::KC;
  const int f_tiles = (F + G::BN - 1) / G::BN;
  const long long blocks = (g.P + G::BM - 1) / G::BM * f_tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(conv3x3_patch_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  conv3x3_patch_kernel<T><<<(unsigned int)blocks, G::THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<T*>(y), g, F, c_chunks,
      f_tiles);
  return cudaGetLastError();
}

}  // namespace

// x: (N, H, W, C) of dtype (0 = float32, 1 = bfloat16), contiguous; k:
// (3, 3, C, F) and y: (N, H, W, F) of the same type, contiguous; all three
// 16-byte aligned.  Any N, H, W, C, F >= 1.  Returns 0, a cudaError_t, or -1
// for a shape or type the kernel does not take.
extern "C" int conv3x3_patch_fwd(const void* x, const void* k, void* y, int N, int H, int W,
                                 int C, int F, int dtype, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, k, y, N, H, W, C, F, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, k, y, N, H, W, C, F, s);
  return -1;
}
