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
// whose N axis is the pixels:
//
//   - a block owns BF output channels and BP consecutive pixels of the
//     flattened N*H*W axis; its K-chunks are the same explicit im2col tiles
//     as conv3x3_patch.cu's (one tap, KC channels, gathered from x with
//     cp.async, zeros for the SAME padding and every ragged edge) beside the
//     matching rows of k, through a ring of stages;
//   - bf16: 8 warps as 2 (channels) x 4 (pixels), a warp 32 channels x 32
//     pixels; A = k^T comes from the k tile through ldmatrix.x4.trans, B =
//     patch^T from the patch tile through ldmatrix.x4 (the tile's rows are
//     pixels, which is B's column-major layout as it lies), mma.sync
//     m16n8k16, 32 fp32 accumulators a thread.  fp32: plain FMAs, 4 channels
//     x 4 pixels a thread (parity only, no TF32);
//   - the epilogue writes the (BF x BP) output tile into shared memory and
//     from there along the pixels, 16 bytes a thread, so that a warp's
//     stores to yt are whole 128-byte rows.
//
// What bounds it: 2*P*9*C*F operations against x read once and yt written
// once (at (160,128,128,192) -> 64 in bf16: 5.8e11 operations, 0.59 ms at the
// 989 TFLOP/s peak, against 1.34 GB, 0.40 ms at 3.35 TB/s): operations; the
// transpose back to NHWC outside moves y twice more.  As in the patch kernel
// every pixel's channels are gathered nine times from L2 and mma.sync cannot
// reach the card's full tensor-core rate.
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
  static constexpr int BF = 64;         // output channels of a block (M)
  static constexpr int BP = 128;        // pixels of a block (N)
  static constexpr int KC = 32;         // input channels of a K-chunk
  static constexpr int THREADS = 256;
  static constexpr int STAGES = 4;      // 14.5 KB each
  static constexpr int P_LD = KC + 8;   // patch tile [pixel][k]
  static constexpr int K_LD = BF + 8;   // k tile [k][channel]
  static constexpr int O_LD = BP + 8;   // output tile [channel][pixel]
  static constexpr int PS = BP * P_LD;
  static constexpr int KS = KC * K_LD;
};

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

// bf16: warp (wf, wp) of 2 x 4 owns channels 32 wf .. 32 wf + 31 (two m16
// tiles) and pixels 32 wp .. 32 wp + 31 (four n8 tiles).  In a 16x8 tile a
// thread holds channels g = lane / 4 and g + 8, pixels 2t and 2t + 1.
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

  __device__ void chunk(const __nv_bfloat16* ps, const __nv_bfloat16* ks) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wf = warp & 1, wp = warp >> 1;
    // A (channels x k) from the k tile [k][channel], read transposed:
    // matrices (channels 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
    const int a_off = ((lane & 7) + ((lane >> 4) << 3)) * G::K_LD + wf * 32 + ((lane >> 3) & 1) * 8;
    // B (k x pixels) from the patch tile [pixel][k] as it lies: matrices
    // (pixels 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15): two n8
    // tiles of pixels
    const int b_off = (wp * 32 + (lane & 7) + ((lane >> 4) << 3)) * G::P_LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < G::KC; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) im2col::ldsm_x4_trans(a[i], ks + a_off + kk * G::K_LD + i * 16);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b[4];
        im2col::ldsm_x4(b, ps + b_off + j * 16 * G::P_LD + kk);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          im2col::mma(c[i][2 * j], a[i], b[0], b[1]);
          im2col::mma(c[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  // out: the ring, free once every thread has passed the last chunk
  __device__ void store(__nv_bfloat16* yt, __nv_bfloat16* out, long long p0, int f0,
                        long long P, int F) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wf = warp & 1, wp = warp >> 1;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        __nv_bfloat16* row = out + (wf * 32 + i * 16 + g + half * 8) * G::O_LD;
#pragma unroll
        for (int n = 0; n < 4; ++n)
          *reinterpret_cast<__nv_bfloat162*>(row + wp * 32 + n * 8 + 2 * t) =
              __floats2bfloat162_rn(c[i][n][half * 2], c[i][n][half * 2 + 1]);
      }
    __syncthreads();
    constexpr int VEC = 8, RV = G::BP / VEC;
    const bool vec_ok = P % VEC == 0;    // every row of yt starts on 16 bytes
    for (int idx = threadIdx.x; idx < G::BF * RV; idx += G::THREADS) {
      const int r = idx / RV, v = idx % RV;
      const int f = f0 + r;
      const long long p = p0 + v * VEC;
      if (f >= F || p >= P) continue;
      const __nv_bfloat16* src = out + r * G::O_LD + v * VEC;
      __nv_bfloat16* dst = yt + (size_t)f * P + p;
      if (vec_ok && p + VEC <= P) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; j < VEC && p + j < P; ++j) dst[j] = src[j];
      }
    }
  }
};

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
static_assert(sizeof(__nv_bfloat16) * Tile<__nv_bfloat16>::BF * Tile<__nv_bfloat16>::O_LD <=
                  smem_bytes<__nv_bfloat16>(),
              "the output tile fits in the ring");

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
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, k, yt, N, H, W, C, F, s);
  return -1;
}
