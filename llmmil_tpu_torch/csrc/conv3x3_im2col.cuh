// Shared pieces of the fp32 im2col kernels of the 3x3 stride-1 SAME
// convolution of an NHWC tensor (conv3x3_patch.cu, conv3x3_tout.cu,
// conv3x3_wgrad_tout.cu): the loaders that stage tiles of the im2col matrix,
// of the kernel and of an (pixels, channels) tensor in shared memory.
//
// The im2col matrix of x (N, H, W, C) has one row a pixel (the N*H*W pixels
// in their NHWC order) and 9*C columns in the kernel's tap-major order,
// k = (dr*3 + dc)*C + c, as k.reshape(9C, F) lays them out:
//
//   patch[p, (dr*3 + dc)*C + c] = x[n, h + dr - 1, w + dc - 1, c]   (0 outside)
//
// A tile of it is one tap and a chunk of channels for a run of consecutive
// pixels.  Nothing of it exists in device memory: the loaders gather it from
// x, 16 bytes a copy with cp.async where the 16 bytes lie inside the image
// and the channels, element by element with zeros elsewhere.

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace im2col {

// The shape of x: H, W, C, and P = N*H*W pixels.
struct Geo {
  int H, W, C;
  long long P;
};

template <typename T>
__device__ __forceinline__ void zero16(T* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// Rows p0 .. p0 + ROWS - 1 of the im2col matrix, columns of tap `tap` and
// channels c0 .. c0 + COLS - 1, into dst (row stride LD elements, a multiple
// of 16 bytes).  Rows past the last pixel and channels past C are zeros.
template <typename T, int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void load_patch(T* dst, const T* __restrict__ x, long long p0,
                                           int tap, int c0, const Geo& g) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int XV = COLS / VEC;
  static_assert(COLS % VEC == 0 && LD % VEC == 0, "16-byte rows");
  const int dr = tap / 3 - 1, dc = tap % 3 - 1;
  const bool vec_ok = g.C % VEC == 0;  // every pixel starts on 16 bytes
  const long long hw = (long long)g.H * g.W;
  for (int i = threadIdx.x; i < ROWS * XV; i += THREADS) {
    const int v = i % XV, r = i / XV;
    const long long p = p0 + r;
    const int c = c0 + v * VEC;
    T* d = dst + r * LD + v * VEC;
    const T* src = nullptr;
    if (p < g.P) {
      const long long n = p / hw;
      const int rem = (int)(p - n * hw);
      const int h = rem / g.W + dr, w = rem % g.W + dc;
      if (h >= 0 && h < g.H && w >= 0 && w < g.W) src = x + ((n * g.H + h) * g.W + w) * g.C;
    }
    if (src != nullptr && vec_ok && c + VEC <= g.C) {
      __pipeline_memcpy_async(d, src + c, 16);
    } else {
      zero16(d);
      if (src != nullptr) {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (c + j < g.C) d[j] = src[c + j];
      }
    }
  }
}

// Rows c0 .. c0 + ROWS - 1 of tap `tap` of the kernel k (9*C, F), columns
// f0 .. f0 + COLS - 1, into dst (row stride LD).  Zeros past C and F.
template <typename T, int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void load_kernel(T* dst, const T* __restrict__ k, int tap, int c0,
                                            int f0, int C, int F) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int WV = COLS / VEC;
  static_assert(COLS % VEC == 0 && LD % VEC == 0, "16-byte rows");
  const bool vec_ok = F % VEC == 0;
  for (int i = threadIdx.x; i < ROWS * WV; i += THREADS) {
    const int v = i % WV, r = i / WV;
    const int c = c0 + r, f = f0 + v * VEC;
    T* d = dst + r * LD + v * VEC;
    const T* src = k + ((size_t)tap * C + c) * F;
    if (c < C && vec_ok && f + VEC <= F) {
      __pipeline_memcpy_async(d, src + f, 16);
    } else {
      zero16(d);
      if (c < C) {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (f + j < F) d[j] = src[f + j];
      }
    }
  }
}

// Rows p0 .. p0 + ROWS - 1 of a (P, F) tensor, columns f0 .. f0 + COLS - 1,
// into dst (row stride LD).  Zeros past P and F.
template <typename T, int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ a, long long p0,
                                          long long P, int F, int f0) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int DV = COLS / VEC;
  static_assert(COLS % VEC == 0 && LD % VEC == 0, "16-byte rows");
  const bool vec_ok = F % VEC == 0;
  for (int i = threadIdx.x; i < ROWS * DV; i += THREADS) {
    const int v = i % DV, r = i / DV;
    const long long p = p0 + r;
    const int f = f0 + v * VEC;
    T* d = dst + r * LD + v * VEC;
    const T* src = a + (size_t)p * F;
    if (p < P && vec_ok && f + VEC <= F) {
      __pipeline_memcpy_async(d, src + f, 16);
    } else {
      zero16(d);
      if (p < P) {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (f + j < F) d[j] = src[f + j];
      }
    }
  }
}

// Waits until stage `q` of a stream of `total` stages, each one commit
// group, has landed, with STAGES - 1 groups started ahead of the one in use.
template <int STAGES>
__device__ __forceinline__ void wait_stage(long long q, long long total) {
  if (q + STAGES - 1 <= total) {
    __pipeline_wait_prior(STAGES - 2);
  } else {
    __pipeline_wait_prior(0);
  }
}

}  // namespace im2col
