// Fused masked gated-attention MIL pooling for Hopper (sm_90a).
//
//   a_n    = w . (tanh(x_n V + bv) * sigmoid(x_n U + bu)) + bw
//   p      = masked_softmax(a)            over the N rows of one bag
//   pooled = sum_n p_n x_n
//
// Replaces the Pallas TPU kernel `_mil_kernel` of
// llmmil_tpu/ops/pallas/mil_pool.py.  That kernel runs one program per bag
// and walks the bag's rows in order with a carried (max, denominator,
// weighted sum).  On this card a bag of 16k rows at batch 1 would then
// occupy one of 132 SMs, so the rows are split across blocks instead
// (flash-decoding style) and a second, small kernel joins the pieces:
//
//   pass 1, grid (ceil(N/TILE_M), B): one block per TILE_M rows (bf16: 128,
//     fp32: 64).  The two gate products run against V and U streamed
//     through shared memory in K-chunks, double-buffered with cp.async so
//     that the next chunk loads while this one multiplies (bf16: mma.sync
//     fed by ldmatrix, fp32 accumulation; fp32: plain fp32 FMAs, no TF32).
//     The block masks its logits (fill -1e30), writes them to the attention
//     buffer, takes its own max m_t, the sum s_t of e = exp(a - m_t) and the
//     vector sum_n e_n x_n (fp32; e is not rounded to the bag's type), and
//     writes those three as its partial.
//   pass 2, grid (L/64, B): joins the partials with exp(m_t - m) rescaling
//     into pooled = acc / max(s, 1e-30) and rewrites the attention buffer
//     in place as exp(a - m) / s under the mask, 0 elsewhere.
//
// Masked rows and the ragged edge past N contribute nothing whatever they
// hold (NaN included): they are skipped in the pooling sum, not multiplied
// by zero.  An all-masked bag gives zeros.
//
// Plain C interface, no allocation, no synchronisation: the caller hands in
// outputs and scratch and the stream to launch on.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 192;        // gate width (ABMIL's D)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The gate products of one block: acc += x_tile(TILE_M x KC) @ {V,U}(KC x 192)
// chunk by chunk, then per row sum_d w_d tanh(.)_d sigmoid(.)_d.  Each
// specialisation names its tile (TILE_M rows, THREADS threads, KC columns of
// K a chunk) and the layout of one stage of the chunk ring in shared memory:
// the row tile's chunk (row stride XS_LD), then V's and U's (row stride W_LD).
template <typename T>
struct Gate;

// bf16: tensor cores through mma.sync m16n8k16 (fp32 accumulation), the
// operands brought from shared memory with ldmatrix.  A warp owns 32 rows
// and 48 columns of both gates: 2 x 6 tiles of 16x8 per gate, 96 accumulator
// registers, and 8 ldmatrix for its 24 mma of one k-step.  In a tile a thread
// holds rows g = lane/4 and g+8, columns 2t and 2t+1 (t = lane%4).
template <>
struct Gate<__nv_bfloat16> {
  // 128 rows a block: V and U come from L2 once per block, so a taller tile
  // halves that traffic against 64 rows; 16 warps keep it inside 128
  // registers a thread
  static constexpr int TILE_M = 128;
  static constexpr int STRIPS = TILE_M / 32;
  static constexpr int PARTS = 4;        // column groups, summed afterwards
  static constexpr int THREADS = STRIPS * PARTS * 32;
  static constexpr int KC = 64;
  static constexpr int XS_LD = KC + 8;   // +16 bytes: ldmatrix's 8 rows fall
  static constexpr int W_LD = kD + 8;    // on 32 different banks
  static constexpr int STAGE_ELEMS = TILE_M * XS_LD + 2 * KC * W_LD;
  static constexpr int NT = 6;           // 16x8 tiles across the warp's 48 columns

  float av[2][NT][4];
  float au[2][NT][4];

  __device__ void init() {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) { av[m][i][j] = 0.0f; au[m][i][j] = 0.0f; }
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
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }

  __device__ void chunk(const __nv_bfloat16* xs, const __nv_bfloat16* vs,
                        const __nv_bfloat16* us) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int strip = warp % STRIPS, part = warp / STRIPS;
    // A (rows x k, row-major): matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7),
    // (rows 0-7, k 8-15), (rows 8-15, k 8-15)
    const __nv_bfloat16* a_ptr = xs + (strip * 32 + (lane & 15)) * XS_LD + (lane >> 4) * 8;
    // B (k x n, row-major, loaded transposed): matrices (k 0-7, n 0-7),
    // (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15): two 16x8 tiles
    const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * W_LD + part * 48 + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a0[4], a1[4];
      ldsm_x4(a0, a_ptr + kk);
      ldsm_x4(a1, a_ptr + 16 * XS_LD + kk);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs + kk * W_LD + b_off + j * 16);
        mma(av[0][2 * j], a0, b[0], b[1]);
        mma(av[0][2 * j + 1], a0, b[2], b[3]);
        mma(av[1][2 * j], a1, b[0], b[1]);
        mma(av[1][2 * j + 1], a1, b[2], b[3]);
        ldsm_x4_trans(b, us + kk * W_LD + b_off + j * 16);
        mma(au[0][2 * j], a0, b[0], b[1]);
        mma(au[0][2 * j + 1], a0, b[2], b[3]);
        mma(au[1][2 * j], a1, b[0], b[1]);
        mma(au[1][2 * j + 1], a1, b[2], b[3]);
      }
    }
  }

  // row_part[part * TILE_M + row] = this warp's share of the row's logit
  __device__ void finish(float* row_part, const float* bv, const float* bu,
                         const float* ww) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int strip = warp % STRIPS, part = warp / STRIPS;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float lo = 0.0f, hi = 0.0f;          // rows g and g + 8 of this half
#pragma unroll
      for (int i = 0; i < NT; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = part * 48 + i * 8 + 2 * t + c;
          lo = fmaf(ww[col], tanhf(av[m][i][c] + bv[col]) * sigmoidf_(au[m][i][c] + bu[col]), lo);
          hi = fmaf(ww[col], tanhf(av[m][i][2 + c] + bv[col]) * sigmoidf_(au[m][i][2 + c] + bu[col]), hi);
        }
      }
      lo += __shfl_xor_sync(0xffffffffu, lo, 1);
      lo += __shfl_xor_sync(0xffffffffu, lo, 2);
      hi += __shfl_xor_sync(0xffffffffu, hi, 1);
      hi += __shfl_xor_sync(0xffffffffu, hi, 2);
      if (t == 0) {
        const int row = strip * 32 + m * 16 + g;
        row_part[part * TILE_M + row] = lo;
        row_part[part * TILE_M + row + 8] = hi;
      }
    }
  }
};

// fp32: plain FMAs, so that an fp32 bag keeps fp32 numerics.  Warp w owns
// rows 8w..8w+7; lane l owns columns l, l+32, ..., l+160.
template <>
struct Gate<float> {
  static constexpr int TILE_M = 64;
  static constexpr int THREADS = 256;
  static constexpr int PARTS = 1;
  static constexpr int KC = 32;
  static constexpr int XS_LD = KC;
  static constexpr int W_LD = kD;
  static constexpr int STAGE_ELEMS = TILE_M * XS_LD + 2 * KC * W_LD;
  static constexpr int ROWS = TILE_M / (THREADS / 32);   // 8
  static constexpr int COLS = kD / 32;                   // 6

  float av[ROWS][COLS];
  float au[ROWS][COLS];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) { av[i][j] = 0.0f; au[i][j] = 0.0f; }
  }

  __device__ void chunk(const float* xs, const float* vs, const float* us) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float xv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) xv[i] = xs[(warp * ROWS + i) * XS_LD + kk];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float wv = vs[kk * W_LD + lane + 32 * j];
        const float wu = us[kk * W_LD + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          av[i][j] = fmaf(xv[i], wv, av[i][j]);
          au[i][j] = fmaf(xv[i], wu, au[i][j]);
        }
      }
    }
  }

  __device__ void finish(float* row_part, const float* bv, const float* bu,
                         const float* ww) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int col = lane + 32 * j;
        sum = fmaf(ww[col], tanhf(av[i][j] + bv[col]) * sigmoidf_(au[i][j] + bu[col]), sum);
      }
      sum = warp_sum(sum);
      if (lane == 0) row_part[warp * ROWS + i] = sum;
    }
  }
};

template <typename T>
constexpr size_t pass1_smem_bytes() {
  using G = Gate<T>;
  return sizeof(T) * 2 * G::STAGE_ELEMS +
         sizeof(float) * (3 * kD + (G::PARTS + 2) * G::TILE_M) +
         sizeof(int) * G::TILE_M;
}

// One K-chunk of the row tile and of V and U into one stage of shared
// memory, asynchronously, 16 bytes a copy.  Rows past N are zero-filled.
template <typename T>
__device__ __forceinline__ void load_chunk(T* xs, const T* xb, const T* wv,
                                           const T* wu, int row0, int N, int L,
                                           int k0) {
  using G = Gate<T>;
  T* vs = xs + G::TILE_M * G::XS_LD;
  T* us = vs + G::KC * G::W_LD;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int XV = G::KC / VEC;
  for (int i = threadIdx.x; i < G::TILE_M * XV; i += G::THREADS) {
    const int r = i / XV, v = i % XV;
    const int n = row0 + r;
    T* dst = xs + r * G::XS_LD + v * VEC;
    if (n < N) {
      __pipeline_memcpy_async(dst, xb + (size_t)n * L + k0 + v * VEC, 16);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  constexpr int WV = kD / VEC;
  for (int i = threadIdx.x; i < G::KC * WV; i += G::THREADS) {
    const int r = i / WV, v = i % WV;
    const size_t g = (size_t)(k0 + r) * kD + v * VEC;
    __pipeline_memcpy_async(vs + r * G::W_LD + v * VEC, wv + g, 16);
    __pipeline_memcpy_async(us + r * G::W_LD + v * VEC, wu + g, 16);
  }
  __pipeline_commit();
}

// 16 bytes of the bag as floats
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p = __bfloat1622float2(h[j]);
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

// part_ms: (B, n_tiles, 2) = (m_t, s_t); part_acc: (B, n_tiles, L).
template <typename T>
__global__ void __launch_bounds__(Gate<T>::THREADS)
mil_pool_pass1(const T* __restrict__ x, const uint8_t* __restrict__ mask,
               const T* __restrict__ wv, const T* __restrict__ wu,
               const float* __restrict__ bv, const float* __restrict__ bu,
               const float* __restrict__ ww, const float* __restrict__ bw,
               float* __restrict__ attn, float* __restrict__ part_ms,
               float* __restrict__ part_acc, int N, int L) {
  using G = Gate<T>;
  constexpr int TILE_M = G::TILE_M, THREADS = G::THREADS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);      // two stages
  float* s_bv = reinterpret_cast<float*>(ring + 2 * G::STAGE_ELEMS);
  float* s_bu = s_bv + kD;
  float* s_ww = s_bu + kD;
  float* row_part = s_ww + kD;                   // PARTS * TILE_M
  float* s_lg = row_part + G::PARTS * TILE_M;    // TILE_M
  float* s_e = s_lg + TILE_M;                    // TILE_M
  int* s_valid = reinterpret_cast<int*>(s_e + TILE_M);

  const int tid = threadIdx.x;
  const int tile = blockIdx.x, b = blockIdx.y, n_tiles = gridDim.x;
  const int row0 = tile * TILE_M;
  const T* xb = x + (size_t)b * N * L;

  if (tid < kD) {
    s_bv[tid] = bv[tid];
    s_bu[tid] = bu[tid];
    s_ww[tid] = ww[tid];
  }

  G gate;
  gate.init();
  const int n_chunks = L / G::KC;
  load_chunk<T>(ring, xb, wv, wu, row0, N, L, 0);
  for (int c = 0; c < n_chunks; ++c) {
    T* xs = ring + (c & 1) * G::STAGE_ELEMS;
    if (c + 1 < n_chunks) {
      // the other stage was read in the last round, and that round ended
      // with a barrier
      load_chunk<T>(ring + ((c + 1) & 1) * G::STAGE_ELEMS, xb, wv, wu, row0,
                    N, L, (c + 1) * G::KC);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    gate.chunk(xs, xs + TILE_M * G::XS_LD,
               xs + TILE_M * G::XS_LD + G::KC * G::W_LD);
    __syncthreads();
  }
  gate.finish(row_part, s_bv, s_bu, s_ww);
  __syncthreads();

  if (tid < TILE_M) {
    const int n = row0 + tid;
    const bool valid = n < N && mask[(size_t)b * N + n] != 0;
    float lg = bw[0];
#pragma unroll
    for (int p = 0; p < G::PARTS; ++p) lg += row_part[p * TILE_M + tid];
    lg = valid ? lg : kNegInf;
    if (n < N) attn[(size_t)b * N + n] = lg;
    s_lg[tid] = lg;
    s_valid[tid] = valid ? 1 : 0;
  }
  __syncthreads();

  if (tid < 32) {          // the tile's max, its e = exp(a - max) and their sum
    float m = kNegInf;
#pragma unroll
    for (int i = tid; i < TILE_M; i += 32) m = fmaxf(m, s_lg[i]);
    m = warp_max(m);
    float s = 0.0f;
#pragma unroll
    for (int i = tid; i < TILE_M; i += 32) {
      const float e = s_valid[i] ? expf(s_lg[i] - m) : 0.0f;
      s_e[i] = e;
      s += e;
    }
    s = warp_sum(s);
    if (tid == 0) {
      float* ms = part_ms + ((size_t)b * n_tiles + tile) * 2;
      ms[0] = m;
      ms[1] = s;
    }
  }
  __syncthreads();

  // sum_n e_n x_n over this tile's valid rows; the rows were read a moment
  // ago and come from L2.  A thread takes 16 bytes of columns and one group
  // of rows; the row groups are joined through the ring, free by now.
  constexpr int VEC = 16 / sizeof(T);
  float* red = reinterpret_cast<float*>(smem_raw);
  float* pacc = part_acc + ((size_t)b * n_tiles + tile) * L;
  const int cgs = L / VEC;                          // column groups
  const int per = min(cgs, THREADS);                // ... taken in one round
  int rgs = 1;                                      // row groups, power of 2
  while (rgs * 2 * cgs <= THREADS && rgs * 2 <= TILE_M) rgs *= 2;
  const int rows_per = TILE_M / rgs;
  const int rg = tid / per;
  for (int cg0 = 0; cg0 < cgs; cg0 += per) {
    const int cg = cg0 + tid % per;
    if (rg < rgs && cg < cgs) {
      float acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
#pragma unroll 4
      for (int r = rg * rows_per; r < (rg + 1) * rows_per; ++r) {
        if (s_valid[r]) {
          const uint4 v = *reinterpret_cast<const uint4*>(xb + (size_t)(row0 + r) * L + cg * VEC);
          float f[VEC];
          unpack(v, f);
          const float e = s_e[r];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] = fmaf(e, f[j], acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[rg * L + cg * VEC + j] = acc[j];
    }
    __syncthreads();
    for (int c = tid; c < per * VEC; c += THREADS) {
      const int col = cg0 * VEC + c;
      if (col < L) {
        float sum = 0.0f;
        for (int g = 0; g < rgs; ++g) sum += red[g * L + col];
        pacc[col] = sum;
      }
    }
    __syncthreads();
  }
}

constexpr int kCols2 = 64;      // pooled columns per block of pass 2
constexpr int kThreads2 = 256;  // its threads
constexpr int kWarps2 = kThreads2 / 32;

__global__ void __launch_bounds__(kThreads2)
mil_pool_pass2(const uint8_t* __restrict__ mask, const float* __restrict__ part_ms,
               const float* __restrict__ part_acc, float* __restrict__ pooled,
               float* __restrict__ attn, int N, int L, int n_tiles) {
  __shared__ float s_red[kThreads2];
  __shared__ float s_bcast[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const float* ms = part_ms + (size_t)b * n_tiles * 2;

  float m = kNegInf;
  for (int t = tid; t < n_tiles; t += kThreads2) m = fmaxf(m, ms[2 * t]);
  m = warp_max(m);
  if (lane == 0) s_red[warp] = m;
  __syncthreads();
  if (tid == 0) {
    float mm = s_red[0];
    for (int w = 1; w < kWarps2; ++w) mm = fmaxf(mm, s_red[w]);
    s_bcast[0] = mm;
  }
  __syncthreads();
  m = s_bcast[0];

  float s = 0.0f;
  for (int t = tid; t < n_tiles; t += kThreads2) s += ms[2 * t + 1] * expf(ms[2 * t] - m);
  s = warp_sum(s);
  __syncthreads();
  if (lane == 0) s_red[warp] = s;
  __syncthreads();
  if (tid == 0) {
    float ss = 0.0f;
    for (int w = 0; w < kWarps2; ++w) ss += s_red[w];
    s_bcast[1] = fmaxf(ss, 1e-30f);
  }
  __syncthreads();
  const float denom = s_bcast[1];

  // pooled: 64 columns a block, the tiles dealt to 4 groups of threads
  const int tx = tid & (kCols2 - 1), ty = tid / kCols2;
  const int col = blockIdx.x * kCols2 + tx;
  float acc = 0.0f;
  for (int t = ty; t < n_tiles; t += kThreads2 / kCols2) {
    acc = fmaf(expf(ms[2 * t] - m), part_acc[((size_t)b * n_tiles + t) * L + col], acc);
  }
  __syncthreads();
  s_red[tid] = acc;
  __syncthreads();
  if (ty == 0) {
    pooled[(size_t)b * L + col] =
        (s_red[tx] + s_red[tx + kCols2] + s_red[tx + 2 * kCols2] + s_red[tx + 3 * kCols2]) / denom;
  }

  // attention: this block's share of the bag's rows, in place over the logits
  const int share = (N + gridDim.x - 1) / gridDim.x;
  const int n0 = blockIdx.x * share;
  const int n1 = min(N, n0 + share);
  for (int n = n0 + tid; n < n1; n += kThreads2) {
    const size_t i = (size_t)b * N + n;
    attn[i] = mask[i] != 0 ? expf(attn[i] - m) / denom : 0.0f;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* mask, const void* wv, const void* wu,
                   const void* bv, const void* bu, const void* ww, const void* bw,
                   void* pooled, void* attn, void* part_ms, void* part_acc,
                   int B, int N, int L, cudaStream_t stream) {
  using G = Gate<T>;
  const int n_tiles = (N + G::TILE_M - 1) / G::TILE_M;
  constexpr size_t smem = pass1_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(mil_pool_pass1<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mil_pool_pass1<T><<<dim3(n_tiles, B), G::THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(wv), static_cast<const T*>(wu),
      static_cast<const float*>(bv), static_cast<const float*>(bu),
      static_cast<const float*>(ww), static_cast<const float*>(bw),
      static_cast<float*>(attn), static_cast<float*>(part_ms),
      static_cast<float*>(part_acc), N, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mil_pool_pass2<<<dim3(L / kCols2, B), kThreads2, 0, stream>>>(
      static_cast<const uint8_t*>(mask), static_cast<const float*>(part_ms),
      static_cast<const float*>(part_acc), static_cast<float*>(pooled),
      static_cast<float*>(attn), N, L, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// Rows of a bag that one block of pass 1 takes for a bag of dtype (0 =
// float32, 1 = bfloat16): the caller sizes the scratch with it (part_ms:
// B * ceil(N / rows) * 2 floats, part_acc: B * ceil(N / rows) * L floats).
extern "C" int mil_pool_tile_rows(int dtype) {
  return dtype == 1 ? Gate<__nv_bfloat16>::TILE_M : Gate<float>::TILE_M;
}

// x: (B, N, L) of dtype (0 = float32, 1 = bfloat16), contiguous, 16-byte
// aligned; mask: (B, N) bytes, non-zero = valid; wv, wu: (L, 192) of x's type;
// bv, bu, ww: (192,) float32; bw: (1,) float32; pooled: (B, L) float32; attn:
// (B, N) float32.  L must be a multiple of 64 and D must be 192.  Returns 0,
// a cudaError_t, or -1 for a shape or type the kernel does not take.
extern "C" int mil_pool_fwd(const void* x, const void* mask, const void* wv,
                            const void* wu, const void* bv, const void* bu,
                            const void* ww, const void* bw, void* pooled,
                            void* attn, void* part_ms, void* part_acc, int B,
                            int N, int L, int D, int dtype, void* stream) {
  if (D != kD || L <= 0 || L % 64 != 0 || B <= 0 || B > 65535 || N <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<float>(x, mask, wv, wu, bv, bu, ww, bw, pooled, attn, part_ms, part_acc, B, N, L, s);
  }
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(x, mask, wv, wu, bv, bu, ww, bw, pooled, attn, part_ms, part_acc, B, N, L, s);
  }
  return -1;
}
