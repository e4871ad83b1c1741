// Fused masked gated-attention MIL pooling for Hopper (sm_90a).
//
//   a_n    = w . (tanh(x_n V + bv) * sigmoid(x_n U + bu)) + bw
//   p      = masked_softmax(a)            over the N rows of one bag
//   pooled = sum_n p_n x_n
//
// Replaces the Pallas TPU kernel `_mil_kernel` of
// llmmil_tpu/ops/pallas/mil_pool.py.  That kernel runs one program per bag
// and walks the bag's rows in order with a carried (max, denominator,
// weighted sum).  On this card a bag of 8k rows at batch 1 would then occupy
// one of 132 SMs, so the rows are split across blocks and the pieces are
// joined the way flash-decoding joins them.
//
// What bounds it: 2 N L (2 D + 1) + 2 N L operations on the valid rows
// against reading them once.  At 8 x 8192 x 768 in bf16 that is ~39 GFLOP
// (39 us at the 989 TFLOP/s peak) against ~101 MB (30 us at 3.35 TB/s):
// operations, by a little.  But each block must also see all of V and U
// (L x 384 bf16, 590 KB at L = 768) for every group of rows it takes, so
// what decides the time is how many rows one load of the gates feeds: the
// gates' bytes, shared memory's ingress, and L2's reads.  And 2 D
// transcendentals a row (tanh, sigmoid) go through the 16-a-clock MUFU pipe.
//
// bf16: ONE launch a call, persistent, warp-specialised, `wgmma` fed by TMA
// (the kernel in namespace bf below):
//   - Rows are taken in tiles of R = 64 MT rows of one bag (MT = 2 where
//     the call has enough 128-row tiles to give every SM one, else MT = 1,
//     so that a batch-1 bag still fills the card).  Every block first reads
//     the whole mask and keeps one bit a tile, set where the tile has a
//     valid row: a tile without one loads nothing and multiplies nothing.
//     The U valid tiles, in (bag, tile) order, are dealt in contiguous runs
//     of K = ceil(U / G) to the G blocks.
//   - The gates arrive packed once by the wrapper as one (384, L) bf16
//     matrix, K-major: rows 192 h .. 192 h + 95 are V's columns 96 h .. 96 h
//     + 95, the next 96 rows U's same columns.  A `wgmma` m64n192k16 over
//     half h then leaves V's column j and U's column j in the same thread,
//     so tanh * sigmoid * w is taken in registers.  A block is two consumer
//     warpgroups and a producer warpgroup that gives its registers up with
//     setmaxnreg (232 a consumer thread: with three warps on each SM
//     sub-partition, the launch alone allows 168).  With MT = 2 each
//     consumer warpgroup owns 64 rows and both halves (192 accumulator
//     registers); with MT = 1 each owns the tile's 64 rows and one half.
//   - The producer's one thread streams K-chunks of 32 columns: the tile's
//     rows (TMA, a 3-D map (L, N, B), so rows past N arrive as zeros and
//     never read the next bag; 64-byte swizzle, A K-major) and the matching
//     chunk of the packed gates (four boxes of 96 rows, the same swizzle, B
//     K-major) into a ring of STAGES `mbarrier` stages.  (Multicasting the
//     gates' boxes over clusters of 2 or 4 blocks, so that one read from L2
//     fed several tiles, was right but took twice as long or more, the
//     blocks of a cluster held to each other's pace: PERF.md.)
//   - After a tile's products the consumers reduce each row's logit
//     (partials of the two warpgroups through shared memory), mask it (fill
//     -1e30), write it to the attention, and take the tile's max m_t, e =
//     exp(a - m_t) (fp32) and s_t = sum e.
//   - The pooling sum reads the tile's rows a second time, from L2, through
//     a second ring that the same producer thread fills with TMA, in the
//     order the consumers drain the two rings; the consumers add e_n x_n on
//     their CUDA cores while the NEXT tile's `wgmma`s run, one chunk of 32
//     columns beside each chunk of products (every warp a share of the
//     rows: one warp taking a whole chunk held its warpgroup's next
//     `wgmma`s back), skipping masked rows (0 * NaN is NaN), into the
//     tile's partial (m_t, s_t, sum e x) in device memory.
//   - The join: after its last tile every block fences its partials and
//     logits and waits at one grid-wide barrier (the launch is cooperative,
//     so all blocks are resident; an atomic count, no float atomics).  Then
//     every block takes a fixed share of the joins: slices of 64 column
//     quads of a bag's pooled vector, chunks of 2048 of its attention rows.
//     A unit takes the bag's max m and s over its valid tiles' (m_t, s_t),
//     in tile order, then sums exp(m_t - m) acc_t in four fixed slices of
//     the tiles, joined in order, into pooled = acc / max(s, 1e-30), or
//     rewrites its rows as exp(a - m) / s under the mask, 0 elsewhere.
//     Every sum's order depends on the bag alone, not on which block ran
//     what: the same bag gives the same bits whatever the other bags hold,
//     run after run.  A bag without a valid row gets zeros.  (A first
//     design joined each bag in the one block that completed its count of
//     tiles, as a ticket said; that block's latency-bound reads of the
//     bag's partials and attention made the join cost ~40 us of ~130 at 8
//     x 8192 x 768 and ~16 of ~32 at 1 x 8202 x 512; spread over every
//     block it costs ~8 and ~5: eval/probe_mil_pool.py, PERF.md.)
//   The transcendentals use the MUFU pipe's tanh.approx (sigmoid(v) =
//   tanh(v / 2) / 2 + 1 / 2): relative error ~2^-11, well inside the
//   products' bf16 rounding of V and U.
//
// fp32: plain FMAs, so that an fp32 bag keeps fp32 numerics (no TF32): two
// passes, pass 1 a block per 64 rows (products over V and U streamed with
// cp.async, the tile's partial), pass 2 the join.
//
// Masked rows and the ragged edge past N contribute nothing whatever they
// hold (NaN included).  An all-masked bag gives zeros.
//
// Builds that skip one phase each (the MIL_POOL_SKIP_* macros, driven by
// eval/probe_mil_pool.py) split the bf16 kernel's time between the loads,
// the products, the pooling pass and the join; MIL_POOL_SETUP_ONLY stops
// after the launch and the mask's scan.
//
// Plain C interface, no allocation, no synchronisation: the caller hands in
// outputs, scratch and the stream to launch on.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_sm90.cuh"

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

// The gate products of one fp32 block: acc += x_tile(TILE_M x KC) @
// {V,U}(KC x 192) chunk by chunk, then per row sum_d w_d tanh(.)_d
// sigmoid(.)_d.  It names its tile (TILE_M rows, THREADS threads, KC columns
// of K a chunk) and the layout of one stage of the chunk ring in shared
// memory: the row tile's chunk (row stride XS_LD), then V's and U's (row
// stride W_LD).
template <typename T>
struct Gate;

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

// 16 bytes of an fp32 bag
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
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

// --------------------------------------------------------------- bf16 --
namespace bf {

using sm90::bf16;
using namespace sm90;

constexpr int KC = 32;                  // columns a chunk of the products: 64 bytes a row
constexpr int PC = KC;                  // columns a chunk of the pooling pass
constexpr int GR = 2 * kD;              // rows of the packed gates
constexpr int GBOX = 96;                // gate rows a TMA box
constexpr uint32_t G_BYTES = GR * KC * 2;
constexpr int THREADS = 384;            // two consumer warpgroups + the producer warpgroup
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr int CONSUMERS = 256;
constexpr int MAX_WORDS = 2048;         // a bit a tile: 65536 tiles a call
constexpr int MAX_TILES = MAX_WORDS * 32;
constexpr int MAX_GROUPS = MAX_WORDS / 32;   // prefix counts, one a 32 words
constexpr int JOIN = 256;               // pieces a batch of a join
constexpr int CONSUMER_BAR = 3;         // named barrier of the 256 consumer threads

template <int MT>
struct Shape {
  static constexpr int R = 64 * MT;                      // rows a tile
  static constexpr uint32_t X_BYTES = R * KC * 2;        // its rows of a K-chunk
  static constexpr uint32_t P_BYTES = R * PC * 2;        // its rows of a pooling chunk
  static constexpr uint32_t STAGE = X_BYTES + G_BYTES;
  // the products' ring, and the pooling pass's
  static constexpr int STAGES = MT == 1 ? 6 : 5;
  static constexpr int PSTAGES = MT == 1 ? 8 : 4;
  // shared memory from a 1024-byte boundary: the rings, then
  static constexpr uint32_t RING = 0;
  static constexpr uint32_t PRING = RING + STAGES * STAGE;
  static constexpr uint32_t FLOATS = PRING + PSTAGES * P_BYTES;
  // floats: bv, bu, w (3 x 192), the warpgroups' row partials (2 x 64), the
  // tile's logits and e (2 x 128), the pooling pass's sums (2 x 8 x PC),
  // the weights of a join's batch of tiles (JOIN), 8 scalars, a join's
  // slices (CONSUMERS float4)
  static constexpr uint32_t N_FLOATS =
      3 * kD + 2 * 64 + 2 * 128 + 2 * 8 * PC + JOIN + 8 + 4 * CONSUMERS;
  static constexpr uint32_t WORDS = FLOATS + 4 * N_FLOATS;
  static constexpr uint32_t GROUPS = WORDS + 4 * MAX_WORDS;
  static constexpr uint32_t INTS = GROUPS + 4 * (MAX_GROUPS + 1);
  // ints: 8 scalars, the tiles of a join's batch (JOIN)
  static constexpr uint32_t BARS = (INTS + 4 * (8 + JOIN) + 7) / 8 * 8;
  static constexpr uint32_t END = BARS + 8 * (2 * STAGES + 2 * PSTAGES);
  static constexpr size_t SMEM = 1024 + END;
};
static_assert(Shape<2>::SMEM <= 232448 && Shape<1>::SMEM <= 232448,
              "the rings exceed an SM's shared memory");
static_assert(Shape<1>::X_BYTES % 1024 == 0 && G_BYTES % 1024 == 0 &&
                  (GBOX * KC * 2) % 1024 == 0 && Shape<1>::P_BYTES % 1024 == 0,
              "swizzled tiles start on 1024 bytes");
static_assert(KC * 2 == 64, "the descriptors and maps assume 64-byte rows (64-byte swizzle)");

__device__ __forceinline__ float tanh_approx(float v) {
  float r;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float sigmoid_approx(float v) {
  return fmaf(0.5f, tanh_approx(0.5f * v), 0.5f);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(CONSUMER_BAR), "n"(CONSUMERS) : "memory");
}

// The valid tiles: bit t of words[] is set where tile t (bag t / T, rows
// (t % T) R on) holds a valid row; groups[g] counts the bits of the words
// before word 32 g, so that a block finds its first tile quickly.
struct Tiles {
  const uint32_t* words;
  const int* groups;
  int n_groups;

  __device__ bool valid(int t) const { return (words[t >> 5] >> (t & 31)) & 1u; }

  // the tile of valid index c (c < the count of valid tiles)
  __device__ int select(int c) const {
    int g = 0;
    while (g + 1 < n_groups && groups[g + 1] <= c) ++g;
    int w = g << 5, seen = groups[g];
    for (;; ++w) {
      const int p = __popc(words[w]);
      if (seen + p > c) break;
      seen += p;
    }
    uint32_t bits = words[w];
    for (int k = c - seen; k > 0; --k) bits &= bits - 1u;
    return (w << 5) + __ffs(bits) - 1;
  }

  // the first valid tile after t (one exists)
  __device__ int next(int t) const {
    int w = (t + 1) >> 5;
    uint32_t bits = words[w] & (~0u << ((t + 1) & 31));
    while (bits == 0u) bits = words[++w];
    return (w << 5) + __ffs(bits) - 1;
  }
};

// Sets the bits of the tiles that hold a nonzero byte of the mask (B x N
// bytes), all threads of the block.
template <int MT>
__device__ void mark_tiles(const uint8_t* __restrict__ mask, uint32_t* words, int N, int T,
                           int total) {
  constexpr int R = Shape<MT>::R;
  auto mark = [&](int f) {            // byte f of the mask
    const int b = f / N, n = f - b * N;
    const int t = b * T + n / R;
    atomicOr(&words[t >> 5], 1u << (t & 31));
  };
  const int head = min(total, (int)((16 - reinterpret_cast<uintptr_t>(mask) % 16) % 16));
  for (int f = threadIdx.x; f < head; f += THREADS)
    if (mask[f]) mark(f);
  const int vecs = (total - head) / 16;
  const uint4* v16 = reinterpret_cast<const uint4*>(mask + head);
  constexpr int U = 8;                   // loads in flight a thread
  for (int i0 = threadIdx.x; i0 < vecs; i0 += U * THREADS) {
    uint4 vs[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS;
      vs[u] = i < vecs ? __ldg(v16 + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint4 v = vs[u];
      if ((v.x | v.y | v.z | v.w) == 0u) continue;
      const int f0 = head + 16 * (i0 + u * THREADS);
      const int b = f0 / N, n = f0 - b * N;
      if (n + 15 < N && n % R + 15 < R) {          // one tile of one bag
        const int t = b * T + n / R;
        atomicOr(&words[t >> 5], 1u << (t & 31));
      } else {
        const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&v);
        for (int k = 0; k < 16; ++k)
          if (bytes[k]) mark(f0 + k);
      }
    }
  }
  for (int f = head + 16 * vecs + threadIdx.x; f < total; f += THREADS)
    if (mask[f]) mark(f);
}

// Warpgroup wg's products of one staged K-chunk: two k16 steps, each one
// m64n192k16 a gate half it holds.  A: its 64 rows of the chunk, K-major,
// 64-byte swizzle, 8 rows 512 bytes (SBO), step s 32 s bytes into the rows.
// B: the half's 192 packed gate rows, K-major, the same layout.
template <int MT>
__device__ __forceinline__ void products(float (&acc)[MT][96], const unsigned char* stage,
                                         int wg) {
  const uint32_t xa = smem_u32(stage) + (MT == 2 ? wg * 64 * KC * 2 : 0);
  const uint32_t ga = smem_u32(stage + Shape<MT>::X_BYTES);
#pragma unroll
  for (int s = 0; s < KC / 16; ++s) {
    const uint64_t a = smem_desc(xa + s * 32, 16, 512, 2);
#pragma unroll
    for (int hh = 0; hh < MT; ++hh) {
      const int h = MT == 2 ? hh : wg;
      wgmma_n192<0, 0>(acc[hh], a, smem_desc(ga + h * kD * KC * 2 + s * 32, 16, 512, 2));
    }
  }
}

// One block's share of the joins, after every tile is done: the units are
// the bags' pooled vectors in slices of 64 column quads, then their
// attention rows in chunks of 8 x CONSUMERS, dealt out round-robin to the
// blocks.  A unit first takes its bag's max m and sum s over the bag's
// valid tiles' (m_t, s_t), in tile order (each unit of a bag computes the
// same m and s from the same partials: the same bits); a pooled unit then
// sums exp(m_t - m) acc_t over the tiles in four contiguous slices of
// them, in order, joined in order through shared memory, and divides by
// max(s, 1e-30); an attention unit rewrites its rows as exp(a - m) / s
// under the mask, 0 elsewhere.  Every sum's order depends on the bag
// alone: the same bag gives the same bits whatever the other bags hold.  A
// bag without a valid row gets zeros.  Every consumer thread of the block;
// the loads are latency-bound, so each thread keeps many in flight.
struct Join {
  const uint8_t* mask;
  float* pooled;
  float* attn;
  const float* part;
  Tiles tiles;
  int B, T, N, L;
  int* s_tile;                           // [JOIN]: a batch's valid tiles
  float* s_wj;                           // [JOIN]: their weights
  float* s_f;                            // scalars
  int* s_i;                              // scalars
  float* s_red4;                         // [CONSUMERS][4]: the slices' sums
};

__device__ __forceinline__ void join_units(const Join& J) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int T = J.T, N = J.N, L = J.L, Q = L / 4;
  const int col_slices = (Q + 63) / 64, row_chunks = (N + 8 * CONSUMERS - 1) / (8 * CONSUMERS);
  const int units = J.B * (col_slices + row_chunks);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const bool pooled_unit = u < J.B * col_slices;
    const int b = pooled_unit ? u / col_slices : (u - J.B * col_slices) / row_chunks;
    const int part_no = pooled_unit ? u % col_slices : (u - J.B * col_slices) % row_chunks;
    const float* src = J.part + (size_t)b * T * (L + 4);
    auto piece = [&](int i) { return src + (size_t)i * (L + 4); };
    auto valid = [&](int i) { return J.tiles.valid(b * T + i); };
    // warp 0: the bag's max and sum; a batch's valid tiles, in order, with
    // their weights
    auto batch = [&](int i0, float m, float* sum) {
      int cnt = 0;
      for (int i = i0 + lane; i - lane < min(T, i0 + JOIN); i += 32) {
        const bool v = i < T && valid(i);
        float mi = 0.0f, si = 0.0f;
        if (v) {
          mi = __ldcg(piece(i));
          si = __ldcg(piece(i) + 1);
        }
        const float w = v ? expf(mi - m) : 0.0f;
        if (sum) *sum = fmaf(si, w, *sum);
        const unsigned int bal = __ballot_sync(0xffffffffu, v);
        if (v) {
          const int pos = cnt + __popc(bal & ((1u << lane) - 1u));
          J.s_tile[pos] = i;
          J.s_wj[pos] = w;
        }
        cnt += __popc(bal);
      }
      if (lane == 0) J.s_i[1] = cnt;
    };
    if (warp == 0) {
      float m = kNegInf;
      for (int i = lane; i < T; i += 32)
        if (valid(i)) m = fmaxf(m, __ldcg(piece(i)));
      m = warp_max(m);
      float sum = 0.0f;
      for (int i0 = JOIN; i0 < T; i0 += JOIN) batch(i0, m, &sum);
      batch(0, m, &sum);                 // the first batch's list stays
      sum = warp_sum(sum);
      if (lane == 0) {
        J.s_f[2] = m;
        J.s_f[3] = fmaxf(sum, 1e-30f);
      }
    }
    consumer_sync();
    const float m = J.s_f[2], denom = J.s_f[3];
    if (pooled_unit) {
      float4* out = reinterpret_cast<float4*>(J.pooled + (size_t)b * L);
      float4* red = reinterpret_cast<float4*>(J.s_red4);
      const int qd = part_no * 64 + (tid & 63), sl = tid >> 6;   // 4 slices
      for (int i0 = 0; i0 < T; i0 += JOIN) {
        if (i0 > 0) {
          if (warp == 0) batch(i0, m, nullptr);
          consumer_sync();
        }
        const int cnt = J.s_i[1];
        const int k_lo = cnt * sl / 4, k_hi = cnt * (sl + 1) / 4;
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        constexpr int P = 16;            // loads in flight
        for (int k0 = k_lo; k0 < k_hi; k0 += P) {
          float4 v[P];
#pragma unroll
          for (int kk = 0; kk < P; ++kk)
            v[kk] = k0 + kk < k_hi && qd < Q
                        ? __ldcg(reinterpret_cast<const float4*>(piece(J.s_tile[k0 + kk]) + 4) + qd)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int kk = 0; kk < P; ++kk) {
            if (k0 + kk >= k_hi) break;
            const float w = J.s_wj[k0 + kk];
            acc.x = fmaf(w, v[kk].x, acc.x);
            acc.y = fmaf(w, v[kk].y, acc.y);
            acc.z = fmaf(w, v[kk].z, acc.z);
            acc.w = fmaf(w, v[kk].w, acc.w);
          }
        }
        red[tid] = acc;
        consumer_sync();
        if (sl == 0 && qd < Q) {         // the slices, in order
          float4 t4 = i0 == 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : out[qd];
          for (int s = 0; s < 4; ++s) {
            const float4 r4 = red[s * 64 + (tid & 63)];
            t4.x += r4.x;
            t4.y += r4.y;
            t4.z += r4.z;
            t4.w += r4.w;
          }
          if (i0 + JOIN >= T) {
            t4.x /= denom;
            t4.y /= denom;
            t4.z /= denom;
            t4.w /= denom;
          }
          out[qd] = t4;
        }
        consumer_sync();
      }
    } else {                             // 8 rows a thread, in flight
      const int r0 = part_no * 8 * CONSUMERS;
      float a[8];
      uint8_t v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = r0 + k * CONSUMERS + tid;
        const size_t i = (size_t)b * N + r;
        v[k] = r < N ? J.mask[i] : 0;
        a[k] = r < N ? __ldcg(J.attn + i) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = r0 + k * CONSUMERS + tid;
        if (r < N) J.attn[(size_t)b * N + r] = v[k] ? expf(a[k] - m) / denom : 0.0f;
      }
      consumer_sync();                   // before the next unit's scalars
    }
  }
}

// Every block of the grid has arrived (the launch is cooperative: all are
// resident at once).  bar[0] counts arrivals and is reset by the last;
// bar[1] is the generation, which the last moves on.
__device__ __forceinline__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();                     // this block's writes, for every block
    if (atomicAdd(bar, 1u) + 1u == gridDim.x) {
      bar[0] = 0u;
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

template <int MT>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap pmap,
       const __grid_constant__ CUtensorMap gmap, const uint8_t* __restrict__ mask,
       const float* __restrict__ bv, const float* __restrict__ bu,
       const float* __restrict__ ww, const float* __restrict__ bw, float* __restrict__ pooled,
       float* attn, float* part, unsigned int* bar, int B, int N, int L) {
  using S = Shape<MT>;
  constexpr int R = S::R;
  extern __shared__ __align__(1024) unsigned char bf_smem[];
  unsigned char* base = bf_smem + ((1024 - smem_u32(bf_smem) % 1024) % 1024);
  unsigned char* ring = base + S::RING;
  unsigned char* pring = base + S::PRING;
  float* s_bv = reinterpret_cast<float*>(base + S::FLOATS);
  float* s_bu = s_bv + kD;
  float* s_ww = s_bu + kD;
  float* s_rp = s_ww + kD;               // [2][64]: the warpgroups' row partials
  float* s_lg = s_rp + 2 * 64;           // [128]: the tile's masked logits
  float* s_e = s_lg + 128;               // [128]: e, or -1 on a masked row
  float* s_red = s_e + 128;              // [2][8][PC]: the pooling pass's sums
  float* s_wj = s_red + 2 * 8 * PC;      // [JOIN]: a join's weights
  float* s_f = s_wj + JOIN;              // scalars
  float* s_red4 = s_f + 8;               // [CONSUMERS][4]: a join's slices
  uint32_t* words = reinterpret_cast<uint32_t*>(base + S::WORDS);
  int* groups = reinterpret_cast<int*>(base + S::GROUPS);
  int* s_i = reinterpret_cast<int*>(base + S::INTS);
  int* s_tile = s_i + 8;                 // [JOIN]: a join's tiles
  constexpr int STAGES = S::STAGES, PSTAGES = S::PSTAGES;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* pfull = empty + STAGES;
  uint64_t* pempty = pfull + PSTAGES;

  const int tid = threadIdx.x;
  const int T = (N + R - 1) / R;         // tiles a bag
  const int n_tiles = B * T;
  const int n_words = (n_tiles + 31) >> 5;
  const int n_groups = (n_words + 31) >> 5;
  const int nk = L / KC;                 // chunks a tile, of the products and of the pooling
  const int G = gridDim.x, j = blockIdx.x;

  // ------------------------------------------------ set-up: every thread --
  for (int w = tid; w < n_words; w += THREADS) words[w] = 0u;
  if (tid < kD) {
    s_bv[tid] = bv[tid];
    s_bu[tid] = bu[tid];
    s_ww[tid] = ww[tid];
  }
  if (tid == 0) {
    s_f[5] = bw[0];
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);           // every consumer warp
    }
    for (int s = 0; s < PSTAGES; ++s) {
      mbar_init(&pfull[s], 1);
      mbar_init(&pempty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  mark_tiles<MT>(mask, words, N, T, B * N);
  __syncthreads();
  if (tid < n_groups) {
    int c = 0;
    for (int w = tid << 5; w < min(n_words, (tid + 1) << 5); ++w) c += __popc(words[w]);
    groups[tid + 1] = c;
  }
  __syncthreads();
  if (tid == 0) {
    groups[0] = 0;
    for (int g = 1; g <= n_groups; ++g) groups[g] += groups[g - 1];
  }
  __syncthreads();
  const Tiles tiles{words, groups, n_groups};
  const int U = groups[n_groups];        // valid tiles
  const int K = (U + G - 1) / G;         // valid tiles a block
  const int mine = max(0, min(K, U - j * K));
#ifdef MIL_POOL_SETUP_ONLY
  return;                                // the launch and the mask's scan alone
#endif

  if (tid >= CONSUMERS) {                // --------------------- producer --
    setmaxnreg_dec<PRODUCER_REGS>();
    // One thread fills both rings in the order the consumers drain them:
    // chunk c of tile k's products, then chunk c of tile k - 1's pooling
    // pass (the last tile's after its products), so it never waits for a
    // stage that waits for it.
    if (tid == CONSUMERS) {
      int t = mine > 0 ? tiles.select(j * K) : 0, prev = 0;
      uint32_t g = 0, pg = 0;
      auto pool_load = [&](int tile, int q) {
        const int s = pg % PSTAGES;
        if (pg >= PSTAGES) mbar_wait(&pempty[s], (pg / PSTAGES - 1) & 1);
        ++pg;
        const int pb = tile / T, pn0 = (tile - pb * T) * R;
        bool load = true;
#if defined(MIL_POOL_SKIP_LOADS) || defined(MIL_POOL_SKIP_POOL)
        load = false;
#endif
        mbar_expect_tx(&pfull[s], load ? S::P_BYTES : 0);
        if (load) tma_load_3d(pring + s * S::P_BYTES, &pmap, &pfull[s], q * PC, pn0, pb);
      };
      for (int k = 0; k < mine; ++k) {
        if (k > 0) t = tiles.next(t);
        const int b = t / T, n0 = (t - b * T) * R;
        for (int c = 0; c < nk; ++c, ++g) {
          const int s = g % STAGES;
          if (g >= STAGES) mbar_wait(&empty[s], (g / STAGES - 1) & 1);
          unsigned char* st = ring + s * S::STAGE;
          bool load = true;
#ifdef MIL_POOL_SKIP_LOADS
          load = false;
#endif
          mbar_expect_tx(&full[s], load ? S::X_BYTES + G_BYTES : 0);
          if (load) {
            tma_load_3d(st, &xmap, &full[s], c * KC, n0, b);
            for (int q = 0; q < GR / GBOX; ++q)
              tma_load_2d(st + S::X_BYTES + q * GBOX * KC * 2, &gmap, &full[s], c * KC,
                          q * GBOX);
          }
          if (k > 0) pool_load(prev, c);
        }
        prev = t;
      }
      if (mine > 0)
        for (int c = 0; c < nk; ++c) pool_load(prev, c);
    }
    __syncwarp();
    grid_sync(bar);                      // the consumers' joins follow; nothing to do
    return;
  }

  // ---------------------------------------------------------- consumers --
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const bool warp_leader = lane == 0;
  float acc[MT][96];
  uint32_t g = 0, pg = 0;                // chunks taken from the two rings
  int t = mine > 0 ? tiles.select(j * K) : 0;
  bool pend = false;                     // a tile whose pooling pass is due
  float* pend_part = part;               // its partial

  // Pooling chunk q of the pending tile: sum_n e_n x_n over its valid rows
  // for PC columns, from the pooling ring; lane = (column pair, row
  // parity), warp = rows 2 (warp + 8 i) + parity; the eight warps' sums are
  // joined through shared memory into the tile's partial.
  auto pool_chunk = [&](int q) {
    const int s = pg % PSTAGES;
    mbar_wait(&pfull[s], (pg / PSTAGES) & 1);
    ++pg;
    const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(pring + s * S::P_BYTES);
    const int pair = lane & 15, par = lane >> 4;
    float a0 = 0.0f, a1 = 0.0f;
#ifndef MIL_POOL_SKIP_POOL
#pragma unroll
    for (int i = 0; i < R / 16; ++i) {
      const int r = 2 * (warp + 8 * i) + par;
      const float e = s_e[r];
      const float2 f = __bfloat1622float2(xs[r * (PC / 2) + pair]);
      const float s0 = fmaf(e, f.x, a0), s1 = fmaf(e, f.y, a1);
      a0 = e >= 0.0f ? s0 : a0;          // a masked row (e = -1) adds nothing
      a1 = e >= 0.0f ? s1 : a1;
    }
#endif
    __syncwarp();
    if (warp_leader) mbar_arrive(&pempty[s]);
    a0 += __shfl_xor_sync(0xffffffffu, a0, 16);
    a1 += __shfl_xor_sync(0xffffffffu, a1, 16);
    float* red = s_red + (q & 1) * 8 * PC;
    if (par == 0) {
      red[warp * PC + 2 * pair] = a0;
      red[warp * PC + 2 * pair + 1] = a1;
    }
    consumer_sync();
    if (tid < PC) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < 8; ++w) sum += red[w * PC + tid];
      pend_part[4 + q * PC + tid] = sum;
    }
  };

  for (int k = 0; k < mine; ++k) {
    if (k > 0) t = tiles.next(t);
    const int b = t / T, n0 = (t - b * T) * R;
    // the tile's mask, read now so that the epilogue does not wait for it
    const bool row_valid = tid < R && n0 + tid < N && mask[(size_t)b * N + n0 + tid] != 0;
    // the products of this tile, the previous tile's pooling pass between
#pragma unroll
    for (int hh = 0; hh < MT; ++hh)
#pragma unroll
      for (int i = 0; i < 96; ++i) acc[hh][i] = 0.0f;
    fence_acc(acc);
    int held = -1;
    for (int c = 0; c < nk; ++c, ++g) {
      const int s = g % STAGES;
      mbar_wait(&full[s], (g / STAGES) & 1);
#ifndef MIL_POOL_SKIP_MMA
      wgmma_fence();
      products<MT>(acc, ring + s * S::STAGE, wg);
      wgmma_commit();
#endif
      if (pend) pool_chunk(c);
#ifndef MIL_POOL_SKIP_MMA
      wgmma_wait<1>();
#endif
      if (held >= 0 && warp_leader) mbar_arrive(&empty[held]);
      held = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (held >= 0 && warp_leader) mbar_arrive(&empty[held]);

    // the tile's logits: each thread's two rows over its columns, then the
    // row partials of the warpgroups joined through shared memory
    {
      const int q = warp & 3, g8 = lane >> 2, tq = lane & 3;
      float lo = 0.0f, hi = 0.0f;
#ifndef MIL_POOL_SKIP_MMA
#pragma unroll
      for (int hh = 0; hh < MT; ++hh) {
        const int h = MT == 2 ? hh : wg;
#pragma unroll
        for (int jj = 0; jj < 12; ++jj)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int col = 96 * h + 8 * jj + 2 * tq + cc;
            const float w = s_ww[col], bvv = s_bv[col], buu = s_bu[col];
            lo = fmaf(w, tanh_approx(acc[hh][4 * jj + cc] + bvv) *
                             sigmoid_approx(acc[hh][4 * (jj + 12) + cc] + buu), lo);
            hi = fmaf(w, tanh_approx(acc[hh][4 * jj + 2 + cc] + bvv) *
                             sigmoid_approx(acc[hh][4 * (jj + 12) + 2 + cc] + buu), hi);
          }
      }
#endif
      lo += __shfl_xor_sync(0xffffffffu, lo, 1);
      lo += __shfl_xor_sync(0xffffffffu, lo, 2);
      hi += __shfl_xor_sync(0xffffffffu, hi, 1);
      hi += __shfl_xor_sync(0xffffffffu, hi, 2);
      if (tq == 0) {
        s_rp[wg * 64 + 16 * q + g8] = lo;
        s_rp[wg * 64 + 16 * q + g8 + 8] = hi;
      }
    }
    consumer_sync();
    if (tid < R) {
      const float a = (MT == 2 ? s_rp[tid] : s_rp[tid] + s_rp[64 + tid]) + s_f[5];
      if (row_valid) attn[(size_t)b * N + n0 + tid] = a;
      s_lg[tid] = row_valid ? a : kNegInf;
      s_e[tid] = row_valid ? 1.0f : -1.0f;   // validity, until e replaces it
    }
    consumer_sync();
    float* tp = part + (size_t)t * (L + 4);
    if (warp == 0) {                     // the tile's max m_t, e = exp(a - m_t), their sum
      float mt = kNegInf;
      for (int r = lane; r < R; r += 32) mt = fmaxf(mt, s_lg[r]);
      mt = warp_max(mt);
      float sum = 0.0f;
      for (int r = lane; r < R; r += 32) {
        const bool valid = s_e[r] >= 0.0f;
        const float e = valid ? expf(s_lg[r] - mt) : -1.0f;
        s_e[r] = e;
        sum += valid ? e : 0.0f;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        tp[0] = mt;
        tp[1] = sum;
      }
    }
    consumer_sync();
    pend = true;
    pend_part = tp;
  }
  if (pend)                              // the last tile's pooling pass
    for (int q = 0; q < nk; ++q) pool_chunk(q);

  __threadfence();                       // the partials and the logits out
  grid_sync(bar);                        // every tile of every bag is done
#ifndef MIL_POOL_SKIP_JOIN
  join_units(Join{mask, pooled, attn, part, tiles, B, T, N, L, s_tile, s_wj, s_f, s_i, s_red4});
#endif
}

}  // namespace bf
// --------------------------------------------------------------- host --

// fp32: pass 1 then pass 2; part_ms (B, n_tiles, 2) and part_acc (B,
// n_tiles, L) one after the other in the scratch.
cudaError_t launch_fp32(const void* x, const void* mask, const void* wv, const void* wu,
                        const void* bv, const void* bu, const void* ww, const void* bw,
                        void* pooled, void* attn, void* scratch, int B, int N, int L,
                        cudaStream_t stream) {
  using G = Gate<float>;
  const int n_tiles = (N + G::TILE_M - 1) / G::TILE_M;
  float* part_ms = static_cast<float*>(scratch);
  float* part_acc = part_ms + (size_t)B * n_tiles * 2;
  constexpr size_t smem = pass1_smem_bytes<float>();
  cudaError_t err = cudaFuncSetAttribute(mil_pool_pass1<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mil_pool_pass1<float><<<dim3(n_tiles, B), G::THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(wv), static_cast<const float*>(wu),
      static_cast<const float*>(bv), static_cast<const float*>(bu),
      static_cast<const float*>(ww), static_cast<const float*>(bw), static_cast<float*>(attn),
      part_ms, part_acc, N, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mil_pool_pass2<<<dim3(L / kCols2, B), kThreads2, 0, stream>>>(
      static_cast<const uint8_t*>(mask), part_ms, part_acc, static_cast<float*>(pooled),
      static_cast<float*>(attn), N, L, n_tiles);
  return cudaGetLastError();
}

namespace bf {

// The plan of a call: tiles of 128 rows where there is one for every SM,
// else of 64; as many blocks as the card holds at once (one an SM), at most
// one a tile.
struct Plan {
  int mt, resident;
};

template <int MT>
cudaError_t resident_blocks(int* blocks) {
  auto kern = kernel<MT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Shape<MT>::SMEM);
  if (err != cudaSuccess) return err;
  unsigned int grid = 0;
  if ((err = persistent_grid(kern, THREADS, Shape<MT>::SMEM, 1LL << 30, &grid)) != cudaSuccess)
    return err;
  *blocks = (int)grid;
  return cudaSuccess;
}

// The SM count and the resident blocks of either tile height, found once a
// device (the queries cost more than a launch).
inline cudaError_t plan(int B, int N, Plan* p) {
  constexpr int kDevices = 64;
  static int sms[kDevices], resident[kDevices][2];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    int n = 0, r1 = 0, r2 = 0;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (err = resident_blocks<1>(&r1)) != cudaSuccess ||
        (err = resident_blocks<2>(&r2)) != cudaSuccess)
      return err;
    resident[device][0] = r1;
    resident[device][1] = r2;
    sms[device] = n;
  }
  p->mt = (long long)B * ((N + 127) / 128) >= sms[device] ? 2 : 1;
  p->resident = resident[device][p->mt - 1];
  return cudaSuccess;
}


// The tensor maps are built here for each call: x as (L, N, B) in boxes
// of KC x R rows, 64-byte swizzled, and in the same boxes unswizzled for
// the pooling pass (rows past N arrive as zeros); the packed gates as (L,
// 384) in boxes of KC x GBOX, 64-byte swizzled.  The launch is cooperative:
// its blocks wait for each other once, before the joins.
template <int MT>
cudaError_t launch(const bf16* x, const uint8_t* mask, const bf16* gates, const float* bv,
                   const float* bu, const float* ww, const float* bw, float* pooled,
                   float* attn, float* part, unsigned int* bar, int B, int N, int L,
                   int resident, cudaStream_t stream) {
  constexpr int R = Shape<MT>::R;
  const int tiles = B * ((N + R - 1) / R);
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  const cuuint64_t e = sizeof(bf16);
  const cuuint64_t xd[3] = {(cuuint64_t)L, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t xs[2] = {L * e, (cuuint64_t)N * L * e};
  const cuuint32_t xbox[3] = {KC, R, 1};
  const cuuint32_t pbox[3] = {PC, R, 1};
  const cuuint64_t gd[2] = {(cuuint64_t)L, GR};
  const cuuint64_t gs[1] = {L * e};
  const cuuint32_t gbox[2] = {KC, GBOX};
  cudaError_t err;
  if ((err = encode(&maps[0], x, 3, xd, xs, xbox, CU_TENSOR_MAP_SWIZZLE_64B)) != cudaSuccess ||
      (err = encode(&maps[1], x, 3, xd, xs, pbox, CU_TENSOR_MAP_SWIZZLE_NONE)) != cudaSuccess ||
      (err = encode(&maps[2], gates, 2, gd, gs, gbox, CU_TENSOR_MAP_SWIZZLE_64B)) != cudaSuccess)
    return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.gridDim = dim3(tiles < resident ? tiles : resident);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Shape<MT>::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel<MT>, maps[0], maps[1], maps[2], mask, bv, bu, ww, bw,
                           pooled, attn, part, bar, B, N, L);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace bf

}  // namespace

// Floats of scratch a call needs (the caller allocates them): a partial of
// L + 2 floats (float32; dtype 0) or L + 4 (bfloat16; 1) for each tile of
// 64 rows, which covers the bf16 kernel's tiles of either height.
extern "C" long long mil_pool_scratch_floats(int B, int N, int L, int dtype) {
  return (long long)B * ((N + 63) / 64) * (L + (dtype == 0 ? 2 : 4));
}

// The bf16 plan of a call on the current device: rows a tile and resident
// blocks.  Returns 0 or a cudaError_t.
extern "C" int mil_pool_plan(int B, int N, int* rows, int* blocks) {
  bf::Plan p;
  const cudaError_t err = bf::plan(B, N, &p);
  if (err != cudaSuccess) return (int)err;
  *rows = 64 * p.mt;
  *blocks = p.resident;
  return 0;
}

// x: (B, N, L) of dtype (0 = float32, 1 = bfloat16), contiguous, 16-byte
// aligned; mask: (B, N) bytes, non-zero = valid; bv, bu, ww: (192,) float32;
// bw: (1,) float32; pooled: (B, L) float32; attn: (B, N) float32.  float32:
// gv, gu are V and U, (L, 192) float32 each.  bfloat16: gv is the packed
// gates, (384, L) bf16 (rows 192 h + i, i < 96: V's column 96 h + i; rows
// 192 h + 96 + i: U's), gu is unused; bar: 2 unsigned ints, zero before
// the first call, which the kernel's grid barrier leaves fit for the next
// call on the same stream.  scratch: mil_pool_scratch_floats() floats.  L
// must be a multiple of 64, D 192, and a bf16 call at most MAX_TILES = 65536
// tiles of 64 rows (B x ceil(N / 64)).  Returns 0, a cudaError_t, or -1 for
// a shape or type the kernel does not take.
extern "C" int mil_pool_fwd(const void* x, const void* mask, const void* gv, const void* gu,
                            const void* bv, const void* bu, const void* ww, const void* bw,
                            void* pooled, void* attn, void* scratch, void* bar, int B, int N,
                            int L, int D, int dtype, void* stream) {
  if (D != kD || L <= 0 || L % 64 != 0 || B <= 0 || B > 65535 || N <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fp32(x, mask, gv, gu, bv, bu, ww, bw, pooled, attn, scratch, B, N, L, s);
  if (dtype != 1 || (long long)B * ((N + 63) / 64) > bf::MAX_TILES) return -1;
  bf::Plan p;
  cudaError_t err = bf::plan(B, N, &p);
  if (err != cudaSuccess) return (int)err;
  auto go = p.mt == 2 ? &bf::launch<2> : &bf::launch<1>;
  return (int)go(static_cast<const sm90::bf16*>(x), static_cast<const uint8_t*>(mask),
                 static_cast<const sm90::bf16*>(gv), static_cast<const float*>(bv),
                 static_cast<const float*>(bu), static_cast<const float*>(ww),
                 static_cast<const float*>(bw), static_cast<float*>(pooled),
                 static_cast<float*>(attn), static_cast<float*>(scratch),
                 static_cast<unsigned int*>(bar), B, N, L, p.resident, s);
}
