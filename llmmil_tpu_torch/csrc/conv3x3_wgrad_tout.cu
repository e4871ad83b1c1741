// Weight gradient of the 3x3 stride-1 SAME convolution of an NHWC tensor in
// transposed form, for Hopper (sm_90a):
//
//   dwt (F, 9C) = dy^T (F, P) . patch (P, 9C),   P = N*H*W pixels,
//   patch[p, (dr*3 + dc)*C + c] = x[n, h + dr - 1, w + dc - 1, c]   (0 outside)
//
// x and dy in one type (bf16 or fp32), products exact in fp32, fp32
// accumulation, dwt in fp32.  The caller turns dwt into (3, 3, C, F).
//
// Replaces the Pallas TPU kernel `_wgrad_tout_kernel` of
// llmmil_tpu/ops/pallas/conv3x3.py (`_conv_wgrad(mode="tout")`).  That kernel
// walks its grid in order on one core, builds each row block's (bh*W, 9C)
// im2col block in VMEM and adds dy^T . patch into one VMEM-resident (F, 9C)
// accumulator, so that the 1728 columns fill the matrix unit's output lanes.
// Here blocks run in parallel and in no order, and the reduction (2.6M pixels
// per CT volume) is huge against the (64, 1728) result, so:
//
//   - the pixel axis (the GEMM's K) is cut into `splits` contiguous ranges,
//     whole waves of blocks, none longer than 16384 pixels (see
//     choose_splits).  A block owns one range, BF output channels (M) and
//     one im2col column slice (N): one tap and BC channels of it; it keeps
//     its (BF x BC) partial of dwt in registers;
//   - per step of BK pixels it stages the (BK x BF) tile of dy and the (BK x
//     BC) im2col tile of its slice, gathered from x with cp.async, zeros for
//     the SAME padding and every ragged edge (conv3x3_im2col.cuh), through a
//     ring of stages;
//   - bf16: the pixel axis is the contracted one, so A = dy^T and B = the
//     im2col tile both come through ldmatrix.x4.trans from tiles whose rows
//     are pixels; 8 warps as 2 (channels) x 4 (columns), a warp 32 x 16,
//     mma.sync m16n8k16, 16 fp32 accumulators a thread.  fp32: plain FMAs,
//     4 output channels x 4 columns a thread (parity only, no TF32);
//   - no float atomics: every block writes its partial into a workspace, and
//     a second kernel adds the `splits` partials of each element in a fixed
//     order, so two runs give the same bits.
//
// What bounds it: 2*P*9*C*F operations against x and dy read once and dwt
// written once (at (160,128,128,192) x (..,64) in bf16: 5.8e11 operations,
// 0.59 ms at the 989 TFLOP/s peak, against 1.34 GB, 0.40 ms at 3.35 TB/s):
// operations.  The design reads more than that from L2: each of a range's
// 9 * C / BC column slices reads the range's dy tile again, and x once a tap;
// the slices of one range are neighbours in the grid, so those reads hit L2.
// mma.sync cannot reach the card's full tensor-core rate (wgmma can).
//
// Plain C interface, no allocation, no synchronisation: the caller hands in
// the workspace, the output and the stream to launch on.

#include "conv3x3_im2col.cuh"

namespace {

using im2col::Geo;

template <typename T>
struct Tile;

template <>
struct Tile<__nv_bfloat16> {
  static constexpr int BF = 64;         // output channels of a block (M)
  static constexpr int BC = 64;         // channels of the block's tap (N)
  static constexpr int BK = 64;         // pixels a step (K)
  static constexpr int THREADS = 256;
  static constexpr int STAGES = 3;      // 18 KB each
  static constexpr int D_LD = BF + 8;   // dy tile [pixel][channel]
  static constexpr int P_LD = BC + 8;   // im2col tile [pixel][column]
  static constexpr int DS = BK * D_LD;
  static constexpr int PS = BK * P_LD;
};

template <>
struct Tile<float> {
  static constexpr int BF = 64;
  static constexpr int BC = 64;
  static constexpr int BK = 32;
  static constexpr int THREADS = 256;
  static constexpr int STAGES = 2;      // 17 KB each
  static constexpr int D_LD = BF + 4;
  static constexpr int P_LD = BC + 4;
  static constexpr int DS = BK * D_LD;
  static constexpr int PS = BK * P_LD;
};

// A block's partial: step() adds one staged step's products, store() writes
// the partial into the workspace ([split][f][tap * C + c], fp32).
template <typename T>
struct Acc;

// bf16: warp (wf, wc) of 2 x 4 owns output channels 32 wf .. 32 wf + 31 (two
// m16 tiles) and columns 16 wc .. 16 wc + 15 (two n8 tiles).  In a 16x8 tile
// a thread holds output channels g = lane / 4 and g + 8, columns 2t, 2t + 1.
template <>
struct Acc<__nv_bfloat16> {
  using G = Tile<__nv_bfloat16>;
  float c[2][2][4];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][n][j] = 0.0f;
  }

  __device__ void step(const __nv_bfloat16* ds, const __nv_bfloat16* ps) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wf = warp & 1, wc = warp >> 1;
    // A (output channels x pixels) from the dy tile [pixel][channel], read
    // transposed: matrices (channels 0-7, pixels 0-7), (8-15, 0-7), (0-7,
    // 8-15), (8-15, 8-15)
    const int a_off = ((lane & 7) + ((lane >> 4) << 3)) * G::D_LD + wf * 32 + ((lane >> 3) & 1) * 8;
    // B (pixels x columns) from the im2col tile [pixel][column], read
    // transposed: matrices (pixels 0-7, n 0-7), (8-15, 0-7), (0-7, 8-15),
    // (8-15, 8-15): two n8 tiles
    const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * G::P_LD + wc * 16 + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < G::BK; kk += 16) {
      uint32_t b[4];
      im2col::ldsm_x4_trans(b, ps + b_off + kk * G::P_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t a[4];
        im2col::ldsm_x4_trans(a, ds + a_off + kk * G::D_LD + i * 16);
        im2col::mma(c[i][0], a, b[0], b[1]);
        im2col::mma(c[i][1], a, b[2], b[3]);
      }
    }
  }

  __device__ void store(float* part, int tap, int c0, int f0, int C, int F) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wf = warp & 1, wc = warp >> 1;
    const int g = lane >> 2, t = lane & 3;
    const size_t cols = 9 * (size_t)C;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int f = f0 + wf * 32 + i * 16 + g + half * 8;
        if (f >= F) continue;
        float* row = part + (size_t)f * cols + (size_t)tap * C;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int ch = c0 + wc * 16 + n * 8 + 2 * t;
          if (ch < C) row[ch] = c[i][n][half * 2];
          if (ch + 1 < C) row[ch + 1] = c[i][n][half * 2 + 1];
        }
      }
  }
};

// fp32: plain FMAs.  Thread (tc, tf) of 16 x 16 owns output channels 4 tf ..
// 4 tf + 3 and columns 4 tc .. 4 tc + 3.
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

  __device__ void step(const float* ds, const float* ps) {
    const int tc = threadIdx.x & 15, tf = threadIdx.x >> 4;
#pragma unroll 4
    for (int k = 0; k < G::BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(ds + k * G::D_LD + tf * 4);
      const float4 b = *reinterpret_cast<const float4*>(ps + k * G::P_LD + tc * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
    }
  }

  __device__ void store(float* part, int tap, int c0, int f0, int C, int F) const {
    const int tc = threadIdx.x & 15, tf = threadIdx.x >> 4;
    const size_t cols = 9 * (size_t)C;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = f0 + tf * 4 + i;
      if (f >= F) continue;
      float* row = part + (size_t)f * cols + (size_t)tap * C;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = c0 + tc * 4 + j;
        if (ch < C) row[ch] = c[i][j];
      }
    }
  }
};

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * Tile<T>::STAGES * (Tile<T>::DS + Tile<T>::PS);
}

struct Plan {
  int c_chunks, f_tiles;
  long long steps;              // pixel steps of BK pixels
  long long slices() const { return 9LL * c_chunks * f_tiles; }
};

template <typename T>
Plan plan(long long P, int C, int F) {
  using G = Tile<T>;
  return Plan{(C + G::BC - 1) / G::BC, (F + G::BF - 1) / G::BF, (P + G::BK - 1) / G::BK};
}

// Block b: column slice b % slices (output-channel tile fastest, then the
// channel chunk, then the tap), pixel range b / slices, so that the blocks of
// one range run side by side and find its dy tiles in L2.  The steps of the
// range pass through a ring of STAGES stages.
template <typename T>
__global__ void __launch_bounds__(Tile<T>::THREADS)
conv3x3_wgrad_tout_partial(const T* __restrict__ x, const T* __restrict__ dy,
                           float* __restrict__ ws, Geo g, int F, int c_chunks, int f_tiles,
                           long long steps, int splits) {
  using G = Tile<T>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  constexpr int STAGE = G::DS + G::PS;
  const int slices = 9 * c_chunks * f_tiles;
  const int sl = (int)(blockIdx.x % slices);
  const int s = (int)(blockIdx.x / slices);
  const int f0 = (sl % f_tiles) * G::BF;
  const int cc = (sl / f_tiles) % c_chunks;
  const int tap = sl / (f_tiles * c_chunks);
  const int c0 = cc * G::BC;
  const long long first = steps * s / splits;
  const long long my_steps = steps * (s + 1) / splits - first;

  auto start_loads = [&](long long q) {
    T* st = ring + (q % G::STAGES) * STAGE;
    const long long p0 = (first + q) * G::BK;
    im2col::load_rows<T, G::BK, G::BF, G::D_LD, G::THREADS>(st, dy, p0, g.P, F, f0);
    im2col::load_patch<T, G::BK, G::BC, G::P_LD, G::THREADS>(st + G::DS, x, p0, tap, c0, g);
    __pipeline_commit();
  };

  Acc<T> acc;
  acc.init();
  for (long long q = 0; q < G::STAGES - 1 && q < my_steps; ++q) start_loads(q);
  for (long long q = 0; q < my_steps; ++q) {
    im2col::wait_stage<G::STAGES>(q, my_steps);
    __syncthreads();
    if (q + G::STAGES - 1 < my_steps) start_loads(q + G::STAGES - 1);
    const T* st = ring + (q % G::STAGES) * STAGE;
    acc.step(st, st + G::DS);
  }
  acc.store(ws + (size_t)s * F * 9 * g.C, tap, c0, f0, g.C, F);
}

// dwt[e] = sum over the splits of ws[s][e], in the order of s: deterministic.
__global__ void conv3x3_wgrad_tout_reduce(const float* __restrict__ ws, float* __restrict__ dwt,
                                          long long count, int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < count;
       e += (long long)gridDim.x * blockDim.x) {
    float sum = 0.0f;
    for (int s = 0; s < splits; ++s) sum += ws[(size_t)s * count + e];
    dwt[e] = sum;
  }
}

// Sets the kernel's dynamic shared memory and returns how many of its
// blocks the card runs at once.
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, size_t smem, long long* resident) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *resident = (long long)sms * per_sm;
  return cudaSuccess;
}

// Pixel ranges: whole waves of the blocks the card runs at a time, enough
// waves that no range holds more than MAX_RANGE_PIXELS pixels (a thread's
// fp32 sum then runs over at most 16k products), and no more ranges than
// there are steps.
constexpr long long MAX_RANGE_PIXELS = 16384;

template <typename T>
cudaError_t choose_splits(long long P, int C, int F, int* splits) {
  using G = Tile<T>;
  const Plan p = plan<T>(P, C, F);
  long long resident = 0;
  cudaError_t err =
      resident_blocks(conv3x3_wgrad_tout_partial<T>, G::THREADS, smem_bytes<T>(), &resident);
  if (err != cudaSuccess) return err;
  const long long max_steps = MAX_RANGE_PIXELS / G::BK;
  const long long per_wave = (resident + p.slices() - 1) / p.slices();
  long long waves = (p.steps + max_steps * per_wave - 1) / (max_steps * per_wave);
  if (waves < 1) waves = 1;
  long long s = waves * per_wave;
  if (s > p.steps) s = p.steps;
  if (s < 1) s = 1;
  if (s * p.slices() > 2147483647LL) return cudaErrorInvalidConfiguration;
  *splits = (int)s;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, void* ws, void* dwt, int N, int H, int W,
                   int C, int F, int splits, cudaStream_t stream) {
  using G = Tile<T>;
  const Geo g{H, W, C, (long long)N * H * W};
  const Plan p = plan<T>(g.P, C, F);
  if (splits < 1 || splits > p.steps) return cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgrad_tout_partial<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)splits * p.slices();
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  conv3x3_wgrad_tout_partial<T><<<(unsigned int)blocks, G::THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<float*>(ws), g, F,
      p.c_chunks, p.f_tiles, p.steps, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long count = 9LL * C * F;
  const long long want = (count + 255) / 256;
  const unsigned int grid = (unsigned int)(want < 4096 ? want : 4096);
  conv3x3_wgrad_tout_reduce<<<grid, 256, 0, stream>>>(static_cast<const float*>(ws),
                                                      static_cast<float*>(dwt), count, splits);
  return cudaGetLastError();
}

}  // namespace

// The number of pixel ranges the kernel splits the N*H*W pixels into for this
// shape and type on the current device; the workspace holds splits x F x 9C
// floats.  Returns 0, a cudaError_t, or -1 for a shape or type the kernel does
// not take.
extern "C" int conv3x3_wgrad_tout_splits(int N, int H, int W, int C, int F, int dtype,
                                         int* splits) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0) return -1;
  const long long P = (long long)N * H * W;
  if (dtype == 0) return (int)choose_splits<float>(P, C, F, splits);
  if (dtype == 1) return (int)choose_splits<__nv_bfloat16>(P, C, F, splits);
  return -1;
}

// x: (N, H, W, C) and dy: (N, H, W, F) of dtype (0 = float32, 1 = bfloat16),
// contiguous, 16-byte aligned; ws: splits x F x 9C float32; dwt: (F, 9C)
// float32, column (dr*3 + dc)*C + c.  Any N, H, W, C, F >= 1.  Returns 0, a
// cudaError_t, or -1 for a shape or type the kernel does not take.
extern "C" int conv3x3_wgrad_tout(const void* x, const void* dy, void* ws, void* dwt, int N,
                                  int H, int W, int C, int F, int splits, int dtype,
                                  void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, dy, ws, dwt, N, H, W, C, F, splits, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dy, ws, dwt, N, H, W, C, F, splits, s);
  return -1;
}
