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
// per CT volume) is huge against the (64, 1728) result, so the pixel axis
// (the GEMM's K) is cut into `splits` contiguous ranges, each block keeps its
// partial in registers across a range, and a second kernel adds the
// partials of each element in a fixed order: no float atomics, two runs
// give the same bits.
//
// bf16: the taps weight gradient (conv3x3_wgrad.cu) with the operands'
// roles swapped, on `wgmma`, fed by TMA, warp-specialised: both are
// conv3x3_sm90.cuh's weight-gradient kernel (namespace wgrad), with this
// file's operand roles and epilogue (struct Tout).  No im2col tile exists:
// the nine taps are shifted windows of one staged halo of x (6 x 66 pixels
// of 64 channels for a tile of 4 x 64 pixels), beside the tile's dy, both
// TMA boxes, 128-byte swizzled.  Each of three consumer warpgroups (tap
// row dr) runs, a k16 step of 16 pixels, one `wgmma.mma_async m64n64k16` a
// tap (dr, dc): A, 64 output channels x 16 pixels, is dy^T; B, 16 pixels x
// 64 channels, is the halo's window shifted by (dr, dc); both MN-major (the
// transpose flags).  At the range's end each warpgroup writes its three
// taps' 64 x 64 partials into [split][f][tap * C + c].  On the card the
// output's orientation is the only thing that separates this kernel from
// the taps one; the materialised im2col tiles of the TPU kernel would read x
// nine times from L2, the halo reads it 1.55 times.  Shapes whose C or F is
// not a multiple of 8 take a cp.async loader in the producer warp.
//
// What bounds it: 2*P*9*C*F operations against x and dy read once and dwt
// written once (at (160,128,128,192) x (..,64) in bf16: 5.8e11 operations,
// 0.59 ms at the 989 TFLOP/s peak, against 1.34 GB, 0.40 ms at 3.35 TB/s):
// operations.  From L2 it reads what conv3x3_wgrad.cu reads, ~2.6 GB a call.
//
// fp32: plain FMAs, 4 output channels x 4 columns a thread (parity only, no
// TF32), over explicit (BK x BC) im2col tiles (one tap, BC channels)
// gathered with cp.async (conv3x3_im2col.cuh) beside the (BK x BF) tile of
// dy, through a ring of stages; ranges of at most 16384 pixels.
//
// Builds that skip one phase each (the CONV3X3_SKIP_* macros of the shared
// kernel, driven by `eval/probe_conv3x3.py --kernel wgrad_tout`) split the
// bf16 kernel's time between the loads of x and of dy, the products and the
// stores of the partials.
//
// Plain C interface, no allocation, no synchronisation: the caller hands in
// the workspace, the output and the stream to launch on.

#include "conv3x3_im2col.cuh"
#include "conv3x3_sm90.cuh"

namespace {

using im2col::Geo;

template <typename T>
struct Tile;

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
  return sm90::wgrad::launch_reduce(static_cast<const float*>(ws), static_cast<float*>(dwt),
                                    9LL * C * F, splits, stream);
}

// ------------------------------------------------------------------ bf16 --

namespace bf {

using namespace sm90;

// The tout weight gradient on conv3x3_sm90.cuh's wgrad kernel, the taps
// one's operands swapped: M is the 64 output channels (dy^T), N the 64 input
// channels (x's window).
struct Tout {
  static __device__ __forceinline__ void product(float (&acc)[32], uint64_t xd, uint64_t dd) {
    wgmma<1, 1>(acc, dd, xd);
  }

  // Warp q of a warpgroup holds output channels 16 q + lane / 4 and + 8 of
  // each tap, channels 8 j + 2 (lane % 4) and + 1 of each group j of 8; the
  // tap (dr, dc)'s values go to columns tap * C + c of the partial (F, 9C).
  static __device__ __forceinline__ void store(const float (&acc)[3][32], float* part, int dr,
                                               int c0, int f0, int C, int F) {
    const int q = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int dc = 0; dc < 3; ++dc)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int f = f0 + q * 16 + g + half * 8;
        if (f >= F) continue;
        float* row = part + (size_t)f * 9 * C + (size_t)(dr * 3 + dc) * C;
#pragma unroll
        for (int j = 0; j < wgrad::CT / 8; ++j) {
          const int c = c0 + j * 8 + 2 * t;
          if (c < C) row[c] = acc[dc][4 * j + 2 * half];
          if (c + 1 < C) row[c + 1] = acc[dc][4 * j + 2 * half + 1];
        }
      }
  }
};

}  // namespace bf

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
  if (dtype == 1) return (int)sm90::wgrad::choose_splits<bf::Tout>(N, H, W, C, F, splits);
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
    return (int)sm90::wgrad::launch<bf::Tout>(x, dy, ws, dwt, N, H, W, C, F, splits, s);
  return -1;
}
