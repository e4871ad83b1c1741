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
// explicit im2col tiles: chunk q is tap q / c_chunks and channels
// (q % c_chunks) * KC .. of the im2col matrix.  Unlike the taps kernel
// (conv3x3.cu), which stages one halo and reads its nine taps as shifted
// windows of it, each tile here is materialised row by row: a tile row is
// one pixel's KC channels at one tap.  The mode exists to measure that
// staging against the taps kernel's.
//
// bf16: `wgmma`, fed by TMA, warp-specialised.  A block owns BP consecutive
// pixels of the flattened N*H*W axis (so H and W need not divide any tile)
// and FT output channels, and is two consumer warpgroups and one producer
// warp; warpgroup w owns the block's pixels WP w .. WP w + WP - 1 as MB x NF
// m64n64 fp32 accumulators.  Two shapes, by F: BP = 256, FT = 64 (MB = 2,
// NF = 1) where F <= 64, the trunk's forward; BP = 128, FT = 192 (MB = 1,
// NF = 3) where F > 64, so that an input gradient's 192 output channels
// share one gather of each im2col tile; 64 or 96 accumulator registers a
// thread.  A chunk is KC = 64 input channels of one tap: four k16 steps,
// MB x NF `wgmma.mma_async m64n64k16` each:
//   - A, the im2col tile (pixels x 64 channels), is written by TMA's im2col
//     mode: x viewed as an NHWC tensor whose bounding box runs from pixel
//     (-1, -1) to (W - 2, H - 2), so that output pixel (w, h) starts at
//     input pixel (w - 1, h - 1) and the tap (dc, dr) is the load's offset;
//     one load a warpgroup brings its WP consecutive pixels, 64 channels
//     each, 128 bytes a pixel, 128-byte swizzled, which is K-major.  Its
//     zero fill outside the tensor is the SAME padding, the channels past C
//     and the pixels past the last; rows that cross an image row or an image
//     need nothing special.  The k16 step s starts 32 s bytes into the rows.
//   - B, the tap's 64 rows of k (64 input channels x FT output channels),
//     is staged as it lies in k, one box of 64 output channels a group nf,
//     128 bytes a row, 128-byte swizzled: N-major, `wgmma`'s transpose flag
//     on B; the k16 step s starts 16 s rows on.
//   Loads into a ring of 4 stages of 40 KB, signalled on `mbarrier`s
//   (`full`: bytes landed; `empty`: both warpgroups have retired the stage's
//   products).  At a tile's end each warpgroup rounds its pixels into
//   128-byte-swizzled boxes of 64 pixels x 64 channels in shared memory and
//   one thread stores them with TMA into y viewed as (F, P), clipped at P
//   and F.  The grid is persistent (one block an SM), tile t being
//   output-channel tile t % f_tiles (fastest), then the pixel tile.
//   Which loader, by shape: TMA needs 16-byte strides in device memory, so C
//   and F multiples of 8 take TMA loads and stores; other shapes take a
//   cp.async gather in the producer warp that writes the same swizzled
//   tiles, and direct stores.
//
// What bounds it: 2*P*9*C*F operations against x read once and y written once
// (at (160,128,128,192) -> 64 in bf16: 5.8e11 operations, 0.59 ms at the 989
// TFLOP/s peak, against 1.34 GB, 0.40 ms at 3.35 TB/s): operations.  The
// design pays for the materialised tile in L2 traffic: every pixel's
// channels are read nine times, once a tap, 9 x 1.007 GB = 9.06 GB a call at
// that shape, and each 256-pixel tile reads all of its slab of k, 221 KB,
// another 2.26 GB; the taps kernel reads 2.43 GB in all.  As the input
// gradient (64 -> 192) the gathers read 3.02 GB and each 128-pixel tile
// reads its 221 KB of k, 4.53 GB.
//
// fp32: plain FMAs, 4 pixels x 4 channels a thread (parity only, no TF32),
// over im2col tiles of KC channels gathered by all threads with cp.async
// (conv3x3_im2col.cuh) beside the matching rows of k, through a ring of
// stages.
//
// Builds that skip one phase each (the CONV3X3_SKIP_* macros, driven by
// `eval/probe_conv3x3.py --kernel patch`) split the bf16 kernel's time
// between the loads of x and of k, the products and the stores.
//
// Plain C interface, no allocation, no synchronisation: the caller hands in
// the output and the stream to launch on.

#include "conv3x3_im2col.cuh"
#include "conv3x3_sm90.cuh"

namespace {

using im2col::Geo;
using namespace sm90;

template <typename T>
struct Tile;

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

// ------------------------------------------------------------------ bf16 --

namespace bf {

constexpr int KC = 64;                   // input channels a chunk: 4 k16 steps
constexpr int THREADS = 288;             // two consumer warpgroups + 1 warp
constexpr int PRODUCER = 256;            // its first thread
constexpr int STAGES = 4;

// A block's shape by the number NF of 64-channel groups of output it owns:
// NF = 1 (F <= 64): 256 pixels, two m64 blocks a consumer warpgroup; NF = 3
// (F > 64: an input gradient's 192): 128 pixels, one m64 block and three
// n64 products a warpgroup, so that every output channel shares one gather
// of the im2col tile.  One stage, as TMA writes it: the im2col tile,
// [pixel][KC channels], then the rows of k, NF groups of [channel][64
// output channels], all 128 bytes a row, 128-byte swizzled (16-byte group j
// of row r at j ^ (r % 8)).  A warpgroup's output tile is MB x NF boxes of
// 64 pixels x 64 channels, staged for its TMA stores in the same rows.
template <int NF>
struct Shape {
  static constexpr int MB = NF == 1 ? 2 : 1;   // m64 blocks of a warpgroup
  static constexpr int NACC = MB * NF;         // accumulators of a thread
  static constexpr int WP = 64 * MB;           // pixels of a warpgroup
  static constexpr int BP = 2 * WP;            // pixels of a block
  static constexpr int FT = 64 * NF;           // output channels of a block
  static constexpr uint32_t A_BYTES = sizeof(bf16) * BP * KC;
  static constexpr uint32_t B_BYTES = sizeof(bf16) * KC * FT;
  static constexpr int AS = BP * KC;
  static constexpr int STAGE = AS + KC * FT;
  static constexpr uint32_t STAGE_BYTES = sizeof(bf16) * STAGE;
  static constexpr int OUT = WP * FT;
  static constexpr size_t SMEM_OUT = sizeof(bf16) * 2 * OUT;
  // + 1024: room to align the swizzled tiles; + the full and empty barriers
  static constexpr size_t SMEM =
      1024 + SMEM_OUT + (size_t)STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static_assert(SMEM <= 232448, "the ring exceeds an SM's shared memory");
  static_assert(A_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0,
                "swizzled tiles start on 1024 bytes");
};

// The loader for shapes TMA does not take (C or F not a multiple of 8): the
// producer warp's 32 threads gather chunk (tap, c0) of pixels p0 .. p0 + BP
// - 1 and the tap's rows c0 .. c0 + KC - 1 of k into the layout TMA would
// write, 16 bytes a cp.async where they are aligned and inside, element by
// element (zeros outside) elsewhere.
template <int NF>
__device__ void load_chunk_cp_async(bf16* as, const bf16* x, const bf16* k, long long p0,
                                    int tap, int c0, int f0, int H, int W, int C, int F,
                                    long long P, int q, int lane) {
  using S = Shape<NF>;
  bf16* bs = as + S::AS;
  const int dr = tap / 3 - 1, dc = tap % 3 - 1;
  const long long hw = (long long)H * W;
  const bool x_vec = C % 8 == 0;   // every pixel starts on 16 bytes
  for (int i = lane; i < S::BP * (KC / 8); i += 32) {
    const int v = i % (KC / 8), r = i / (KC / 8);
    const long long p = p0 + r;
    const int c = c0 + v * 8;
    bf16* dst = as + r * KC + ((v ^ r) & 7) * 8;
    const bf16* src = nullptr;
#ifdef CONV3X3_SKIP_X
    if (q > 0) continue;
#endif
    if (p < P) {
      const long long n = p / hw;
      const int rem = (int)(p - n * hw);
      const int h = rem / W + dr, wd = rem % W + dc;
      if (h >= 0 && h < H && wd >= 0 && wd < W) src = x + ((n * H + h) * W + wd) * C;
    }
    if (src != nullptr && x_vec && c + 8 <= C) {
      cp_async16(dst, src + c);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      if (src != nullptr) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j < C) dst[j] = src[c + j];
      }
    }
  }
  const bool w_vec = F % 8 == 0;
  for (int i = lane; i < KC * (S::FT / 8); i += 32) {
    const int fg = i % 8, r = (i / 8) % KC, nf = i / (8 * KC);
    const int c = c0 + r, f = f0 + nf * 64 + fg * 8;
    const size_t row = ((size_t)tap * C + c) * F;
    bf16* dst = bs + (nf * KC + r) * 64 + ((fg ^ r) & 7) * 8;
#ifdef CONV3X3_SKIP_W
    if (q > 0) continue;
#endif
    if (c < C && w_vec && f + 8 <= F) {
      cp_async16(dst, k + row + f);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      if (c < C) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (f + j < F) dst[j] = k[row + f + j];
      }
    }
  }
}

// Warpgroup wg's products of one staged chunk: four k16 steps, each MB x NF
// m64n64k16; accumulator m * NF + nf holds m64 block m and output-channel
// group nf.  A, K-major, 128-byte swizzle: 64 of the warpgroup's pixels, 8
// of them 1024 bytes (SBO), k16 step s 32 s bytes into the rows.  B,
// N-major (transpose flag), 128-byte swizzle: 16 rows of group nf of k from
// row 16 s on, 8 of them 1024 bytes (SBO), 64 output channels in a row (LBO
// unused).
template <int NF>
__device__ __forceinline__ void products(float (&acc)[Shape<NF>::NACC][32], const bf16* as,
                                         int wg) {
  using S = Shape<NF>;
  const uint32_t a0 = smem_u32(as + wg * S::WP * KC), b0 = smem_u32(as + S::AS);
#pragma unroll
  for (int s = 0; s < KC / 16; ++s)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
      const uint64_t b = smem_desc(b0 + (nf * KC + s * 16) * 64 * 2, 16, 1024, 1);
#pragma unroll
      for (int m = 0; m < S::MB; ++m)
        wgmma<0, 1>(acc[m * NF + nf], smem_desc(a0 + m * 64 * KC * 2 + s * 32, 16, 1024, 1), b);
    }
}

// Warp q of a warpgroup holds pixels 16 q + lane / 4 and + 8 of each of its
// m64 blocks, output channels 8 j + 2 (lane % 4) and + 1 of each group j of
// 8 of each 64-channel group.

// The warpgroup's pixels rounded to bf16 into its output tile in shared
// memory: box m * NF + nf holds m64 block m's pixels, one 128-byte row a
// pixel of group nf's 64 channels, whose 16-byte groups are swizzled as TMA
// reads them (group j of row r at j ^ (r % 8)).
template <int NF>
__device__ __forceinline__ void stage_out(const float (&acc)[Shape<NF>::NACC][32], bf16* out) {
  const int q = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  char* base = reinterpret_cast<char*>(out);
#pragma unroll
  for (int b = 0; b < Shape<NF>::NACC; ++b)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = q * 16 + g + half * 8;   // r % 8 == g
      char* row = base + (b * 64 + r) * 128 + 4 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + ((j ^ g) << 4)) =
            __floats2bfloat162_rn(acc[b][4 * j + 2 * half], acc[b][4 * j + 2 * half + 1]);
    }
}

// The warpgroup's pixels written to y directly (the cp.async loader's
// shapes), masked at every edge; p0 is the warpgroup's first pixel.
template <int NF>
__device__ __forceinline__ void store_direct(const float (&acc)[Shape<NF>::NACC][32], bf16* y,
                                             long long p0, int f0, long long P, int F) {
  const int q = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (F & 1) == 0;       // a pair of channels is 4-byte aligned
#pragma unroll
  for (int b = 0; b < Shape<NF>::NACC; ++b)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long p = p0 + (b / NF) * 64 + q * 16 + g + half * 8;
      if (p >= P) continue;
      bf16* px = y + (size_t)p * F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int f = f0 + (b % NF) * 64 + j * 8 + 2 * t;
        const float v0 = acc[b][4 * j + 2 * half], v1 = acc[b][4 * j + 2 * half + 1];
        if (pairs && f + 1 < F) {
          *reinterpret_cast<__nv_bfloat162*>(px + f) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (f < F) px[f] = __float2bfloat16(v0);
          if (f + 1 < F) px[f + 1] = __float2bfloat16(v1);
        }
      }
    }
}

// Warp-specialised and persistent, as conv3x3.cu's kernel.  Block b takes
// tiles b, b + gridDim.x, ...; tile t is output-channel tile t % f_tiles
// (fastest), then pixel tile t / f_tiles.  Its last warp is the producer:
// it walks the 9 * c_chunks chunks of all of the block's tiles and fills
// stage g % STAGES with chunk g once both warpgroups have released that
// stage's previous chunk (`empty`, one arrival a consumer warp), signalling
// `full` when the bytes have landed (TMA: one thread, transaction bytes;
// cp.async: 32 arrivals).  The two warpgroups each wait for `full`, issue
// the chunk's products, and release the chunk before it once those have
// retired.  At a tile's end each writes its pixels: with TMA it stages them
// in shared memory and one thread stores them asynchronously, so the next
// tile's products start while the store drains.
template <int NF, bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_patch_wgmma(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap ymap, const bf16* __restrict__ x,
                    const bf16* __restrict__ k, bf16* __restrict__ y, int H, int W, int C, int F,
                    long long P, int c_chunks, int f_tiles, unsigned int total_tiles) {
  using S = Shape<NF>;
  constexpr int NACC = S::NACC;
  extern __shared__ __align__(1024) unsigned char bf_smem[];
  // the swizzled tiles want 1024-byte alignment
  unsigned char* base = bf_smem + ((1024 - smem_u32(bf_smem) % 1024) % 1024);
  bf16* out = reinterpret_cast<bf16*>(base);
  bf16* ring = reinterpret_cast<bf16*>(base + S::SMEM_OUT);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + S::SMEM_OUT + (size_t)STAGES * S::STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int n_chunks = 9 * c_chunks;
  if (blockIdx.x >= total_tiles) return;
  const unsigned int my_tiles = (total_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const unsigned int my_chunks = my_tiles * n_chunks;
  auto place = [&](unsigned int t, long long& p0, int& f0) {
    t = blockIdx.x + t * gridDim.x;
    f0 = (int)(t % f_tiles) * S::FT;
    p0 = (long long)(t / f_tiles) * S::BP;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], TMA ? 1 : 32);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= PRODUCER) {           // ------------------ producer --
    const int lane = threadIdx.x - PRODUCER;
    if (TMA && lane != 0) return;
    const long long hw = (long long)H * W;
    for (unsigned int g = 0; g < my_chunks; ++g) {
      const int s = g % STAGES;
      if (g >= STAGES) mbar_wait(&empty[s], (g / STAGES - 1) & 1);
      long long p0;
      int f0;
      place(g / n_chunks, p0, f0);
      const int q = (int)(g % n_chunks);
      const int tap = q / c_chunks, c0 = (q % c_chunks) * KC;
      bf16* as = ring + s * S::STAGE;
      if (TMA) {
        bool load_x = true, load_k = true;
#ifdef CONV3X3_SKIP_X
        load_x = q == 0;
#endif
#ifdef CONV3X3_SKIP_W
        load_k = q == 0;
#endif
        mbar_expect_tx(&full[s], (load_x ? S::A_BYTES : 0) + (load_k ? S::B_BYTES : 0));
        if (load_x) {
#pragma unroll
          for (int w = 0; w < 2; ++w) {    // one load a warpgroup's pixels
            const long long p = p0 + w * S::WP;
            const long long n = p / hw;
            const int rem = (int)(p - n * hw);
            tma_load_im2col_4d(as + w * S::WP * KC, &xmap, &full[s], c0, rem % W - 1,
                               rem / W - 1, (int)n, (uint16_t)(tap % 3), (uint16_t)(tap / 3));
          }
        }
        if (load_k) {
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
            tma_load_3d(as + S::AS + nf * KC * 64, &kmap, &full[s], f0 + nf * 64, c0, tap);
        }
      } else {
        load_chunk_cp_async<NF>(as, x, k, p0, tap, c0, f0, H, W, C, F, P, q, lane);
        fence_proxy_async();               // the zeros written by hand
        mbar_arrive_cp_async(&full[s]);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers --
  const int wg = threadIdx.x >> 7;
  const bool warp_leader = (threadIdx.x & 31) == 0;
  const bool wg_leader = (threadIdx.x & 127) == 0;
  bf16* my_out = out + wg * S::OUT;
  float acc[NACC][32];
  unsigned int g = 0;
  for (unsigned int t = 0; t < my_tiles; ++t) {
#pragma unroll
    for (int b = 0; b < NACC; ++b)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[b][j] = 0.0f;
    fence_acc(acc);
    int held = -1;                         // stage of the chunk still in flight
    for (int c = 0; c < n_chunks; ++c, ++g) {
      const int s = g % STAGES;
      mbar_wait(&full[s], (g / STAGES) & 1);
      if (!TMA) fence_proxy_async();       // cp.async's writes, for wgmma
#ifndef CONV3X3_SKIP_MMA
      wgmma_fence();
      products<NF>(acc, ring + s * S::STAGE, wg);
      wgmma_commit();
      wgmma_wait<1>();                     // the chunk before has retired
#endif
      if (held >= 0 && warp_leader) mbar_arrive(&empty[held]);
      held = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (warp_leader) mbar_arrive(&empty[held]);
    long long p0;
    int f0;
    place(t, p0, f0);
    p0 += wg * S::WP;
#ifdef CONV3X3_SKIP_STORE
    if (p0 >= 0) continue;                 // never stores
#endif
    if (TMA) {
      if (wg_leader) tma_store_wait_read();   // the last stores have left my_out
      warpgroup_sync(wg);
      stage_out<NF>(acc, my_out);
      fence_proxy_async();                 // the staged tile, for TMA
      warpgroup_sync(wg);
      if (wg_leader) {
#pragma unroll
        for (int b = 0; b < NACC; ++b)
          if (p0 + (b / NF) * 64 < P && f0 + (b % NF) * 64 < F)
            tma_store_2d(&ymap, my_out + b * 64 * 64, f0 + (b % NF) * 64,
                         (int)(p0 + (b / NF) * 64));
      }
    } else {
      store_direct<NF>(acc, y, p0, f0, P, F);
    }
  }
  if (TMA && wg_leader) tma_store_wait();
}

// The loaders and the store are chosen by shape: TMA needs 16-byte strides
// in device memory, so C and F multiples of 8 take the TMA kernel; other
// shapes take the cp.async gather and direct stores.  Neither is a fallback
// for the other: a launch that fails returns its error.  The tensor maps are
// built here for each call: x (C, W, H, N) in TMA's im2col mode, WP pixels
// of KC channels a load, 128-byte swizzled; k (F, C, 9 taps) in boxes of 64
// x KC x 1, 128-byte swizzled; y viewed as (F, P) in boxes of 64 x 64,
// 128-byte swizzled, clipped at the edges.
template <int NF>
cudaError_t launch_nf(const void* x, const void* k, void* y, int N, int H, int W, int C, int F,
                      cudaStream_t stream) {
  using S = Shape<NF>;
  const long long P = (long long)N * H * W;
  const int c_chunks = (C + KC - 1) / KC;
  const int f_tiles = (F + S::FT - 1) / S::FT;
  const long long tiles = (P + S::BP - 1) / S::BP * f_tiles;
  if (tiles > 2147483647LL || P > 2147483647LL) return cudaErrorInvalidConfiguration;
  const bool tma = C % 8 == 0 && F % 8 == 0;
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  cudaError_t err = cudaSuccess;
  if (tma) {
    const cuuint64_t e = sizeof(bf16);
    const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
    const cuuint64_t xs[3] = {C * e, (cuuint64_t)W * C * e, (cuuint64_t)H * W * C * e};
    const cuuint64_t kd[3] = {(cuuint64_t)F, (cuuint64_t)C, 9};
    const cuuint64_t ks[2] = {F * e, (cuuint64_t)C * F * e};
    const cuuint32_t kb[3] = {64, KC, 1};
    const cuuint64_t yd[2] = {(cuuint64_t)F, (cuuint64_t)P};
    const cuuint64_t ys[1] = {F * e};
    const cuuint32_t yb[2] = {64, 64};
    if ((err = encode_im2col(&maps[0], x, xd, xs, -1, -1, KC, S::WP)) != cudaSuccess ||
        (err = encode(&maps[1], k, 3, kd, ks, kb, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess ||
        (err = encode(&maps[2], y, 2, yd, ys, yb, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess)
      return err;
  }
  auto kernel = tma ? conv3x3_patch_wgmma<NF, true> : conv3x3_patch_wgmma<NF, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (err != cudaSuccess) return err;
  unsigned int grid = 0;
  err = persistent_grid(kernel, THREADS, S::SMEM, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, S::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const bf16*>(x), static_cast<const bf16*>(k),
      static_cast<bf16*>(y), H, W, C, F, P, c_chunks, f_tiles, (unsigned int)tiles);
  return cudaGetLastError();
}

cudaError_t launch(const void* x, const void* k, void* y, int N, int H, int W, int C, int F,
                   cudaStream_t stream) {
  return F <= 64 ? launch_nf<1>(x, k, y, N, H, W, C, F, stream)
                 : launch_nf<3>(x, k, y, N, H, W, C, F, stream);
}

}  // namespace bf

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
  if (dtype == 1) return (int)bf::launch(x, k, y, N, H, W, C, F, s);
  return -1;
}
