// Exhaustive integer-ME SAD surface for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel video_codecs_tpu/ops/pallas_sad.py
// (_sad_kernel at :32, launched by sad_surface's pl.pallas_call at :65):
//
//   out[b, dy, dx] = sum_{y<n, x<n} |win[b, dy+y, dx+x] - cur[b, y, x]|
//   cur [B, n, n], win [B, n+2r, n+2r] uint8 -> out [B, 2r+1, 2r+1] int32
//
// What bounds it.  A 1280x720 P picture at search range 16 asks for
// 3600 blocks of 16x16 and 14400 blocks of 8x8 at 33x33 displacements:
// 2,007,244,800 absolute differences, 4.01 G operations (a subtract and
// an add each) on 8-bit samples, 2.0 us at the card's 1,979 TOP/s for
// 8-bit integers.  The bytes it must move are the uint8 blocks and
// windows (33.6 MB) and the int32 surfaces (78.4 MB): 111.6 MB, 33.3 us
// at 3.35 TB/s.  So it is bound by bytes, at 33.3 us per picture.  Off
// the tensor cores the byte-SIMD difference below issues at the integer
// rate, which puts its own ceiling near 37 us (PERF.md).  The first
// kernel (one thread per displacement, int32 pixels in shared memory)
// paid two 32-bit shared-memory loads and three integer instructions for
// every difference.

// Design.  Everything stays 8-bit until it is summed.  One CTA takes
// `group` blocks and stages their uint8 windows (rows padded against
// bank conflicts) and current blocks in shared memory.  Each thread owns
// a tile of kM=2 adjacent dy by kK=12 adjacent dx of one block and keeps
// its 24 sums in registers.  It walks the n+kM-1 window rows its tile
// touches; for each row it loads the 12/4 + n/4 + 1 words it needs once,
// builds the three byte-shifted copies with PRMT (__byte_perm), and then,
// for every dy of the tile that uses this row, loads the current block's
// row (a broadcast) and takes four differences per instruction with the
// byte-SIMD sum of absolute differences (PTX vabsdiff4 with .add, one
// VABSDIFF4.U8.ACC in SASS).  Per difference that is about 0.3
// instructions and 0.03 shared-memory loads instead of 5 and 2.  The
// sums go through shared memory so that the CTA's surfaces, one
// contiguous range of `out`, are stored by neighbouring threads to
// neighbouring words.  The launcher picks `group` for the most busy lanes
// over the whole grid (tiles per CTA against whole warps, CTAs against
// whole waves of the card), and a thread loops over tiles when a block
// has more tiles than the CTA threads.  There is no 2r+1 <= 128 limit as
// on the TPU: the window only has to fit in shared memory (the launch
// returns cudaErrorInvalidValue where it does not).  n is 16 or 8 (the
// H.264 blocks, the HEVC pyramid's full-resolution windows) or 4 or 2
// (the pyramid's 4x4-pooled quarter-resolution stage): a row of the
// current block is then one word, whose unused bytes (n = 2) are zero in
// the block and masked off in the window.
// What still holds it back is in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kK = 12;           // adjacent dx per thread (a multiple of 4)
constexpr int kM = 2;            // adjacent dy per thread
constexpr int kMaxSmem = 232448;   // one CTA's shared memory on Hopper
constexpr int kThreads = 256;      // the most threads of a CTA

// acc + sum over the 4 bytes of |a - b|
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b,
                                         uint32_t acc) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(acc));
  return d;
}

struct Geometry {
  int span, wsz, tx_n, tiles, stride, rows, win_bytes, out_bytes;
};

__host__ __device__ inline Geometry geometry(int n, int r) {
  Geometry g;
  g.span = 2 * r + 1;
  g.wsz = n + 2 * r;
  g.tx_n = (g.span + kK - 1) / kK;
  g.tiles = g.tx_n * ((g.span + kM - 1) / kM);
  // A tile reads bytes up to dx0 + kK + n + 3 of a row and rows up to
  // dy0 + n + kM - 2; the padding is read only for displacements that are
  // not stored.  A row stride of 2 mod 4 words keeps the 32 lanes of a
  // warp (3 tiles along dx, about 11 along dy) at most 2 to a bank.
  int words = (g.wsz + kK + 4 + 3) / 4;
  words += (6 - words % 4) % 4;
  g.stride = 4 * words;
  g.rows = g.wsz + kM - 1;
  g.win_bytes = (g.rows * g.stride + 15) / 16 * 16;
  g.out_bytes = (4 * g.span * g.span + 15) / 16 * 16;
  return g;
}

// Copy `items` contiguous [height, width] uint8 arrays from global `src`
// into shared memory: row i of item g goes to dst + g * item_bytes +
// i * stride.
__device__ void stage(uint8_t* dst, const uint8_t* __restrict__ src,
                      int items, int width, int height, int stride,
                      int item_bytes) {
  const int total = items * width * height;
  if ((width & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    // 16-byte vectors; each 4-byte word lies in one row (width % 4 == 0)
    // and width * height is then a multiple of 16.
    const uint4* v = reinterpret_cast<const uint4*>(src);
    for (int i = threadIdx.x; i < total / 16; i += blockDim.x) {
      const uint4 x = v[i];
      const int off = i * 16;
      int item = off / (width * height);
      const int rem = off - item * width * height;
      int row = rem / width;
      int col = rem - row * width;
      const uint32_t w4[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        *reinterpret_cast<uint32_t*>(dst + item * item_bytes +
                                     row * stride + col) = w4[q];
        col += 4;
        if (col == width) {
          col = 0;
          if (++row == height) {
            row = 0;
            ++item;
          }
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int item = i / (width * height);
      const int rem = i - item * width * height;
      const int row = rem / width;
      dst[item * item_bytes + row * stride + rem - row * width] = src[i];
    }
  }
}

// One window row rr of a tile: its words, their byte-shifted copies, and
// the sums of every dy m of the tile that uses this row (current-block
// row y = rr - m in [0, N)).  CHECK is false where every m does; where it
// is true, rr is known at compile time and the checks fold away.
template <int N, bool CHECK>
__device__ __forceinline__ void tile_row(const uint8_t* wrow,
                                         const uint8_t* crow, int rr,
                                         uint32_t (&acc)[kM][kK]) {
  constexpr int NW = (N + 3) / 4;       // words of a current-block row
  constexpr int SW = kK / 4 + NW;       // window words one shift needs
  uint32_t w[SW + 1];
#pragma unroll
  for (int j = 0; j <= SW; ++j)
    w[j] = reinterpret_cast<const uint32_t*>(wrow)[j];
  // sh[s][j]: the 4 window bytes that start s bytes into word j
  uint32_t sh[4][SW];
#pragma unroll
  for (int j = 0; j < SW; ++j) {
    sh[0][j] = w[j];
    sh[1][j] = __byte_perm(w[j], w[j + 1], 0x4321);
    sh[2][j] = __byte_perm(w[j], w[j + 1], 0x5432);
    sh[3][j] = __byte_perm(w[j], w[j + 1], 0x6543);
  }
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const int y = rr - m;
    if (CHECK && (y < 0 || y >= N)) continue;
    uint32_t c[NW];
    if constexpr (N == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(crow + y * N);
      c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
    } else if constexpr (N == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(crow + y * N);
      c[0] = v.x; c[1] = v.y;
    } else if constexpr (N == 4) {
      c[0] = *reinterpret_cast<const uint32_t*>(crow + y * N);
    } else {
      c[0] = *reinterpret_cast<const uint16_t*>(crow + y * N);
    }
    // n = 2: only the low two bytes of a window word are this row's
    constexpr uint32_t kMask = N == 2 ? 0x0000ffffu : 0xffffffffu;
#pragma unroll
    for (int k = 0; k < kK; ++k)
#pragma unroll
      for (int j = 0; j < NW; ++j)
        acc[m][k] = sad4(sh[k & 3][(k >> 2) + j] & kMask, c[j], acc[m][k]);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
sad_surface_u8(const uint8_t* __restrict__ cur,
               const uint8_t* __restrict__ win, int32_t* __restrict__ out,
               int nblk, int r, int group) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Geometry geo = geometry(N, r);
  const int b0 = blockIdx.x * group;
  const int gcount = min(group, nblk - b0);
  // [group, span, span] sums, then the windows, then the blocks
  int32_t* s_out = reinterpret_cast<int32_t*>(smem);
  uint8_t* s_win = smem + group * geo.out_bytes;
  uint8_t* s_cur = s_win + group * geo.win_bytes;   // dense [g, N, N]

  stage(s_win, win + (int64_t)b0 * geo.wsz * geo.wsz, gcount, geo.wsz,
        geo.wsz, geo.stride, geo.win_bytes);
  stage(s_cur, cur + (int64_t)b0 * N * N, gcount, N, N, N, N * N);
  __syncthreads();

  for (int t = threadIdx.x; t < gcount * geo.tiles; t += blockDim.x) {
    const int g = t / geo.tiles;
    const int tile = t - g * geo.tiles;
    const int ty = tile / geo.tx_n;
    const int dy0 = ty * kM;
    const int dx0 = (tile - ty * geo.tx_n) * kK;
    const uint8_t* wrow = s_win + g * geo.win_bytes + dy0 * geo.stride + dx0;
    const uint8_t* crow = s_cur + g * N * N;

    uint32_t acc[kM][kK];
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int k = 0; k < kK; ++k) acc[m][k] = 0;

    // rows the first dy of the tile does not reach yet, rows every dy
    // uses, rows only the last dys use
#pragma unroll
    for (int rr = 0; rr < kM - 1; ++rr)
      tile_row<N, true>(wrow + rr * geo.stride, crow, rr, acc);
#pragma unroll 1
    for (int rr = kM - 1; rr < N; ++rr)
      tile_row<N, false>(wrow + rr * geo.stride, crow, rr, acc);
#pragma unroll
    for (int rr = N; rr < N + kM - 1; ++rr)
      tile_row<N, true>(wrow + rr * geo.stride, crow, rr, acc);

    int32_t* o = s_out + g * geo.span * geo.span;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int dy = dy0 + m;
      if (dy >= geo.span) break;
#pragma unroll
      for (int k = 0; k < kK; ++k)
        if (dx0 + k < geo.span)
          o[dy * geo.span + dx0 + k] = (int32_t)acc[m][k];
    }
  }
  // The CTA's surfaces are one contiguous range of `out`: store it with
  // neighbouring threads on neighbouring words (a thread's own sums are
  // 12 words apart from its neighbour's, which would cost a 32-byte
  // sector per 4-byte store).
  __syncthreads();
  int32_t* o = out + (int64_t)b0 * geo.span * geo.span;
  for (int i = threadIdx.x; i < gcount * geo.span * geo.span;
       i += blockDim.x)
    o[i] = s_out[i];
}

template <int N>
int launch(const void* cur, const void* win, void* out, int b, int r,
           cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      sad_surface_u8<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const Geometry geo = geometry(N, r);
  const int per_block = geo.out_bytes + geo.win_bytes + N * N;
  auto threads_for = [&](int g) {
    return min((g * geo.tiles + 31) / 32 * 32, kThreads);
  };
  // Blocks per CTA: the most busy lanes over the whole grid.  A CTA of g
  // blocks keeps g * tiles of its threads busy, and the last wave of CTAs
  // leaves slots of the card empty, so count both.
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int group = 0;
  double best = -1.0;
  for (int g = 1; g <= b && g * per_block <= kMaxSmem &&
                  (g == 1 || g * geo.tiles <= kThreads); ++g) {
    const int threads = threads_for(g);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sad_surface_u8<N>, threads, (size_t)g * per_block);
    if (per_sm <= 0) continue;
    const int passes = (g * geo.tiles + threads - 1) / threads;
    const double slots = (double)per_sm * sms;
    const double ctas = (b + g - 1) / g;
    const double waves = std::ceil(ctas / slots);
    const double eff = (double)(g * geo.tiles) / (passes * threads) *
                       ctas / (waves * slots);
    if (eff > best + 1e-9) {
      best = eff;
      group = g;
    }
  }
  if (group < 1) return (int)cudaErrorInvalidValue;
  const int grid = (b + group - 1) / group;
  sad_surface_u8<N><<<grid, threads_for(group), (size_t)group * per_block,
                      stream>>>((const uint8_t*)cur, (const uint8_t*)win,
                                (int32_t*)out, b, r, group);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  cur [b, n, n] and win
// [b, n+2r, n+2r] uint8, out [b, 2r+1, 2r+1] int32, all contiguous on
// the current device.  Launches on `stream` and returns the cudaError_t
// of the launch (0 = success); it never synchronises and allocates
// nothing.
extern "C" int vct_sad_surface_u8(const void* cur, const void* win,
                                  void* out, int b, int n, int r,
                                  void* stream) {
  if (b <= 0) return 0;
  if (n == 16)
    return launch<16>(cur, win, out, b, r, (cudaStream_t)stream);
  if (n == 8)
    return launch<8>(cur, win, out, b, r, (cudaStream_t)stream);
  if (n == 4)
    return launch<4>(cur, win, out, b, r, (cudaStream_t)stream);
  if (n == 2)
    return launch<2>(cur, win, out, b, r, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
