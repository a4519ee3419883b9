// Per-CTB statistics of sample adaptive offset (SAO) for Hopper (sm_90a).
//
// Replaces the reference's XLA device loop `sao_stats_dev`
// (video_codecs_tpu/ops/sao.py:127, jitted by
// video_codecs_tpu/models/hevc/inter_qt.py:454 `_sao_stats_jit`), which the
// TPU ran as whole-plane vector ops and box reductions.  For one plane
// (orig and rec uint8 [h, w], h and w multiples of the CTB size ctb) and
// every CTB (by, bx) it computes
//
//   eo_count[k, cat, by, bx], eo_sum[k, cat, by, bx]   k = EO class 0..3
//   bo_count[band, by, bx],   bo_sum[band, by, bx]     band = rec >> 3
//
// the number of samples in each EO category (0..4) and band (0..31) and
// the sum of orig - rec over them.  A sample's category is the spec's
// edgeIdx of sign(c - a) + sign(c - b) for the class's two neighbours a
// and b, and 0 where a neighbour lies outside the plane (the plane's own
// dims, which include the caller's edge padding; every sample counts).
//
// What bounds it.  The uint8 inputs are read once and the outputs written
// once: at 1920x1088 luma with CTB32 that is 4.18 MB in and 2,040 CTBs x
// 104 values x 4 bytes = 0.85 MB out; each 960x544 chroma plane with
// CTB16 1.04 MB in and 0.85 MB out.  About 8.8 MB a picture, 2.6 us at
// 3.35 TB/s: bound by bytes.  A few integer operations per sample (under
// 30 M a picture) are far below the card's integer rate.
//
// Design.  One CTA per CTB.  It stages the CTB's rec samples with a
// one-sample halo in shared memory, the halo clamped to the plane (the
// reference's edge pad; those neighbours matter only where the mask
// zeroes the category).  Each thread classifies one or more samples and
// adds to 52 shared bins (4 classes x 5 categories, 32 bands) with one
// shared atomic per bin: the count and the difference travel packed in
// one int, diff * 2048 + 1.  A CTB holds at most 1,024 samples with
// |diff| <= 255, so the packed sum stays within +-535 M and the count
// below 2048: both are exact, and integer atomics are order-free.  The
// float32 sums written at the end are integers below 2^24, exact in
// float32 in any order, so the kernel, the plain version and XLA agree
// bit for bit.  Nothing is carried between CTAs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEoBins = 4 * 5;           // EO class x category
constexpr int kBins = kEoBins + 32;      // then the 32 bands
constexpr int kCountBits = 11;           // count < 2048 in the low bits

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

// spec edgeIdx: s = -2 -> 1, -1 -> 2, 0 -> 0, 1 -> 3, 2 -> 4
__device__ __forceinline__ int category(int s) {
  return s == 0 ? 0 : (s < 0 ? s + 3 : s + 2);
}

template <int CTB>
__global__ void __launch_bounds__(kThreads) sao_stats_kernel(
    const uint8_t* __restrict__ orig, const uint8_t* __restrict__ rec,
    int h, int w, int* __restrict__ eo_count, float* __restrict__ eo_sum,
    int* __restrict__ bo_count, float* __restrict__ bo_sum) {
  constexpr int T = CTB + 2;
  __shared__ uint8_t tile[T * T];
  __shared__ int bins[kBins];
  const int bx = blockIdx.x, by = blockIdx.y;
  const int cx = gridDim.x, cy = gridDim.y;
  const int x0 = bx * CTB, y0 = by * CTB;
  for (int i = threadIdx.x; i < kBins; i += kThreads) bins[i] = 0;
  for (int i = threadIdx.x; i < T * T; i += kThreads) {
    const int y = min(max(y0 + i / T - 1, 0), h - 1);
    const int x = min(max(x0 + i % T - 1, 0), w - 1);
    tile[i] = rec[(size_t)y * w + x];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < CTB * CTB; k += kThreads) {
    const int ly = k / CTB, lx = k % CTB;
    const int y = y0 + ly, x = x0 + lx;
    const uint8_t* t = tile + (ly + 1) * T + (lx + 1);
    const int c = t[0];
    const int v = (int(orig[(size_t)y * w + x]) - c) * (1 << kCountBits) + 1;
    const bool row = x > 0 && x + 1 < w;     // both horizontal neighbours
    const bool col = y > 0 && y + 1 < h;     // both vertical neighbours
    // EO classes (ops/sao.py EO_NEIGHBORS): 0 horizontal, 1 vertical,
    // 2 135 degrees (up-left, down-right), 3 45 degrees (up-right,
    // down-left)
    const int c0 = row ? category(sgn(c - t[-1]) + sgn(c - t[1])) : 0;
    const int c1 = col ? category(sgn(c - t[-T]) + sgn(c - t[T])) : 0;
    const int c2 = row && col
        ? category(sgn(c - t[-T - 1]) + sgn(c - t[T + 1])) : 0;
    const int c3 = row && col
        ? category(sgn(c - t[-T + 1]) + sgn(c - t[T - 1])) : 0;
    atomicAdd(&bins[0 * 5 + c0], v);
    atomicAdd(&bins[1 * 5 + c1], v);
    atomicAdd(&bins[2 * 5 + c2], v);
    atomicAdd(&bins[3 * 5 + c3], v);
    atomicAdd(&bins[kEoBins + (c >> 3)], v);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += kThreads) {
    const int packed = bins[i];
    const int n = packed & ((1 << kCountBits) - 1);
    const float s = (float)((packed - n) / (1 << kCountBits));
    if (i < kEoBins) {
      const size_t o = ((size_t)i * cy + by) * cx + bx;
      eo_count[o] = n;
      eo_sum[o] = s;
    } else {
      const size_t o = ((size_t)(i - kEoBins) * cy + by) * cx + bx;
      bo_count[o] = n;
      bo_sum[o] = s;
    }
  }
}

template <int CTB>
int launch(const void* orig, const void* rec, void* eo_count, void* eo_sum,
           void* bo_count, void* bo_sum, int h, int w, cudaStream_t stream) {
  const dim3 grid(w / CTB, h / CTB);
  sao_stats_kernel<CTB><<<grid, kThreads, 0, stream>>>(
      (const uint8_t*)orig, (const uint8_t*)rec, h, w, (int*)eo_count,
      (float*)eo_sum, (int*)bo_count, (float*)bo_sum);
  return (int)cudaGetLastError();
}

}  // namespace

// orig, rec: uint8 [h, w]; eo_count int32 / eo_sum float32 [4, 5, h/ctb,
// w/ctb]; bo_count int32 / bo_sum float32 [32, h/ctb, w/ctb].  Returns the
// launch's cudaError (cudaErrorInvalidValue for a ctb other than 16 or 32
// or a plane that is not a CTB multiple).
extern "C" int vct_sao_stats_u8(const void* orig, const void* rec,
                                void* eo_count, void* eo_sum, void* bo_count,
                                void* bo_sum, int h, int w, int ctb,
                                void* stream) {
  if (ctb != 16 && ctb != 32) return (int)cudaErrorInvalidValue;
  if (h < 0 || w < 0 || h % ctb || w % ctb) return (int)cudaErrorInvalidValue;
  if (h == 0 || w == 0) return 0;
  if (ctb == 32)
    return launch<32>(orig, rec, eo_count, eo_sum, bo_count, bo_sum, h, w,
                      (cudaStream_t)stream);
  return launch<16>(orig, rec, eo_count, eo_sum, bo_count, bo_sum, h, w,
                    (cudaStream_t)stream);
}
