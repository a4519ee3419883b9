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
// 3.35 TB/s: bound by bytes.  At CTB 8 the outputs outweigh the inputs:
// a 416x240 chroma plane is 0.20 MB in and 1,560 CTBs x 416 bytes =
// 0.65 MB out.  A few integer operations per sample (under
// 30 M a picture) are far below the card's integer rate.
//
// Design.  One CTA per strip of CTBs side by side in a CTB row (2 at CTB
// 32, 4 at CTB 16 and 8), 128 threads: each CTB gets 2 * CTB threads at
// CTB 16 and 32, each lane one column of its CTB and every other row in
// it, CTB / 2 samples; at CTB 8 (the flat CTB16 engines' chroma) a warp,
// each lane one column and every fourth row, 2 samples, so that a warp
// never spans two CTBs.  A strip past the plane's right edge (52 chroma
// CTBs at 832x480 take 13 strips of 4, 6 at 96x64 one of 4 and one of 2)
// reads the plane's last samples again and writes nothing for the CTBs
// outside.  Fewer,
// wider CTAs than one per CTB, and each bin's outputs of the strip's CTBs
// are neighbours in memory, so the stores coalesce: with one CTA per CTB,
// launching the CTAs and scattering their 104 stores each set a chroma
// plane's time, whatever the sample loop cost (PERF.md).  The CTA stages
// the strip's rec samples with a one-sample halo in shared memory, the halo
// clamped to the plane (the reference's edge pad; those neighbours matter
// only where the mask zeroes the category), and its orig samples; every
// thread issues all its loads before it waits for any.  A sample's count
// and difference travel packed in one int, diff * 2048 + 1.  On real
// content most samples of a CTB share EO category 0 and a few bands, so the
// lanes of a warp mostly hit the same bin: shared atomics serialise on it,
// and grouping the lanes by bin first (__match_any_sync and
// __reduce_add_sync) measured twice as slow (PERF.md).  So every lane keeps
// its own bins, bin b of lane l at word 32 b + l: its updates are plain
// adds in its own bank, with no atomic and no conflict whatever bins the
// lanes hit.  A sample adds to three bins: one of 25 for the pair of signs
// (s0, s1) of EO classes 0 and 1 (s = sign(c - a) + sign(c - b), -2..2),
// one of 25 for classes 2 and 3, and its band's; the classes' own bins are
// the pair bins' margins, taken at the end.  The classification runs
// without a branch (the plane-edge masks are ands, the signs clamps).  Then
// each warp folds its lanes' bins, lane l summing bins l, l + 32 and l + 64
// over the 32 lanes in a rotated order (lane l reads lane (i + l) mod 32 at
// step i, 32 banks again), and the CTA adds each CTB's warps, takes the
// margins and writes the strip's outputs bin by bin.  A CTB holds at most
// 1,024 samples with |diff| <= 255, so every packed sum, a lane's, a
// warp's, a margin or the CTB's, stays within +-535 M and the count below
// 2048: both are exact, and integer sums are order-free.  The float32 sums
// written at the end are integers below 2^24, exact in float32 in any
// order, so the kernel, the plain version and XLA agree bit for bit.
// Nothing is carried between CTAs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kEoBins = 4 * 5;           // EO class x category (outputs)
constexpr int kOutBins = kEoBins + 32;   // then the 32 bands
constexpr int kPairBins = 25;            // (s, s') of two EO classes
constexpr int kBins = 2 * kPairBins + 32;  // the lanes' bins
constexpr int kCountBits = 11;           // count < 2048 in the low bits

// sign of a difference of two samples, as a clamp
__device__ __forceinline__ int sgn(int v) { return min(max(v, -1), 1); }


template <int CTB>
struct Strip {
  static constexpr int kCtbs = CTB == 32 ? 2 : 4;       // CTBs per CTA
  static constexpr int kCtbThreads = CTB == 8 ? 32 : 2 * CTB;
  static constexpr int kThreads = kCtbs * kCtbThreads;  // 128
  static constexpr int kWarpsPerCtb = kCtbThreads / 32;
  static constexpr int kRowStep = kCtbThreads / CTB;    // rows between samples
  static constexpr int kT = CTB + 2;                     // tile rows
  static constexpr int kTw = kCtbs * CTB + 2;            // tile columns
  static constexpr int kOw = kCtbs * CTB;                // orig columns
  static constexpr int kTileLoads = (kT * kTw + kThreads - 1) / kThreads;
  // orig is read in aligned words of kOb bytes, a whole number a thread
  static constexpr int kOb = CTB == 8 ? 2 : 4;
  static constexpr int kOrigWords = CTB * kOw / kOb / kThreads;
  using OWord = typename std::conditional<kOb == 2, uint16_t, uint32_t>::type;
  static_assert(CTB * kOw % (kOb * kThreads) == 0, "whole orig words");
  static_assert(kWarpsPerCtb >= 1, "a warp spans one CTB");
};

template <int CTB>
__global__ void __launch_bounds__(Strip<CTB>::kThreads) sao_stats_kernel(
    const uint8_t* __restrict__ orig, const uint8_t* __restrict__ rec,
    int h, int w, int* __restrict__ eo_count, float* __restrict__ eo_sum,
    int* __restrict__ bo_count, float* __restrict__ bo_sum) {
  using S = Strip<CTB>;
  constexpr int T = S::kT, TW = S::kTw, OW = S::kOw, K = S::kCtbs;
  constexpr int kThreads = S::kThreads, kWarps = kThreads / 32;
  constexpr int kSamples = CTB / S::kRowStep;            // per lane
  using OWord = typename S::OWord;
  constexpr int kOb = S::kOb;
  __shared__ uint8_t tile[T * TW];
  __shared__ __align__(4) uint8_t orig_tile[CTB * OW];
  __shared__ int bins[kWarps][kBins * 32];   // [warp][bin][lane]
  __shared__ int totals[kWarps][kBins];
  const int cx = w / CTB, cy = gridDim.y;
  const int by = blockIdx.y, bx0 = blockIdx.x * K;       // first CTB
  const int x0 = bx0 * CTB, y0 = by * CTB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = threadIdx.x / S::kCtbThreads;            // the CTB in strip
  const int u = threadIdx.x % S::kCtbThreads;
  const int lx = j * CTB + u % CTB, ly0 = u / CTB;   // ly0 < kRowStep
  int* mine = bins[warp] + lane;             // this lane's bins, stride 32
  // every load of the CTA issued before any is waited for, into
  // registers: the strip's orig samples (words, aligned: x0 and w are
  // multiples of 8), then its rec tile with the halo, clamped to the plane
  // (a strip past the plane's right edge reads its last samples again, and
  // writes nothing out for those CTBs)
  OWord o[S::kOrigWords];
  int r[S::kTileLoads];
#pragma unroll
  for (int i = 0; i < S::kOrigWords; ++i) {
    const int k = threadIdx.x + i * kThreads;          // word of the strip
    const int y = y0 + k / (OW / kOb);
    const int x = min(x0 + kOb * (k % (OW / kOb)), w - kOb);
    o[i] = *reinterpret_cast<const OWord*>(orig + (size_t)y * w + x);
  }
#pragma unroll
  for (int i = 0; i < S::kTileLoads; ++i) {
    const int k = min(threadIdx.x + i * kThreads, T * TW - 1);
    const int y = min(max(y0 + k / TW - 1, 0), h - 1);
    const int x = min(max(x0 + k % TW - 1, 0), w - 1);
    r[i] = rec[(size_t)y * w + x];
  }
#pragma unroll
  for (int b = 0; b < kBins; ++b) mine[32 * b] = 0;
#pragma unroll
  for (int i = 0; i < S::kOrigWords; ++i)
    reinterpret_cast<OWord*>(orig_tile)[threadIdx.x + i * kThreads] = o[i];
#pragma unroll
  for (int i = 0; i < S::kTileLoads; ++i) {
    const int k = threadIdx.x + i * kThreads;
    if (k < T * TW) tile[k] = (uint8_t)r[i];
  }
  __syncthreads();
  // both horizontal neighbours inside the plane: one column per lane
  const int row = x0 + lx > 0 && x0 + lx + 1 < w ? -1 : 0;
  // the lane's column and its neighbours, three tile rows at a time: at a
  // row step of 2 the row below one sample is the row above the next
  const uint8_t* col0 = tile + ly0 * TW + lx;
  int ul = col0[0], uc = col0[1], ur = col0[2];
#pragma unroll
  for (int i = 0; i < kSamples; ++i) {
    const int ly = ly0 + S::kRowStep * i, y = y0 + ly;
    const uint8_t* t = col0 + (S::kRowStep * i + 1) * TW;
    if (S::kRowStep != 2) {
      ul = t[-TW];
      uc = t[1 - TW];
      ur = t[2 - TW];
    }
    const int ml = t[0], c = t[1], mr = t[2];
    const int dl = t[TW], dc = t[TW + 1], dr = t[TW + 2];
    const int v = (int(orig_tile[ly * OW + lx]) - c) * (1 << kCountBits) + 1;
    const int col = y > 0 && y + 1 < h ? -1 : 0;   // both vertical ones
    // EO classes (ops/sao.py EO_NEIGHBORS): 0 horizontal, 1 vertical,
    // 2 135 degrees (up-left, down-right), 3 45 degrees (up-right,
    // down-left); s = 0 (category 0) where a neighbour is outside
    const int s0 = (sgn(c - ml) + sgn(c - mr)) & row;
    const int s1 = (sgn(c - uc) + sgn(c - dc)) & col;
    const int s2 = (sgn(c - ul) + sgn(c - dr)) & row & col;
    const int s3 = (sgn(c - ur) + sgn(c - dl)) & row & col;
    ul = dl;
    uc = dc;
    ur = dr;
    mine[32 * ((s0 + 2) * 5 + s1 + 2)] += v;
    mine[32 * (kPairBins + (s2 + 2) * 5 + s3 + 2)] += v;
    mine[32 * (2 * kPairBins + (c >> 3))] += v;
  }
  __syncwarp();
  const int* warp_bins = bins[warp];
  for (int b = lane; b < kBins; b += 32) {
    int sum = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) sum += warp_bins[32 * b + ((i + lane) & 31)];
    totals[warp][b] = sum;
  }
  __syncthreads();
  // the strip's outputs bin by bin, the CTBs of a bin side by side
  for (int i = threadIdx.x; i < kOutBins * K; i += kThreads) {
    const int b = i / K, jj = i % K, bx = bx0 + jj;
    if (bx >= cx) continue;
    const int* tot = totals[jj * S::kWarpsPerCtb];
    int packed = 0;
    if (b < kEoBins) {
      // class k's category cat: the margin of its pair over the other
      // class's 5 signs, at s + 2 = (2, 0, 1, 3, 4)[cat] (edgeIdx)
      const int k = b / 5, cat = b % 5;
      const int sv = cat == 0 ? 2 : cat < 3 ? cat - 1 : cat;
      const int pair = (k >> 1) * kPairBins;
      for (int q = 0; q < 5; ++q) {
        const int pb = pair + ((k & 1) ? q * 5 + sv : sv * 5 + q);
#pragma unroll
        for (int m = 0; m < S::kWarpsPerCtb; ++m)
          packed += tot[m * kBins + pb];
      }
    } else {
#pragma unroll
      for (int m = 0; m < S::kWarpsPerCtb; ++m)
        packed += tot[m * kBins + 2 * kPairBins + b - kEoBins];
    }
    const int n = packed & ((1 << kCountBits) - 1);
    const float sum = (float)((packed - n) / (1 << kCountBits));
    if (b < kEoBins) {
      const size_t o = ((size_t)b * cy + by) * cx + bx;
      eo_count[o] = n;
      eo_sum[o] = sum;
    } else {
      const size_t o = ((size_t)(b - kEoBins) * cy + by) * cx + bx;
      bo_count[o] = n;
      bo_sum[o] = sum;
    }
  }
}

template <int CTB>
int launch(const void* orig, const void* rec, void* eo_count, void* eo_sum,
           void* bo_count, void* bo_sum, int h, int w, cudaStream_t stream) {
  constexpr int K = Strip<CTB>::kCtbs;
  const dim3 grid((w / CTB + K - 1) / K, h / CTB);
  sao_stats_kernel<CTB><<<grid, Strip<CTB>::kThreads, 0, stream>>>(
      (const uint8_t*)orig, (const uint8_t*)rec, h, w, (int*)eo_count,
      (float*)eo_sum, (int*)bo_count, (float*)bo_sum);
  return (int)cudaGetLastError();
}

}  // namespace

// orig, rec: uint8 [h, w]; eo_count int32 / eo_sum float32 [4, 5, h/ctb,
// w/ctb]; bo_count int32 / bo_sum float32 [32, h/ctb, w/ctb].  Returns the
// launch's cudaError (cudaErrorInvalidValue for a ctb other than 8, 16 or
// 32, a plane that is not a CTB multiple or an orig not 4-byte aligned).
extern "C" int vct_sao_stats_u8(const void* orig, const void* rec,
                                void* eo_count, void* eo_sum, void* bo_count,
                                void* bo_sum, int h, int w, int ctb,
                                void* stream) {
  if (ctb != 8 && ctb != 16 && ctb != 32) return (int)cudaErrorInvalidValue;
  if (h < 0 || w < 0 || h % ctb || w % ctb) return (int)cudaErrorInvalidValue;
  // orig is read in aligned 32-bit words
  if ((uintptr_t)orig % 4) return (int)cudaErrorInvalidValue;
  if (h == 0 || w == 0) return 0;
  if (ctb == 32)
    return launch<32>(orig, rec, eo_count, eo_sum, bo_count, bo_sum, h, w,
                      (cudaStream_t)stream);
  if (ctb == 16)
    return launch<16>(orig, rec, eo_count, eo_sum, bo_count, bo_sum, h, w,
                      (cudaStream_t)stream);
  return launch<8>(orig, rec, eo_count, eo_sum, bo_count, bo_sum, h, w,
                   (cudaStream_t)stream);
}
