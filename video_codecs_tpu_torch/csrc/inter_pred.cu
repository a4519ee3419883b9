// The HEVC inter-prediction device stages for Hopper (sm_90a): motion
// compensation with its uni/bi combine, the quarter-pel SATD refinement and
// the alternating bi refinement pass.
//
// Replaces stages of the reference's jit-compiled inter device programs
// (`encode_p_frame_dev`, video_codecs_tpu/models/hevc/inter_jax.py:193;
// `encode_b_frame_dev`, :480; `qt_merge_dev`, inter_qt.py:99), which XLA
// fused on the TPU and the port's plain versions run as eager torch ops,
// hundreds of launches each:
//   mc_pred_kernel      per block: the edge-clamped window of one reference
//                       of a stack picked by a per-block index
//                       (video_codecs_tpu/ops/interp.py:103), the separable
//                       8-tap luma (quarter-pel) or 4-tap chroma
//                       (eighth-pel) filter to 14 bits (:115, :145), then
//                       the 14-bit hypothesis, or the 8-bit prediction:
//                       uni (p + 32) >> 6, or `bi_average` (:170) by the
//                       block's direction; optionally the 8x8 Hadamard
//                       SATD against the original block (ops/cost.py:19).
//                       The combiners it serves: inter_jax.py's `mrg_pred`
//                       (:660), `final_pred` (:814), `pred8` (:1004) and
//                       the merge loops, inter_qt.py's `_pred_cand` (:83).
//                       Its combine stage alone is `bi_average` on two
//                       given 14-bit planes.  Plain versions `mc_pred_ref`
//                       and `bi_average_ref` (video_codecs_tpu_torch/ops/
//                       inter_pred.py, ops/interp.py);
//   qpel_refine_kernel  the two rounds of `_refine` (ops/me.py:253), step 2
//                       then step 1: 9 candidates a round (the round's
//                       start and `_OFFS8` x step), each an 8-tap MC and
//                       the SATD, the first strict minimum kept.  Plain
//                       version `refine_qpel_ref` (two `me._refine` calls);
//   bi_refine_kernel    the one alternating bi pass of inter_jax.py:586-616:
//                       L0's 14-bit hypothesis, L1 refined against it, L1's
//                       winner's hypothesis, L0 refined against that.  Each
//                       refinement walks `_OFFS8` from the running best
//                       MV (a candidate moves the MV the next candidate
//                       starts from), so its 9 candidates are evaluated in
//                       order.  Plain version `bi_refine_pass_ref`.
// Each computes what its plain version computes, bit for bit: every value
// is an integer and int32 holds every intermediate (the horizontal pass
// |hor| <= 88 * 255, the vertical |ver| <= 88 * 22,440 < 2^21, a 2-D 8x8
// Hadamard of differences <= 64 * 255), so no order of summation matters.
//
// The tables (the filters, `_OFFS8`) come from the port's copies in an
// int32 buffer the wrapper builds (`inter_pred.tables_np`), at the offsets
// kTab* below; the kernels copy it to shared memory.  `_OFFS8`'s entries
// lie in {-1, 0, 1} (the wrapper checks it).
//
// Clamping.  The reference clamps each sample coordinate into the picture
// (edge replication); a window staged with the same per-coordinate clamp
// holds, at every offset, the samples each candidate's own gather would
// read, however far outside the picture the MV points.  So one window per
// block and reference covers all candidates: the refinements move an MV by
// at most 3 quarter samples, so from the integer origin (mv - 3) >> 2 a
// window of (n + 9)^2 samples covers every candidate's (n + 7)^2.
//
// Work skipped where the plain version repeats it.  qpel_refine: a round's
// 9 candidates lie in 3 columns (mvx - step, mvx, mvx + step), whose
// horizontal passes over the round's n + 8 rows are computed once each;
// round 2's centre is round 1's winner, whose SATD is known.  bi_refine:
// L0's centre candidate is L0's hypothesis of step 1, and L1's winner's
// hypothesis is kept from its search, not filtered again.  mc_pred with
// the originals writes only the SATD (every caller that asks for it uses
// nothing else).
//
// What bounds them.  Bytes: each block's window(s), its original and its
// outputs, a few KB per block; the integer multiply-adds of the filters
// (8 per sample per pass) are the larger bound in the refinements at the
// card's int32 rate.  The design: the window staged once in shared
// memory, the horizontal pass into shared memory, the vertical pass and
// the combine in registers, the Hadamard as butterflies in registers
// with the 8 columns of a tile reduced by warp shuffles.  A "team" codes
// one block: the whole CTA (256 threads) for mc_pred at n >= 16, one
// warp for mc_pred at n <= 8 (4 blocks a CTA) and for bi_refine (4
// blocks a CTA, its candidates in order); in qpel_refine the CTA's 9
// warps share a round's three horizontal passes, then each warp takes
// one candidate's vertical pass and SATD, and the CTA picks the first
// minimum from the 9 SATDs in shared memory.
// Barriers: __syncthreads for a CTA team, __syncwarp for a warp team,
// always from warp-uniform control flow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Offsets of the int32 table buffer (ops/inter_pred.py TAB_*).
constexpr int kTabLuma = 0;     // LUMA_FILTERS, 4 x 8
constexpr int kTabChroma = 32;  // CHROMA_FILTERS, 8 x 4
constexpr int kTabOffs = 64;    // _OFFS8, 8 x (dx, dy)
constexpr int kTabSize = 80;

// Output modes of mc_pred_kernel.
constexpr int kOut14 = 0;    // hypothesis 0 in the 14-bit domain
constexpr int kOutPred = 1;  // the 8-bit prediction (uni, or by direction)

__device__ __forceinline__ int clip8(int v) { return min(max(v, 0), 255); }

// The 8-bit prediction from 14-bit hypotheses: uni (p + 32) >> 6, and
// `bi_average` (p0 + p1 + 64) >> 7, clipped.
__device__ __forceinline__ int uni8(int p) { return clip8((p + 32) >> 6); }
__device__ __forceinline__ int bi8(int p0, int p1) {
  return clip8((p0 + p1 + 64) >> 7);
}

template <bool CTA>
__device__ __forceinline__ void team_sync() {
  if (CTA) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// dst[r * w + c] = plane[clamp(y + r)][clamp(x + c)] for an h x w window.
__device__ void stage_window(const int* __restrict__ plane, int hh, int ww,
                             int x, int y, int w, int h, int* dst, int rank,
                             int nthreads) {
  for (int i = rank; i < w * h; i += nthreads) {
    const int r = i / w;
    const int c = i - r * w;
    const int yy = min(max(y + r, 0), hh - 1);
    const int xx = min(max(x + c, 0), ww - 1);
    dst[i] = plane[(size_t)yy * ww + xx];
  }
}

// The horizontal pass: hor[r][c] = sum_k win[oy + r][ox + c + k] * fh[k]
// for the (N + T - 1) x N samples the vertical pass reads.
template <int N, int T>
__device__ void filter_hor(const int* win, int ws, int ox, int oy,
                           const int* fh_tab, int* hor, int rank,
                           int nthreads) {
  int fh[T];
#pragma unroll
  for (int k = 0; k < T; ++k) fh[k] = fh_tab[k];
  for (int i = rank; i < (N + T - 1) * N; i += nthreads) {
    const int r = i / N;
    const int c = i - r * N;
    const int* s = win + (oy + r) * ws + ox + c;
    int acc = 0;
#pragma unroll
    for (int k = 0; k < T; ++k) acc += s[k] * fh[k];
    hor[i] = acc;
  }
}

// The vertical pass at sample p of the block: the 14-bit value.
template <int N, int T>
__device__ __forceinline__ int filter_ver(const int* hor, int p,
                                          const int* fv) {
  const int r = p / N;
  const int c = p - r * N;
  const int* s = hor + r * N + c;
  int acc = 0;
#pragma unroll
  for (int k = 0; k < T; ++k) acc += s[k * N] * fv[k];
  return acc >> 6;
}

__device__ __forceinline__ void hadamard8(int v[8]) {
#pragma unroll
  for (int h = 1; h < 8; h <<= 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if ((i & h) == 0) {
        const int a = v[i];
        const int b = v[i + h];
        v[i] = a + b;
        v[i + h] = a - b;
      }
    }
  }
}

// SATD of the N x N differences d (overwritten): per 8x8 tile
// ((sum |H8 d H8|) + 2) >> 2, summed over the tiles (TComRdCost
// xCalcHADs8x8, the reference's ops/cost.py:19).  Rows, then columns:
// item i of a pass is row / column i % 8 of tile i / 8; the 8 items of a
// tile lie on 8 neighbouring lanes, whose column sums meet by shuffles.
// Every thread of the team calls it (the loops' trip counts are uniform);
// a CTA team needs `red`, one int per warp.  Returns the SATD in every
// thread of the team.
template <int N, bool CTA>
__device__ int satd8x8(int* d, int rank, int nthreads, int* red) {
  constexpr int kTilesX = N / 8;
  constexpr int kItems = N * N / 8;
  for (int i = rank; i < kItems; i += nthreads) {
    const int t = i >> 3;
    int* row = d + ((t / kTilesX) * 8 + (i & 7)) * N + (t % kTilesX) * 8;
    int v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = row[k];
    hadamard8(v);
#pragma unroll
    for (int k = 0; k < 8; ++k) row[k] = v[k];
  }
  team_sync<CTA>();
  int acc = 0;
  for (int base = 0; base < kItems; base += nthreads) {
    const int i = base + rank;
    int s = 0;
    if (i < kItems) {
      const int t = i >> 3;
      const int* col = d + (t / kTilesX) * 8 * N + (t % kTilesX) * 8 +
                       (i & 7);
      int v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = col[k * N];
      hadamard8(v);
#pragma unroll
      for (int k = 0; k < 8; ++k) s += abs(v[k]);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    // a tile of no item sums 0, and (0 + 2) >> 2 = 0
    if ((rank & 7) == 0) acc += (s + 2) >> 2;
  }
  acc = warp_sum(acc);
  if (!CTA) return acc;
  if ((rank & 31) == 0) red[rank >> 5] = acc;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < nthreads / 32; ++w) total += red[w];
  __syncthreads();
  return total;
}

__device__ __forceinline__ void load_table(const int* __restrict__ tab,
                                           int* s_tab) {
  for (int i = threadIdx.x; i < kTabSize; i += blockDim.x) s_tab[i] = tab[i];
  __syncthreads();
}

// ---- mc_pred_kernel -------------------------------------------------------

// Per-block inputs of mc_pred_kernel (device pointers, B entries each; the
// L1 ones and dirs may be null where the call does not read them).
struct McArgs {
  const int* refs0;  // [R0, H, W]
  const int* refs1;  // [R1, H, W]
  const int* x;
  const int* y;
  const int* ridx0;
  const int* mv0x;
  const int* mv0y;
  const int* ridx1;
  const int* mv1x;
  const int* mv1y;
  const int* dirs;   // 1 = L0, 2 = L1, 3 = bi (anything else: L1)
  const int* cur;    // [B, N, N] originals for the SATD, or null
  int* out;          // [B, N, N], written when cur is null
  int* satd;         // [B], written when cur is given
  int hh, ww, b, dir_const, has_l1;
};

// Team storage of one block: the window, the horizontal pass, both
// hypotheses and the SATD's differences.
template <int N, int T>
struct McSmem {
  int win[(N + T - 1) * (N + T - 1)];
  int hor[(N + T - 1) * N];
  int p0[N * N];
  int p1[N * N];
  int d[N * N];
};

// One hypothesis of block b into p14: the window of plane `plane` at the
// MV's integer position, then both passes.
template <int N, int T, bool CTA>
__device__ void mc_hypothesis(const int* plane, int hh, int ww, int x,
                              int y, int mvx, int mvy, const int* s_tab,
                              McSmem<N, T>& sm, int* p14, int rank,
                              int nthreads) {
  constexpr int kShift = T == 8 ? 2 : 3;      // quarter / eighth sample
  constexpr int kHalf = T / 2 - 1;            // taps left of the sample
  constexpr int kW = N + T - 1;
  const int* filt = s_tab + (T == 8 ? kTabLuma : kTabChroma);
  const int fx = mvx & ((1 << kShift) - 1);
  const int fy = mvy & ((1 << kShift) - 1);
  stage_window(plane, hh, ww, x + (mvx >> kShift) - kHalf,
               y + (mvy >> kShift) - kHalf, kW, kW, sm.win, rank, nthreads);
  team_sync<CTA>();
  filter_hor<N, T>(sm.win, kW, 0, 0, filt + fx * T, sm.hor, rank, nthreads);
  team_sync<CTA>();
  int fv[T];
#pragma unroll
  for (int k = 0; k < T; ++k) fv[k] = filt[fy * T + k];
  for (int p = rank; p < N * N; p += nthreads)
    p14[p] = filter_ver<N, T>(sm.hor, p, fv);
  team_sync<CTA>();
}

// One block per team: CTA teams (n >= 16) take blockIdx.x, warp teams
// (n <= 8) the CTA's warps in turn.
template <int N, int T, bool CTA, int MODE>
__global__ void mc_pred_kernel(McArgs a, const int* __restrict__ tab) {
  constexpr int kTeams = CTA ? 1 : 4;
  __shared__ int s_tab[kTabSize];
  __shared__ McSmem<N, T> s_team[kTeams];
  __shared__ int s_red[8];
  load_table(tab, s_tab);
  const int team = CTA ? 0 : (int)(threadIdx.x >> 5);
  const int rank = CTA ? (int)threadIdx.x : (int)(threadIdx.x & 31);
  const int nthreads = CTA ? (int)blockDim.x : 32;
  const int b = CTA ? (int)blockIdx.x : (int)blockIdx.x * kTeams + team;
  if (b >= a.b) return;  // a whole warp team, after the last barrier of all
  McSmem<N, T>& sm = s_team[team];
  const size_t plane = (size_t)a.hh * a.ww;
  const int x = a.x[b];
  const int y = a.y[b];
  const int dir = a.dirs ? a.dirs[b] : a.dir_const;
  const bool bi = MODE == kOutPred && a.has_l1;
  const bool need0 = !bi || dir == 1 || dir == 3;
  const bool need1 = bi && dir != 1;
  if (need0)
    mc_hypothesis<N, T, CTA>(a.refs0 + (size_t)a.ridx0[b] * plane, a.hh,
                             a.ww, x, y, a.mv0x[b], a.mv0y[b], s_tab, sm,
                             sm.p0, rank, nthreads);
  if (need1)
    mc_hypothesis<N, T, CTA>(a.refs1 + (size_t)a.ridx1[b] * plane, a.hh,
                             a.ww, x, y, a.mv1x[b], a.mv1y[b], s_tab, sm,
                             sm.p1, rank, nthreads);
  int* out = a.out + (size_t)b * N * N;
  const int* cur = a.cur ? a.cur + (size_t)b * N * N : nullptr;
  for (int p = rank; p < N * N; p += nthreads) {
    int v;
    if (MODE == kOut14) {
      v = sm.p0[p];
    } else if (bi && dir == 3) {
      v = bi8(sm.p0[p], sm.p1[p]);
    } else if (need0) {
      v = uni8(sm.p0[p]);
    } else {
      v = uni8(sm.p1[p]);
    }
    if (cur) {
      sm.d[p] = cur[p] - v;
    } else {
      out[p] = v;
    }
  }
  if (cur) {  // uniform: the argument of the call
    team_sync<CTA>();
    const int s = satd8x8<N, CTA>(sm.d, rank, nthreads, s_red);
    if (rank == 0) a.satd[b] = s;
  }
}

// bi_average on two given 14-bit planes: mc_pred_kernel's combine stage.
__global__ void mc_average_kernel(const int* __restrict__ p0,
                                  const int* __restrict__ p1, int* out,
                                  long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = bi8(p0[i], p1[i]);
}

// ---- qpel_refine_kernel ---------------------------------------------------

constexpr int kRefineWarps = 9;  // the centre and the 8 neighbours

template <int N>
struct RefineSmem {
  int win[(N + 9) * (N + 9)];
  int cur[N * N];
  int hor[3][(N + 8) * N];  // a round's three columns
  int d[kRefineWarps][N * N];
  int satd[kRefineWarps];
  int tab[kTabSize];
};

// One CTA of 9 warps per block; warp w scores candidate w of a round
// (0: the round's start, k > 0: the start + _OFFS8[k - 1] x step).
template <int N>
__global__ void __launch_bounds__(kRefineWarps * 32)
qpel_refine_kernel(const int* __restrict__ ref, int hh, int ww,
                   const int* __restrict__ cur, const int* __restrict__ x0,
                   const int* __restrict__ y0, const int* __restrict__ mvx_in,
                   const int* __restrict__ mvy_in, int* mvx_out,
                   int* mvy_out, int* satd_out, const int* __restrict__ tab) {
  constexpr int kWs = N + 9;             // the window's stride
  constexpr int kCol = (N + 8) * N;      // one column's horizontal pass
  __shared__ RefineSmem<N> sm;
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nthreads = kRefineWarps * 32;
  for (int i = threadIdx.x; i < kTabSize; i += nthreads) sm.tab[i] = tab[i];
  int mvx = mvx_in[b];
  int mvy = mvy_in[b];
  const int bx = (mvx - 3) >> 2;
  const int by = (mvy - 3) >> 2;
  stage_window(ref, hh, ww, x0[b] + bx - 3, y0[b] + by - 3, kWs, kWs,
               sm.win, threadIdx.x, nthreads);
  for (int i = threadIdx.x; i < N * N; i += nthreads)
    sm.cur[i] = cur[(size_t)b * N * N + i];
  __syncthreads();
  const int* filt = sm.tab + kTabLuma;
  // this warp's candidate, in steps: its column ox + 1 of the three
  const int ox = warp > 0 ? sm.tab[kTabOffs + 2 * (warp - 1)] : 0;
  const int oy = warp > 0 ? sm.tab[kTabOffs + 2 * (warp - 1) + 1] : 0;
  int best = 0;
  for (int step = 2; step >= 1; --step) {
    // The three columns' horizontal passes, over the N + 8 window rows
    // from the top candidates' first: a round's rows span at most one
    // integer position more than one candidate's N + 7.
    const int row0 = ((mvy - step) >> 2) - by;
    for (int i = threadIdx.x; i < 3 * kCol; i += nthreads) {
      const int j = i / kCol;
      const int k = i - j * kCol;
      const int r = k / N;
      const int c = k - r * N;
      const int cx = mvx + (j - 1) * step;
      const int* s = sm.win + (row0 + r) * kWs + (cx >> 2) - bx + c;
      const int* fh = filt + (cx & 3) * 8;
      int acc = 0;
#pragma unroll
      for (int t = 0; t < 8; ++t) acc += s[t] * fh[t];
      sm.hor[j][k] = acc;
    }
    __syncthreads();
    if (step == 2 || warp > 0) {  // warp-uniform
      const int cx = mvx + ox * step;
      const int cy = mvy + oy * step;
      const int* hor = sm.hor[ox + 1] + (((cy >> 2) - by) - row0) * N;
      int fv[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) fv[t] = filt[(cy & 3) * 8 + t];
      int* d = sm.d[warp];
      for (int p = lane; p < N * N; p += 32)
        d[p] = sm.cur[p] - uni8(filter_ver<N, 8>(hor, p, fv));
      __syncwarp();
      const int s = satd8x8<N, false>(d, lane, 32, nullptr);
      if (lane == 0) sm.satd[warp] = s;
    } else if (lane == 0) {
      sm.satd[0] = best;  // round 2's centre: round 1's winner
    }
    __syncthreads();
    // the first strict minimum in the order centre, _OFFS8[0..7]
    best = sm.satd[0];
    int k = 0;
    for (int j = 1; j < kRefineWarps; ++j) {
      if (sm.satd[j] < best) {
        best = sm.satd[j];
        k = j;
      }
    }
    if (k > 0) {
      mvx += sm.tab[kTabOffs + 2 * (k - 1)] * step;
      mvy += sm.tab[kTabOffs + 2 * (k - 1) + 1] * step;
    }
    __syncthreads();  // satd[] and hor[] are read before they are rewritten
  }
  if (threadIdx.x == 0) {
    mvx_out[b] = mvx;
    mvy_out[b] = mvy;
    satd_out[b] = best;
  }
}

// ---- bi_refine_kernel -----------------------------------------------------

constexpr int kBiWarps = 4;  // blocks per CTA, one warp each
constexpr int kBiN = 16;     // the block size of the bi pass

template <int N>
struct BiSmem {
  int win0[(N + 9) * (N + 9)];
  int win1[(N + 9) * (N + 9)];
  int cur[N * N];
  int p0[N * N];      // L0's 14-bit hypothesis at its start MV
  int hyp[2][N * N];  // the candidate's and the best candidate's, 14-bit
  // A candidate's horizontal pass, then its differences for the SATD:
  // never live at once, so one buffer (42.6 KB a CTA of 4 warps, which
  // lets 5 CTAs share an SM's 228 KB where separate buffers let 4).
  union {
    int hor[(N + 7) * N];
    int d[N * N];
  };
};

// The 14-bit hypothesis at (cx, cy) from a staged window into dst.
template <int N>
__device__ void warp_mc14(const int* win, int bx, int by, int cx, int cy,
                          const int* s_tab, int* hor, int* dst, int lane) {
  const int* filt = s_tab + kTabLuma;
  filter_hor<N, 8>(win, N + 9, (cx >> 2) - bx, (cy >> 2) - by,
                   filt + (cx & 3) * 8, hor, lane, 32);
  __syncwarp();
  int fv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) fv[k] = filt[(cy & 3) * 8 + k];
  for (int p = lane; p < N * N; p += 32) dst[p] = filter_ver<N, 8>(hor, p, fv);
  __syncwarp();
}

// One list's refinement against the fixed 14-bit hypothesis `fix`: the
// start, then _OFFS8 in order, each from the running best MV, kept where
// its SATD of bi_average(fix, candidate) is strictly lower.  `start` is
// the start's hypothesis where the caller has it (else it is filtered).
// Candidates are filtered into sm.hyp[spare]; with KEEP a winner's buffer
// is kept and `spare` turns to the other, so the winner's hypothesis ends
// in sm.hyp[spare ^ 1].  One warp; (mvx, mvy) in and out, returns the
// best SATD.
template <int N, bool KEEP>
__device__ int warp_bi_search(const int* win, int bx, int by, int& mvx,
                              int& mvy, const int* fix, const int* start,
                              int& spare, BiSmem<N>& sm, const int* s_tab,
                              int lane) {
  int best = 0;
  for (int k = 0; k < 9; ++k) {
    int cx = mvx;
    int cy = mvy;
    if (k > 0) {
      cx += s_tab[kTabOffs + 2 * (k - 1)];
      cy += s_tab[kTabOffs + 2 * (k - 1) + 1];
    }
    const int* h = start;
    if (k > 0 || !start) {  // uniform across the warp
      warp_mc14<N>(win, bx, by, cx, cy, s_tab, sm.hor, sm.hyp[spare], lane);
      h = sm.hyp[spare];
    }
    for (int p = lane; p < N * N; p += 32)
      sm.d[p] = sm.cur[p] - bi8(fix[p], h[p]);
    __syncwarp();
    const int s = satd8x8<N, false>(sm.d, lane, 32, nullptr);
    if (k == 0 || s < best) {  // s is the same in every lane
      best = s;
      mvx = cx;
      mvy = cy;
      if (KEEP) spare ^= 1;
    }
    __syncwarp();
  }
  return best;
}

template <int N>
__global__ void __launch_bounds__(kBiWarps * 32)
bi_refine_kernel(const int* __restrict__ refs0,
                 const int* __restrict__ refs1, int hh, int ww,
                 const int* __restrict__ cur, const int* __restrict__ x0,
                 const int* __restrict__ y0, const int* __restrict__ ridx0,
                 const int* __restrict__ ridx1,
                 const int* __restrict__ mv0x, const int* __restrict__ mv0y,
                 const int* __restrict__ mv1x, const int* __restrict__ mv1y,
                 int* b0x, int* b0y, int* b1x, int* b1y, int* satd_out,
                 int nb, const int* __restrict__ tab) {
  __shared__ int s_tab[kTabSize];
  __shared__ BiSmem<N> s_warp[kBiWarps];
  load_table(tab, s_tab);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kBiWarps + warp;
  if (b >= nb) return;  // the whole warp; no CTA barrier follows
  BiSmem<N>& sm = s_warp[warp];
  const size_t plane = (size_t)hh * ww;
  int m0x = mv0x[b], m0y = mv0y[b];
  int m1x = mv1x[b], m1y = mv1y[b];
  const int a0x = (m0x - 3) >> 2, a0y = (m0y - 3) >> 2;
  const int a1x = (m1x - 3) >> 2, a1y = (m1y - 3) >> 2;
  stage_window(refs0 + (size_t)ridx0[b] * plane, hh, ww, x0[b] + a0x - 3,
               y0[b] + a0y - 3, N + 9, N + 9, sm.win0, lane, 32);
  stage_window(refs1 + (size_t)ridx1[b] * plane, hh, ww, x0[b] + a1x - 3,
               y0[b] + a1y - 3, N + 9, N + 9, sm.win1, lane, 32);
  for (int i = lane; i < N * N; i += 32) sm.cur[i] = cur[(size_t)b * N * N + i];
  __syncwarp();
  // 1. L0's hypothesis at the best uni MV
  warp_mc14<N>(sm.win0, a0x, a0y, m0x, m0y, s_tab, sm.hor, sm.p0, lane);
  // 2. L1 refined against it, its winner's hypothesis kept (3.)
  int spare = 0;
  warp_bi_search<N, true>(sm.win1, a1x, a1y, m1x, m1y, sm.p0, nullptr,
                          spare, sm, s_tab, lane);
  // 4. L0 refined against L1's winner, its centre L0's hypothesis of 1.
  const int s = warp_bi_search<N, false>(sm.win0, a0x, a0y, m0x, m0y,
                                         sm.hyp[spare ^ 1], sm.p0, spare,
                                         sm, s_tab, lane);
  if (lane == 0) {
    b0x[b] = m0x;
    b0y[b] = m0y;
    b1x[b] = m1x;
    b1y[b] = m1y;
    satd_out[b] = s;
  }
}

template <int N, int T, bool CTA, int MODE>
int launch_mc(const McArgs& a, const int* tab, cudaStream_t stream) {
  const int threads = CTA ? 256 : 128;
  const int grid = CTA ? a.b : (a.b + 3) / 4;
  mc_pred_kernel<N, T, CTA, MODE><<<grid, threads, 0, stream>>>(a, tab);
  return (int)cudaGetLastError();
}

template <int N, int T, bool CTA>
int launch_mc_mode(const McArgs& a, int out14, const int* tab,
                   cudaStream_t stream) {
  return out14 ? launch_mc<N, T, CTA, kOut14>(a, tab, stream)
               : launch_mc<N, T, CTA, kOutPred>(a, tab, stream);
}

}  // namespace

// Block sizes: luma n = 8, 16, 32 and chroma n = 4, 8, 16 (mc_pred);
// n = 8, 16 (qpel_refine); n = 16 (bi_refine).  Another n returns
// cudaErrorInvalidValue.

extern "C" int vct_mc_pred(const void* refs0, const void* refs1, int hh,
                           int ww, const void* x, const void* y,
                           const void* ridx0, const void* mv0x,
                           const void* mv0y, const void* ridx1,
                           const void* mv1x, const void* mv1y,
                           const void* dirs, int dir_const, int has_l1,
                           int out14, int nb, int n, int luma,
                           const void* cur, void* out, void* satd,
                           const void* tab, void* stream) {
  McArgs a;
  a.refs0 = (const int*)refs0;
  a.refs1 = (const int*)refs1;
  a.x = (const int*)x;
  a.y = (const int*)y;
  a.ridx0 = (const int*)ridx0;
  a.mv0x = (const int*)mv0x;
  a.mv0y = (const int*)mv0y;
  a.ridx1 = (const int*)ridx1;
  a.mv1x = (const int*)mv1x;
  a.mv1y = (const int*)mv1y;
  a.dirs = (const int*)dirs;
  a.cur = (const int*)cur;
  a.out = (int*)out;
  a.satd = (int*)satd;
  a.hh = hh;
  a.ww = ww;
  a.b = nb;
  a.dir_const = dir_const;
  a.has_l1 = has_l1;
  if (nb <= 0) return 0;
  if (cur && n % 8) return (int)cudaErrorInvalidValue;
  const int* t = (const int*)tab;
  cudaStream_t s = (cudaStream_t)stream;
  if (luma) {
    if (n == 32) return launch_mc_mode<32, 8, true>(a, out14, t, s);
    if (n == 16) return launch_mc_mode<16, 8, true>(a, out14, t, s);
    if (n == 8) return launch_mc_mode<8, 8, false>(a, out14, t, s);
  } else {
    if (n == 16) return launch_mc_mode<16, 4, true>(a, out14, t, s);
    if (n == 8) return launch_mc_mode<8, 4, false>(a, out14, t, s);
    if (n == 4) return launch_mc_mode<4, 4, false>(a, out14, t, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int vct_mc_average(const void* p0, const void* p1, void* out,
                              long long n, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + 255) / 256;
  const int grid = (int)(blocks < 4096 ? blocks : 4096);
  mc_average_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int*)p0, (const int*)p1, (int*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int vct_qpel_refine(const void* ref, int hh, int ww,
                               const void* cur, const void* x0,
                               const void* y0, const void* mvx_in,
                               const void* mvy_in, void* mvx_out,
                               void* mvy_out, void* satd_out, int nb, int n,
                               const void* tab, void* stream) {
  if (nb <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define VCT_REFINE(NN)                                                       \
  qpel_refine_kernel<NN><<<nb, kRefineWarps * 32, 0, s>>>(                   \
      (const int*)ref, hh, ww, (const int*)cur, (const int*)x0,              \
      (const int*)y0, (const int*)mvx_in, (const int*)mvy_in,                \
      (int*)mvx_out, (int*)mvy_out, (int*)satd_out, (const int*)tab)
  if (n == 16) {
    VCT_REFINE(16);
  } else if (n == 8) {
    VCT_REFINE(8);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef VCT_REFINE
  return (int)cudaGetLastError();
}

extern "C" int vct_bi_refine(const void* refs0, const void* refs1, int hh,
                             int ww, const void* cur, const void* x0,
                             const void* y0, const void* ridx0,
                             const void* ridx1, const void* mv0x,
                             const void* mv0y, const void* mv1x,
                             const void* mv1y, void* b0x, void* b0y,
                             void* b1x, void* b1y, void* satd_out, int nb,
                             int n, const void* tab, void* stream) {
  if (nb <= 0) return 0;
  if (n != kBiN) return (int)cudaErrorInvalidValue;
  const int grid = (nb + kBiWarps - 1) / kBiWarps;
  bi_refine_kernel<kBiN><<<grid, kBiWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int*)refs0, (const int*)refs1, hh, ww, (const int*)cur,
      (const int*)x0, (const int*)y0, (const int*)ridx0, (const int*)ridx1,
      (const int*)mv0x, (const int*)mv0y, (const int*)mv1x,
      (const int*)mv1y, (int*)b0x, (int*)b0y, (int*)b1x, (int*)b1y,
      (int*)satd_out, nb, (const int*)tab);
  return (int)cudaGetLastError();
}
