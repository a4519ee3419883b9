// HM's full rate-distortion optimised quantisation (RDOQ) for Hopper
// (sm_90a), one call for a batch of transform blocks (TUs).
//
// Replaces the reference's XLA device loop `rdoq_dev`
// (video_codecs_tpu/ops/rdoq_jax.py:227), a nested `lax.scan` over the
// coefficient groups (CGs) and their 16 positions that the TPU ran as one
// program; the port's plain version is `rdoq_dev_ref` in
// video_codecs_tpu_torch/ops/rdoq_dev.py, which runs the same loop as
// about 40 eager torch ops per position.  For each [N, N] int32 block
// (N = 4, 8, 16, 32) it computes what `rdoq_dev_ref` computes, bit for
// bit: the levels (int32 [N, N], signed) and, on request, the estimated
// CABAC rate of those levels in float32 bits.
//
// What bounds it.  The roofline reading: the int32 coefficients are read
// once, the int32 levels and the float32 bits written once, 8 bytes per
// coefficient and 4 per block, 16.5 MB for the 1080p B picture's 8,040
// TU16s, 4.9 us at 3.35 TB/s; a few hundred operations per position are
// far below the card's rate.  What sets the time is neither: each
// position's level choice waits on the context state (c1, c2, Rice
// parameter, CG significance) the previous one left, a chain of N*N
// dependent positions per TU, about 130 instructions a position where a
// TU of the warp has a nonzero max level (two rates, three float64-rounded
// costs with nine float32/float64 conversions, the compares and the state
// update; scripts/profile_torch_rdoq.py writes the SASS).  A warp
// that walks alone on its SM sub-partition issues them in order at a few
// cycles each, so its floor is N*N positions times that, plus the shorter
// passes: scripts/bench_torch_rdoq.py measures it as the time of B = 32
// (one warp's TUs alone on the card) and scripts/profile_torch_rdoq.py
// splits it into passes; PERF.md keeps both beside the bound.  Every
// batch on the paths fits the card in one wave (TU16, B = 8,040: 252
// walking warps; TU32, B = 2,040: 128), so a call takes about its
// slowest warp's chain.
//
// Design.  One thread walks one TU.  A CTA holds 32 TUs (16 at TU32, lanes
// 16-31 then a copy of lanes 0-15, so that the CTA's coefficients, 64 KB,
// stay in L1 beside its shared memory) and 4 warps (8 at TU16 and TU32):
// warp 0 walks the chains in lockstep, one a lane, and then all the warps
// share the passes that are not serial, lane t of each on TU t.  The trip
// counts are the same for every TU (all NCG CGs and all 16 positions,
// masked by `active` / `is_last`), and the state update and the candidate
// choice are selects, so the lanes never diverge; a TU whose chain ends
// early (a smaller last position, an all-zero block, a lane past the
// batch's end) runs the same steps on masked values.
//   walk       warp 0, in reverse scan order as the reference's scan does,
//              chooses every position's level among {0, max - 1, max},
//              zeroes a CG where coding it costs more than not, and stores
//              the levels (int16) and the choices' costs (float32)
//              position-major, position p of the CTA's TUs at consecutive
//              words, so the lockstep stores touch one row, and per CG the
//              total of its costs.  The first position with a nonzero max
//              level it meets is the last significant one, so no pass
//              before it looks for it.  Where no TU of the warp has a
//              nonzero max level at a position (a vote), the warp skips
//              the candidates' rates and costs: the level is 0 and the
//              state does not move;
//   search     warp w takes CGs w, w + W, ... of the last-position search:
//              the exclusive prefix of the CGs' cost totals (every thread
//              runs it over all CGs, NCG adds), the running sums, the
//              suffix sums of the level-0 distortions, the total per
//              candidate and the argmin; the warps' argmins are merged
//              (the least total, a tie at the higher position);
//   rate       warp w takes the 32-entry chunks w, w + W, ...: the final
//              levels, signed, into a staging copy in raster order (its
//              rows padded so the lanes' stores hit 32 banks) and, with the
//              rate, each chunk's distortion sum; warp 0 adds the chunks;
//   epilogue   the CTA copies the staged levels out, the TUs back to back,
//              neighbouring lanes on neighbouring addresses.
// A warp alone on its scheduler issues in order, so any load whose
// latency lands on the chain stalls it: each pass loads a CG's
// coefficients one CG ahead into registers, and a CG's table rows
// (16-byte loads) at its start.  Only the levels and the costs are kept
// per position, 6 bytes: the coefficients are read again through the
// caller's strides (L1 hits), the level-0 distortion recomputed from
// them, the significance cost from the CG's neighbour pattern and nonzero
// mask.  Shared memory per CTA: 5.0 / 15.5 / 58.5 / 115.2 KB at TU4 / 8 /
// 16 / 32, above 48 KB by the launch's opt-in (cudaFuncSetAttribute, its
// error returned).
//
// Float32 in the plain version's order.  Every float operation is an
// explicit round-to-nearest intrinsic, which nvcc never contracts into a
// fused multiply-add, so the build flags need no -fmad=false.  The plain
// version's `fma32(a, b, c)` is (a * b + c) in float64 rounded to float32
// (a * b is exact in float64); it is reproduced as that, not with
// __fmaf_rn: the two differ only where the float64 sum lands on a float32
// rounding tie, and the kernel must equal the plain version even there.
// The sums keep the plain version's orders: CG sums left to right; row
// sums of more than 32 entries as 32-entry chunks, then the chunk sums;
// prefix sums as 16-entry tiles plus the exclusive prefix of the tile
// totals (recursively at 64 tiles), position p's read as its tile's
// running sum plus that tile's offset, never carried across tiles; the
// 4x4 rate's 16-entry distortion sum as 8 lanes (entry i + 8 fused onto
// entry i) and halves, or, where the block was zeroed, one fused chain; a
// tie in the argmin keeps the higher position.  Integers wrap as torch's
// int32 do (shifts and products in uint32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBypass = 1 << 15;     // one bypass bin in fractional bits
constexpr float kInf = 1e30f;        // a position that holds no level
constexpr int kLanes = 32;

__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

__device__ __forceinline__ int shl32(int v, int s) {
  return (int)((unsigned)v << s);
}

// |coefficient| * scale, wrapping as torch's int32 do
__device__ __forceinline__ int level_double(int c, int scale) {
  const int a = c < 0 ? (int)(0u - (unsigned)c) : c;
  return (int)((unsigned)a * (unsigned)scale);
}

__device__ __forceinline__ int max_level(int ld, int half, int q_bits) {
  return min((int)((unsigned)ld + (unsigned)half) >> q_bits, 32767);
}

// Fractional bits of coding an absolute level >= 1 at the live context
// state: the plain version's `_rate_level_dev` (HM xGetICRate), as
// selects.
__device__ __forceinline__ int rate_level(int level, int one0, int one1,
                                          int abs0, int abs1, int rice,
                                          int c1_idx, int c2_idx) {
  const bool in_c1 = c1_idx < 8;
  const int base = in_c1 ? (c2_idx == 0 ? 3 : 2) : 1;
  const int symbol = level - base;
  const int esc_at = 3 << rice;
  const int value = max(symbol - esc_at, 0);
  const int k = 31 - __clz(max(value + (1 << rice), 1));
  const int len = symbol < esc_at ? (symbol >> rice) + 1 + rice
                                  : 4 + 2 * k - rice;
  const bool ge_base = level >= base;
  int rate = kBypass + (ge_base ? len << 15 : 0) +
             (ge_base && in_c1 ? one1 : 0) +
             (ge_base && in_c1 && c2_idx == 0 ? abs1 : 0);
  rate = !ge_base && level == 1 ? kBypass + one0 : rate;
  rate = !ge_base && level == 2 ? kBypass + one1 + abs0 : rate;
  return rate;
}

// Inclusive prefix sums of a sequence of tile totals, one total at a time,
// in the plain version's `_cumsum` order for NT totals: left to right for
// NT <= 16; for NT = 64 left to right within each group of 16, plus the
// running sum of the earlier groups' totals.
template <int NT>
struct TilePrefix {
  float grp = 0.0f, outer = 0.0f;
  int i = 0;
  __device__ __forceinline__ float next(float t) {
    if (NT <= 16) {
      grp = i++ == 0 ? t : __fadd_rn(grp, t);
      return grp;
    }
    const int u = i >> 4, k = i & 15;
    grp = k == 0 ? t : __fadd_rn(grp, t);
    const float inc = u == 0 ? grp : __fadd_rn(grp, outer);
    if (k == 15) outer = u == 0 ? grp : __fadd_rn(outer, grp);
    ++i;
    return inc;
  }
};

// One CTA's shared memory, byte offsets: per position the level (int16)
// and the choice's cost (float32) of each of the 32 TUs, position-major;
// per CG of each TU its suffix offsets, the total of its costs and the
// mask of its nonzero levels; per scan position its element offset in a TU
// (the caller's strides); per TU what the walk and the search hand on.
// After the search the cost rows hold the staged output levels and the
// first suffix rows the rate's 32-entry distortion sums.
template <int LOG2>
struct Layout {
  static constexpr int kNN = 1 << (2 * LOG2);
  static constexpr int kNumCg = kNN >> 4;
  // warps per CTA: one walks, all search and rate
  static constexpr int kWarps = LOG2 >= 4 ? 8 : 4;
  // TUs per CTA, one a lane of each warp; at TU32 16, lanes 16-31 a copy
  // of lanes 0-15, so that the CTA's coefficients (64 KB) stay in L1
  // beside its shared memory for the passes that read them again
  static constexpr int kTus = LOG2 == 5 ? 16 : 32;
  static constexpr int kCost = 0;                         // f32 [NN][TUs]
  static constexpr int kLevel = kCost + 4 * kNN * kTus;   // i16 [NN][TUs]
  static constexpr int kSufIn = kLevel + 2 * kNN * kTus;  // f32 [NCG][TUs]
  static constexpr int kSufAll = kSufIn + 4 * kNumCg * kTus;
  static constexpr int kTotal = kSufAll + 4 * kNumCg * kTus;
  static constexpr int kOffset = kTotal + 4 * kNumCg * kTus;  // i32 [NN]
  static constexpr int kSigMap = kOffset + 4 * kNN;       // u64 [TUs]
  static constexpr int kBest = kSigMap + 8 * kTus;        // f32 [W][TUs]
  static constexpr int kBestPos = kBest + 4 * kWarps * kTus;  // i32 [W][TUs]
  static constexpr int kLast = kBestPos + 4 * kWarps * kTus;  // i32 [TUs]
  static constexpr int kChosen = kLast + 4 * kTus;        // f32 [TUs]
  static constexpr int kNonzero = kChosen + 4 * kTus;     // u16 [NCG][TUs]
  static constexpr int kBytes = kNonzero + 2 * kNumCg * kTus;
  static constexpr int kStageRow = kNN + 2;   // i16, padded by one word
  static_assert(2 * kStageRow * kTus <= 4 * kNN * kTus,
                "the staged levels fit in the cost rows");
  static_assert(kBytes <= 232448, "one CTA's shared memory on Hopper");
};

// The 16 int32 of a table row (16-byte aligned) into registers.
__device__ __forceinline__ void load_row16(const int* row, int* v) {
  const int4* q = reinterpret_cast<const int4*>(row);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 x = __ldg(q + k);
    v[4 * k] = x.x;
    v[4 * k + 1] = x.y;
    v[4 * k + 2] = x.z;
    v[4 * k + 3] = x.w;
  }
}

template <int LOG2>
__global__ void __launch_bounds__(Layout<LOG2>::kWarps * kLanes) rdoq_kernel(
    const int* __restrict__ coeff, long long s_b, long long s_y,
    long long s_x, int* __restrict__ out, float* __restrict__ bits_out,
    int num_blocks, const int* __restrict__ tab,
    const float* __restrict__ rate_last, int q_bits, int scale,
    float lam_bits, float es, float inv, int is_luma, int allow_all_zero) {
  using L = Layout<LOG2>;
  constexpr int N = 1 << LOG2, NN = L::kNN, NCG = L::kNumCg;
  constexpr int kWarps = L::kWarps, kTus = L::kTus;
  extern __shared__ __align__(16) unsigned char smem[];
  float* cost_s = reinterpret_cast<float*>(smem + L::kCost);
  short* level_s = reinterpret_cast<short*>(smem + L::kLevel);
  float* suf_in_s = reinterpret_cast<float*>(smem + L::kSufIn);
  float* suf_all_s = reinterpret_cast<float*>(smem + L::kSufAll);
  float* total_s = reinterpret_cast<float*>(smem + L::kTotal);
  int* offset_s = reinterpret_cast<int*>(smem + L::kOffset);
  unsigned long long* sig_map_s =
      reinterpret_cast<unsigned long long*>(smem + L::kSigMap);
  float* best_s = reinterpret_cast<float*>(smem + L::kBest);
  int* best_pos_s = reinterpret_cast<int*>(smem + L::kBestPos);
  int* last_s = reinterpret_cast<int*>(smem + L::kLast);
  float* chosen_s = reinterpret_cast<float*>(smem + L::kChosen);
  uint16_t* nonzero_s = reinterpret_cast<uint16_t*>(smem + L::kNonzero);
  short* stage = reinterpret_cast<short*>(smem + L::kCost);
  float* chunk_s = suf_in_s;         // after the search

  const int lane = threadIdx.x & 31;
  const int t = lane & (kTus - 1);   // the lane's TU
  const bool primary = lane < kTus;  // the lane that writes TU t out
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * kTus;
  const int count = min(kTus, num_blocks - first);
  const bool valid = t < count;
  // a lane past the batch's end walks the CTA's first TU again and writes
  // nothing out
  const int* tu = coeff + (long long)(valid ? first + t : first) * s_b;
  // the rate tables, packed by the wrapper (ops/rdoq_dev._kernel_tables)
  const int* scan = tab;                       // [NN] scan -> raster
  const int* sig_tab = scan + NN;              // [NCG step][4][16][2]
  const int* gt1 = sig_tab + NCG * 128;        // [16][2]
  const int* gt2 = gt1 + 32;                   // [4][2]
  const int* cg_bits = gt2 + 8;                // [2][2]
  const int* cg_rev = cg_bits + 4;             // [NCG step] CG raster
  const int* ngr_rev = cg_rev + NCG;           // right neighbour or -1
  const int* ngb_rev = ngr_rev + NCG;          // lower neighbour or -1
  const int half = 1 << (q_bits - 1);

  for (int p = threadIdx.x; p < NN; p += kWarps * kLanes) {
    const int r = scan[p];
    offset_s[p] = (r >> LOG2) * (int)s_y + (r & (N - 1)) * (int)s_x;
  }
  __syncthreads();

  // This thread's TU's 16 coefficients of CG c, in scan order.  Each pass
  // loads the next CG's while it works on this one, so the loads' latency
  // stays off the chain.
  auto load_cg = [&](int c, int* v) {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = __ldg(tu + offset_s[c * 16 + j]);
  };

  // ---- the walk (warp 0): CGs and positions in reverse scan order ----
  // The first position with a nonzero max level met on the way down is
  // the last significant position; positions above it are inactive.
  if (warp == 0) {
  int last_pos = -1;
  const int base_set = is_luma ? 2 : 0;
  unsigned long long sig_map = 0;    // decided CG significance, by raster
  int prev_c1 = 1;
  TilePrefix<NCG> d0_prefix;         // over the CGs' reversed d0 totals
  float d0_excl = 0.0f;
  int next[16];
  load_cg(NCG - 1, next);
  for (int s = 0; s < NCG; ++s) {
    const int cg_i = NCG - 1 - s;
    int ld[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) ld[j] = level_double(next[j], scale);
    if (s + 1 < NCG) load_cg(cg_i - 1, next);
    const int ngr = ngr_rev[s], ngb = ngb_rev[s];
    const int right = ngr >= 0 ? (int)(sig_map >> ngr) & 1 : 0;
    const int below = ngb >= 0 ? (int)(sig_map >> ngb) & 1 : 0;
    const int pattern = right + 2 * below;
    int sig[32];                     // (bits0, bits1) of the 16 positions
    load_row16(sig_tab + (s * 4 + pattern) * 32, sig);
    load_row16(sig_tab + (s * 4 + pattern) * 32 + 16, sig + 16);
    const int ctx_set = (cg_i == 0 ? 0 : base_set) + (prev_c1 == 0);
    const int abs0 = gt2[2 * ctx_set], abs1 = gt2[2 * ctx_set + 1];
    int g0[4], g1[4];                // gt1 bits of ctx_set by c1 = 0..3
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      g0[k] = gt1[2 * (ctx_set * 4 + k)];
      g1[k] = gt1[2 * (ctx_set * 4 + k) + 1];
    }
    int c1 = 1, c1_idx = 0, c2_idx = 0, rice = 0;   // c1 stays in 0..3
    bool cg_has = false;
    int lv[16];
    float cc[16], d0[16];
#pragma unroll
    for (int j = 15; j >= 0; --j) {
      const int p = cg_i * 16 + j;
      const int ma = max_level(ld[j], half, q_bits);
      const float ldf = __int2float_rn(ld[j]);
      d0[j] = __fmul_rn(__fmul_rn(ldf, ldf), es);
      const bool is_last = last_pos < 0 && ma > 0;
      last_pos = is_last ? p : last_pos;
      const bool active = last_pos >= 0;
      const int sb0 = is_last ? 0 : sig[2 * j];
      const float j0 = fma32(lam_bits, __int2float_rn(sb0), d0[j]);
      // level 0 unless the max level is nonzero, which implies active; a
      // position where no TU of the warp has one skips the candidates, and
      // the context state stays as it is
      int best_l = 0;
      float best_j = j0;
      if (__any_sync(0xffffffffu, ma > 0)) {
        const int sb1 = is_last ? 0 : sig[2 * j + 1];
        const int one0 = c1 >= 2 ? (c1 & 1 ? g0[3] : g0[2])
                                 : (c1 & 1 ? g0[1] : g0[0]);
        const int one1 = c1 >= 2 ? (c1 & 1 ? g1[3] : g1[2])
                                 : (c1 & 1 ? g1[1] : g1[0]);
        const int l_lo = max(ma - 1, 1), l_hi = ma;
        const int r_lo = rate_level(l_lo, one0, one1, abs0, abs1, rice,
                                    c1_idx, c2_idx);
        const int r_hi = rate_level(l_hi, one0, one1, abs0, abs1, rice,
                                    c1_idx, c2_idx);
        const float d_lo =
            __fsub_rn(ldf, __int2float_rn(shl32(l_lo, q_bits)));
        const float d_hi =
            __fsub_rn(ldf, __int2float_rn(shl32(l_hi, q_bits)));
        const float j_lo = fma32(
            __fmul_rn(d_lo, d_lo), es,
            __fmul_rn(lam_bits, __int2float_rn(sb1 + r_lo)));
        const float j_hi = fma32(
            __fmul_rn(d_hi, d_hi), es,
            __fmul_rn(lam_bits, __int2float_rn(sb1 + r_hi)));
        const bool has = ma > 0;
        const bool take_lo = has && j_lo < j0;
        best_l = take_lo ? l_lo : 0;
        best_j = take_lo ? j_lo : j0;
        const bool take_hi = has && l_hi != l_lo && j_hi < best_j;
        best_l = take_hi ? l_hi : best_l;
        best_j = take_hi ? j_hi : best_j;
        // context-state evolution
        const bool nz = best_l > 0;
        const bool in_c1 = c1_idx < 8;
        const bool gt1_ = best_l > 1;
        const int c2_n = nz && in_c1 && gt1_ ? 1 : c2_idx;
        const int c1_n = nz && in_c1 && gt1_ ? 0
                         : nz && in_c1 && c1 > 0 && c1 < 3 ? c1 + 1 : c1;
        const int c1i_n = nz && in_c1 ? c1_idx + 1 : c1_idx;
        const int rice_n =
            nz && best_l > (3 << rice) ? min(rice + 1, 4) : rice;
        c1 = c1_n;
        c1_idx = c1i_n;
        c2_idx = c2_n;
        rice = rice_n;
        cg_has = cg_has || nz;
      }
      lv[j] = best_l;
      cc[j] = active ? best_j : 0.0f;
    }
    // CG zero-out (only 0 < cg_i < last_cg)
    float sum_cc = cc[0], sum_d0 = d0[0], rev_d0 = d0[15];
#pragma unroll
    for (int i = 1; i < 16; ++i) {
      sum_cc = __fadd_rn(sum_cc, cc[i]);
      sum_d0 = __fadd_rn(sum_d0, d0[i]);
      rev_d0 = __fadd_rn(rev_d0, d0[15 - i]);
    }
    const int ctx = right + below > 0;
    const float j_keep = fma32(lam_bits, __int2float_rn(cg_bits[2 * ctx + 1]),
                               sum_cc);
    const float j_zero = fma32(lam_bits, __int2float_rn(cg_bits[2 * ctx]),
                               sum_d0);
    const bool zero_out = cg_i > 0 && cg_i < (last_pos >> 4) && cg_has &&
                          j_zero < j_keep;
    unsigned nonzero = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int at = (cg_i * 16 + j) * kTus + t;
      const int l = zero_out ? 0 : lv[j];
      level_s[at] = (short)l;
      cost_s[at] = zero_out ? d0[j] : cc[j];
      nonzero |= (unsigned)(l > 0) << j;
    }
    // the suffix sums of d0 that the search reads in this CG: the
    // exclusive prefix of the reversed tiles above it, and with its own
    // reversed total added
    const int at = cg_i * kTus + t;
    nonzero_s[at] = (uint16_t)nonzero;
    total_s[at] = zero_out ? sum_d0 : sum_cc;  // the tile's cost total
    suf_in_s[at] = d0_excl;
    suf_all_s[at] = __fadd_rn(rev_d0, d0_excl);
    d0_excl = d0_prefix.next(rev_d0);
    if (cg_has && !zero_out) sig_map |= 1ull << cg_rev[s];
    prev_c1 = c1;
  }
  last_s[t] = last_pos;
  sig_map_s[t] = sig_map;
  }
  __syncthreads();

  // ---- last-position search: warp w takes CGs w, w + 4, ... ----
  // Each thread runs the exclusive prefix of the CGs' cost totals over all
  // CGs, and the positions of its own CGs: their running sums, suffix sums
  // of the level-0 distortions, the total per candidate and the argmin.
  const int last_pos = last_s[t];
  const unsigned long long sig_map = sig_map_s[t];
  float best = __int_as_float(0x7f800000);
  int best_p = -1;
  {
    TilePrefix<NCG> cc_prefix;
    float cc_excl = 0.0f;            // exclusive prefix of the CG's tile
    float prev_cum = 0.0f;           // inclusive prefix at the CG's start - 1
    int next[16];
    if (warp < NCG) load_cg(warp, next);
    for (int c = 0; c < NCG; ++c) {
      const int at = c * kTus + t;
      const float total = total_s[at];
      if (c % kWarps == warp) {
        float cc[16];
        int cur[16], sig[32];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          cur[j] = next[j];
          cc[j] = cost_s[(c * 16 + j) * kTus + t];
        }
        if (c + kWarps < NCG) load_cg(c + kWarps, next);
        const unsigned nonzero = nonzero_s[at];
        if (__any_sync(0xffffffffu, nonzero != 0)) {
          // the CG's neighbour pattern, as the walk saw it: the right and
          // lower CGs were decided before it
          const int s = NCG - 1 - c;
          const int ngr = ngr_rev[s], ngb = ngb_rev[s];
          const int pattern = (ngr >= 0 ? (int)(sig_map >> ngr) & 1 : 0) +
                              2 * (ngb >= 0 ? (int)(sig_map >> ngb) & 1 : 0);
          load_row16(sig_tab + (s * 4 + pattern) * 32, sig);
          load_row16(sig_tab + (s * 4 + pattern) * 32 + 16, sig + 16);
          float d0[16], rs[16], rl[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float ldf = __int2float_rn(level_double(cur[j], scale));
            d0[j] = __fmul_rn(__fmul_rn(ldf, ldf), es);
          }
          load_row16(reinterpret_cast<const int*>(rate_last) + c * 16,
                     reinterpret_cast<int*>(rl));
          const float suf_in = suf_in_s[at];
          const float suf_next =
              c + 1 < NCG ? suf_all_s[at + kTus] : 0.0f;
          rs[15] = d0[15];           // rs[m] = d0[15] + d0[14] + ... + d0[m]
#pragma unroll
          for (int m = 14; m >= 0; --m) rs[m] = __fadd_rn(rs[m + 1], d0[m]);
          float pc = 0.0f;           // the tile's running sum of cc
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int p = c * 16 + j;
            const float prefix = p == 0 ? 0.0f
                                 : j == 0 ? prev_cum
                                          : __fadd_rn(pc, cc_excl);
            pc = j == 0 ? cc[0] : __fadd_rn(pc, cc[j]);
            const float suffix = p + 1 == NN ? 0.0f
                                 : j < 15 ? __fadd_rn(rs[j + 1], suf_in)
                                          : suf_next;
            const int sb1 = p == last_pos ? 0 : sig[2 * j + 1];
            const float cs = __fmul_rn(lam_bits, __int2float_rn(sb1));
            float tot = __fadd_rn(
                __fadd_rn(__fadd_rn(prefix, __fsub_rn(cc[j], cs)),
                          __fmul_rn(lam_bits, rl[j])),
                suffix);
            if (!(nonzero >> j & 1)) tot = kInf;
            if (tot <= best) {       // p rises: a tie keeps the higher p
              best = tot;
              best_p = p;
            }
          }
        } else if (kInf <= best) {
          // no candidate in this CG for any TU of the warp: a total of
          // kInf at each position, the tie kept at the highest
          best = kInf;
          best_p = c * 16 + 15;
        }
      }
      prev_cum = __fadd_rn(total, cc_excl);
      cc_excl = cc_prefix.next(total);
    }
  }
  best_s[warp * kTus + t] = best;
  best_pos_s[warp * kTus + t] = best_p;
  __syncthreads();
  if (warp == 0) {
    // the warps' argmins merged: the least total, a tie at the higher p
    for (int w = 1; w < kWarps; ++w) {
      const float v = best_s[w * kTus + t];
      const int vp = best_pos_s[w * kTus + t];
      if (v < best || (v == best && vp > best_p)) {
        best = v;
        best_p = vp;
      }
    }
    float chosen = best;
    bool all_zero = false;
    if (allow_all_zero) {
      const float total_zero = suf_all_s[t];   // all of d0, CG 0 included
      all_zero = total_zero < best;
      if (all_zero) chosen = total_zero;
    }
    if (last_pos < 0) chosen = 0.0f;
    // what the rate pass needs: the last position kept (-2: the whole
    // block zeroed by the all-zero test, -1: no level at all), the chosen
    // total
    best_pos_s[t] = all_zero ? -2 : last_pos < 0 ? -1 : best_p;
    chosen_s[t] = chosen;
  }
  __syncthreads();

  // ---- the final levels, staged in raster order, and the rate ----
  // Warp w takes the 32-entry chunks w, w + 4, ... of the positions (the
  // rate's distortion sum runs in such chunks); a 4x4 block is warp 0's.
  const bool rate = bits_out != nullptr;
  const int keep = best_pos_s[t];    // positions <= keep keep their level
  short* row = stage + t * L::kStageRow;
  constexpr int kChunkCgs = NN == 16 ? 1 : 2;
  constexpr int kChunks = NCG / kChunkCgs;
  float sq[16];                      // 4x4: squared errors for XLA's order
  for (int k = warp; k < kChunks; k += kWarps) {
    float chunk = 0.0f;
#pragma unroll
    for (int h = 0; h < kChunkCgs; ++h) {
      const int c = k * kChunkCgs + h;
      int cv[16], lv[16];
      load_cg(c, cv);
#pragma unroll
      for (int j = 0; j < 16; ++j) lv[j] = level_s[(c * 16 + j) * kTus + t];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int p = c * 16 + j;
        const int lvl = p > keep ? 0 : lv[j];
        row[scan[p]] = (short)(cv[j] > 0 ? lvl : cv[j] < 0 ? -lvl : 0);
        if (!rate) continue;
        const float ldf = __int2float_rn(level_double(cv[j], scale));
        const float e = __fsub_rn(ldf, __int2float_rn(shl32(lvl, q_bits)));
        if (NN == 16) {
          sq[j] = lvl > 0 ? __fmul_rn(e, e) : __fmul_rn(ldf, ldf);
        } else {
          const float d = lvl > 0 ? __fmul_rn(__fmul_rn(e, e), es)
                                  : __fmul_rn(__fmul_rn(ldf, ldf), es);
          chunk = p % 32 == 0 ? d : __fadd_rn(chunk, d);
        }
      }
    }
    if (NN > 16 && rate) chunk_s[k * kTus + t] = chunk;
  }
  if (rate && NN == 16 && warp == 0 && valid && primary) {
    float dist_sum;
    if (allow_all_zero && keep == -2) {
      float acc = __fmul_rn(sq[0], es);
#pragma unroll
      for (int i = 1; i < 16; ++i) acc = fma32(sq[i], es, acc);
      dist_sum = acc;
    } else {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = fma32(sq[8 + i], es, __fmul_rn(sq[i], es));
#pragma unroll
      for (int h = 4; h >= 1; h >>= 1)
#pragma unroll
        for (int i = 0; i < h; ++i) v[i] = __fadd_rn(v[i], v[i + h]);
      dist_sum = v[0];
    }
    const float r = __fmul_rn(__fsub_rn(chosen_s[t], dist_sum), inv);
    bits_out[first + t] = r < 0.0f ? 0.0f : r;
  }
  __syncthreads();
  if (rate && NN > 16 && warp == 0 && valid && primary) {
    // the chunk sums left to right
    float dist_sum = chunk_s[t];
    for (int k = 1; k < kChunks; ++k)
      dist_sum = __fadd_rn(dist_sum, chunk_s[k * kTus + t]);
    const float r = __fmul_rn(__fsub_rn(chosen_s[t], dist_sum), inv);
    bits_out[first + t] = r < 0.0f ? 0.0f : r;
  }

  // ---- epilogue: the staged levels out, the CTA's TUs back to back ----
  int* dst = out + (long long)first * NN;
#pragma unroll 4
  for (int i = threadIdx.x; i < count * NN; i += kWarps * kLanes)
    dst[i] = stage[(i / NN) * L::kStageRow + i % NN];
}

template <int LOG2>
int launch(const void* coeff, long long s_b, long long s_y, long long s_x,
           void* out, void* bits, int num_blocks, const void* tab,
           const void* rate_last, int q_bits, int scale, float lam_bits,
           float es, float inv, int is_luma, int allow_all_zero,
           cudaStream_t stream) {
  constexpr int bytes = Layout<LOG2>::kBytes;
  if (bytes > 48 * 1024) {
    const cudaError_t opt = cudaFuncSetAttribute(
        rdoq_kernel<LOG2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (opt != cudaSuccess) return (int)opt;
  }
  constexpr int kTus = Layout<LOG2>::kTus;
  const int grid = (num_blocks + kTus - 1) / kTus;
  rdoq_kernel<LOG2><<<grid, Layout<LOG2>::kWarps * kLanes, bytes, stream>>>(
      (const int*)coeff, s_b, s_y, s_x, (int*)out, (float*)bits, num_blocks,
      (const int*)tab, (const float*)rate_last, q_bits, scale, lam_bits, es,
      inv, is_luma, allow_all_zero);
  return (int)cudaGetLastError();
}

}  // namespace

// coeff: int32 [B, N, N] with element strides (s_b, s_y, s_x); out: int32
// [B, N, N] contiguous; bits: float32 [B] or null (no rate); tab / rate_last:
// the packed int32 rate tables and the float32 last-position rates of
// ops/rdoq_dev._kernel_tables.  Returns the launch's cudaError, or the
// shared-memory opt-in's (cudaErrorInvalidValue for a log2 size outside
// 2..5, or strides that put an element of a block 2^31 or more elements
// past its first).
extern "C" int vct_rdoq(const void* coeff, long long s_b, long long s_y,
                        long long s_x, void* out, void* bits, int num_blocks,
                        int log2_size, const void* tab, const void* rate_last,
                        int q_bits, int scale, float lam_bits, float es,
                        float inv, int is_luma, int allow_all_zero,
                        void* stream) {
  if (num_blocks < 0 || q_bits < 1 || q_bits > 30)
    return (int)cudaErrorInvalidValue;
  if (num_blocks == 0) return 0;
  // the kernel keeps a position's offset in a TU in 32 bits
  if (log2_size < 2 || log2_size > 5 || s_y < 0 || s_x < 0 ||
      ((1LL << log2_size) - 1) * (s_y + s_x) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (log2_size) {
    case 2:
      return launch<2>(coeff, s_b, s_y, s_x, out, bits, num_blocks, tab,
                       rate_last, q_bits, scale, lam_bits, es, inv, is_luma,
                       allow_all_zero, st);
    case 3:
      return launch<3>(coeff, s_b, s_y, s_x, out, bits, num_blocks, tab,
                       rate_last, q_bits, scale, lam_bits, es, inv, is_luma,
                       allow_all_zero, st);
    case 4:
      return launch<4>(coeff, s_b, s_y, s_x, out, bits, num_blocks, tab,
                       rate_last, q_bits, scale, lam_bits, es, inv, is_luma,
                       allow_all_zero, st);
    case 5:
      return launch<5>(coeff, s_b, s_y, s_x, out, bits, num_blocks, tab,
                       rate_last, q_bits, scale, lam_bits, es, inv, is_luma,
                       allow_all_zero, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
