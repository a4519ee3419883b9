// HM's full rate-distortion optimised quantisation (RDOQ) for Hopper
// (sm_90a), one call for a batch of transform blocks.
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
// What bounds it.  The int32 coefficients are read once, the int32 levels
// and the float32 bits written once: 8 bytes per coefficient and 4 per
// block, 16.5 MB for the 1080p B picture's 8,040 TU16s, 4.9 us at
// 3.35 TB/s.  The arithmetic is a few hundred operations per position,
// far below the card's rate.  What sets this kernel's time today is
// neither: it is the serial chain of N*N positions in one block, each
// position's level choice waiting on the context state (c1, c2, Rice
// parameter, CG significance) that the previous one left.
//
// Design.  One warp per block; four blocks per CTA up to TU16, one at
// TU32 (each block's working set is 28 bytes a position in shared
// memory).  The lanes gather the block in scan order and compute each
// position's max level, scaled level and zero-level distortion (the
// prologue).  Lane 0 then walks the CGs and positions in reverse scan
// order as the reference's scan does, carrying the context state, and
// writes each position's level, cost and significance cost to shared
// memory; it zeroes a CG where coding it costs more than not.  The lanes
// take the last-position search: prefix sums of the costs and suffix
// sums of the zero distortions, the total per candidate last position,
// and the argmin.  They then scatter the signed levels back to raster
// order and, with the rate, sum the final distortion.  Faster designs
// (the level candidates of a CG evaluated by 16 lanes at once, a CTA per
// CG) keep this interface.
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
// totals (recursively at 64 tiles); the 4x4 rate's 16-entry distortion
// sum as 8 lanes (entry i + 8 fused onto entry i) and halves, or, where
// the block was zeroed, one fused chain.  Integers wrap as torch's int32
// do (shifts and products in uint32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBypass = 1 << 15;     // one bypass bin in fractional bits
constexpr float kInf = 1e30f;        // a position that holds no level

__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

__device__ __forceinline__ int shl32(int v, int s) {
  return (int)((unsigned)v << s);
}

// Fractional bits of coding an absolute level >= 1 at the live context
// state: the plain version's `_rate_level_dev` (HM xGetICRate).
__device__ __forceinline__ int rate_level(int level, int one0, int one1,
                                          int abs0, int abs1, int rice,
                                          int c1_idx, int c2_idx) {
  const int base = c1_idx < 8 ? (c2_idx == 0 ? 3 : 2) : 1;
  const int symbol = level - base;
  const int esc_at = 3 << rice;
  int len;
  if (symbol < esc_at) {
    len = (symbol >> rice) + 1 + rice;
  } else {
    const int value = max(symbol - esc_at, 0);
    const int k = 31 - __clz(max(value + (1 << rice), 1));
    len = 4 + 2 * k - rice;
  }
  const bool ge_base = level >= base;
  const bool in_c1 = c1_idx < 8;
  int rate = kBypass;
  if (ge_base) rate += len << 15;
  if (ge_base && in_c1) rate += one1;
  if (ge_base && in_c1 && c2_idx == 0) rate += abs1;
  if (!ge_base && level == 1) rate = kBypass + one0;
  if (!ge_base && level == 2) rate = kBypass + one1 + abs0;
  return rate;
}

template <int LOG2>
struct Shape {
  static constexpr int kN = 1 << LOG2;
  static constexpr int kNN = kN * kN;
  static constexpr int kNumCg = kNN >> 4;      // CGs = 16-entry scan tiles
  static constexpr int kWarps = LOG2 == 5 ? 1 : 4;
};

// One block's working set.
template <int NN>
struct Work {
  int lv[NN];        // max level, then the chosen level, scan order
  int ld[NN];        // |coefficient| * scale
  float d0[NN];      // distortion at level 0
  float cc[NN];      // cost of the position's choice
  float cs[NN];      // its significance-flag cost
  float pc[NN];      // 16-entry tile prefix sums of cc
  float sd[NN];      // 16-entry tile prefix sums of d0, read backwards
  int cg_sig[NN / 16];
  float tile_cc[NN / 16], tile_d0[NN / 16];   // tile totals, then their
  float excl_cc[NN / 16], excl_d0[NN / 16];   // exclusive prefix sums
  float red_f[32];
  int red_i[32];
  int last_pos, best_last, all_zero;
  float best_total, chosen;
};

// Inclusive prefix sums of t[0..n) into o, in the plain version's
// `_cumsum` order (n = 4, 16 or 64).
__device__ void tile_prefix(const float* t, float* o, int n) {
  if (n <= 16) {
    float a = t[0];
    o[0] = a;
    for (int i = 1; i < n; ++i) o[i] = a = __fadd_rn(a, t[i]);
    return;
  }
  float outer[4];
  for (int u = 0; u < n / 16; ++u) {
    float a = t[16 * u];
    o[16 * u] = a;
    for (int i = 1; i < 16; ++i) o[16 * u + i] = a = __fadd_rn(a, t[16 * u + i]);
    outer[u] = u == 0 ? a : __fadd_rn(outer[u - 1], a);
  }
  for (int u = 0; u < n / 16; ++u) {
    const float ex = u == 0 ? 0.0f : outer[u - 1];
    for (int i = 0; i < 16; ++i) o[16 * u + i] = __fadd_rn(o[16 * u + i], ex);
  }
}

template <int LOG2>
__global__ void __launch_bounds__(32 * Shape<LOG2>::kWarps) rdoq_kernel(
    const int* __restrict__ coeff, long long s_b, long long s_y,
    long long s_x, int* __restrict__ out, float* __restrict__ bits_out,
    int num_blocks, const int* __restrict__ tab,
    const float* __restrict__ rate_last, int q_bits, int scale,
    float lam_bits, float es, float inv, int is_luma, int allow_all_zero) {
  using S = Shape<LOG2>;
  constexpr int N = S::kN, NN = S::kNN, NCG = S::kNumCg;
  __shared__ Work<NN> work[S::kWarps];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int blk = blockIdx.x * S::kWarps + wid;
  const bool valid = blk < num_blocks;
  Work<NN>& w = work[wid];
  // the rate tables, packed by the wrapper (ops/rdoq_dev._kernel_tables)
  const int* scan = tab;                       // [NN] scan -> raster
  const int* sig_tab = scan + NN;              // [NCG step][4][16][2]
  const int* gt1 = sig_tab + NCG * 128;        // [16][2]
  const int* gt2 = gt1 + 32;                   // [4][2]
  const int* cg_bits = gt2 + 8;                // [2][2]
  const int* cg_rev = cg_bits + 4;             // [NCG step] CG raster
  const int* ngr_rev = cg_rev + NCG;           // right neighbour or -1
  const int* ngb_rev = ngr_rev + NCG;          // lower neighbour or -1
  const long long base = (long long)blk * s_b;

  // ---- prologue: scan-order gather, max level, level-0 distortion ----
  const int half = 1 << (q_bits - 1);
  int my_last = -1;
  for (int p = lane; p < NN; p += 32) {
    const int r = scan[p];
    const int c = valid ? coeff[base + (r >> LOG2) * s_y + (r & (N - 1)) * s_x]
                        : 0;
    const int a = c < 0 ? (int)(0u - (unsigned)c) : c;
    const int ld = (int)((unsigned)a * (unsigned)scale);
    const int ma = min((int)((unsigned)ld + (unsigned)half) >> q_bits, 32767);
    const float ldf = __int2float_rn(ld);
    w.lv[p] = ma;
    w.ld[p] = ld;
    w.d0[p] = __fmul_rn(__fmul_rn(ldf, ldf), es);
    if (ma > 0) my_last = p;
  }
  w.red_i[lane] = my_last;
  for (int k = lane; k < NCG; k += 32) w.cg_sig[k] = 0;
  __syncwarp();

  // ---- the CG / position loop, serial by nature: lane 0 ----
  if (lane == 0) {
    int last_pos = -1;
    for (int i = 0; i < 32; ++i) last_pos = max(last_pos, w.red_i[i]);
    w.last_pos = last_pos;
    const int last_cg = last_pos >> 4;
    const int base_set = is_luma ? 2 : 0;
    int prev_c1 = 1;
    for (int s = 0; s < NCG; ++s) {
      const int cg_i = NCG - 1 - s;
      const int ngr = ngr_rev[s], ngb = ngb_rev[s];
      const int right = ngr >= 0 ? w.cg_sig[ngr] : 0;
      const int below = ngb >= 0 ? w.cg_sig[ngb] : 0;
      const int* sig = sig_tab + (s * 4 + right + 2 * below) * 32;
      const int ctx_set = (cg_i == 0 ? 0 : base_set) + (prev_c1 == 0);
      const int abs0 = gt2[2 * ctx_set], abs1 = gt2[2 * ctx_set + 1];
      int c1 = 1, c1_idx = 0, c2_idx = 0, rice = 0;
      bool cg_has = false;
      for (int j = 15; j >= 0; --j) {
        const int p = cg_i * 16 + j;
        const int ma = w.lv[p];
        const float ldf = __int2float_rn(w.ld[p]);
        const bool active = p <= last_pos;
        const bool is_last = p == last_pos;
        const int sb0 = is_last ? 0 : sig[2 * j];
        const int sb1 = is_last ? 0 : sig[2 * j + 1];
        const int oi = 2 * (ctx_set * 4 + min(c1, 3));
        const int one0 = gt1[oi], one1 = gt1[oi + 1];
        const float j0 = fma32(lam_bits, __int2float_rn(sb0), w.d0[p]);
        const int l_lo = max(ma - 1, 1), l_hi = ma;
        const int r_lo = rate_level(l_lo, one0, one1, abs0, abs1, rice,
                                    c1_idx, c2_idx);
        const int r_hi = rate_level(l_hi, one0, one1, abs0, abs1, rice,
                                    c1_idx, c2_idx);
        const float d_lo = __fsub_rn(ldf, __int2float_rn(shl32(l_lo, q_bits)));
        const float d_hi = __fsub_rn(ldf, __int2float_rn(shl32(l_hi, q_bits)));
        const float j_lo = fma32(__fmul_rn(d_lo, d_lo), es,
                                 __fmul_rn(lam_bits, __int2float_rn(sb1 + r_lo)));
        const float j_hi = fma32(__fmul_rn(d_hi, d_hi), es,
                                 __fmul_rn(lam_bits, __int2float_rn(sb1 + r_hi)));
        const bool has = ma > 0;
        int best_l = 0;
        float best_j = j0;
        if (has && j_lo < best_j) { best_l = l_lo; best_j = j_lo; }
        if (has && l_hi != l_lo && j_hi < best_j) { best_l = l_hi; best_j = j_hi; }
        if (!active) best_l = 0;
        w.lv[p] = best_l;
        w.cc[p] = active ? best_j : 0.0f;
        w.cs[p] = active ? __fmul_rn(lam_bits, __int2float_rn(best_l > 0 ? sb1 : sb0))
                         : 0.0f;
        // context-state evolution
        const bool nz = best_l > 0;
        const bool in_c1 = c1_idx < 8;
        const bool gt1_ = best_l > 1;
        const int c2_n = nz && in_c1 && gt1_ ? 1 : c2_idx;
        const int c1_n = nz && in_c1 && gt1_ ? 0
                         : nz && in_c1 && c1 > 0 && c1 < 3 ? c1 + 1 : c1;
        const int c1i_n = nz && in_c1 ? c1_idx + 1 : c1_idx;
        const int rice_n = nz && best_l > (3 << rice) ? min(rice + 1, 4) : rice;
        c1 = c1_n;
        c1_idx = c1i_n;
        c2_idx = c2_n;
        rice = rice_n;
        cg_has = cg_has || nz;
      }
      // CG zero-out (only 0 < cg_i < last_cg)
      const int q = cg_i * 16;
      float sum_cc = w.cc[q], sum_d0 = w.d0[q];
      for (int i = 1; i < 16; ++i) {
        sum_cc = __fadd_rn(sum_cc, w.cc[q + i]);
        sum_d0 = __fadd_rn(sum_d0, w.d0[q + i]);
      }
      const int ctx = right + below > 0;
      const float j_keep = fma32(lam_bits, __int2float_rn(cg_bits[2 * ctx + 1]),
                                 sum_cc);
      const float j_zero = fma32(lam_bits, __int2float_rn(cg_bits[2 * ctx]),
                                 sum_d0);
      const bool zero_out = cg_i > 0 && cg_i < last_cg && cg_has &&
                            j_zero < j_keep;
      if (zero_out) {
        for (int i = 0; i < 16; ++i) {
          w.lv[q + i] = 0;
          w.cc[q + i] = w.d0[q + i];
          w.cs[q + i] = 0.0f;
        }
      }
      w.cg_sig[cg_rev[s]] = zero_out ? 0 : (int)cg_has;
      prev_c1 = c1;
    }
  }
  __syncwarp();

  // ---- last-position search: tile prefix sums ----
  for (int t = lane; t < NCG; t += 32) {
    float a = w.cc[16 * t], b = w.d0[NN - 1 - 16 * t];
    w.pc[16 * t] = a;
    w.sd[16 * t] = b;
    for (int i = 1; i < 16; ++i) {
      w.pc[16 * t + i] = a = __fadd_rn(a, w.cc[16 * t + i]);
      w.sd[16 * t + i] = b = __fadd_rn(b, w.d0[NN - 1 - 16 * t - i]);
    }
    w.tile_cc[t] = a;
    w.tile_d0[t] = b;
  }
  __syncwarp();
  if (NCG > 1 && lane < 2) {
    // the exclusive prefix of the tile totals (lane 0: costs, 1: d0)
    float* tot = lane == 0 ? w.tile_cc : w.tile_d0;
    float* ex = lane == 0 ? w.excl_cc : w.excl_d0;
    float inc[NCG];
    tile_prefix(tot, inc, NCG);
    ex[0] = 0.0f;
    for (int t = 1; t < NCG; ++t) ex[t] = inc[t - 1];
  }
  __syncwarp();
  const int last_pos = w.last_pos;
  // the inclusive prefix at k of the costs / of d0 read backwards
  auto cum_cc = [&](int k) {
    return NCG > 1 ? __fadd_rn(w.pc[k], w.excl_cc[k >> 4]) : w.pc[k];
  };
  auto cum_d0 = [&](int k) {
    return NCG > 1 ? __fadd_rn(w.sd[k], w.excl_d0[k >> 4]) : w.sd[k];
  };
  float best = __int_as_float(0x7f800000);
  int best_p = -1;
  for (int p = lane; p < NN; p += 32) {
    const float prefix = p == 0 ? 0.0f : cum_cc(p - 1);
    const float suffix = p + 1 == NN ? 0.0f : cum_d0(NN - 2 - p);
    float tot = __fadd_rn(
        __fadd_rn(__fadd_rn(prefix, __fsub_rn(w.cc[p], w.cs[p])),
                  __fmul_rn(lam_bits, rate_last[p])),
        suffix);
    if (!(w.lv[p] > 0)) tot = kInf;
    if (tot <= best) {        // p rises: a tie keeps the higher p
      best = tot;
      best_p = p;
    }
  }
  w.red_f[lane] = best;
  w.red_i[lane] = best_p;
  __syncwarp();
  if (lane == 0) {
    float b = w.red_f[0];
    int bp = w.red_i[0];
    for (int i = 1; i < 32; ++i) {
      const float v = w.red_f[i];
      if (v < b || (v == b && w.red_i[i] > bp)) {
        b = v;
        bp = w.red_i[i];
      }
    }
    float chosen = b;
    int all_zero = 0;
    if (allow_all_zero) {
      const float total_zero = cum_d0(NN - 1);
      all_zero = total_zero < b;
      if (all_zero) chosen = total_zero;
    }
    if (last_pos < 0) chosen = 0.0f;
    w.best_last = bp;
    w.all_zero = all_zero;
    w.chosen = chosen;
  }
  __syncwarp();
  const bool zero_all = last_pos < 0 || w.all_zero;
  const int best_last = w.best_last;

  // ---- the levels back to raster order, signed ----
  for (int p = lane; p < NN; p += 32) {
    const int lvl = zero_all || p > best_last ? 0 : w.lv[p];
    w.lv[p] = lvl;
    if (valid) {
      const int r = scan[p];
      const int c = coeff[base + (r >> LOG2) * s_y + (r & (N - 1)) * s_x];
      out[(long long)blk * NN + r] = lvl * ((c > 0) - (c < 0));
    }
  }
  if (bits_out == nullptr) return;
  __syncwarp();

  // ---- the rate: (chosen total - final distortion) / lambda ----
  float dist_sum = 0.0f;
  if (NN == 16) {
    if (lane == 0) {
      float sq[16];
      for (int i = 0; i < 16; ++i) {
        const float ldf = __int2float_rn(w.ld[i]);
        const float e = __fsub_rn(ldf, __int2float_rn(shl32(w.lv[i], q_bits)));
        sq[i] = w.lv[i] > 0 ? __fmul_rn(e, e) : __fmul_rn(ldf, ldf);
      }
      if (allow_all_zero && w.all_zero) {
        float acc = __fmul_rn(sq[0], es);
        for (int i = 1; i < 16; ++i) acc = fma32(sq[i], es, acc);
        dist_sum = acc;
      } else {
        float v[8];
        for (int i = 0; i < 8; ++i) v[i] = fma32(sq[8 + i], es, __fmul_rn(sq[i], es));
        for (int h = 4; h >= 1; h >>= 1)
          for (int i = 0; i < h; ++i) v[i] = __fadd_rn(v[i], v[i + h]);
        dist_sum = v[0];
      }
    }
  } else {
    // 32-entry chunks left to right, one lane each, then the chunk sums
    if (lane < NN / 32) {
      float acc = 0.0f;
      for (int i = 0; i < 32; ++i) {
        const int p = 32 * lane + i;
        const float ldf = __int2float_rn(w.ld[p]);
        const float e = __fsub_rn(ldf, __int2float_rn(shl32(w.lv[p], q_bits)));
        const float d = w.lv[p] > 0 ? __fmul_rn(__fmul_rn(e, e), es) : w.d0[p];
        acc = i == 0 ? d : __fadd_rn(acc, d);
      }
      w.red_f[lane] = acc;
    }
    __syncwarp();
    if (lane == 0) {
      dist_sum = w.red_f[0];
      for (int i = 1; i < NN / 32; ++i) dist_sum = __fadd_rn(dist_sum, w.red_f[i]);
    }
  }
  if (lane == 0 && valid) {
    const float r = __fmul_rn(__fsub_rn(w.chosen, dist_sum), inv);
    bits_out[blk] = r < 0.0f ? 0.0f : r;
  }
}

template <int LOG2>
int launch(const void* coeff, long long s_b, long long s_y, long long s_x,
           void* out, void* bits, int num_blocks, const void* tab,
           const void* rate_last, int q_bits, int scale, float lam_bits,
           float es, float inv, int is_luma, int allow_all_zero,
           cudaStream_t stream) {
  constexpr int W = Shape<LOG2>::kWarps;
  const int grid = (num_blocks + W - 1) / W;
  rdoq_kernel<LOG2><<<grid, 32 * W, 0, stream>>>(
      (const int*)coeff, s_b, s_y, s_x, (int*)out, (float*)bits, num_blocks,
      (const int*)tab, (const float*)rate_last, q_bits, scale, lam_bits, es,
      inv, is_luma, allow_all_zero);
  return (int)cudaGetLastError();
}

}  // namespace

// coeff: int32 [B, N, N] with element strides (s_b, s_y, s_x); out: int32
// [B, N, N] contiguous; bits: float32 [B] or null (no rate); tab / rate_last:
// the packed int32 rate tables and the float32 last-position rates of
// ops/rdoq_dev._kernel_tables.  Returns the launch's cudaError
// (cudaErrorInvalidValue for a log2 size outside 2..5).
extern "C" int vct_rdoq(const void* coeff, long long s_b, long long s_y,
                        long long s_x, void* out, void* bits, int num_blocks,
                        int log2_size, const void* tab, const void* rate_last,
                        int q_bits, int scale, float lam_bits, float es,
                        float inv, int is_luma, int allow_all_zero,
                        void* stream) {
  if (num_blocks < 0 || q_bits < 1 || q_bits > 30)
    return (int)cudaErrorInvalidValue;
  if (num_blocks == 0) return 0;
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
