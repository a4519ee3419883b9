// The HEVC intra reconstruction wavefronts for Hopper (sm_90a): the
// quadtree IDR's and the flat CTB16 encoder's, one launch per anti-diagonal.
//
// Replaces two of the reference's XLA device loops, which the TPU ran as
// one program each and the port's plain versions run as eager torch ops,
// a few hundred per diagonal:
//   qt_wavefront_kernel    the `lax.fori_loop` over CTB anti-diagonals of
//                          `encode_frame_qt_device`
//                          (video_codecs_tpu/models/hevc/encoder_jax_qt.py:276);
//                          plain version `encode_frame_qt_device_ref` in
//                          video_codecs_tpu_torch/models/hevc/encoder_qt_dev.py;
//   flat_wavefront_kernel  the `lax.fori_loop` over 16x16-block diagonals
//                          of `encode_frame_device`
//                          (video_codecs_tpu/models/hevc/encoder_jax.py:231)
//                          and the one `_intra_wavefront`
//                          (video_codecs_tpu/models/hevc/inter_jax.py:125)
//                          inlines into the P and B pictures; plain
//                          versions `encode_frame_device_ref` in
//                          models/hevc/encoder_dev.py and
//                          `_intra_wavefront_ref` in models/hevc/inter_dev.py.
// Both compute what their plain versions compute, bit for bit: the
// reconstructed planes, the levels and (flat) the coded-block flags.
//
// Why one CTB's whole Z order in one block.  The reference codes, per
// diagonal d = cx + 2 * cy, one micro-step (the 32-CU, then per 16-quadrant
// the 16-CU and its four 8-CUs) of every CTB on d at a time.  CTBs on one
// diagonal never read each other's samples: the left and top-right
// neighbours lie on d - 1, the top on d - 2, the top-left on d - 3, and a
// 32-CU's top reference row reaches 64 samples right, into CTB cx + 1 of
// the row above and no further.  So a block that codes its CTB's CUs in Z
// order gives the reference's planes (tests/test_torch_intra_wavefront.py
// holds that order, as a plain torch loop, to the JAX package).  The flat
// kernel's blocks are 16x16 blocks, one per CTA, on d = bx + 2 * by.
//
// Per coded TB, the CTA (kThreads threads, every loop strided over the
// CTA so that the logic holds for any thread count) does in shared memory:
// gather the 4N+1 reference samples with their availability (Z scan
// against the true picture size for the quadtree, decoding raster order
// with below-left never available for the flat blocks) and substitute the
// unavailable ones (spec 8.4.4.2.2); the [1,2,1] filter where the port's
// `use_filtered_ref` says so; the prediction by the spec's integer
// formulas, which equal the port's float32 product over `_mode_weights`
// (exact on integers) for every mode and size, with the DC, pure-vertical
// and pure-horizontal edge fixups for luma N <= 16; the residual; the two
// stages of the forward DCT (HM's rounding shifts, int32 sums: at most
// 9.4e7); hard quantisation or RDOQ-lite; sign-data hiding per 4x4
// coefficient group in the diagonal or the mode-dependent scan; the
// dequantisation, the two clamped inverse stages and the clamp to 0-255;
// then it writes the recon and the levels.  Tables come from the host in
// one int32 buffer (layout in `Tab` below, built by ops/intra_wavefront.py
// from the port's rom), the RDOQ-lite rates are the port's
// `log_1p_tables()[1]`, and the RDOQ-lite lambdas lam_td are float32
// values the wrapper forms as the plain version does.
//
// Float32 in the plain version's order.  Only RDOQ-lite's and SBH's costs
// are floats.  Every float operation is an explicit round-to-nearest
// intrinsic, which nvcc never contracts into a fused multiply-add, and the
// plain version's `fma32(a, b, c)` (a * b + c in float64, rounded to
// float32) is __dmul_rn / __dadd_rn / __double2float_rn.  SBH's argmin over
// the 32 candidates takes the first minimum, and an excluded candidate
// costs 1e30f, as in `_sbh_fix_cgs`.
//
// What bounds it.  The bytes: the original int32 planes read once, the
// int32 recon and level planes written once (the quadtree 1080p IDR,
// 1920x1088 padded: 12.5 MB in, 25.1 MB out, 11.2 us at 3.35 TB/s); the
// integer operations, about (8N + 30) per sample of an NxN TB, are below
// that at the float32 rate of 67 T/s.  Neither sets the time: a diagonal
// waits for the one before it, and inside a CTA each TB is a chain of
// about a dozen barrier-separated steps, each as long as its slowest
// thread.  The chain floor is the number of diagonals (126 at 1080p, 27
// at 416x240 for the quadtree; 252 for the flat 1080p picture) times the
// serial time of one CTB's CUs; chip_smoke.py prints both bounds beside
// the kernel's time.  This first version keeps each TB's work in one CTA
// and stages nothing across TBs; a persistent single launch, the CTB
// staged in shared memory and tensor-core transforms are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e30f;        // an SBH candidate that is not allowed

// The int32 table buffer: the DCT matrices (N = 4, 8, 16, 32, row-major),
// the scans (scan position -> raster position) for log2 2..5 and scan
// types diagonal / horizontal / vertical, the intra angles and the
// inverse angles (stored positive) per mode, the quantiser's scales.
struct Tab {
  static constexpr int kDct = 0;                     // 1,360 entries
  static constexpr int kScan = 1360;                 // 4,080
  static constexpr int kAngle = kScan + 4080;        // 35
  static constexpr int kInvAngle = kAngle + 35;      // 35
  static constexpr int kQuantScale = kInvAngle + 35; // 6
  static constexpr int kInvQuantScale = kQuantScale + 6;  // 6
  static constexpr int kSize = kInvQuantScale + 6;
};
static_assert(Tab::kSize == 5522, "ops/intra_wavefront.py's TAB_SIZE");

__device__ __forceinline__ int dct_off(int log2) {
  return log2 == 2 ? 0 : log2 == 3 ? 16 : log2 == 4 ? 80 : 336;
}

__device__ __forceinline__ int scan_off(int log2, int type) {
  const int base = log2 == 2 ? 0 : log2 == 3 ? 48 : log2 == 4 ? 240 : 1008;
  return Tab::kScan + base + type * (1 << (2 * log2));
}

__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

// The per-TB quantiser of one plane (luma or chroma QP) at one size.
struct Quant {
  int q_bits, q_scale, q_add;        // forward
  int dq_scale, dq_shift;            // inverse: shift > 0 right, else left
  float lam_td;                      // RDOQ-lite's lambda
};

__device__ __forceinline__ Quant make_quant(const int* tab, int qp, int log2,
                                           float lam_td) {
  Quant q;
  const int per = qp / 6, rem = qp % 6;
  const int tshift = 15 - 8 - log2;              // transform_shift
  q.q_bits = 14 + per + tshift;
  q.q_scale = tab[Tab::kQuantScale + rem];
  q.q_add = 171 << (q.q_bits - 9);               // intra slice
  q.dq_scale = tab[Tab::kInvQuantScale + rem];
  q.dq_shift = 6 - (tshift + per);
  q.lam_td = lam_td;
  return q;
}

// ops/quant.dequantize of one level.
__device__ __forceinline__ int dequant(int level, const Quant& q) {
  const int l = clampi(level, -32768, 32767);
  int c;
  if (q.dq_shift > 0)
    c = (l * q.dq_scale + (1 << (q.dq_shift - 1))) >> q.dq_shift;
  else
    c = (l * q.dq_scale) * (1 << (-q.dq_shift));
  return clampi(c, -32768, 32767);
}

// ops/quant.quantize (intra slice) or rdoq_lite of one coefficient.
__device__ __forceinline__ int quant(int c, const Quant& q, bool lite,
                                     const float* rate) {
  const int mag = c < 0 ? -c : c;
  if (!lite) {
    const int m = (mag * q.q_scale + q.q_add) >> q.q_bits;
    return clampi(sgn(c) * m, -32768, 32767);
  }
  const int l_floor = (mag * q.q_scale) >> q.q_bits;
  const int l0 = clampi(l_floor, 0, 32767);
  const int l1 = clampi(l_floor + 1, 0, 32767);
  const float d0 = __int2float_rn(mag - dequant(l0, q));
  const float d1 = __int2float_rn(mag - dequant(l1, q));
  const float r0 = l0 == 0 ? 0.0f : rate[l0];
  const float r1 = l1 == 0 ? 0.0f : rate[l1];
  const float j0 = fma32(d0, d0, __fmul_rn(q.lam_td, r0));
  const float j1 = fma32(d1, d1, __fmul_rn(q.lam_td, r1));
  return sgn(c) * (j1 < j0 ? l1 : l0);
}

// Shared memory of one CTA: one TB at a time.
struct Smem {
  int ref[129];        // substituted reference samples, 4N+1
  int filt[129];       // the same after the [1,2,1] filter
  unsigned char avail[129];
  int pred[1024];
  int res[1024];       // residual, then the first inverse stage
  int coef[1024];      // the forward transform's coefficients
  int lev[1024];       // levels
  int tmp[1024];       // first forward stage, then the dequantised levels
  int dc;
  int any;             // a level is nonzero
};

// Where a TB lies and how its references are found.
struct Plane {
  const int* orig;     // original plane (H x W, row-major)
  int* rec;            // recon plane, read for references and written
  int ph, pw;          // the planes' dims
  int w, h;            // the true picture dims (Z availability)
  int log2_ctb;        // 0: raster availability (flat), else Z scan
};

// encoder_qt_dev.z_index_dev of the 4x4 block holding (x, y).
__device__ __forceinline__ int z_index(int x, int y, int log2_ctb,
                                       int ctbs_per_row) {
  const int nbits = log2_ctb - 2;
  const int mask = (1 << nbits) - 1;
  const int ix = (x >> 2) & mask, iy = (y >> 2) & mask;
  int m = 0;
  for (int b = 0; b < nbits; ++b)
    m |= (((ix >> b) & 1) << (2 * b)) | (((iy >> b) & 1) << (2 * b + 1));
  const int ctb = (y >> log2_ctb) * ctbs_per_row + (x >> log2_ctb);
  return (ctb << (2 * nbits)) + m;
}

// One TB of size 1 << LOG2 at (x0, y0): predict, code, reconstruct.  lv /
// lv_stride: where its levels go; cbf: its coded-block flag or null;
// keep_pred: recon = prediction where no level is nonzero (the flat
// `_code_blocks`; the same samples either way).  Every thread of the CTA
// calls it with the same arguments.
template <int LOG2>
__device__ void code_tb(Smem& s, const int* tab, const float* rate,
                        const Plane& p, int x0, int y0, int mode,
                        bool is_luma, const Quant& q, bool lite, bool sbh,
                        int scan_type, int* lv, int lv_stride,
                        unsigned char* cbf) {
  constexpr int n = 1 << LOG2;
  constexpr int nn = n * n;
  constexpr int r = 4 * n + 1;
  const int tid = threadIdx.x, nt = blockDim.x;

  // 1. raw reference samples and their availability
  const int cpr = p.log2_ctb ? (p.w + (1 << p.log2_ctb) - 1) >> p.log2_ctb
                             : 0;
  const int zcur = p.log2_ctb ? z_index(x0, y0, p.log2_ctb, cpr) : 0;
  for (int k = tid; k < r; k += nt) {
    int dy, dx;
    if (k < 2 * n) {
      dy = 2 * n - 1 - k;
      dx = -1;
    } else if (k == 2 * n) {
      dy = -1;
      dx = -1;
    } else {
      dy = -1;
      dx = k - 2 * n - 1;
    }
    const int row = y0 + dy, col = x0 + dx;
    const int rc = clampi(row, 0, p.ph - 1), cc = clampi(col, 0, p.pw - 1);
    bool av;
    if (p.log2_ctb) {
      av = row >= 0 && col >= 0 && row < p.h && col < p.w &&
           z_index(cc, rc, p.log2_ctb, cpr) < zcur;
    } else if (k < 2 * n) {
      av = x0 > 0 && k >= n;
    } else if (k == 2 * n) {
      av = x0 > 0 && y0 > 0;
    } else {
      av = y0 > 0 && col < p.pw;
    }
    s.ref[k] = p.rec[rc * p.pw + cc];
    s.avail[k] = av;
  }
  __syncthreads();

  // 2. substitution (one thread walks the 4N+1 samples) and the DC value
  if (tid == 0) {
    int first = -1;
    for (int k = 0; k < r; ++k)
      if (s.avail[k]) {
        first = k;
        break;
      }
    if (first < 0) {
      for (int k = 0; k < r; ++k) s.ref[k] = 128;
    } else {
      int last = s.ref[first];
      for (int k = 0; k < r; ++k) {
        if (s.avail[k]) last = s.ref[k];
        s.ref[k] = last;
      }
    }
    int sum = n;
    for (int i = 0; i < n; ++i) sum += s.ref[2 * n + 1 + i] + s.ref[2 * n - 1 - i];
    s.dc = sum >> (LOG2 + 1);
    s.any = 0;
  }
  __syncthreads();

  // 3. the [1,2,1] filter of the linear array, ends kept
  for (int k = tid; k < r; k += nt)
    s.filt[k] = (k == 0 || k == r - 1)
                    ? s.ref[k]
                    : (s.ref[k - 1] + 2 * s.ref[k] + s.ref[k + 1] + 2) >> 2;
  __syncthreads();

  // 4. prediction and residual
  bool use_filt = false;
  if (is_luma && LOG2 != 2 && mode != 1) {
    const int thresh = LOG2 == 3 ? 7 : (LOG2 == 4 ? 1 : 0);
    const int a26 = mode > 26 ? mode - 26 : 26 - mode;
    const int a10 = mode > 10 ? mode - 10 : 10 - mode;
    use_filt = (a26 < a10 ? a26 : a10) > thresh;
  }
  const int* R = use_filt ? s.filt : s.ref;
  const int angle = tab[Tab::kAngle + mode];
  const int inv = tab[Tab::kInvAngle + mode];
  const bool ver = mode >= 18;
  const bool fix = is_luma && LOG2 <= 4;
  for (int i = tid; i < nn; i += nt) {
    const int y = i >> LOG2, x = i & (n - 1);
    int v;
    if (mode == 0) {
      v = ((n - 1 - x) * R[2 * n - 1 - y] + (x + 1) * R[3 * n + 1] +
           (n - 1 - y) * R[2 * n + 1 + x] + (y + 1) * R[n - 1] + n) >>
          (LOG2 + 1);
    } else if (mode == 1) {
      v = s.dc;
    } else {
      const int a = ver ? y : x, b = ver ? x : y;
      const int pos = (a + 1) * angle;
      const int iidx = pos >> 5, fact = pos & 31;
      int vals[2];
      for (int e = 0; e < 2; ++e) {
        const int t = b + iidx + 1 + e;        // refMain[t]
        int lin;
        if (t == 0) {
          lin = 2 * n;
        } else if (t > 0) {
          const int tt = t < 2 * n ? t : 2 * n;
          lin = ver ? 2 * n + tt : 2 * n - tt;
        } else {
          int si = ((-t) * inv + 128) >> 8;
          si = si < 2 * n ? si : 2 * n;
          lin = si == 0 ? 2 * n : (ver ? 2 * n - si : 2 * n + si);
        }
        vals[e] = R[lin];
      }
      v = fact ? ((32 - fact) * vals[0] + fact * vals[1] + 16) >> 5 : vals[0];
    }
    if (fix) {
      const int corner = s.ref[2 * n];
      const int left0 = s.ref[2 * n - 1], top0 = s.ref[2 * n + 1];
      if (mode == 1) {
        if (y == 0 && x == 0)
          v = (left0 + 2 * s.dc + top0 + 2) >> 2;
        else if (y == 0)
          v = (s.ref[2 * n + 1 + x] + 3 * s.dc + 2) >> 2;
        else if (x == 0)
          v = (s.ref[2 * n - 1 - y] + 3 * s.dc + 2) >> 2;
      } else if (mode == 26 && x == 0) {
        v = clampi(top0 + ((s.ref[2 * n - 1 - y] - corner) >> 1), 0, 255);
      } else if (mode == 10 && y == 0) {
        v = clampi(left0 + ((s.ref[2 * n + 1 + x] - corner) >> 1), 0, 255);
      }
    }
    v = clampi(v, 0, 255);
    s.pred[i] = v;
    s.res[i] = p.orig[(y0 + y) * p.pw + x0 + x] - v;
  }
  __syncthreads();

  // 5. forward transform: tmp[k][j] = rows' transform, then columns'
  const int* T = tab + Tab::kDct + dct_off(LOG2);
  {
    constexpr int s1 = LOG2 - 1, s2 = LOG2 + 6;
    for (int i = tid; i < nn; i += nt) {
      const int k = i >> LOG2, j = i & (n - 1);
      int acc = 0;
      for (int m = 0; m < n; ++m) acc += T[k * n + m] * s.res[j * n + m];
      s.tmp[i] = (acc + (1 << (s1 - 1))) >> s1;
    }
    __syncthreads();
    for (int i = tid; i < nn; i += nt) {
      const int k = i >> LOG2, j = i & (n - 1);
      int acc = 0;
      for (int m = 0; m < n; ++m) acc += T[k * n + m] * s.tmp[j * n + m];
      s.coef[i] = (acc + (1 << (s2 - 1))) >> s2;
    }
    __syncthreads();
  }

  // 6. quantisation
  for (int i = tid; i < nn; i += nt) s.lev[i] = quant(s.coef[i], q, lite, rate);
  __syncthreads();

  // 7. sign-data hiding, one thread per 4x4 group in scan order
  if (sbh) {
    const int* scan = tab + scan_off(LOG2, scan_type);
    for (int g = tid; g < nn / 16; g += nt) {
      const int* sc = scan + 16 * g;
      int c[16], o[16];
      int first = 16, last = -1, sum_abs = 0;
      for (int i = 0; i < 16; ++i) {
        c[i] = s.lev[sc[i]];
        o[i] = s.coef[sc[i]];
        if (c[i] != 0) {
          if (first == 16) first = i;
          last = i;
        }
        sum_abs += c[i] < 0 ? -c[i] : c[i];
      }
      const bool hidden = (last - first) >= 4;
      const bool neg = c[first < 15 ? first : 15] < 0;
      if (hidden && ((sum_abs & 1) != (neg ? 1 : 0))) {
        float best = 0.0f;
        int best_k = -1;
        for (int k = 0; k < 32; ++k) {
          const int i = k & 15;
          const int lmag = c[i] < 0 ? -c[i] : c[i];
          const float cmag = __int2float_rn(o[i] < 0 ? -o[i] : o[i]);
          const float e0 = __fsub_rn(cmag, __int2float_rn(dequant(lmag, q)));
          const float err0 = __fmul_rn(e0, e0);
          float cand;
          if (k < 16) {
            const float e = __fsub_rn(cmag, __int2float_rn(dequant(lmag + 1, q)));
            cand = (i >= first && i <= last) ? fma32(e, e, -err0) : kBig;
          } else {
            const float e = __fsub_rn(
                cmag, __int2float_rn(dequant(lmag - 1 > 0 ? lmag - 1 : 0, q)));
            const bool dec_ok = lmag >= 2 || (lmag == 1 && i > first && i < last);
            cand = dec_ok ? fma32(e, e, -err0) : kBig;
          }
          if (best_k < 0 || cand < best) {
            best = cand;
            best_k = k;
          }
        }
        const bool is_dec = best_k >= 16;
        const int bpos = best_k & 15;
        const int cur = c[bpos];
        const int step = is_dec ? -1 : 1;
        const int newval = cur != 0 ? cur + step * sgn(cur)
                                    : step * (o[bpos] < 0 ? -1 : 1);
        s.lev[sc[bpos]] = newval;
      }
    }
    __syncthreads();
  }

  // 8. the levels out, the coded-block flag, the dequantised levels
  for (int i = tid; i < nn; i += nt) {
    const int l = s.lev[i];
    lv[(i >> LOG2) * lv_stride + (i & (n - 1))] = l;
    if (l != 0) s.any = 1;
    s.tmp[i] = dequant(l, q);
  }
  __syncthreads();
  if (cbf != nullptr && tid == 0) *cbf = s.any ? 1 : 0;

  // 9. inverse transform: columns, clamp, rows, clamp; recon
  for (int i = tid; i < nn; i += nt) {
    const int k = i >> LOG2, j = i & (n - 1);   // spatial row k, freq j
    int acc = 0;
    for (int m = 0; m < n; ++m) acc += T[m * n + k] * s.tmp[m * n + j];
    s.res[i] = clampi((acc + 64) >> 7, -32768, 32767);
  }
  __syncthreads();
  const bool keep_pred = cbf != nullptr && !s.any;
  for (int i = tid; i < nn; i += nt) {
    const int row = i >> LOG2, col = i & (n - 1);
    int acc = 0;
    for (int m = 0; m < n; ++m) acc += T[m * n + col] * s.res[row * n + m];
    const int rv = clampi((acc + 2048) >> 12, -32768, 32767);
    const int v = keep_pred ? s.pred[i] : clampi(s.pred[i] + rv, 0, 255);
    p.rec[(y0 + row) * p.pw + x0 + col] = v;
  }
  __syncthreads();
}

// _scan_type_dev: the mode-dependent scan of luma TB8 and chroma TB4.
__device__ __forceinline__ int mode_scan(int mode) {
  if (mode >= 6 && mode <= 14) return 2;     // vertical
  if (mode >= 22 && mode <= 30) return 1;    // horizontal
  return 0;
}

struct QtArgs {
  const int *y, *u, *v;              // padded originals
  const int *depth8, *m8, *m16, *m32;
  int *rec_y, *rec_u, *rec_v, *coef_y, *coef_u, *coef_v;
  int ph, pw, w, h;                  // padded and true luma dims
  int qp, qp_c, sbh, lite;
  const int* tab;
  const float* rate;
  const float* lam_td;               // [luma, chroma][log2 - 2]
};

// One CU of size 1 << LOG2 at (x, y) if the decided tree holds it there.
template <int LOG2>
__device__ void code_cu(Smem& s, const QtArgs& a, int x, int y, int want) {
  if (x >= a.w || y >= a.h) return;
  const int pw8 = a.pw >> 3;
  const int yy = y < a.ph - 1 ? y : a.ph - 1, xx = x < a.pw - 1 ? x : a.pw - 1;
  if (a.depth8[(yy >> 3) * pw8 + (xx >> 3)] != want) return;
  const int* map = LOG2 == 5 ? a.m32 : (LOG2 == 4 ? a.m16 : a.m8);
  const int mode = map[(y >> LOG2) * (a.pw >> LOG2) + (x >> LOG2)];
  const bool lite = a.lite != 0, sbh = a.sbh != 0;

  const Plane pl{a.y, a.rec_y, a.ph, a.pw, a.w, a.h, 5};
  const Quant ql = make_quant(a.tab, a.qp, LOG2, a.lam_td[LOG2 - 2]);
  code_tb<LOG2>(s, a.tab, a.rate, pl, x, y, mode, true, ql, lite, sbh,
                LOG2 == 3 ? mode_scan(mode) : 0,
                a.coef_y + y * a.pw + x, a.pw, nullptr);

  constexpr int CL = LOG2 - 1 > 2 ? LOG2 - 1 : 2;
  const int cph = a.ph / 2, cpw = a.pw / 2;
  const Quant qc = make_quant(a.tab, a.qp_c, CL, a.lam_td[4 + CL - 2]);
  const int cx = x / 2, cy = y / 2;
  const int cscan = CL == 2 ? mode_scan(mode) : 0;
  const Plane pu{a.u, a.rec_u, cph, cpw, a.w / 2, a.h / 2, 4};
  code_tb<CL>(s, a.tab, a.rate, pu, cx, cy, mode, false, qc, lite, sbh, cscan,
              a.coef_u + cy * cpw + cx, cpw, nullptr);
  const Plane pv{a.v, a.rec_v, cph, cpw, a.w / 2, a.h / 2, 4};
  code_tb<CL>(s, a.tab, a.rate, pv, cx, cy, mode, false, qc, lite, sbh, cscan,
              a.coef_v + cy * cpw + cx, cpw, nullptr);
}

// One CTA per CTB (cx, cy) of diagonal d = cx + 2 * cy, cy = cy_lo + block.
__global__ void __launch_bounds__(kThreads)
    qt_wavefront_kernel(QtArgs a, int d, int cy_lo) {
  __shared__ Smem s;
  const int cy = cy_lo + blockIdx.x, cx = d - 2 * cy;
  const int x0 = cx * 32, y0 = cy * 32;
  code_cu<5>(s, a, x0, y0, 0);
  for (int qd = 0; qd < 4; ++qd) {
    const int qx = x0 + (qd & 1) * 16, qy = y0 + (qd >> 1) * 16;
    code_cu<4>(s, a, qx, qy, 1);
    for (int sb = 0; sb < 4; ++sb)
      code_cu<3>(s, a, qx + (sb & 1) * 8, qy + (sb >> 1) * 8, 2);
  }
}

struct FlatArgs {
  const int *y, *u, *v;              // originals [T, H, W] / [T, H/2, W/2]
  const int* modes;                  // [T, bh, bw]
  const unsigned char* intra;        // [bh, bw] or null: code every block
  int *rec_y, *rec_u, *rec_v;        // recon planes, coded in place
  int *lv_y, *lv_u, *lv_v;           // levels: blocks [B, N, N] or planes
  int lv_planes;                     // 1: levels at their place in planes
  unsigned char *cbf_y, *cbf_u, *cbf_v;   // [B]
  int H, W, Hc, Wc, bw, bh;
  int qp, qp_c, sbh, lite;
  const int* tab;
  const float* rate;
  const float* lam_td;
};

// One CTA per 16x16 block (bx, by) of diagonal d = bx + 2 * by of tile
// blockIdx.y, by = by_lo + blockIdx.x.
__global__ void __launch_bounds__(kThreads)
    flat_wavefront_kernel(FlatArgs a, int d, int by_lo) {
  __shared__ Smem s;
  const int by = by_lo + blockIdx.x, bx = d - 2 * by, t = blockIdx.y;
  if (a.intra != nullptr && !a.intra[by * a.bw + bx]) return;
  const int bidx = t * a.bw * a.bh + by * a.bw + bx;
  const int mode = a.modes[bidx];
  const bool lite = a.lite != 0, sbh = a.sbh != 0;
  const long long lo = (long long)t * a.H * a.W;
  const long long co = (long long)t * a.Hc * a.Wc;
  const int x0 = bx * 16, y0 = by * 16, cx = bx * 8, cy = by * 8;

  const Plane pl{a.y + lo, a.rec_y + lo, a.H, a.W, a.W, a.H, 0};
  const Quant ql = make_quant(a.tab, a.qp, 4, a.lam_td[2]);
  int* lvy = a.lv_planes ? a.lv_y + lo + y0 * a.W + x0 : a.lv_y + bidx * 256;
  code_tb<4>(s, a.tab, a.rate, pl, x0, y0, mode, true, ql, lite, sbh, 0, lvy,
             a.lv_planes ? a.W : 16, a.cbf_y + bidx);

  const Quant qc = make_quant(a.tab, a.qp_c, 3, a.lam_td[4 + 1]);
  const Plane pu{a.u + co, a.rec_u + co, a.Hc, a.Wc, a.Wc, a.Hc, 0};
  int* lvu = a.lv_planes ? a.lv_u + co + cy * a.Wc + cx : a.lv_u + bidx * 64;
  code_tb<3>(s, a.tab, a.rate, pu, cx, cy, mode, false, qc, lite, sbh, 0, lvu,
             a.lv_planes ? a.Wc : 8, a.cbf_u + bidx);
  const Plane pv{a.v + co, a.rec_v + co, a.Hc, a.Wc, a.Wc, a.Hc, 0};
  int* lvv = a.lv_planes ? a.lv_v + co + cy * a.Wc + cx : a.lv_v + bidx * 64;
  code_tb<3>(s, a.tab, a.rate, pv, cx, cy, mode, false, qc, lite, sbh, 0, lvv,
             a.lv_planes ? a.Wc : 8, a.cbf_v + bidx);
}

// The rows [lo, hi] of a bw x bh block grid on diagonal d = x + 2 * y.
void diag_rows(int d, int bw, int bh, int* lo, int* hi) {
  const int a = d - (bw - 1);
  *lo = a > 0 ? (a + 1) / 2 : 0;
  *hi = d / 2 < bh - 1 ? d / 2 : bh - 1;
}

}  // namespace

// The quadtree wavefront over diagonals [d_begin, d_end) of the padded
// picture's CTB grid, one launch each on `stream`; returns the first
// launch's error (cudaGetLastError), 0 when all were taken.
extern "C" int vct_intra_qt_wavefront(
    const void* y, const void* u, const void* v, const void* depth8,
    const void* m8, const void* m16, const void* m32, void* rec_y,
    void* rec_u, void* rec_v, void* coef_y, void* coef_u, void* coef_v,
    int ph, int pw, int w, int h, int qp, int qp_c, int sbh, int lite,
    const void* tab, const void* rate, const void* lam_td, int d_begin,
    int d_end, void* stream) {
  if (ph <= 0 || pw <= 0 || ph % 32 || pw % 32 || w <= 0 || h <= 0 ||
      w > pw || h > ph || qp < 0 || qp > 51 || qp_c < 0 || qp_c > 51)
    return (int)cudaErrorInvalidValue;
  const int cw = pw / 32, ch = ph / 32;
  const int steps = cw + 2 * (ch - 1);
  if (d_begin < 0 || d_end > steps || d_begin > d_end)
    return (int)cudaErrorInvalidValue;
  QtArgs a{(const int*)y, (const int*)u, (const int*)v,
           (const int*)depth8, (const int*)m8, (const int*)m16,
           (const int*)m32, (int*)rec_y, (int*)rec_u, (int*)rec_v,
           (int*)coef_y, (int*)coef_u, (int*)coef_v, ph, pw, w, h, qp,
           qp_c, sbh, lite, (const int*)tab, (const float*)rate,
           (const float*)lam_td};
  const cudaStream_t st = (cudaStream_t)stream;
  for (int d = d_begin; d < d_end; ++d) {
    int lo, hi;
    diag_rows(d, cw, ch, &lo, &hi);
    qt_wavefront_kernel<<<hi - lo + 1, kThreads, 0, st>>>(a, d, lo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The flat wavefront over diagonals [d_begin, d_end) of nt stacked bw x bh
// block grids, one launch each on `stream`, skipping a diagonal whose
// entry in the host array diag_on (null: none skipped) is 0.
extern "C" int vct_intra_flat_wavefront(
    const void* y, const void* u, const void* v, const void* modes,
    const void* intra, void* rec_y, void* rec_u, void* rec_v, void* lv_y,
    void* lv_u, void* lv_v, int lv_planes, void* cbf_y, void* cbf_u,
    void* cbf_v, int nt, int H, int W, int Hc, int Wc, int bw, int bh,
    int qp, int qp_c, int sbh, int lite, const void* tab, const void* rate,
    const void* lam_td, const unsigned char* diag_on, int d_begin,
    int d_end, void* stream) {
  if (nt <= 0 || bw <= 0 || bh <= 0 || bw * 16 > W || bh * 16 > H ||
      bw * 8 > Wc || bh * 8 > Hc || qp < 0 || qp > 51 || qp_c < 0 ||
      qp_c > 51 || nt > 65535)
    return (int)cudaErrorInvalidValue;
  const int steps = bw + 2 * (bh - 1);
  if (d_begin < 0 || d_end > steps || d_begin > d_end)
    return (int)cudaErrorInvalidValue;
  FlatArgs a{(const int*)y, (const int*)u, (const int*)v,
             (const int*)modes, (const unsigned char*)intra, (int*)rec_y,
             (int*)rec_u, (int*)rec_v, (int*)lv_y, (int*)lv_u, (int*)lv_v,
             lv_planes, (unsigned char*)cbf_y, (unsigned char*)cbf_u,
             (unsigned char*)cbf_v, H, W, Hc, Wc, bw, bh, qp, qp_c, sbh,
             lite, (const int*)tab, (const float*)rate,
             (const float*)lam_td};
  const cudaStream_t st = (cudaStream_t)stream;
  for (int d = d_begin; d < d_end; ++d) {
    if (diag_on != nullptr && !diag_on[d]) continue;
    int lo, hi;
    diag_rows(d, bw, bh, &lo, &hi);
    flat_wavefront_kernel<<<dim3(hi - lo + 1, nt), kThreads, 0, st>>>(a, d,
                                                                       lo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
