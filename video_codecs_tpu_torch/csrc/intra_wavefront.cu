// The HEVC intra reconstruction wavefronts for Hopper (sm_90a): the
// quadtree IDR's and the flat CTB16 encoder's, one persistent launch each.
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
// The unit and its order.  A unit is one CTB32 (quadtree) or one 16x16
// block of one tile column (flat).  The reference codes, per diagonal
// d = x + 2 * y, one micro-step of every unit on d at a time; units on one
// diagonal never read each other's samples: the left and top-right
// neighbours lie on d - 1, the top on d - 2, the top-left on d - 3, and a
// 32-CU's top reference row reaches 64 samples right, into the top-right
// neighbour and no further.  So coding each unit alone, its CUs in Z
// order, once those four neighbours are done gives the reference's planes
// (tests/test_torch_intra_wavefront.py holds that order, as a plain torch
// loop, to the JAX package).
//
// What bounds it.  The bytes: the original int32 planes read once, the
// int32 recon and level planes written once (the quadtree 1080p IDR,
// 1920x1088 padded: 12.5 MB in, 25.1 MB out, 11.2 us at 3.35 TB/s); the
// integer operations, about (8N + 30) per sample of an NxN TB, are below
// that at the float32 rate of 67 T/s.  Neither sets the time: the time is
// the critical path, the number of diagonals (126 for the 1080p quadtree,
// 252 for the flat 1080p picture) times one unit's serial latency, and
// inside a unit each TB is a chain of barrier-separated steps.
//
// The design against that chain:
//   - one persistent launch per call: the grid is the resident capacity
//     (SMs x cudaOccupancyMaxActiveBlocksPerMultiprocessor, at most the
//     number of units); each CTA takes units from an atomic ticket counter
//     in wavefront order (diagonal, then tile, then row), waits with
//     acquire loads on the done flags of the unit's left, top-left, top
//     and top-right neighbours, and publishes its own flag with an atomic
//     exchange after its writes and a __threadfence.  Tickets come in
//     dependency order, so every awaited unit is held by a CTA that is
//     already running: progress needs no cooperative launch.  The counter
//     and the flags are a zeroed int32 scratch tensor from the wrapper.
//     A flat unit that the P/B intra map leaves out publishes its flag at
//     once (its inter recon is already in the planes), so the map is read
//     on the card and the host never reads it back;
//   - the unit staged in shared memory: its originals arrive by cp.async
//     while warp 0 waits on the flags; the neighbours' reference samples
//     (the top row out to 2U + 1 from the top-left, the left column) are
//     read once from L2 (ld.global.cg); the unit's recon and levels stay
//     in shared memory, every TB gathers its references there, and they
//     go out once, coalesced, before the flag;
//   - luma, Cb and Cr as three concurrent chains: the decided modes fix
//     everything that couples the planes, so each plane's TBs run on
//     their own warps with a named barrier (barrier.sync id, n) of that
//     group; the groups meet only at the unit's start and at its flag.  A
//     TB of at most 64 samples runs on the group's first warp alone with
//     __syncwarp.  Warps per group: kQtLumaWarps etc. below;
//   - shorter steps: the reference substitution (spec 8.4.4.2.2) on one
//     warp, the first available sample by ballot and __ffs and the
//     hold-last fill by a max-scan of the last available index over
//     shuffles, the DC sum a warp reduction; the forward and inverse DCT
//     stages split each product into its even and odd halves (the first
//     level of HM's partial butterflies: a thread makes an even/odd
//     output pair from one pass over its input row, half the
//     multiply-adds of the plain product, int32 sums of at most 9.4e7, so
//     exact); quantisation and dequantisation fused into the second
//     forward stage; sign-data hiding with the 32 candidates of a 4x4
//     group spread over 16 lanes (two per lane) and a lexicographic
//     (cost, index) minimum over shuffles, which is `_sbh_fix_cgs`' first
//     minimum, 1e30f marking an excluded candidate.  The FP64 tensor-core
//     (DMMA) transform was not tried.
// Per TB: the reference step, prediction and residual, the two forward
// stages, sign-data hiding, the two inverse stages and the recon: six or
// seven group barriers, against a dozen CTA barriers in the
// one-launch-per-diagonal version this replaced.
//
// Exactness.  Prediction by the spec's integer formulas (equal to the
// port's float32 product over `_mode_weights`), with the DC,
// pure-vertical and pure-horizontal edge fixups for luma N <= 16; HM's
// rounding shifts in the transforms; only RDOQ-lite's and SBH's costs are
// floats, every float operation an explicit round-to-nearest intrinsic
// (nvcc never contracts those into a fused multiply-add), the plain
// version's `fma32(a, b, c)` as __dmul_rn / __dadd_rn / __double2float_rn;
// the rates are the port's `log_1p_tables()[1]` and the lambdas lam_td the
// float32 values the wrapper forms as the plain version does.  Tables come
// from the host in one int32 buffer (layout in `Tab`, built by
// ops/intra_wavefront.py from the port's rom), staged in shared memory.

#include <cuda_runtime.h>

namespace {

// Warps of each plane's chain per CTA: luma, and each chroma plane.  At
// 1080p on an H100 (chip_smoke.py's shapes) the quadtree kernel took
// 1.95 ms with 16 + 2 + 2 warps, 1.99 with 8 + 4 + 4, 2.50 with 8 + 2 + 2
// and 3.78 with 2 + 1 + 1; the flat one 1.45 ms with 8 + 1 + 1, 1.50 with
// 16 + 1 + 1, 1.54 with 4 + 1 + 1.  The faster splits hold one CTA per SM:
// a CTA on the critical path then shares its SM with no other.
constexpr int kQtLumaWarps = 16, kQtChromaWarps = 2;
constexpr int kFlatLumaWarps = 8, kFlatChromaWarps = 1;

constexpr int kQtLuma = 32 * kQtLumaWarps;
constexpr int kQtChroma = 32 * kQtChromaWarps;
constexpr int kQtThreads = kQtLuma + 2 * kQtChroma;
constexpr int kFlatLuma = 32 * kFlatLumaWarps;
constexpr int kFlatChroma = 32 * kFlatChromaWarps;
constexpr int kFlatThreads = kFlatLuma + 2 * kFlatChroma;
constexpr float kBig = 1e30f;        // an SBH candidate that is not allowed
constexpr unsigned kFull = 0xffffffffu;

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

// ---- the PTX this file uses ----
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The named barrier of a warp group.  Not the .aligned form (bar.sync):
// a warp may reach it with its lanes apart (after lane-dependent code the
// compiler, seeing only this asm, does not reconverge), which .aligned
// leaves undefined; barrier.sync counts each thread.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("barrier.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}
// ---- end of the PTX ----

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
  const float r0 = l0 == 0 ? 0.0f : __ldg(rate + l0);
  const float r1 = l1 == 0 ? 0.0f : __ldg(rate + l1);
  const float j0 = fma32(d0, d0, __fmul_rn(q.lam_td, r0));
  const float j1 = fma32(d1, d1, __fmul_rn(q.lam_td, r1));
  return sgn(c) * (j1 < j0 ? l1 : l0);
}

// The threads that run one plane's chain, and their barrier: a named
// barrier of the group, or __syncwarp where the group is one warp.
struct Group {
  int tid, nt, bar;
  __device__ __forceinline__ void sync() const {
    if (bar)
      named_sync(bar, nt);
    else
      __syncwarp();
  }
};

// One plane's chain: the TB being coded.  S = NMAX + 1 strides keep a
// warp's column reads on distinct banks.
template <int NMAX>
struct Chain {
  int ref[4 * NMAX + 1];             // substituted reference samples
  int filt[4 * NMAX + 1];            // the same after the [1,2,1] filter
  int res[NMAX * (NMAX + 1)];        // residual, then the dequantised levels
  int tmp[NMAX * (NMAX + 1)];        // first forward, then first inverse stage
  int coef[NMAX * (NMAX + 1)];       // coefficients (SBH reads them)
  int dc;
  int any;                           // a level of the TB is nonzero
};

// One plane of the unit (U x U samples) in shared memory: the recon with
// the top reference row (2U + 1 samples from the top-left) and the left
// column, the originals and the levels.
template <int U>
struct Tile {
  static constexpr int kRs = 2 * U + 1;
  int rec[(U + 1) * kRs];
  int org[U * U];
  int lev[U * U];
};

// Where a TB lies and how its references are found.
struct Plane {
  int* rec;            // the unit's recon tile, origin (uy - 1, ux - 1)
  const int* org;      // its originals, origin (uy, ux)
  int* lev;            // its levels, origin (uy, ux)
  int u, rs;           // unit size in this plane, recon tile stride
  int ux, uy;          // the unit's origin in the plane
  int pw, w, h;        // the plane's width; the true picture dims
  int log2_ctb;        // 0: raster availability (flat), else Z scan
  __device__ __forceinline__ int& r(int row, int col) const {
    return rec[(row - uy + 1) * rs + col - ux + 1];
  }
  __device__ __forceinline__ int& l(int row, int col) const {
    return lev[(row - uy) * u + col - ux];
  }
  __device__ __forceinline__ int o(int row, int col) const {
    return org[(row - uy) * u + col - ux];
  }
};

template <int U>
__device__ __forceinline__ Plane make_plane(Tile<U>& t, int ux, int uy,
                                            int pw, int w, int h,
                                            int log2_ctb) {
  return Plane{t.rec, t.org, t.lev, U, Tile<U>::kRs, ux, uy, pw, w, h,
               log2_ctb};
}

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

// One TB of size 1 << LOG2 at (x0, y0) of the plane: predict, code,
// reconstruct into the recon tile, levels into the level tile.  Every
// thread of the group calls it with the same arguments.
template <int LOG2, int NMAX>
__device__ void code_tb(const Group& g, Chain<NMAX>& c, const int* tab,
                        const float* rate, const Plane& p, int x0, int y0,
                        int mode, bool is_luma, const Quant& q, bool lite,
                        bool sbh, int scan_type) {
  constexpr int n = 1 << LOG2, nn = n * n, r = 4 * n + 1, S = NMAX + 1;
  constexpr int kChunks = (r + 31) / 32;
  static_assert(n <= NMAX, "TB larger than its chain");
  bool use_filt = false;
  if (is_luma && LOG2 != 2 && mode != 1) {
    const int thresh = LOG2 == 3 ? 7 : (LOG2 == 4 ? 1 : 0);
    const int a26 = mode > 26 ? mode - 26 : 26 - mode;
    const int a10 = mode > 10 ? mode - 10 : 10 - mode;
    use_filt = (a26 < a10 ? a26 : a10) > thresh;
  }

  // 1. the group's first warp: the 4N+1 reference samples with their
  // availability (Z scan against the true picture size for the quadtree,
  // decoding raster order with below-left never available for the flat
  // blocks) from the recon tile, the substitution, the DC value, the
  // [1,2,1] filter.
  if (g.tid < 32) {
    const int lane = g.tid;
    const int cpr = p.log2_ctb ? (p.w + (1 << p.log2_ctb) - 1) >> p.log2_ctb
                               : 0;
    const int zcur = p.log2_ctb ? z_index(x0, y0, p.log2_ctb, cpr) : 0;
    int first = -1, carry = -1;
    int last[kChunks];
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int k = ch * 32 + lane;
      bool av = false;
      if (k < r) {
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
        if (p.log2_ctb) {
          av = row >= 0 && col >= 0 && row < p.h && col < p.w &&
               z_index(col, row, p.log2_ctb, cpr) < zcur;
        } else if (k < 2 * n) {
          av = x0 > 0 && k >= n;
        } else if (k == 2 * n) {
          av = x0 > 0 && y0 > 0;
        } else {
          av = y0 > 0 && col < p.pw;
        }
        c.ref[k] = av ? p.r(row, col) : 0;
      }
      const unsigned b = __ballot_sync(kFull, av);
      if (first < 0 && b != 0) first = ch * 32 + __ffs(b) - 1;
      int idx = av ? k : -1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, idx, o);
        if (lane >= o && t > idx) idx = t;
      }
      if (carry > idx) idx = carry;
      carry = __shfl_sync(kFull, idx, 31);
      last[ch] = idx;
    }
    __syncwarp();
    // Every read below is of an available sample, which keeps its value.
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int k = ch * 32 + lane;
      if (k < r) {
        const int src = last[ch] >= 0 ? last[ch] : first;
        c.ref[k] = first < 0 ? 128 : c.ref[src];
      }
    }
    __syncwarp();
    int sum = 0;
    for (int i = lane; i < n; i += 32)
      sum += c.ref[2 * n + 1 + i] + c.ref[2 * n - 1 - i];
    sum = __reduce_add_sync(kFull, sum);
    if (use_filt)
      for (int k = lane; k < r; k += 32)
        c.filt[k] = (k == 0 || k == r - 1)
                        ? c.ref[k]
                        : (c.ref[k - 1] + 2 * c.ref[k] + c.ref[k + 1] + 2) >> 2;
    if (lane == 0) {
      c.dc = (sum + n) >> (LOG2 + 1);
      c.any = 0;
    }
  }
  g.sync();

  // 2. prediction (into the recon tile) and residual
  const int* R = use_filt ? c.filt : c.ref;
  const int angle = tab[Tab::kAngle + mode];
  const int inv = tab[Tab::kInvAngle + mode];
  const bool ver = mode >= 18;
  const bool fix = is_luma && LOG2 <= 4;
  for (int i = g.tid; i < nn; i += g.nt) {
    const int y = i >> LOG2, x = i & (n - 1);
    int v;
    if (mode == 0) {
      v = ((n - 1 - x) * R[2 * n - 1 - y] + (x + 1) * R[3 * n + 1] +
           (n - 1 - y) * R[2 * n + 1 + x] + (y + 1) * R[n - 1] + n) >>
          (LOG2 + 1);
    } else if (mode == 1) {
      v = c.dc;
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
      const int corner = c.ref[2 * n];
      const int left0 = c.ref[2 * n - 1], top0 = c.ref[2 * n + 1];
      if (mode == 1) {
        if (y == 0 && x == 0)
          v = (left0 + 2 * c.dc + top0 + 2) >> 2;
        else if (y == 0)
          v = (c.ref[2 * n + 1 + x] + 3 * c.dc + 2) >> 2;
        else if (x == 0)
          v = (c.ref[2 * n - 1 - y] + 3 * c.dc + 2) >> 2;
      } else if (mode == 26 && x == 0) {
        v = clampi(top0 + ((c.ref[2 * n - 1 - y] - corner) >> 1), 0, 255);
      } else if (mode == 10 && y == 0) {
        v = clampi(left0 + ((c.ref[2 * n + 1 + x] - corner) >> 1), 0, 255);
      }
    }
    v = clampi(v, 0, 255);
    p.r(y0 + y, x0 + x) = v;
    c.res[y * S + x] = p.o(y0 + y, x0 + x) - v;
  }
  g.sync();

  // 3. forward transform, rows: tmp[k][j] = sum_m T[k][m] res[j][m], the
  // even row k from res[j][m] + res[j][n-1-m], the odd row k + 1 from the
  // difference (T[k][n-1-m] = (-1)^k T[k][m]).
  const int* T = tab + Tab::kDct + dct_off(LOG2);
  constexpr int s1 = LOG2 - 1, s2 = LOG2 + 6;
  for (int it = g.tid; it < nn / 2; it += g.nt) {
    const int j = it & (n - 1), k = (it >> LOG2) * 2;
    const int* xr = c.res + j * S;
    int ev = 0, od = 0;
#pragma unroll
    for (int m = 0; m < n / 2; ++m) {
      const int a = xr[m], b = xr[n - 1 - m];
      ev += T[k * n + m] * (a + b);
      od += T[(k + 1) * n + m] * (a - b);
    }
    c.tmp[k * S + j] = (ev + (1 << (s1 - 1))) >> s1;
    c.tmp[(k + 1) * S + j] = (od + (1 << (s1 - 1))) >> s1;
  }
  g.sync();

  // 4. columns, then quantisation and the dequantised levels (into res)
  bool nz = false;
  for (int it = g.tid; it < nn / 2; it += g.nt) {
    const int j = it & (n - 1), k = (it >> LOG2) * 2;
    const int* xr = c.tmp + j * S;
    int ev = 0, od = 0;
#pragma unroll
    for (int m = 0; m < n / 2; ++m) {
      const int a = xr[m], b = xr[n - 1 - m];
      ev += T[k * n + m] * (a + b);
      od += T[(k + 1) * n + m] * (a - b);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cf = ((e ? od : ev) + (1 << (s2 - 1))) >> s2;
      const int l = quant(cf, q, lite, rate);
      c.coef[(k + e) * S + j] = cf;
      p.l(y0 + k + e, x0 + j) = l;
      c.res[(k + e) * S + j] = dequant(l, q);
      nz |= l != 0;
    }
  }
  if (nz) c.any = 1;
  g.sync();

  // 5. sign-data hiding per 4x4 group in scan order: a group on 16 lanes,
  // lane i holds position i and its two candidates (k = i: +1, k = 16 + i:
  // -1); the first minimum over k as the lexicographic (cost, k) minimum.
  if (sbh) {
    const int* scan = tab + scan_off(LOG2, scan_type);
    const int lane = g.tid & 31, half = lane >> 4, i = lane & 15;
    for (int cg0 = (g.tid >> 5) * 2; cg0 < nn / 16; cg0 += 2 * (g.nt >> 5)) {
      const int cg = cg0 + half;
      const bool valid = cg < nn / 16;
      const int pos = valid ? scan[16 * cg + i] : 0;
      const int prow = pos >> LOG2, pcol = pos & (n - 1);
      const int cv = valid ? p.l(y0 + prow, x0 + pcol) : 0;
      const int ov = valid ? c.coef[prow * S + pcol] : 0;
      const unsigned hb =
          (__ballot_sync(kFull, cv != 0) >> (16 * half)) & 0xffffu;
      const int first = hb ? __ffs(hb) - 1 : 16;
      const int last = hb ? 31 - __clz(hb) : -1;
      int sum_abs = cv < 0 ? -cv : cv;
#pragma unroll
      for (int o = 8; o; o >>= 1) sum_abs += __shfl_xor_sync(kFull, sum_abs, o);
      const int cfirst =
          __shfl_sync(kFull, cv, 16 * half + (first < 15 ? first : 15));
      const bool fix_cg = valid && (last - first) >= 4 &&
                          ((sum_abs & 1) != (cfirst < 0 ? 1 : 0));
      const int lmag = cv < 0 ? -cv : cv;
      const float cmag = __int2float_rn(ov < 0 ? -ov : ov);
      const float e0 = __fsub_rn(cmag, __int2float_rn(dequant(lmag, q)));
      const float err0 = __fmul_rn(e0, e0);
      const float ei = __fsub_rn(cmag, __int2float_rn(dequant(lmag + 1, q)));
      const float inc = (i >= first && i <= last) ? fma32(ei, ei, -err0)
                                                  : kBig;
      const float ed = __fsub_rn(
          cmag, __int2float_rn(dequant(lmag - 1 > 0 ? lmag - 1 : 0, q)));
      const bool dec_ok = lmag >= 2 || (lmag == 1 && i > first && i < last);
      const float dec = dec_ok ? fma32(ed, ed, -err0) : kBig;
      float best = inc;
      int bk = i;
      if (dec < best) {
        best = dec;
        bk = 16 + i;
      }
#pragma unroll
      for (int o = 8; o; o >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, o);
        const int ok = __shfl_xor_sync(kFull, bk, o);
        if (ob < best || (ob == best && ok < bk)) {
          best = ob;
          bk = ok;
        }
      }
      if (fix_cg && (bk & 15) == i) {
        const int step = bk >= 16 ? -1 : 1;
        const int nv = cv != 0 ? cv + step * sgn(cv)
                               : step * (ov < 0 ? -1 : 1);
        p.l(y0 + prow, x0 + pcol) = nv;
        c.res[prow * S + pcol] = dequant(nv, q);
      }
    }
    g.sync();
  }

  // 6. inverse transform, columns: tmp[k][j] = sum_m T[m][k] dq[m][j],
  // spatial rows k and n-1-k from the even and odd m (T[m][n-1-k] =
  // (-1)^m T[m][k]); clamp
  for (int it = g.tid; it < nn / 2; it += g.nt) {
    const int j = it & (n - 1), k = it >> LOG2;
    int ev = 0, od = 0;
#pragma unroll
    for (int m = 0; m < n; m += 2) {
      ev += T[m * n + k] * c.res[m * S + j];
      od += T[(m + 1) * n + k] * c.res[(m + 1) * S + j];
    }
    c.tmp[k * S + j] = clampi((ev + od + 64) >> 7, -32768, 32767);
    c.tmp[(n - 1 - k) * S + j] = clampi((ev - od + 64) >> 7, -32768, 32767);
  }
  g.sync();

  // 7. rows, clamp, recon = clamp(prediction + residual) in the tile
  for (int it = g.tid; it < nn / 2; it += g.nt) {
    const int col = it & (n / 2 - 1), row = it >> (LOG2 - 1);
    const int* xr = c.tmp + row * S;
    int ev = 0, od = 0;
#pragma unroll
    for (int m = 0; m < n; m += 2) {
      ev += T[m * n + col] * xr[m];
      od += T[(m + 1) * n + col] * xr[m + 1];
    }
    const int ra = clampi((ev + od + 2048) >> 12, -32768, 32767);
    const int rb = clampi((ev - od + 2048) >> 12, -32768, 32767);
    int& pa = p.r(y0 + row, x0 + col);
    pa = clampi(pa + ra, 0, 255);
    int& pb = p.r(y0 + row, x0 + n - 1 - col);
    pb = clampi(pb + rb, 0, 255);
  }
  g.sync();
}

// A TB of a group's chain: on the whole group, or (at most 64 samples,
// or a one-warp group) on its first warp with __syncwarp.  `pending`: the
// first warp ran TBs alone since the group last met.
template <int LOG2, int NMAX>
__device__ __forceinline__ void chain_tb(const Group& g, bool& pending,
                                         Chain<NMAX>& c, const int* tab,
                                         const float* rate, const Plane& p,
                                         int x0, int y0, int mode,
                                         bool is_luma, const Quant& q,
                                         bool lite, bool sbh, int scan) {
  if ((1 << (2 * LOG2)) <= 64 || g.nt == 32) {
    if (g.tid < 32)
      code_tb<LOG2, NMAX>(Group{g.tid, 32, 0}, c, tab, rate, p, x0, y0, mode,
                          is_luma, q, lite, sbh, scan);
    pending = g.nt > 32;
  } else {
    if (pending) g.sync();
    pending = false;
    code_tb<LOG2, NMAX>(g, c, tab, rate, p, x0, y0, mode, is_luma, q, lite,
                        sbh, scan);
  }
}

// _scan_type_dev: the mode-dependent scan of luma TB8 and chroma TB4.
__device__ __forceinline__ int mode_scan(int mode) {
  if (mode >= 6 && mode <= 14) return 2;     // vertical
  if (mode >= 22 && mode <= 30) return 1;    // horizontal
  return 0;
}

// The rows [lo, hi] of a bw x bh unit grid on diagonal d = x + 2 * y.
__host__ __device__ __forceinline__ void diag_rows(int d, int bw, int bh,
                                                   int* lo, int* hi) {
  const int a = d - (bw - 1);
  *lo = a > 0 ? (a + 1) / 2 : 0;
  *hi = d / 2 < bh - 1 ? d / 2 : bh - 1;
}

// Ticket -> unit: the diagonal d of ticket t, its first ticket `base`, and
// t's tile and row; tickets rise per CTA, so the cursor only moves on.
struct Cursor {
  int d = 0, base = 0;
  __device__ __forceinline__ void seek(int t, int bw, int bh, int nt,
                                       int* tile, int* y) {
    int lo, hi;
    diag_rows(d, bw, bh, &lo, &hi);
    while (t >= base + nt * (hi - lo + 1)) {
      base += nt * (hi - lo + 1);
      ++d;
      diag_rows(d, bw, bh, &lo, &hi);
    }
    const int off = t - base, rows = hi - lo + 1;
    *tile = off / rows;
    *y = lo + off % rows;
  }
};

// Warp 0 of the CTA: lanes 0-3 read the done flags of the left,
// top-left, top and top-right units of (x, y) in a bw x bh grid whose
// flags start at f; the whole warp polls until all four are set, so the
// warp never diverges around the CTA barrier that follows.
__device__ __forceinline__ void wait_neighbours(const int* f, int x, int y,
                                                int bw) {
  const int lane = threadIdx.x;
  int nx = x - 1, ny = y;
  if (lane == 1) ny = y - 1;
  if (lane == 2) nx = x, ny = y - 1;
  if (lane == 3) nx = x + 1, ny = y - 1;
  const bool mine = lane < 4 && nx >= 0 && ny >= 0 && nx < bw;
  const int* flag = f + (mine ? ny * bw + nx : 0);
  while (!__all_sync(kFull, !mine || ld_acquire(flag) != 0)) __nanosleep(32);
}

// Publish a unit's done flag once the CTA's writes are fenced: the whole
// CTA has passed a barrier after its __threadfence.
__device__ __forceinline__ void publish(int* flag) {
  if (threadIdx.x == 0) {
    __threadfence();
    atomicExch(flag, 1);
  }
}

// Stage the U x U originals of a plane at (ux, uy) (row stride pw) with
// cp.async, threads [t0, t0 + nt) of the CTA.
template <int U>
__device__ __forceinline__ void stage_org(Tile<U>& t, const int* plane,
                                          int pw, int ux, int uy, int tid,
                                          int nt) {
  for (int i = tid; i < U * U; i += nt)
    cp_async4(t.org + i, plane + (uy + i / U) * pw + ux + i % U);
}

// The neighbours' recon a unit's TBs read: the top row (2U + 1 samples
// from the top-left) and the left column, from L2; samples outside the
// plane are never available and read as 0.
template <int U>
__device__ __forceinline__ void read_border(Tile<U>& t, const int* rec,
                                            int ph, int pw, int ux, int uy,
                                            int tid, int nt) {
  constexpr int kRs = Tile<U>::kRs;
  for (int k = tid; k < kRs + U; k += nt) {
    const int row = k < kRs ? uy - 1 : uy + k - kRs;
    const int col = k < kRs ? ux - 1 + k : ux - 1;
    const bool in = row >= 0 && col >= 0 && row < ph && col < pw;
    const int v = in ? __ldcg(rec + row * pw + col) : 0;
    if (k < kRs)
      t.rec[k] = v;
    else
      t.rec[(k - kRs + 1) * kRs] = v;
  }
}

// The unit's recon and levels out, row by row.
template <int U>
__device__ __forceinline__ void write_tile(const Tile<U>& t, int* rec,
                                           int* lev, int pw, int lev_stride,
                                           int ux, int uy, int tid, int nt) {
  for (int i = tid; i < U * U; i += nt) {
    const int row = i / U, col = i % U;
    rec[(uy + row) * pw + ux + col] = t.rec[(row + 1) * Tile<U>::kRs + col + 1];
    lev[row * lev_stride + col] = t.lev[i];
  }
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

struct QtSmem {
  int tab[Tab::kSize];
  Tile<32> ty;
  Tile<16> tu, tv;
  Chain<32> cy;
  Chain<16> cu, cv;
  int cus[21];                       // the unit's coded CUs in Z order
  int ncu;
  int ticket[2];
};

// The decided CU of Z-order candidate i (0: the 32-CU; 1 + 5q: the 16-CU
// of quadrant q, then its four 8-CUs) of the CTB at (x0, y0), packed as
// x | y << 5 | log2 << 10 | mode << 13, or -1 where the tree holds none.
__device__ __forceinline__ int qt_candidate(const QtArgs& a, int x0, int y0,
                                            int i) {
  int x = x0, y = y0, log2 = 5, want = 0;
  if (i > 0) {
    const int qd = (i - 1) / 5, sb = (i - 1) % 5 - 1;
    x += (qd & 1) * 16;
    y += (qd >> 1) * 16;
    log2 = 4;
    want = 1;
    if (sb >= 0) {
      x += (sb & 1) * 8;
      y += (sb >> 1) * 8;
      log2 = 3;
      want = 2;
    }
  }
  if (x >= a.w || y >= a.h) return -1;
  const int yy = y < a.ph - 1 ? y : a.ph - 1, xx = x < a.pw - 1 ? x : a.pw - 1;
  if (a.depth8[(yy >> 3) * (a.pw >> 3) + (xx >> 3)] != want) return -1;
  const int* map = log2 == 5 ? a.m32 : (log2 == 4 ? a.m16 : a.m8);
  const int mode = map[(y >> log2) * (a.pw >> log2) + (x >> log2)];
  return (x - x0) | ((y - y0) << 5) | (log2 << 10) | (mode << 13);
}

// One plane's chain of a CTB: its TBs of the coded CUs in Z order (a
// chroma TB is half its CU, at least 4x4).
__device__ void qt_chain(QtSmem& s, const QtArgs& a, const Group& g,
                         bool luma, Chain<32>* cy, Chain<16>* cc,
                         const Plane& p) {
  const bool lite = a.lite != 0, sbh = a.sbh != 0;
  bool pending = false;
  for (int i = 0; i < s.ncu; ++i) {
    const int e = s.cus[i];
    const int lg = (e >> 10) & 7, mode = e >> 13;
    // the CU's offset in the CTB, halved in the chroma planes
    const int x = p.ux + ((e & 31) >> (luma ? 0 : 1));
    const int y = p.uy + (((e >> 5) & 31) >> (luma ? 0 : 1));
    if (luma) {
      const Quant q = make_quant(s.tab, a.qp, lg, __ldg(a.lam_td + lg - 2));
      if (lg == 5)
        chain_tb<5, 32>(g, pending, *cy, s.tab, a.rate, p, x, y, mode, true,
                        q, lite, sbh, 0);
      else if (lg == 4)
        chain_tb<4, 32>(g, pending, *cy, s.tab, a.rate, p, x, y, mode, true,
                        q, lite, sbh, 0);
      else
        chain_tb<3, 32>(g, pending, *cy, s.tab, a.rate, p, x, y, mode, true,
                        q, lite, sbh, mode_scan(mode));
    } else {
      const int cl = lg - 1 > 2 ? lg - 1 : 2;
      const Quant q = make_quant(s.tab, a.qp_c, cl,
                                 __ldg(a.lam_td + 4 + cl - 2));
      if (cl == 4)
        chain_tb<4, 16>(g, pending, *cc, s.tab, a.rate, p, x, y, mode, false,
                        q, lite, sbh, 0);
      else if (cl == 3)
        chain_tb<3, 16>(g, pending, *cc, s.tab, a.rate, p, x, y, mode, false,
                        q, lite, sbh, 0);
      else
        chain_tb<2, 16>(g, pending, *cc, s.tab, a.rate, p, x, y, mode, false,
                        q, lite, sbh, mode_scan(mode));
    }
  }
}

// Persistent: each CTA codes CTBs (cx, cy) in ticket order until none is
// left.  sync: [0] the ticket counter, [1 + cy * cw + cx] the CTB's flag.
__global__ void __launch_bounds__(kQtThreads)
    qt_wavefront_kernel(QtArgs a, int* sync) {
  extern __shared__ __align__(16) unsigned char vct_smem[];
  QtSmem& s = *reinterpret_cast<QtSmem*>(vct_smem);
  const int tid = threadIdx.x;
  const int cw = a.pw / 32, ch = a.ph / 32, cph = a.ph / 2, cpw = a.pw / 2;
  for (int i = tid; i < Tab::kSize; i += kQtThreads) s.tab[i] = a.tab[i];
  Cursor cur;
  for (int it = 0;; ++it) {
    if (tid == 0) s.ticket[it & 1] = atomicAdd(sync, 1);
    __syncthreads();
    const int t = s.ticket[it & 1];
    if (t >= cw * ch) break;
    int tile, cy;
    cur.seek(t, cw, ch, 1, &tile, &cy);
    const int cx = cur.d - 2 * cy, x0 = cx * 32, y0 = cy * 32;

    // the neighbours' flags on warp 0; the rest stage the originals,
    // clear the tiles and list the coded CUs
    if (tid < 32) {
      wait_neighbours(sync + 1, cx, cy, cw);
    } else {
      const int st = tid - 32, nst = kQtThreads - 32;
      stage_org(s.ty, a.y, a.pw, x0, y0, st, nst);
      stage_org(s.tu, a.u, cpw, x0 / 2, y0 / 2, st, nst);
      stage_org(s.tv, a.v, cpw, x0 / 2, y0 / 2, st, nst);
      for (int i = st; i < 32 * 32; i += nst) {
        s.ty.rec[(i / 32 + 1) * Tile<32>::kRs + i % 32 + 1] = 0;
        s.ty.lev[i] = 0;
      }
      for (int i = st; i < 16 * 16; i += nst) {
        s.tu.rec[(i / 16 + 1) * Tile<16>::kRs + i % 16 + 1] = 0;
        s.tv.rec[(i / 16 + 1) * Tile<16>::kRs + i % 16 + 1] = 0;
        s.tu.lev[i] = 0;
        s.tv.lev[i] = 0;
      }
      if (tid < 64) {
        const int lane = tid - 32;
        const int e = lane < 21 ? qt_candidate(a, x0, y0, lane) : -1;
        const unsigned b = __ballot_sync(kFull, e >= 0);
        if (e >= 0) s.cus[__popc(b & ((1u << lane) - 1))] = e;
        if (lane == 0) s.ncu = __popc(b);
      }
      cp_async_wait_all();
    }
    __syncthreads();
    read_border(s.ty, a.rec_y, a.ph, a.pw, x0, y0, tid, kQtThreads);
    read_border(s.tu, a.rec_u, cph, cpw, x0 / 2, y0 / 2, tid, kQtThreads);
    read_border(s.tv, a.rec_v, cph, cpw, x0 / 2, y0 / 2, tid, kQtThreads);
    __syncthreads();

    // the three chains
    if (tid < kQtLuma) {
      qt_chain(s, a, Group{tid, kQtLuma, kQtLuma == 32 ? 0 : 1}, true,
               &s.cy, nullptr,
               make_plane(s.ty, x0, y0, a.pw, a.w, a.h, 5));
    } else if (tid < kQtLuma + kQtChroma) {
      qt_chain(s, a, Group{tid - kQtLuma, kQtChroma, kQtChroma == 32 ? 0 : 2},
               false, nullptr, &s.cu,
               make_plane(s.tu, x0 / 2, y0 / 2, cpw, a.w / 2, a.h / 2, 4));
    } else {
      qt_chain(s, a,
               Group{tid - kQtLuma - kQtChroma, kQtChroma,
                     kQtChroma == 32 ? 0 : 3},
               false, nullptr, &s.cv,
               make_plane(s.tv, x0 / 2, y0 / 2, cpw, a.w / 2, a.h / 2, 4));
    }
    __syncthreads();

    write_tile(s.ty, a.rec_y, a.coef_y + y0 * a.pw + x0, a.pw, a.pw, x0, y0,
               tid, kQtThreads);
    write_tile(s.tu, a.rec_u, a.coef_u + y0 / 2 * cpw + x0 / 2, cpw, cpw,
               x0 / 2, y0 / 2, tid, kQtThreads);
    write_tile(s.tv, a.rec_v, a.coef_v + y0 / 2 * cpw + x0 / 2, cpw, cpw,
               x0 / 2, y0 / 2, tid, kQtThreads);
    __threadfence();
    __syncthreads();
    publish(sync + 1 + cy * cw + cx);
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
  int H, W, Hc, Wc, bw, bh, nt;
  int qp, qp_c, sbh, lite;
  const int* tab;
  const float* rate;
  const float* lam_td;
};

struct FlatSmem {
  int tab[Tab::kSize];
  Tile<16> ty;
  Tile<8> tu, tv;
  Chain<16> cy;
  Chain<8> cu, cv;
  int ticket[2];
};

// Persistent: each CTA codes 16x16 blocks (t, bx, by) in ticket order
// until none is left; a block the intra map leaves out only publishes its
// flag.  sync: [0] the ticket counter, [1 + block index] the flags.
__global__ void __launch_bounds__(kFlatThreads)
    flat_wavefront_kernel(FlatArgs a, int* sync) {
  extern __shared__ __align__(16) unsigned char vct_smem[];
  FlatSmem& s = *reinterpret_cast<FlatSmem*>(vct_smem);
  const int tid = threadIdx.x;
  const int per_tile = a.bw * a.bh;
  for (int i = tid; i < Tab::kSize; i += kFlatThreads) s.tab[i] = a.tab[i];
  Cursor cur;
  for (int it = 0;; ++it) {
    if (tid == 0) s.ticket[it & 1] = atomicAdd(sync, 1);
    __syncthreads();
    const int t = s.ticket[it & 1];
    if (t >= a.nt * per_tile) break;
    int tile, by;
    cur.seek(t, a.bw, a.bh, a.nt, &tile, &by);
    const int bx = cur.d - 2 * by;
    const int bidx = tile * per_tile + by * a.bw + bx;
    if (a.intra != nullptr && !a.intra[by * a.bw + bx]) {
      publish(sync + 1 + bidx);
      continue;
    }
    const long long lo = (long long)tile * a.H * a.W;
    const long long co = (long long)tile * a.Hc * a.Wc;
    const int x0 = bx * 16, y0 = by * 16, cx = bx * 8, cy = by * 8;

    if (tid < 32) {
      wait_neighbours(sync + 1 + tile * per_tile, bx, by, a.bw);
    } else {
      const int st = tid - 32, nst = kFlatThreads - 32;
      stage_org(s.ty, a.y + lo, a.W, x0, y0, st, nst);
      stage_org(s.tu, a.u + co, a.Wc, cx, cy, st, nst);
      stage_org(s.tv, a.v + co, a.Wc, cx, cy, st, nst);
      cp_async_wait_all();
    }
    __syncthreads();
    read_border(s.ty, a.rec_y + lo, a.H, a.W, x0, y0, tid, kFlatThreads);
    read_border(s.tu, a.rec_u + co, a.Hc, a.Wc, cx, cy, tid, kFlatThreads);
    read_border(s.tv, a.rec_v + co, a.Hc, a.Wc, cx, cy, tid, kFlatThreads);
    __syncthreads();

    const int mode = a.modes[bidx];
    const bool lite = a.lite != 0, sbh = a.sbh != 0;
    bool pending = false;
    if (tid < kFlatLuma) {
      const Group g{tid, kFlatLuma, kFlatLuma == 32 ? 0 : 1};
      chain_tb<4, 16>(g, pending, s.cy, s.tab, a.rate,
                      make_plane(s.ty, x0, y0, a.W, a.W, a.H, 0), x0, y0,
                      mode, true,
                      make_quant(s.tab, a.qp, 4, __ldg(a.lam_td + 2)), lite,
                      sbh, 0);
    } else {
      const bool cb = tid < kFlatLuma + kFlatChroma;
      const Group g{tid - kFlatLuma - (cb ? 0 : kFlatChroma), kFlatChroma,
                    kFlatChroma == 32 ? 0 : (cb ? 2 : 3)};
      chain_tb<3, 8>(g, pending, cb ? s.cu : s.cv, s.tab, a.rate,
                     make_plane(cb ? s.tu : s.tv, cx, cy, a.Wc, a.Wc, a.Hc,
                                0),
                     cx, cy, mode, false,
                     make_quant(s.tab, a.qp_c, 3, __ldg(a.lam_td + 5)), lite,
                     sbh, 0);
    }
    __syncthreads();

    write_tile(s.ty, a.rec_y + lo,
               a.lv_planes ? a.lv_y + lo + y0 * a.W + x0 : a.lv_y + bidx * 256,
               a.W, a.lv_planes ? a.W : 16, x0, y0, tid, kFlatThreads);
    write_tile(s.tu, a.rec_u + co,
               a.lv_planes ? a.lv_u + co + cy * a.Wc + cx : a.lv_u + bidx * 64,
               a.Wc, a.lv_planes ? a.Wc : 8, cx, cy, tid, kFlatThreads);
    write_tile(s.tv, a.rec_v + co,
               a.lv_planes ? a.lv_v + co + cy * a.Wc + cx : a.lv_v + bidx * 64,
               a.Wc, a.lv_planes ? a.Wc : 8, cx, cy, tid, kFlatThreads);
    if (tid == 0) {
      a.cbf_y[bidx] = s.cy.any ? 1 : 0;
      a.cbf_u[bidx] = s.cu.any ? 1 : 0;
      a.cbf_v[bidx] = s.cv.any ? 1 : 0;
    }
    __threadfence();
    __syncthreads();
    publish(sync + 1 + bidx);
  }
}

// The resident capacity of a kernel on the current card (SMs x CTAs per
// SM at its threads and dynamic shared memory), found once per card; the
// shared-memory limit is raised first.  0 with *err set on failure.
template <typename K>
int resident(K kernel, int which, int threads, int smem, int* err) {
  static int cached[2][64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= 0 && dev < 64 && cached[which][dev] > 0)
    return cached[which][dev];
  int sms = 0, occ = 0;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads,
                                                      smem);
  if (e != cudaSuccess || sms * occ <= 0) {
    *err = e != cudaSuccess ? (int)e : (int)cudaErrorInvalidConfiguration;
    return 0;
  }
  if (dev >= 0 && dev < 64) cached[which][dev] = sms * occ;
  return sms * occ;
}

}  // namespace

// The quadtree wavefront of the padded picture's CTB grid, one launch on
// `stream`.  sync: cw * ch + 1 zeroed int32 on the card.  *grid: the CTAs
// launched.  Returns the launch's error (cudaGetLastError), 0 when taken.
extern "C" int vct_intra_qt_wavefront(
    const void* y, const void* u, const void* v, const void* depth8,
    const void* m8, const void* m16, const void* m32, void* rec_y,
    void* rec_u, void* rec_v, void* coef_y, void* coef_u, void* coef_v,
    int ph, int pw, int w, int h, int qp, int qp_c, int sbh, int lite,
    const void* tab, const void* rate, const void* lam_td, void* sync,
    int* grid, void* stream) {
  if (ph <= 0 || pw <= 0 || ph % 32 || pw % 32 || w <= 0 || h <= 0 ||
      w > pw || h > ph || qp < 0 || qp > 51 || qp_c < 0 || qp_c > 51)
    return (int)cudaErrorInvalidValue;
  const int units = (pw / 32) * (ph / 32);
  int err = 0;
  const int cap = resident(qt_wavefront_kernel, 0, kQtThreads,
                           (int)sizeof(QtSmem), &err);
  if (cap == 0) return err;
  QtArgs a{(const int*)y, (const int*)u, (const int*)v,
           (const int*)depth8, (const int*)m8, (const int*)m16,
           (const int*)m32, (int*)rec_y, (int*)rec_u, (int*)rec_v,
           (int*)coef_y, (int*)coef_u, (int*)coef_v, ph, pw, w, h, qp,
           qp_c, sbh, lite, (const int*)tab, (const float*)rate,
           (const float*)lam_td};
  *grid = cap < units ? cap : units;
  qt_wavefront_kernel<<<*grid, kQtThreads, sizeof(QtSmem),
                        (cudaStream_t)stream>>>(a, (int*)sync);
  return (int)cudaGetLastError();
}

// The flat wavefront of nt stacked bw x bh block grids, one launch on
// `stream`; intra (null: every block) [bh, bw] uint8 on the card codes
// only its blocks.  sync: nt * bw * bh + 1 zeroed int32 on the card.
extern "C" int vct_intra_flat_wavefront(
    const void* y, const void* u, const void* v, const void* modes,
    const void* intra, void* rec_y, void* rec_u, void* rec_v, void* lv_y,
    void* lv_u, void* lv_v, int lv_planes, void* cbf_y, void* cbf_u,
    void* cbf_v, int nt, int H, int W, int Hc, int Wc, int bw, int bh,
    int qp, int qp_c, int sbh, int lite, const void* tab, const void* rate,
    const void* lam_td, void* sync, int* grid, void* stream) {
  if (nt <= 0 || bw <= 0 || bh <= 0 || bw * 16 > W || bh * 16 > H ||
      bw * 8 > Wc || bh * 8 > Hc || qp < 0 || qp > 51 || qp_c < 0 ||
      qp_c > 51 || (intra != nullptr && nt != 1))
    return (int)cudaErrorInvalidValue;
  const int units = nt * bw * bh;
  int err = 0;
  const int cap = resident(flat_wavefront_kernel, 1, kFlatThreads,
                           (int)sizeof(FlatSmem), &err);
  if (cap == 0) return err;
  FlatArgs a{(const int*)y, (const int*)u, (const int*)v,
             (const int*)modes, (const unsigned char*)intra, (int*)rec_y,
             (int*)rec_u, (int*)rec_v, (int*)lv_y, (int*)lv_u, (int*)lv_v,
             lv_planes, (unsigned char*)cbf_y, (unsigned char*)cbf_u,
             (unsigned char*)cbf_v, H, W, Hc, Wc, bw, bh, nt, qp, qp_c,
             sbh, lite, (const int*)tab, (const float*)rate,
             (const float*)lam_td};
  *grid = cap < units ? cap : units;
  flat_wavefront_kernel<<<*grid, kFlatThreads, sizeof(FlatSmem),
                          (cudaStream_t)stream>>>(a, (int*)sync);
  return (int)cudaGetLastError();
}
