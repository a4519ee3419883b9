// Native CABAC slice serializer for the all-intra HEVC build.
//
// The serial tail of the two-phase encoder (SURVEY.md §7.1): the TPU
// produces modes/levels in parallel; this C++ hot loop binarizes and
// arithmetic-codes the slice data.  Behavioral twin of
// video_codecs_tpu/entropy/{cabac,residual}.py + intra_codec._encode_ctu —
// the Python side remains the reference; tests assert byte-identical
// output.  Parity: HM TEncBinCoderCABAC.cpp:187, TEncSbac codeCoeffNxN.
//
// Exposed C API (ctypes):
//   int vct_encode_slice(...) -> number of EBSP bytes written (or -1).
//   Context layout/initial states are passed in from Python so the tables
//   live in exactly one place (entropy/ctx.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// spec Table 9-46 (TComCABACTables.cpp:43)
static const uint8_t kLps[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216},
    {123, 150, 178, 205}, {116, 142, 169, 195}, {111, 135, 160, 185},
    {105, 128, 152, 175}, {100, 122, 144, 166}, {95, 116, 137, 158},
    {90, 110, 130, 150},  {85, 104, 123, 142},  {81, 99, 117, 135},
    {77, 94, 111, 128},   {73, 89, 105, 122},   {69, 85, 100, 116},
    {66, 80, 95, 110},    {62, 76, 90, 104},    {59, 72, 86, 99},
    {56, 69, 81, 94},     {53, 65, 77, 89},     {51, 62, 73, 85},
    {48, 59, 69, 80},     {46, 56, 66, 76},     {43, 53, 63, 72},
    {41, 50, 59, 69},     {39, 48, 56, 65},     {37, 45, 54, 62},
    {35, 43, 51, 59},     {33, 41, 48, 56},     {32, 39, 46, 53},
    {30, 37, 43, 50},     {29, 35, 41, 48},     {27, 33, 39, 45},
    {26, 31, 37, 43},     {24, 30, 35, 41},     {23, 28, 33, 39},
    {22, 27, 32, 37},     {21, 26, 30, 35},     {20, 24, 29, 33},
    {19, 23, 27, 31},     {18, 22, 26, 30},     {17, 21, 25, 28},
    {16, 20, 23, 27},     {15, 19, 22, 25},     {14, 18, 21, 24},
    {14, 17, 20, 23},     {13, 16, 19, 22},     {12, 15, 18, 21},
    {12, 14, 17, 20},     {11, 14, 16, 19},     {11, 13, 15, 18},
    {10, 12, 15, 17},     {10, 12, 14, 16},     {9, 11, 13, 15},
    {9, 11, 12, 14},      {8, 10, 12, 14},      {8, 9, 11, 13},
    {7, 9, 11, 12},       {7, 9, 10, 12},       {7, 8, 10, 11},
    {6, 8, 9, 11},        {6, 7, 9, 10},        {6, 7, 8, 9},
    {2, 2, 2, 2}};

// Packed-128 state transitions (ContextModel.cpp:67-89).
static const uint8_t kNextMps[128] = {
    2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57,
    58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75,
    76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93,
    94, 95, 96, 97, 98, 99, 100, 101, 102, 103, 104, 105, 106, 107, 108, 109,
    110, 111, 112, 113, 114, 115, 116, 117, 118, 119, 120, 121, 122, 123,
    124, 125, 124, 125, 126, 127};
static const uint8_t kNextLps[128] = {
    1, 0, 0, 1, 2, 3, 4, 5, 4, 5, 8, 9, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 18, 19, 22, 23, 22, 23, 24, 25, 26, 27, 26, 27, 30, 31, 30,
    31, 32, 33, 32, 33, 36, 37, 36, 37, 38, 39, 38, 39, 42, 43, 42, 43, 44,
    45, 44, 45, 46, 47, 48, 49, 48, 49, 50, 51, 52, 53, 52, 53, 54, 55, 54,
    55, 56, 57, 58, 59, 58, 59, 60, 61, 60, 61, 60, 61, 62, 63, 64, 65, 64,
    65, 66, 67, 66, 67, 66, 67, 68, 69, 68, 69, 70, 71, 70, 71, 70, 71, 72,
    73, 72, 73, 72, 73, 74, 75, 74, 75, 74, 75, 76, 77, 76, 77, 126, 127};

static const int kGroupIdx[32] = {0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6,
                                  7, 7, 7, 7, 8, 8, 8, 8, 8, 8, 8, 8,
                                  9, 9, 9, 9, 9, 9, 9, 9};
static const int kMinInGroup[10] = {0, 1, 2, 3, 4, 6, 8, 12, 16, 24};
static const int kCtxIndMap4x4[16] = {0, 1, 4, 5, 2, 3, 4, 5,
                                      6, 6, 8, 8, 7, 7, 8, 8};

struct BitWriter {
  std::vector<uint8_t>* out;
  uint64_t cur = 0;
  int nbits = 0;
  void put(uint32_t v, int n) {
    cur = (cur << n) | v;
    nbits += n;
    while (nbits >= 8) {
      nbits -= 8;
      out->push_back(uint8_t((cur >> nbits) & 0xff));
    }
    cur &= (1u << nbits) - 1;
  }
};

struct Cabac {
  BitWriter* bw;
  uint8_t* states;
  uint32_t low = 0, range = 510;
  int bits_outstanding = 0;
  bool first_bit = true;

  void put_bit(int b) {
    if (first_bit)
      first_bit = false;
    else
      bw->put(b, 1);
    while (bits_outstanding > 0) {
      bw->put(1 - b, 1);
      --bits_outstanding;
    }
  }
  void renorm() {
    while (range < 256) {
      if (low >= 512) {
        put_bit(1);
        low -= 512;
      } else if (low < 256) {
        put_bit(0);
      } else {
        ++bits_outstanding;
        low -= 256;
      }
      low <<= 1;
      range <<= 1;
    }
  }
  void bin(int ctx, int b) {
    uint8_t s = states[ctx];
    uint32_t lps = kLps[s >> 1][(range >> 6) & 3];
    range -= lps;
    if (b != (s & 1)) {
      low += range;
      range = lps;
      states[ctx] = kNextLps[s];
    } else {
      states[ctx] = kNextMps[s];
    }
    renorm();
  }
  void bypass(int b) {
    low <<= 1;
    if (b) low += range;
    if (low >= 1024) {
      put_bit(1);
      low -= 1024;
    } else if (low < 512) {
      put_bit(0);
    } else {
      ++bits_outstanding;
      low -= 512;
    }
  }
  void bypass_bins(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) bypass((v >> i) & 1);
  }
  void terminate(int b) {
    range -= 2;
    if (b) {
      low += range;
      flush();
    } else {
      renorm();
    }
  }
  void flush() {
    range = 2;
    renorm();
    put_bit((low >> 9) & 1);
    bw->put(((low >> 7) & 3) | 1, 2);
  }
};

struct Offsets {
  int part_size, prev_intra, chroma_pred, cbf_luma, cbf_chroma;
  int last_x, last_y, sig_cg, sig_flag, one_flag, abs_flag;
};

// 4x4 scans: scan position -> raster position in 4x4, per scan type
// (0 = up-right diagonal, 1 = horizontal, 2 = vertical; rom.scan_order).
static const int kDiag4[16] = {0, 4, 1, 8, 5, 2, 12, 9,
                               6, 3, 13, 10, 7, 14, 11, 15};
static const int kHor4[16] = {0, 1, 2, 3, 4, 5, 6, 7,
                              8, 9, 10, 11, 12, 13, 14, 15};
static const int kVer4[16] = {0, 4, 8, 12, 1, 5, 9, 13,
                              2, 6, 10, 14, 3, 7, 11, 15};

enum { SCAN_DIAG = 0, SCAN_HOR = 1, SCAN_VER = 2 };

static const int* inner_scan(int scan_type) {
  return scan_type == SCAN_HOR ? kHor4 : (scan_type == SCAN_VER ? kVer4
                                                                : kDiag4);
}

struct ScanTables {
  // For a 2^log2 square TB: CG scan list (scan idx -> cg raster).
  std::vector<int> cg_scan;
  int cg_w;
  void init(int log2, int scan_type = SCAN_DIAG) {
    int n = 1 << log2;
    cg_w = n >> 2;
    if (cg_w == 0) cg_w = 1;
    cg_scan.clear();
    int size = cg_w;
    if (scan_type == SCAN_HOR) {
      for (int gy = 0; gy < size; ++gy)
        for (int gx = 0; gx < size; ++gx) cg_scan.push_back(gy * size + gx);
    } else if (scan_type == SCAN_VER) {
      for (int gx = 0; gx < size; ++gx)
        for (int gy = 0; gy < size; ++gy) cg_scan.push_back(gy * size + gx);
    } else {
      // up-right diagonal over cg grid
      int x = 0, y = 0;
      while ((int)cg_scan.size() < size * size) {
        while (y >= 0) {
          if (x < size && y < size) cg_scan.push_back(y * size + x);
          --y;
          ++x;
        }
        y = x;
        x = 0;
      }
    }
  }
};

static void encode_last_xy(Cabac& c, const Offsets& o, int lx, int ly,
                           int log2, bool luma) {
  int off, shift;
  if (luma) {
    off = 3 * (log2 - 2) + ((log2 - 1) >> 2);
    shift = (log2 + 1) >> 2;
  } else {
    off = 15;
    shift = log2 - 2;
  }
  int gx = kGroupIdx[lx], gy = kGroupIdx[ly];
  int max_group = (log2 << 1) - 1;
  for (int i = 0; i < gx; ++i) c.bin(o.last_x + off + (i >> shift), 1);
  if (gx < max_group) c.bin(o.last_x + off + (gx >> shift), 0);
  for (int i = 0; i < gy; ++i) c.bin(o.last_y + off + (i >> shift), 1);
  if (gy < max_group) c.bin(o.last_y + off + (gy >> shift), 0);
  if (gx > 3) c.bypass_bins(lx - kMinInGroup[gx], (gx >> 1) - 1);
  if (gy > 3) c.bypass_bins(ly - kMinInGroup[gy], (gy >> 1) - 1);
}

static void encode_remainder(Cabac& c, int value, int rice) {
  if (value < (3 << rice)) {
    int length = value >> rice;
    c.bypass_bins((1u << (length + 1)) - 2, length + 1);
    c.bypass_bins(value & ((1 << rice) - 1), rice);
  } else {
    int length = rice;
    value -= 3 << rice;
    while (value >= (1 << length)) value -= 1 << (length++);
    c.bypass_bins((1u << (3 + length + 1 - rice)) - 2, 3 + length + 1 - rice);
    c.bypass_bins(value, length);
  }
}

static int sig_ctx_inc(int pattern, int px, int py, int log2, bool luma,
                       int first_ctx) {
  if (px + py == 0) return 0;
  if (log2 == 2) return first_ctx + kCtxIndMap4x4[4 * py + px];
  int xp = px & 3, yp = py & 3, cnt;
  switch (pattern) {
    case 0: {
      int tot = xp + yp;
      cnt = tot >= 3 ? 0 : (tot >= 1 ? 1 : 2);
      break;
    }
    case 1:
      cnt = yp >= 2 ? 0 : (yp >= 1 ? 1 : 2);
      break;
    case 2:
      cnt = xp >= 2 ? 0 : (xp >= 1 ? 1 : 2);
      break;
    default:
      cnt = 2;
  }
  bool not_first = ((px >> 2) + (py >> 2)) > 0;
  int offset = (not_first && luma ? 3 : 0) + cnt;
  return first_ctx + offset;
}

static void encode_residual(Cabac& c, const Offsets& o, const int32_t* lv,
                            int log2, bool luma, bool sign_hiding,
                            int scan_type = SCAN_DIAG) {
  int n = 1 << log2;
  ScanTables st;
  st.init(log2, scan_type);
  const int* inner = inner_scan(scan_type);
  int num_cg = (n * n) >> 4;
  int cg_w = st.cg_w;

  // scan-ordered coefficients: coeffs[i*16+k] where CG i at cg_scan[i]
  std::vector<int32_t> coeffs(n * n);
  std::vector<int> csbf(num_cg, 0);
  int last_scan = -1;
  for (int i = 0; i < num_cg; ++i) {
    int cgr = st.cg_scan[i];
    int cgx = cgr % cg_w, cgy = cgr / cg_w;
    for (int k = 0; k < 16; ++k) {
      int rin = inner[k];
      int px = (cgx << 2) + (rin & 3), py = (cgy << 2) + (rin >> 2);
      int32_t v = lv[py * n + px];
      coeffs[i * 16 + k] = v;
      if (v) {
        csbf[cgr] = 1;
        last_scan = i * 16 + k;
      }
    }
  }
  int last_cg = last_scan >> 4;
  int lr = st.cg_scan[last_cg];
  int rin = inner[last_scan & 15];
  int lx = ((lr % cg_w) << 2) + (rin & 3);
  int ly = ((lr / cg_w) << 2) + (rin >> 2);
  if (scan_type == SCAN_VER) {
    int t = lx;
    lx = ly;
    ly = t;
  }
  encode_last_xy(c, o, lx, ly, log2, luma);

  int first_ctx, single_ctx;
  if (luma) {
    first_ctx = log2 == 2 ? 0 : (log2 == 3 ? 9 : 21);
    if (log2 == 3 && scan_type != SCAN_DIAG) first_ctx += 6;
    single_ctx = 27;
  } else {
    first_ctx = log2 == 2 ? 0 : (log2 == 3 ? 9 : 12);
    single_ctx = 15;
  }
  int sig_base = o.sig_flag + (luma ? 0 : 28);

  int c1 = 1;
  for (int i = last_cg; i >= 0; --i) {
    int cgr = st.cg_scan[i];
    int cgx = cgr % cg_w, cgy = cgr / cg_w;
    int right = (cgx + 1 < cg_w) ? csbf[cgr + 1] : 0;
    int below = (cgy + 1 < cg_w) ? csbf[cgr + cg_w] : 0;
    int pattern = right + 2 * below;

    int infer_dc = 0;
    if (i < last_cg && i > 0) {
      int ctx = o.sig_cg + ((right || below) ? 1 : 0) + (luma ? 0 : 2);
      c.bin(ctx, csbf[cgr]);
      infer_dc = 1;
      if (!csbf[cgr]) continue;
    }

    const int32_t* cgc = &coeffs[i * 16];
    int start_n = (i == last_cg) ? (last_scan - i * 16 - 1) : 15;
    for (int k = start_n; k >= 0; --k) {
      int sig = cgc[k] != 0;
      if (k > 0 || !infer_dc) {
        int ri = inner[k];
        int px = (cgx << 2) + (ri & 3), py = (cgy << 2) + (ri >> 2);
        int sc = (first_ctx == single_ctx)
                     ? first_ctx
                     : sig_ctx_inc(pattern, px, py, log2, luma, first_ctx);
        c.bin(sig_base + sc, sig);
      }
      if (sig) infer_dc = 0;
    }

    int sig_pos[16], nsig = 0;
    for (int k = 15; k >= 0; --k)
      if (cgc[k]) sig_pos[nsig++] = k;
    if (!nsig) continue;
    bool hidden = sign_hiding && (sig_pos[0] - sig_pos[nsig - 1] > 3);

    int ctx_set = (i == 0 || !luma) ? 0 : 2;
    if (c1 == 0) ctx_set += 1;
    c1 = 1;
    int one_base = o.one_flag + (luma ? ctx_set * 4 : 16 + ctx_set * 4);
    int abs_base = o.abs_flag + (luma ? ctx_set : 4 + ctx_set);

    int num_c1 = nsig < 8 ? nsig : 8;
    int first_c2 = -1;
    for (int k = 0; k < num_c1; ++k) {
      int a = cgc[sig_pos[k]];
      if (a < 0) a = -a;
      int sym = a > 1;
      c.bin(one_base + c1, sym);
      if (sym) {
        c1 = 0;
        if (first_c2 < 0) first_c2 = k;
      } else if (c1 > 0 && c1 < 3) {
        ++c1;
      }
    }
    if (first_c2 >= 0) {
      int a = cgc[sig_pos[first_c2]];
      if (a < 0) a = -a;
      c.bin(abs_base, a > 2);
    }
    int nsigns = hidden ? nsig - 1 : nsig;
    for (int k = 0; k < nsigns; ++k) c.bypass(cgc[sig_pos[k]] < 0);

    int rice = 0, first_coeff2 = 1;
    for (int k = 0; k < nsig; ++k) {
      int a = cgc[sig_pos[k]];
      if (a < 0) a = -a;
      int base_level = k < 8 ? 2 + first_coeff2 : 1;
      if (a >= base_level) {
        encode_remainder(c, a - base_level, rice);
        if (a > (3 << rice) && rice < 4) ++rice;
      }
      if (a >= 2) first_coeff2 = 0;
    }
  }
}

}  // namespace

extern "C" {

// Returns number of bytes written to `out` (EBSP payload: header bytes +
// slice data with emulation prevention), or -1 on overflow.
int vct_encode_slice(int bw, int bh, int /*qp*/, const int32_t* modes,
                     const uint8_t* cbf,        // [3][B]
                     const int32_t* levels_y,   // [B][256]
                     const int32_t* levels_cb,  // [B][64]
                     const int32_t* levels_cr,  // [B][64]
                     const uint8_t* header, int header_len,
                     const uint8_t* init_states, int num_ctx,
                     const int* offs,  // 11 offsets, order as struct Offsets
                     uint8_t* out, int out_capacity, int sign_hiding) {
  Offsets o;
  o.part_size = offs[0];
  o.prev_intra = offs[1];
  o.chroma_pred = offs[2];
  o.cbf_luma = offs[3];
  o.cbf_chroma = offs[4];
  o.last_x = offs[5];
  o.last_y = offs[6];
  o.sig_cg = offs[7];
  o.sig_flag = offs[8];
  o.one_flag = offs[9];
  o.abs_flag = offs[10];

  std::vector<uint8_t> rbsp(header, header + header_len);
  BitWriter bwr;
  bwr.out = &rbsp;
  std::vector<uint8_t> states(init_states, init_states + num_ctx);
  Cabac c;
  c.bw = &bwr;
  c.states = states.data();

  int b = bw * bh;
  for (int i = 0; i < b; ++i) {
    int left_mode = (i % bw) ? modes[i - 1] : 1;
    int mode = modes[i];
    // part_mode 2Nx2N
    c.bin(o.part_size, 1);
    // MPM (above candidate always DC at CTB granularity)
    int mpm[3];
    if (left_mode < 2) {
      mpm[0] = 0;
      mpm[1] = 1;
      mpm[2] = 26;
    } else {
      mpm[0] = left_mode;
      mpm[1] = 1;
      mpm[2] = 0;
    }
    int idx = mode == mpm[0] ? 0 : (mode == mpm[1] ? 1 : (mode == mpm[2] ? 2 : -1));
    if (idx >= 0) {
      c.bin(o.prev_intra, 1);
      c.bypass(idx == 0 ? 0 : 1);
      if (idx) c.bypass(idx - 1);
    } else {
      c.bin(o.prev_intra, 0);
      int rem = mode;
      for (int k = 0; k < 3; ++k)
        if (mode > mpm[k]) --rem;
      c.bypass_bins(rem, 5);
    }
    c.bin(o.chroma_pred, 0);  // DM
    int cbf_y = cbf[i], cbf_cb = cbf[b + i], cbf_cr = cbf[2 * b + i];
    c.bin(o.cbf_chroma, cbf_cb);
    c.bin(o.cbf_chroma, cbf_cr);
    c.bin(o.cbf_luma + 1, cbf_y);
    if (cbf_y) encode_residual(c, o, levels_y + i * 256, 4, true, sign_hiding);
    if (cbf_cb) encode_residual(c, o, levels_cb + i * 64, 3, false, sign_hiding);
    if (cbf_cr) encode_residual(c, o, levels_cr + i * 64, 3, false, sign_hiding);
    c.terminate(i == b - 1 ? 1 : 0);
  }
  // byte-align; flush's last bit is the rbsp stop bit
  if (bwr.nbits) bwr.put(0, 8 - bwr.nbits);

  // emulation prevention
  int zeros = 0, pos = 0;
  for (size_t k = 0; k < rbsp.size(); ++k) {
    uint8_t byte = rbsp[k];
    if (zeros >= 2 && byte <= 3) {
      if (pos >= out_capacity) return -1;
      out[pos++] = 3;
      zeros = 0;
    }
    if (pos >= out_capacity) return -1;
    out[pos++] = byte;
    zeros = byte == 0 ? zeros + 1 : 0;
  }
  return pos;
}
}  // extern "C"

// ---------------------------------------------------------------------------
// Quadtree slice serializer (device quadtree path, CTB 32 / CU 32..8)
// Behavioral twin of quadtree_codec.encode_slice_qt; byte-identical output
// is asserted in tests.
// ---------------------------------------------------------------------------

namespace {

// Mode-dependent coefficient scan (rom.intra_scan_type): 4x4/8x8 luma and
// 4x4 chroma only.
static int intra_scan_type(int log2, int mode, bool luma) {
  if (log2 > 3 || (!luma && log2 > 2)) return SCAN_DIAG;
  if (mode >= 6 && mode <= 14) return SCAN_VER;
  if (mode >= 22 && mode <= 30) return SCAN_HOR;
  return SCAN_DIAG;
}

struct QtEnc {
  Cabac* c;
  const Offsets* o;
  int off_split;
  int w, h, log2_ctb;
  const int8_t *depth8, *m8, *m16, *m32;
  int pw8, pw16, pw32;  // row strides of the (padded) maps
  const int16_t *coef_y, *coef_u, *coef_v;
  bool sbh;
  // coded-state grids at 8-px granularity (2Nx2N CUs only)
  std::vector<int8_t> cdepth;   // coded depth (0 until coded; ctx rule)
  std::vector<int8_t> cmode;    // intra mode per coded 8-cell
  std::vector<uint8_t> cintra;  // coded flag
  int gw, gh;

  void init() {
    gw = w / 8;
    gh = h / 8;
    cdepth.assign(gw * gh, 0);
    cmode.assign(gw * gh, 1);
    cintra.assign(gw * gh, 0);
  }

  int split_ctx(int x, int y, int depth) const {
    int ctx = 0;
    if (x > 0 && cdepth[(y / 8) * gw + (x - 1) / 8] > depth) ++ctx;
    if (y > 0 && cdepth[((y - 1) / 8) * gw + x / 8] > depth) ++ctx;
    return ctx;
  }

  int mode_at(int sx, int sy, int cur_y, bool clamp_ctb) const {
    if (sx < 0 || sy < 0 || sx >= w || sy >= h) return 1;
    if (clamp_ctb && (sy >> log2_ctb) != (cur_y >> log2_ctb)) return 1;
    int cell = (sy / 8) * gw + sx / 8;
    if (!cintra[cell]) return 1;
    return cmode[cell];
  }

  void mpm(int x, int y, int out3[3]) const {
    int a = mode_at(x - 1, y, y, false);
    int b = mode_at(x, y - 1, y, true);
    if (a == b) {
      if (a < 2) {
        out3[0] = 0;
        out3[1] = 1;
        out3[2] = 26;
      } else {
        out3[0] = a;
        out3[1] = 2 + ((a + 29) % 32);
        out3[2] = 2 + ((a - 2 + 1) % 32);
      }
      return;
    }
    out3[0] = a;
    out3[1] = b;
    for (int third : {0, 1, 26}) {
      if (third != a && third != b) {
        out3[2] = third;
        break;
      }
    }
  }

  bool any_nz16(const int16_t* plane, int stride, int x, int y,
                int size) const {
    for (int j = 0; j < size; ++j)
      for (int i = 0; i < size; ++i)
        if (plane[(y + j) * stride + x + i]) return true;
    return false;
  }

  void copy_block(const int16_t* plane, int stride, int x, int y, int size,
                  std::vector<int32_t>& out) const {
    out.resize(size * size);
    for (int j = 0; j < size; ++j)
      for (int i = 0; i < size; ++i)
        out[j * size + i] = plane[(y + j) * stride + x + i];
  }

  void encode_cu(int x, int y, int log2) {
    int size = 1 << log2;
    if (size == 8) c->bin(o->part_size, 1);  // 2Nx2N
    int mode;
    {
      int d = log2_ctb - log2;
      if (log2 == 5)
        mode = m32[(y / 32) * pw32 + x / 32];
      else if (log2 == 4)
        mode = m16[(y / 16) * pw16 + x / 16];
      else
        mode = m8[(y / 8) * pw8 + x / 8];
      (void)d;
    }
    int m3[3];
    mpm(x, y, m3);
    int idx = mode == m3[0] ? 0 : (mode == m3[1] ? 1 : (mode == m3[2] ? 2 : -1));
    c->bin(o->prev_intra, idx >= 0);
    // mark coded cells (decode order: before the next CU's MPM derivation)
    for (int j = 0; j < size / 8; ++j)
      for (int i = 0; i < size / 8; ++i) {
        int cell = (y / 8 + j) * gw + x / 8 + i;
        cmode[cell] = (int8_t)mode;
        cintra[cell] = 1;
        cdepth[cell] = (int8_t)(log2_ctb - log2);
      }
    if (idx >= 0) {
      c->bypass(idx == 0 ? 0 : 1);
      if (idx) c->bypass(idx - 1);
    } else {
      int rem = mode;
      // subtract per candidate larger-first (sorted descending)
      int s0 = m3[0], s1 = m3[1], s2 = m3[2];
      // simple 3-element sort descending
      if (s0 < s1) { int t = s0; s0 = s1; s1 = t; }
      if (s1 < s2) { int t = s1; s1 = s2; s2 = t; }
      if (s0 < s1) { int t = s0; s0 = s1; s1 = t; }
      if (mode > s0) --rem;
      if (mode > s1) --rem;
      if (mode > s2) --rem;
      c->bypass_bins(rem, 5);
    }
    c->bin(o->chroma_pred, 0);  // DM

    int cs = size / 2 < 4 ? 4 : size / 2;
    int clog2 = cs == 4 ? 2 : (cs == 8 ? 3 : 4);
    int cx = x / 2, cy = y / 2;
    bool cbf_cb = any_nz16(coef_u, w / 2, cx, cy, cs);
    bool cbf_cr = any_nz16(coef_v, w / 2, cx, cy, cs);
    bool cbf_y = any_nz16(coef_y, w, x, y, size);
    c->bin(o->cbf_chroma, cbf_cb);
    c->bin(o->cbf_chroma, cbf_cr);
    c->bin(o->cbf_luma + 1, cbf_y);
    std::vector<int32_t> blk;
    if (cbf_y) {
      copy_block(coef_y, w, x, y, size, blk);
      encode_residual(*c, *o, blk.data(), log2, true, sbh,
                      intra_scan_type(log2, mode, true));
    }
    int cst = intra_scan_type(clog2, mode, false);
    if (cbf_cb) {
      copy_block(coef_u, w / 2, cx, cy, cs, blk);
      encode_residual(*c, *o, blk.data(), clog2, false, sbh, cst);
    }
    if (cbf_cr) {
      copy_block(coef_v, w / 2, cx, cy, cs, blk);
      encode_residual(*c, *o, blk.data(), clog2, false, sbh, cst);
    }
  }

  void encode_node(int x, int y, int log2, int depth) {
    int size = 1 << log2;
    bool inside = (x + size <= w) && (y + size <= h);
    bool leaf = inside &&
                depth8[(y / 8) * pw8 + x / 8] == (int8_t)(log2_ctb - log2);
    if (inside && log2 > 3)
      c->bin(off_split + split_ctx(x, y, depth), leaf ? 0 : 1);
    if (leaf) {
      encode_cu(x, y, log2);
      return;
    }
    int half = size / 2;
    for (int q = 0; q < 4; ++q) {
      int cx2 = x + (q & 1) * half;
      int cy2 = y + (q >> 1) * half;
      if (cx2 >= w || cy2 >= h) continue;
      encode_node(cx2, cy2, log2 - 1, depth + 1);
    }
  }
};

}  // namespace

extern "C" {

int vct_encode_slice_qt(int w, int h, int log2_ctb,
                        const int8_t* depth8, int pw8,
                        const int8_t* m8, const int8_t* m16, int pw16,
                        const int8_t* m32, int pw32,
                        const int16_t* coef_y, const int16_t* coef_u,
                        const int16_t* coef_v,
                        const uint8_t* header, int header_len,
                        const uint8_t* init_states, int num_ctx,
                        const int* offs,  // 12: Offsets order + split_cu_flag
                        uint8_t* out, int out_capacity, int sign_hiding) {
  Offsets o;
  o.part_size = offs[0];
  o.prev_intra = offs[1];
  o.chroma_pred = offs[2];
  o.cbf_luma = offs[3];
  o.cbf_chroma = offs[4];
  o.last_x = offs[5];
  o.last_y = offs[6];
  o.sig_cg = offs[7];
  o.sig_flag = offs[8];
  o.one_flag = offs[9];
  o.abs_flag = offs[10];

  std::vector<uint8_t> rbsp(header, header + header_len);
  BitWriter bwr;
  bwr.out = &rbsp;
  std::vector<uint8_t> states(init_states, init_states + num_ctx);
  Cabac c;
  c.bw = &bwr;
  c.states = states.data();

  QtEnc e;
  e.c = &c;
  e.o = &o;
  e.off_split = offs[11];
  e.w = w;
  e.h = h;
  e.log2_ctb = log2_ctb;
  e.depth8 = depth8;
  e.pw8 = pw8;
  e.m8 = m8;
  e.m16 = m16;
  e.pw16 = pw16;
  e.m32 = m32;
  e.pw32 = pw32;
  e.coef_y = coef_y;
  e.coef_u = coef_u;
  e.coef_v = coef_v;
  e.sbh = sign_hiding != 0;
  e.init();

  int ctb = 1 << log2_ctb;
  int cw = (w + ctb - 1) / ctb, ch = (h + ctb - 1) / ctb;
  int n = cw * ch, i = 0;
  for (int cy = 0; cy < h; cy += ctb)
    for (int cx = 0; cx < w; cx += ctb) {
      e.encode_node(cx, cy, log2_ctb, 0);
      ++i;
      c.terminate(i == n ? 1 : 0);
    }
  if (bwr.nbits) bwr.put(0, 8 - bwr.nbits);

  int zeros = 0, pos = 0;
  for (size_t k = 0; k < rbsp.size(); ++k) {
    uint8_t byte = rbsp[k];
    if (zeros >= 2 && byte <= 3) {
      if (pos >= out_capacity) return -1;
      out[pos++] = 3;
      zeros = 0;
    }
    if (pos >= out_capacity) return -1;
    out[pos++] = byte;
    zeros = byte == 0 ? zeros + 1 : 0;
  }
  return pos;
}
}
