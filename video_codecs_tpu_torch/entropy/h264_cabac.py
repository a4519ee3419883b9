"""H.264/AVC CABAC entropy coding (spec 9.3), encoder + decoder.

The port's copy of video_codecs_tpu/entropy/h264_cabac.py, whole and as it
is (the B-slice binarizations too); each function keeps its name and a
comment gives the original's line.

Parity references: jm18.5/lencod/src/cabac.c (writeMB_I_typeInfo_CABAC :752,
writeMB_P_typeInfo_CABAC :520, writeMB_Pskip_flagInfo_CABAC :424,
writeIntraPredMode_CABAC :939, writeCIPredMode_CABAC :1246, writeCBP_CABAC
:1326, writeDquant_CABAC :1116, writeMVD_CABAC :1152, writeRefPic_P_CABAC
:970, write_and_store_CBP_block_bit :1630, write_significance_map :1735,
write_significant_coefficients :1782), lencod/inc/cabac.h:23-34 (maxpos /
c1isdc / type2ctx / max_c2 tables), lencod/src/biariencode.c:553
(biari_init_context), ldecod/src/cabac.c (the decode mirrors), and
lcommon/inc/ctx_tables.h (init constants -> h264_ctx_data, generated).

The arithmetic core is the same M-coder as HEVC (identical rLPS table and
64-state FSM), so the HEVC engine (entropy.cabac) is reused; only context
initialization (from (m, n) pairs), binarizations, and context derivations
are H.264-specific.  Frame coding only (no MBAFF/field contexts).
"""

from __future__ import annotations

import numpy as np

from video_codecs_tpu_torch.entropy import h264_ctx_data as tab
from video_codecs_tpu_torch.entropy.bitstream import BitReader, BitWriter
from video_codecs_tpu_torch.entropy.cabac import CabacDecoder, CabacEncoder

# --- CABAC block types (jm18.5/lencod/inc/defines.h:210, 4:2:0 subset) ---
LUMA_16DC = 0
LUMA_16AC = 1
LUMA_8x8 = 2
LUMA_4x4 = 5
CHROMA_DC = 6
CHROMA_AC = 7

MAXPOS = {LUMA_16DC: 15, LUMA_16AC: 14, LUMA_8x8: 63, LUMA_4x4: 15,
          CHROMA_DC: 3, CHROMA_AC: 14}
C1ISDC = {LUMA_16DC: 1, LUMA_16AC: 0, LUMA_8x8: 1, LUMA_4x4: 1,
          CHROMA_DC: 1, CHROMA_AC: 0}
TYPE2CTX_BCBP = {LUMA_16DC: 0, LUMA_16AC: 1, LUMA_8x8: 2, LUMA_4x4: 4,
                 CHROMA_DC: 5, CHROMA_AC: 6}
TYPE2CTX_MAP = {LUMA_16DC: 0, LUMA_16AC: 1, LUMA_8x8: 2, LUMA_4x4: 5,
                CHROMA_DC: 6, CHROMA_AC: 7}
TYPE2CTX_ONE = {LUMA_16DC: 0, LUMA_16AC: 1, LUMA_8x8: 2, LUMA_4x4: 4,
                CHROMA_DC: 5, CHROMA_AC: 6}
MAX_C2 = {LUMA_16DC: 4, LUMA_16AC: 4, LUMA_8x8: 4, LUMA_4x4: 4,
          CHROMA_DC: 3, CHROMA_AC: 4}

POS2CTX_MAP4x4 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 14]
POS2CTX_MAP2x4C = [0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2]
POS2CTX_LAST4x4 = list(range(16))
POS2CTX_LAST2x4C = [0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2]
# 8x8 significance/last position->ctx maps (frame coding; spec Table
# 9-43 / jm18.5 lencod/src/cabac.c:36 pos2ctx_map8x8, :102
# pos2ctx_last8x8 — spec-mandated constants).
POS2CTX_MAP8x8 = [
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
    4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7,
    7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11,
    12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12, 14]
POS2CTX_LAST8x8 = [
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4,
    5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8, 8]
# NB: the 2x4c tables belong to 4:2:2's CHROMA_DC_2x4 (type 8); 4:2:0
# CHROMA_DC (type 6) indexes pos2ctx_map4x4 (lencod/src/cabac.c:60,126).
POS2CTX_MAP = {LUMA_16DC: POS2CTX_MAP4x4, LUMA_16AC: POS2CTX_MAP4x4,
               LUMA_8x8: POS2CTX_MAP8x8,
               LUMA_4x4: POS2CTX_MAP4x4, CHROMA_DC: POS2CTX_MAP4x4,
               CHROMA_AC: POS2CTX_MAP4x4}
POS2CTX_LAST = {LUMA_16DC: POS2CTX_LAST4x4, LUMA_16AC: POS2CTX_LAST4x4,
                LUMA_8x8: POS2CTX_LAST8x8,
                LUMA_4x4: POS2CTX_LAST4x4, CHROMA_DC: POS2CTX_LAST4x4,
                CHROMA_AC: POS2CTX_LAST4x4}

# --- flat context layout (functional groups, JM MotionInfo/TextureInfo) ---
_GROUPS = [
    ("mb_type", 3 * 11), ("b8_type", 2 * 9), ("mv_res", 2 * 10),
    ("ref_no", 2 * 6), ("transform_size", 3), ("ipr", 2), ("cipr", 4),
    ("cbp", 3 * 4), ("bcbp", 22 * 4), ("delta_qp", 4),
    ("map", 22 * 15), ("last", 22 * 15), ("one", 22 * 5), ("abs", 22 * 5),
]
OFFSETS: dict[str, int] = {}
_o = 0
for _n, _c in _GROUPS:
    OFFSETS[_n] = _o
    _o += _c
NUM_CTX = _o

_GROUP_COLS = {"mb_type": 11, "b8_type": 9, "mv_res": 10, "ref_no": 6,
               "cbp": 4, "bcbp": 4, "map": 15, "last": 15, "one": 5,
               "abs": 5}


# video_codecs_tpu/entropy/h264_cabac.py:95
def off(name: str, i: int = 0, j: int | None = None) -> int:
    if j is None:
        return OFFSETS[name] + i
    return OFFSETS[name] + i * _GROUP_COLS[name] + j


# video_codecs_tpu/entropy/h264_cabac.py:101
def _pack_states(mn: np.ndarray, qp: int) -> np.ndarray:
    """(..., 2) (m, n) pairs -> packed 128-state array (biariencode.c:553)."""
    qp = max(0, min(51, qp))
    pre = np.clip((mn[..., 0].astype(np.int32) * qp >> 4) + mn[..., 1],
                  1, 126)
    mps = (pre >= 64).astype(np.int32)
    pstate = np.where(mps == 1, pre - 64, 63 - pre)
    return ((pstate << 1) | mps).astype(np.uint8).reshape(-1)


# video_codecs_tpu/entropy/h264_cabac.py:111
def init_states(slice_type: str, qp: int, model: int = 0) -> np.ndarray:
    """Fresh context-state array for a slice.

    slice_type: "I" or "P" ("B" shares the P tables, model = cabac_init_idc).
    """
    st = np.zeros(NUM_CTX, np.uint8)
    if slice_type == "I":
        groups = [("mb_type", tab.INIT_MB_TYPE_I[0]),
                  ("b8_type", tab.INIT_B8_TYPE_I[0]),
                  ("mv_res", tab.INIT_MV_RES_I[0]),
                  ("ref_no", tab.INIT_REF_NO_I[0]),
                  ("transform_size", tab.INIT_TRANSFORM_SIZE_I[0]),
                  ("ipr", tab.INIT_IPR_I[0]), ("cipr", tab.INIT_CIPR_I[0]),
                  ("cbp", tab.INIT_CBP_I[0]), ("bcbp", tab.INIT_BCBP_I[0]),
                  ("delta_qp", tab.INIT_DELTA_QP_I[0]),
                  ("map", tab.INIT_MAP_I[0]), ("last", tab.INIT_LAST_I[0]),
                  ("one", tab.INIT_ONE_I[0]), ("abs", tab.INIT_ABS_I[0])]
    else:
        m = model
        groups = [("mb_type", tab.INIT_MB_TYPE_P[m]),
                  ("b8_type", tab.INIT_B8_TYPE_P[m]),
                  ("mv_res", tab.INIT_MV_RES_P[m]),
                  ("ref_no", tab.INIT_REF_NO_P[m]),
                  ("transform_size", tab.INIT_TRANSFORM_SIZE_P[m]),
                  ("ipr", tab.INIT_IPR_P[m]), ("cipr", tab.INIT_CIPR_P[m]),
                  ("cbp", tab.INIT_CBP_P[m]), ("bcbp", tab.INIT_BCBP_P[m]),
                  ("delta_qp", tab.INIT_DELTA_QP_P[m]),
                  ("map", tab.INIT_MAP_P[m]), ("last", tab.INIT_LAST_P[m]),
                  ("one", tab.INIT_ONE_P[m]), ("abs", tab.INIT_ABS_P[m])]
    for name, mn in groups:
        o = OFFSETS[name]
        packed = _pack_states(np.asarray(mn), qp)
        st[o:o + packed.size] = packed
    return st


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

# video_codecs_tpu/entropy/h264_cabac.py:151
class H264CabacEncoder:
    """H.264 syntax-element encoder over the shared M-coder engine."""

    # video_codecs_tpu/entropy/h264_cabac.py:154
    def __init__(self, bw: BitWriter, slice_type: str, qp: int,
                 model: int = 0) -> None:
        # cabac_alignment_one_bit: slice data starts byte-aligned (7.3.4)
        while bw.num_bits() & 7:
            bw.write(1, 1)
        self.core = CabacEncoder(bw, init_states(slice_type, qp, model))

    # --- primitives ---
    # video_codecs_tpu/entropy/h264_cabac.py:162
    def bin(self, ctx: int, v: int) -> None:
        self.core.encode_bin(ctx, v)

    # video_codecs_tpu/entropy/h264_cabac.py:165
    def bypass(self, v: int) -> None:
        self.core.encode_bypass(v)

    # video_codecs_tpu/entropy/h264_cabac.py:168
    def final(self, v: int) -> None:
        """biari_encode_symbol_final (ctxIdx 276, fixed 2-LPS)."""
        self.core.encode_terminate(v)

    # video_codecs_tpu/entropy/h264_cabac.py:172
    def finish(self) -> None:
        """arienco_done_encoding at end_of_slice_flag == 1."""
        self.core.finish_slice()

    # video_codecs_tpu/entropy/h264_cabac.py:176
    def unary(self, symbol: int, ctx0: int, ctx_rest: int) -> None:
        """unary_bin_encode (cabac.c:178)."""
        if symbol == 0:
            self.bin(ctx0, 0)
            return
        self.bin(ctx0, 1)
        for _ in range(symbol - 1):
            self.bin(ctx_rest, 1)
        self.bin(ctx_rest, 0)

    # video_codecs_tpu/entropy/h264_cabac.py:186
    def unary_max(self, symbol: int, ctx: int, max_symbol: int) -> None:
        """unary_bin_max_encode with ctx_offset 0 (cabac.c:207)."""
        if symbol == 0:
            self.bin(ctx, 0)
            return
        self.bin(ctx, 1)
        for _ in range(symbol - 1):
            self.bin(ctx, 1)
        if symbol < max_symbol:
            self.bin(ctx, 0)

    # video_codecs_tpu/entropy/h264_cabac.py:197
    def exp_golomb_bypass(self, symbol: int, k: int) -> None:
        """exp_golomb_encode_eq_prob (cabac.c:148)."""
        while symbol >= (1 << k):
            self.bypass(1)
            symbol -= 1 << k
            k += 1
        self.bypass(0)
        for i in range(k - 1, -1, -1):
            self.bypass((symbol >> i) & 1)

    # video_codecs_tpu/entropy/h264_cabac.py:207
    def ueg_level(self, symbol: int, ctx: int) -> None:
        """unary_exp_golomb_level_encode (cabac.c:237): TU(13) + EG0."""
        if symbol == 0:
            self.bin(ctx, 0)
            return
        self.bin(ctx, 1)
        for _ in range(min(symbol, 13) - 1):
            self.bin(ctx, 1)
        if symbol < 13:
            self.bin(ctx, 0)
        else:
            self.exp_golomb_bypass(symbol - 13, 0)

    # video_codecs_tpu/entropy/h264_cabac.py:220
    def ueg_mv(self, symbol: int, ctx_base: int) -> None:
        """unary_exp_golomb_mv_encode (cabac.c:268): TU(8) ctx ladder + EG3.

        ctx_base indexes mv_res row 1; bins 1,2,3 advance the context, bins
        4.. share the last one (max_bin = 3).
        """
        if symbol == 0:
            self.bin(ctx_base, 0)
            return
        self.bin(ctx_base, 1)
        ctx = ctx_base + 1
        nbin = 1
        k = 1
        left = symbol
        while left - 1 > 0 and k + 1 <= 8:
            left -= 1
            k += 1
            self.bin(ctx, 1)
            nbin += 1
            if nbin == 2:
                ctx += 1
            if nbin == 3:  # max_bin
                ctx += 1
        if symbol < 8:
            self.bin(ctx, 0)
        else:
            self.exp_golomb_bypass(symbol - 8, 3)

    # --- macroblock-level syntax elements ---

    # video_codecs_tpu/entropy/h264_cabac.py:250
    def mb_skip_flag_p(self, skip: int, left_nonskip: int,
                       up_nonskip: int) -> None:
        """writeMB_Pskip_flagInfo_CABAC: 1 = skip."""
        ctx = off("mb_type", 1, left_nonskip + up_nonskip)
        self.bin(ctx, 1 if skip else 0)

    # video_codecs_tpu/entropy/h264_cabac.py:256
    def mb_type_i(self, act_sym: int, ctx_inc: int,
                  row: int = 0, base: int = 0) -> None:
        """writeMB_I_typeInfo_CABAC.  act_sym: 0 = I_4x4, 1..24 = I_16x16
        variants (1 + pred + 4*cbp_chroma + 12*cbp_luma), 25 = PCM.
        ctx_inc = a + b neighbor term.  For the intra suffix inside P
        slices, row/base select mb_type row 1 and context base 7-1=... the
        caller passes row=1, base=3 so ctx numbers 4..8 map to [1][7..10]."""
        r = row
        if base == 0:
            self.bin(off("mb_type", r, ctx_inc), 0 if act_sym == 0 else 1)
            if act_sym == 0:
                return
            if act_sym == 25:
                self.final(1)
                return
            self.final(0)
            c_ac, c_cbp1, c_cbp2, c_pm1, c_pm2 = 4, 5, 6, 7, 8
        else:
            # intra suffix in P slice (prefix bin already coded by caller):
            # contexts 8, 9, 9, 10, 10 of row 1 (writeMB_P_typeInfo :577)
            if act_sym == 25:
                self.final(1)
                return
            self.final(0)
            c_ac, c_cbp1, c_cbp2, c_pm1, c_pm2 = 8, 9, 9, 10, 10
        mode_sym = act_sym - 1
        self.bin(off("mb_type", r, c_ac), mode_sym // 12)
        mode_sym %= 12
        cbp = mode_sym >> 2
        if cbp == 0:
            self.bin(off("mb_type", r, c_cbp1), 0)
        else:
            self.bin(off("mb_type", r, c_cbp1), 1)
            self.bin(off("mb_type", r, c_cbp2), 1 if cbp != 1 else 0)
        mode_sym &= 3
        self.bin(off("mb_type", r, c_pm1), mode_sym >> 1)
        self.bin(off("mb_type", r, c_pm2), mode_sym & 1)

    # video_codecs_tpu/entropy/h264_cabac.py:294
    def mb_type_p(self, act_sym: int, i16_sym: int = 0) -> None:
        """writeMB_P_typeInfo_CABAC.  act_sym: 1 = P_L0_16x16,
        2 = P_L0_L0_16x8, 3 = P_L0_L0_8x16, 4/5 = P_8x8, 6 = I_4x4,
        7 = I_16x16 (i16_sym = 0..23 selects the variant, 24 = PCM)."""
        r = 1
        if act_sym == 1:
            for c, v in ((4, 0), (5, 0), (6, 0)):
                self.bin(off("mb_type", r, c), v)
        elif act_sym == 2:
            for c, v in ((4, 0), (5, 1), (7, 1)):
                self.bin(off("mb_type", r, c), v)
        elif act_sym == 3:
            for c, v in ((4, 0), (5, 1), (7, 0)):
                self.bin(off("mb_type", r, c), v)
        elif act_sym in (4, 5):
            for c, v in ((4, 0), (5, 0), (6, 1)):
                self.bin(off("mb_type", r, c), v)
        elif act_sym == 6:
            self.bin(off("mb_type", r, 4), 1)
            self.bin(off("mb_type", r, 7), 0)
        elif act_sym == 7:
            self.bin(off("mb_type", r, 4), 1)
            self.bin(off("mb_type", r, 7), 1)
            self.mb_type_i(1 + i16_sym if i16_sym < 24 else 25, 0,
                           row=1, base=3)
            return
        else:
            raise AssertionError(act_sym)

    # video_codecs_tpu/entropy/h264_cabac.py:323
    def sub_mb_type_p(self, v: int) -> None:
        """writeB8_typeInfo_CABAC, P rows (cabac.c:584): sub_mb_type
        0 = 8x8 '1'@ctx1, 1 = 8x4 '00'@1,3, 2 = 4x8 '011'@1,3,4,
        3 = 4x4 '010' (spec Table 9-38)."""
        if v == 0:
            self.bin(off("b8_type", 0, 1), 1)
            return
        self.bin(off("b8_type", 0, 1), 0)
        if v == 1:
            self.bin(off("b8_type", 0, 3), 0)
            return
        self.bin(off("b8_type", 0, 3), 1)
        self.bin(off("b8_type", 0, 4), 1 if v == 2 else 0)

    # video_codecs_tpu/entropy/h264_cabac.py:337
    def sub_mb_type_b(self, v: int) -> None:
        """writeB8_typeInfo_CABAC, B rows (cabac.c:584 / spec 9.3.2.5):
        sub_mb_type 0 = B_Direct_8x8 '0'@ctx0; 1/2 = L0/L1 8x8
        '1 0 b'@ctx0,1,3; 3..6 '1 1 0 b b'@ctx0,1,2,3,3;
        7..10 '1 1 1 0 b b'; 11/12 '1 1 1 1 b' (all tail bins @ctx3)."""
        if v == 0:
            self.bin(off("b8_type", 1, 0), 0)
            return
        self.bin(off("b8_type", 1, 0), 1)
        a = v - 1
        if a < 2:
            self.bin(off("b8_type", 1, 1), 0)
            self.bin(off("b8_type", 1, 3), a)
            return
        self.bin(off("b8_type", 1, 1), 1)
        if a < 6:
            self.bin(off("b8_type", 1, 2), 0)
            self.bin(off("b8_type", 1, 3), ((a - 2) >> 1) & 1)
            self.bin(off("b8_type", 1, 3), (a - 2) & 1)
            return
        self.bin(off("b8_type", 1, 2), 1)
        if a < 10:
            self.bin(off("b8_type", 1, 3), 0)
            self.bin(off("b8_type", 1, 3), ((a - 6) >> 1) & 1)
            self.bin(off("b8_type", 1, 3), (a - 6) & 1)
        else:
            self.bin(off("b8_type", 1, 3), 1)
            self.bin(off("b8_type", 1, 3), a - 10)

    # video_codecs_tpu/entropy/h264_cabac.py:366
    def mb_skip_flag_b(self, skip: int, left_nonskip: int,
                       up_nonskip: int) -> None:
        """writeMB_Bskip_flagInfo_CABAC (cabac.c:456): 1 = skip
        (B_Direct_16x16 with no coefficients).  Neighbor terms use the
        same skip_flag semantics."""
        ctx = off("mb_type", 2, 7 + left_nonskip + up_nonskip)
        self.bin(ctx, 1 if skip else 0)

    # video_codecs_tpu/entropy/h264_cabac.py:374
    def mb_type_b(self, act_sym: int, ctx_inc: int, i16_sym: int = 0) -> None:
        """writeMB_B_typeInfo_CABAC (cabac.c:626).  act_sym is the CAVLC
        B mb_type code: 0 = B_Direct_16x16, 1 = B_L0_16x16,
        2 = B_L1_16x16, 3 = B_Bi_16x16, 4..21 = the two-partition types,
        22 = B_8x8, 23 = I_4x4, 24 = I_16x16 (i16_sym 0..23, 24 = PCM).
        ctx_inc = a + b, neighbor term = neighbor present and not direct."""
        r = 2
        if act_sym == 0:
            self.bin(off("mb_type", r, ctx_inc), 0)
            return
        self.bin(off("mb_type", r, ctx_inc), 1)
        if act_sym <= 2:
            self.bin(off("mb_type", r, 4), 0)
            self.bin(off("mb_type", r, 6), 1 if act_sym != 1 else 0)
            return
        self.bin(off("mb_type", r, 4), 1)
        if act_sym <= 10:
            t = act_sym - 3
            self.bin(off("mb_type", r, 5), 0)
            for sh in (2, 1, 0):
                self.bin(off("mb_type", r, 6), (t >> sh) & 1)
            return
        self.bin(off("mb_type", r, 5), 1)
        if act_sym in (11, 22):
            self.bin(off("mb_type", r, 6), 1)
            self.bin(off("mb_type", r, 6), 1)
            self.bin(off("mb_type", r, 6), 1 if act_sym != 11 else 0)
            return
        t = act_sym - 13 if act_sym > 22 else act_sym - 12
        for sh in (3, 2, 1, 0):
            self.bin(off("mb_type", r, 6), (t >> sh) & 1)
        if act_sym >= 24:   # I_16x16 suffix (row-1 contexts 8,9,9,10,10)
            self.mb_type_i(1 + i16_sym if i16_sym < 24 else 25, 0,
                           row=1, base=3)

    # video_codecs_tpu/entropy/h264_cabac.py:409
    def intra4x4_pred_mode(self, mode: int, pred: int) -> None:
        """writeIntraPredMode_CABAC: prev flag + 3 fixed-ctx rem bins."""
        if mode == pred:
            self.bin(off("ipr", 0), 1)
            return
        rem = mode if mode < pred else mode - 1
        self.bin(off("ipr", 0), 0)
        self.bin(off("ipr", 1), rem & 1)
        self.bin(off("ipr", 1), (rem >> 1) & 1)
        self.bin(off("ipr", 1), (rem >> 2) & 1)

    # video_codecs_tpu/entropy/h264_cabac.py:420
    def transform_size_8x8_flag(self, flag: int, ctx_inc: int) -> None:
        """writeMB_transform_size_flag_CABAC (cabac.c:498): ctx_inc =
        left.trans8 + up.trans8."""
        self.bin(off("transform_size", ctx_inc), flag)

    # video_codecs_tpu/entropy/h264_cabac.py:425
    def intra_chroma_pred_mode(self, mode: int, ctx_inc: int) -> None:
        """writeCIPredMode_CABAC."""
        if mode == 0:
            self.bin(off("cipr", ctx_inc), 0)
            return
        self.bin(off("cipr", ctx_inc), 1)
        self.unary_max(mode - 1, off("cipr", 3), 2)

    # video_codecs_tpu/entropy/h264_cabac.py:433
    def cbp(self, cbp: int, up: dict | None, left: dict | None) -> None:
        """writeCBP_CABAC.  up/left: neighbor dicts with 'cbp' and 'ipcm'
        keys (None = unavailable)."""
        for b8 in range(4):
            mb_x = (b8 & 1) << 1
            mb_y = (b8 >> 1) << 1
            if mb_y == 0:
                b = 0
                if up is not None and not up["ipcm"]:
                    b = 1 if (up["cbp"] & (1 << (2 + (mb_x >> 1)))) == 0 else 0
            else:
                b = 1 if (cbp & (1 << (mb_x >> 1))) == 0 else 0
            if mb_x == 0:
                a = 0
                if left is not None and not left["ipcm"]:
                    a = 1 if (left["cbp"] & (1 << (2 * (mb_y >> 1) + 1))) \
                        == 0 else 0
            else:
                a = 1 if (cbp & (1 << mb_y)) == 0 else 0
            self.bin(off("cbp", 0, a + 2 * b),
                     1 if cbp & (1 << b8) else 0)
        # chroma part (4:2:0)
        b0 = 2 if (up is not None and (up["ipcm"] or up["cbp"] > 15)) else 0
        a0 = 1 if (left is not None and
                   (left["ipcm"] or left["cbp"] > 15)) else 0
        self.bin(off("cbp", 1, a0 + b0), 1 if cbp > 15 else 0)
        if cbp > 15:
            b1 = 2 if (up is not None and
                       (up["ipcm"] or (up["cbp"] > 15 and
                                       (up["cbp"] >> 4) == 2))) else 0
            a1 = 1 if (left is not None and
                       (left["ipcm"] or (left["cbp"] > 15 and
                                         (left["cbp"] >> 4) == 2))) else 0
            self.bin(off("cbp", 2, a1 + b1), 1 if (cbp >> 4) == 2 else 0)

    # video_codecs_tpu/entropy/h264_cabac.py:468
    def mb_qp_delta(self, dquant: int, prev_nonzero: bool) -> None:
        """writeDquant_CABAC."""
        sign = 0 if dquant <= 0 else -1
        act_sym = (abs(dquant) << 1) + sign
        ctx = off("delta_qp", 1 if prev_nonzero else 0)
        if act_sym == 0:
            self.bin(ctx, 0)
            return
        self.bin(ctx, 1)
        self.unary(act_sym - 1, off("delta_qp", 2), off("delta_qp", 3))

    # video_codecs_tpu/entropy/h264_cabac.py:479
    def ref_idx(self, ref: int, ctx_inc: int) -> None:
        """writeRefPic_P_CABAC (list 0)."""
        if ref == 0:
            self.bin(off("ref_no", 0, ctx_inc), 0)
            return
        self.bin(off("ref_no", 0, ctx_inc), 1)
        self.unary(ref - 1, off("ref_no", 0, 4), off("ref_no", 0, 5))

    # video_codecs_tpu/entropy/h264_cabac.py:487
    def mvd(self, mvd: int, comp: int, local_err: int) -> None:
        """writeMVD_CABAC.  comp: 0 = x, 1 = y; local_err = |mvdA| + |mvdB|
        of the neighbors for this component."""
        if local_err < 3:
            ctx_inc = 5 * comp
        elif local_err > 32:
            ctx_inc = 5 * comp + 3
        else:
            ctx_inc = 5 * comp + 2
        a = abs(mvd)
        if a == 0:
            self.bin(off("mv_res", 0, ctx_inc), 0)
            return
        self.bin(off("mv_res", 0, ctx_inc), 1)
        self.ueg_mv(a - 1, off("mv_res", 1, 5 * comp))
        self.bypass(1 if mvd < 0 else 0)

    # video_codecs_tpu/entropy/h264_cabac.py:504
    def residual_block(self, block_type: int, coeffs: list[int],
                       cbf_ctx: int, code_cbf: bool = True) -> None:
        """coded_block_flag + significance map + levels for one block.

        coeffs: scan-ordered coefficient list for this block type (len 16
        for LUMA_16DC/LUMA_4x4, 15 for *_AC, 4 for CHROMA_DC).
        cbf_ctx: (upper_bit << 1) + left_bit for the coded_block_flag.
        """
        nz = [c for c in coeffs if c != 0]
        if code_cbf:
            self.bin(off("bcbp", TYPE2CTX_BCBP[block_type], cbf_ctx),
                     1 if nz else 0)
        if not nz:
            return
        # significance map (write_significance_map :1735)
        maxpos = MAXPOS[block_type]
        c1isdc = C1ISDC[block_type]
        mctx = TYPE2CTX_MAP[block_type]
        p2m = POS2CTX_MAP[block_type]
        p2l = POS2CTX_LAST[block_type]
        coeff_ctr = len(nz)
        k0, k1 = 0, maxpos
        koff = 0
        if not c1isdc:
            k0 += 1
            k1 += 1
            koff = 1  # coeff[k] refers to coeffs[k - 1]
        for k in range(k0, k1):
            sig = 1 if coeffs[k - koff] != 0 else 0
            self.bin(off("map", mctx, p2m[k]), sig)
            if sig:
                coeff_ctr -= 1
                last = 1 if coeff_ctr == 0 else 0
                self.bin(off("last", mctx, p2l[k]), last)
                if last:
                    break
        # levels in reverse scan order (write_significant_coefficients)
        octx = TYPE2CTX_ONE[block_type]
        c1, c2 = 1, 0
        for i in range(maxpos, -1, -1):
            if i >= len(coeffs) or coeffs[i] == 0:
                continue
            a = abs(coeffs[i])
            g1 = 1 if a > 1 else 0
            self.bin(off("one", octx, min(c1, 4)), g1)
            if g1:
                self.ueg_level(a - 2, off("abs", octx,
                                          min(c2, MAX_C2[block_type])))
                c2 += 1
                c1 = 0
            elif c1:
                c1 += 1
            self.bypass(1 if coeffs[i] < 0 else 0)


# video_codecs_tpu/entropy/h264_cabac.py:559
class CbfState:
    """Per-picture coded_block_flag neighbor bits (cbp_bits in JM,
    write_and_store_CBP_block_bit :1630).

    Bit layout per MB (64-bit int): 0 = luma DC, 1 + 4*by + bx = luma 4x4
    block (bx, by), 17 = U DC, 18 = V DC, 19 + 4*by + bx = U AC block,
    35 + 4*by + bx = V AC block (4:2:0: bx, by in 0..1).
    """

    LUMA_DC_BIT = 0
    U_DC_BIT, V_DC_BIT = 17, 18
    U_AC_BASE, V_AC_BASE = 19, 35

    # video_codecs_tpu/entropy/h264_cabac.py:572
    def __init__(self, mbw: int, mbh: int) -> None:
        self.mbw, self.mbh = mbw, mbh
        self.bits = np.zeros((mbh, mbw), np.int64)
        self.decoded = np.zeros((mbh, mbw), bool)

    # video_codecs_tpu/entropy/h264_cabac.py:577
    def _bit(self, mbx, mby, bit, default):
        if mbx < 0 or mby < 0 or not self.decoded[mby, mbx]:
            return default
        return int(self.bits[mby, mbx] >> bit) & 1

    # video_codecs_tpu/entropy/h264_cabac.py:582
    def set_bit(self, mbx, mby, bit, v=1):
        if v:
            self.bits[mby, mbx] |= np.int64(1) << np.int64(bit)

    # video_codecs_tpu/entropy/h264_cabac.py:586
    def mark(self, mbx, mby):
        self.decoded[mby, mbx] = True

    # video_codecs_tpu/entropy/h264_cabac.py:589
    def ctx_dc(self, mbx, mby, bit, cur_intra):
        """cbf ctx for a DC block (luma DC / chroma DC): left+up MB bits."""
        d = 1 if cur_intra else 0
        left = self._bit(mbx - 1, mby, bit, d)
        up = self._bit(mbx, mby - 1, bit, d)
        return (up << 1) + left

    # video_codecs_tpu/entropy/h264_cabac.py:596
    def ctx_ac(self, mbx, mby, bx, by, base, nblk, cur_bits, cur_intra):
        """cbf ctx for an AC/4x4 block at (bx, by) in nblk x nblk units."""
        d = 1 if cur_intra else 0
        if bx > 0:
            left = int(cur_bits >> (base + 4 * by + bx - 1)) & 1
        else:
            left = self._bit(mbx - 1, mby, base + 4 * by + (nblk - 1), d)
        if by > 0:
            up = int(cur_bits >> (base + 4 * (by - 1) + bx)) & 1
        else:
            up = self._bit(mbx, mby - 1, base + 4 * (nblk - 1) + bx, d)
        return (up << 1) + left


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

# video_codecs_tpu/entropy/h264_cabac.py:614
class H264CabacDecoder:
    """Mirror of H264CabacEncoder (ldecod/src/cabac.c)."""

    # video_codecs_tpu/entropy/h264_cabac.py:617
    def __init__(self, br: BitReader, slice_type: str, qp: int,
                 model: int = 0) -> None:
        br.byte_align()  # cabac_alignment_one_bit
        self.core = CabacDecoder(br, init_states(slice_type, qp, model))

    # video_codecs_tpu/entropy/h264_cabac.py:622
    def bin(self, ctx: int) -> int:
        return self.core.decode_bin(ctx)

    # video_codecs_tpu/entropy/h264_cabac.py:625
    def bypass(self) -> int:
        return self.core.decode_bypass()

    # video_codecs_tpu/entropy/h264_cabac.py:628
    def final(self) -> int:
        return self.core.decode_terminate()

    # video_codecs_tpu/entropy/h264_cabac.py:631
    def unary(self, ctx0: int, ctx_rest: int) -> int:
        if not self.bin(ctx0):
            return 0
        v = 1
        while self.bin(ctx_rest):
            v += 1
        return v

    # video_codecs_tpu/entropy/h264_cabac.py:639
    def unary_max(self, ctx: int, max_symbol: int) -> int:
        if not self.bin(ctx):
            return 0
        v = 1
        while v < max_symbol and self.bin(ctx):
            v += 1
        return v

    # video_codecs_tpu/entropy/h264_cabac.py:647
    def exp_golomb_bypass(self, k: int) -> int:
        v = 0
        while self.bypass():
            v += 1 << k
            k += 1
        suffix = 0
        for _ in range(k):
            suffix = (suffix << 1) | self.bypass()
        return v + suffix

    # video_codecs_tpu/entropy/h264_cabac.py:657
    def ueg_level(self, ctx: int) -> int:
        if not self.bin(ctx):
            return 0
        v = 1
        while v < 13 and self.bin(ctx):
            v += 1
        if v == 13:
            v += self.exp_golomb_bypass(0)
        return v

    # video_codecs_tpu/entropy/h264_cabac.py:667
    def ueg_mv(self, ctx_base: int) -> int:
        if not self.bin(ctx_base):
            return 0
        ctx = ctx_base + 1
        nbin = 1
        v = 1
        while v < 8:
            if not self.bin(ctx):
                return v
            v += 1
            nbin += 1
            if nbin == 2:
                ctx += 1
            if nbin == 3:
                ctx += 1
        return 8 + self.exp_golomb_bypass(3)

    # --- macroblock-level ---

    # video_codecs_tpu/entropy/h264_cabac.py:686
    def mb_skip_flag_p(self, left_nonskip: int, up_nonskip: int) -> int:
        return self.bin(off("mb_type", 1, left_nonskip + up_nonskip))

    # video_codecs_tpu/entropy/h264_cabac.py:689
    def mb_type_i(self, ctx_inc: int, row: int = 0, base: int = 0) -> int:
        r = row
        if base == 0:
            if not self.bin(off("mb_type", r, ctx_inc)):
                return 0
            if self.final():
                return 25
            c_ac, c_cbp1, c_cbp2, c_pm1, c_pm2 = 4, 5, 6, 7, 8
        else:
            if self.final():
                return 25
            c_ac, c_cbp1, c_cbp2, c_pm1, c_pm2 = 8, 9, 9, 10, 10
        ac = self.bin(off("mb_type", r, c_ac))
        if self.bin(off("mb_type", r, c_cbp1)):
            cbp = 2 if self.bin(off("mb_type", r, c_cbp2)) else 1
        else:
            cbp = 0
        pm = (self.bin(off("mb_type", r, c_pm1)) << 1) | \
            self.bin(off("mb_type", r, c_pm2))
        return 1 + ac * 12 + cbp * 4 + pm

    # video_codecs_tpu/entropy/h264_cabac.py:710
    def mb_type_p(self) -> tuple[int, int]:
        """Returns (act_sym, i16_sym) per mb_type_p conventions."""
        r = 1
        if self.bin(off("mb_type", r, 4)):  # intra prefix
            if not self.bin(off("mb_type", r, 7)):
                return 6, 0
            sym = self.mb_type_i(0, row=1, base=3)
            return 7, (24 if sym == 25 else sym - 1)
        if self.bin(off("mb_type", r, 5)):
            return (2, 0) if self.bin(off("mb_type", r, 7)) else (3, 0)
        return (4, 0) if self.bin(off("mb_type", r, 6)) else (1, 0)

    # video_codecs_tpu/entropy/h264_cabac.py:722
    def sub_mb_type_p(self) -> int:
        """readB8_typeInfo_CABAC_p_slice (ldecod cabac.c): ctx 1/3/4."""
        if self.bin(off("b8_type", 0, 1)):
            return 0
        if not self.bin(off("b8_type", 0, 3)):
            return 1
        return 2 if self.bin(off("b8_type", 0, 4)) else 3

    # video_codecs_tpu/entropy/h264_cabac.py:730
    def sub_mb_type_b(self) -> int:
        """readB8_typeInfo_CABAC_b_slice (ldecod cabac.c)."""
        if not self.bin(off("b8_type", 1, 0)):
            return 0
        if not self.bin(off("b8_type", 1, 1)):
            return 1 + self.bin(off("b8_type", 1, 3))
        if not self.bin(off("b8_type", 1, 2)):
            a = 2 + ((self.bin(off("b8_type", 1, 3)) << 1)
                     | self.bin(off("b8_type", 1, 3)))
        elif self.bin(off("b8_type", 1, 3)):
            a = 10 + self.bin(off("b8_type", 1, 3))
        else:
            a = 6 + ((self.bin(off("b8_type", 1, 3)) << 1)
                     | self.bin(off("b8_type", 1, 3)))
        return a + 1

    # video_codecs_tpu/entropy/h264_cabac.py:746
    def mb_skip_flag_b(self, left_nonskip: int, up_nonskip: int) -> int:
        return self.bin(off("mb_type", 2, 7 + left_nonskip + up_nonskip))

    # video_codecs_tpu/entropy/h264_cabac.py:749
    def mb_type_b(self, ctx_inc: int) -> tuple[int, int]:
        """Returns (act_sym, i16_sym) per mb_type_b conventions."""
        r = 2
        if not self.bin(off("mb_type", r, ctx_inc)):
            return 0, 0
        if not self.bin(off("mb_type", r, 4)):
            return 1 + self.bin(off("mb_type", r, 6)), 0
        if not self.bin(off("mb_type", r, 5)):
            t = (self.bin(off("mb_type", r, 6)) << 2) | \
                (self.bin(off("mb_type", r, 6)) << 1) | \
                self.bin(off("mb_type", r, 6))
            return 3 + t, 0
        if self.bin(off("mb_type", r, 6)):
            if self.bin(off("mb_type", r, 6)):
                return (22 if self.bin(off("mb_type", r, 6)) else 11), 0
            t = 8 + ((self.bin(off("mb_type", r, 6)) << 1) |
                     self.bin(off("mb_type", r, 6)))
            if t <= 9:
                return t + 12, 0
            if t == 10:
                return 23, 0
            sym = self.mb_type_i(0, row=1, base=3)
            return 24, (24 if sym == 25 else sym - 1)
        t = (self.bin(off("mb_type", r, 6)) << 2) | \
            (self.bin(off("mb_type", r, 6)) << 1) | \
            self.bin(off("mb_type", r, 6))
        return 12 + t, 0

    # video_codecs_tpu/entropy/h264_cabac.py:777
    def intra4x4_pred_mode(self, pred: int) -> int:
        if self.bin(off("ipr", 0)):
            return pred
        rem = (self.bin(off("ipr", 1)) |
               (self.bin(off("ipr", 1)) << 1) |
               (self.bin(off("ipr", 1)) << 2))
        return rem if rem < pred else rem + 1

    # video_codecs_tpu/entropy/h264_cabac.py:785
    def transform_size_8x8_flag(self, ctx_inc: int) -> int:
        return self.bin(off("transform_size", ctx_inc))

    # video_codecs_tpu/entropy/h264_cabac.py:788
    def intra_chroma_pred_mode(self, ctx_inc: int) -> int:
        if not self.bin(off("cipr", ctx_inc)):
            return 0
        return 1 + self.unary_max(off("cipr", 3), 2)

    # video_codecs_tpu/entropy/h264_cabac.py:793
    def cbp(self, up: dict | None, left: dict | None) -> int:
        cbp = 0
        for b8 in range(4):
            mb_x = (b8 & 1) << 1
            mb_y = (b8 >> 1) << 1
            if mb_y == 0:
                b = 0
                if up is not None and not up["ipcm"]:
                    b = 1 if (up["cbp"] & (1 << (2 + (mb_x >> 1)))) == 0 else 0
            else:
                b = 1 if (cbp & (1 << (mb_x >> 1))) == 0 else 0
            if mb_x == 0:
                a = 0
                if left is not None and not left["ipcm"]:
                    a = 1 if (left["cbp"] & (1 << (2 * (mb_y >> 1) + 1))) \
                        == 0 else 0
            else:
                a = 1 if (cbp & (1 << mb_y)) == 0 else 0
            if self.bin(off("cbp", 0, a + 2 * b)):
                cbp |= 1 << b8
        b0 = 2 if (up is not None and (up["ipcm"] or up["cbp"] > 15)) else 0
        a0 = 1 if (left is not None and
                   (left["ipcm"] or left["cbp"] > 15)) else 0
        if self.bin(off("cbp", 1, a0 + b0)):
            b1 = 2 if (up is not None and
                       (up["ipcm"] or (up["cbp"] > 15 and
                                       (up["cbp"] >> 4) == 2))) else 0
            a1 = 1 if (left is not None and
                       (left["ipcm"] or (left["cbp"] > 15 and
                                         (left["cbp"] >> 4) == 2))) else 0
            cbp |= (2 if self.bin(off("cbp", 2, a1 + b1)) else 1) << 4
        return cbp

    # video_codecs_tpu/entropy/h264_cabac.py:826
    def mb_qp_delta(self, prev_nonzero: bool) -> int:
        ctx = off("delta_qp", 1 if prev_nonzero else 0)
        if not self.bin(ctx):
            return 0
        act_sym = 1 + self.unary(off("delta_qp", 2), off("delta_qp", 3))
        # act_sym = (|dquant| << 1) + sign, sign: 0 neg/zero, -1 pos
        if act_sym & 1:
            return (act_sym + 1) >> 1
        return -(act_sym >> 1)

    # video_codecs_tpu/entropy/h264_cabac.py:836
    def ref_idx(self, ctx_inc: int) -> int:
        if not self.bin(off("ref_no", 0, ctx_inc)):
            return 0
        return 1 + self.unary(off("ref_no", 0, 4), off("ref_no", 0, 5))

    # video_codecs_tpu/entropy/h264_cabac.py:841
    def mvd(self, comp: int, local_err: int) -> int:
        if local_err < 3:
            ctx_inc = 5 * comp
        elif local_err > 32:
            ctx_inc = 5 * comp + 3
        else:
            ctx_inc = 5 * comp + 2
        if not self.bin(off("mv_res", 0, ctx_inc)):
            return 0
        a = 1 + self.ueg_mv(off("mv_res", 1, 5 * comp))
        return -a if self.bypass() else a

    # video_codecs_tpu/entropy/h264_cabac.py:853
    def residual_block(self, block_type: int, length: int, cbf_ctx: int,
                       code_cbf: bool = True) -> list[int]:
        if code_cbf:
            if not self.bin(off("bcbp", TYPE2CTX_BCBP[block_type], cbf_ctx)):
                return [0] * length
        maxpos = MAXPOS[block_type]
        c1isdc = C1ISDC[block_type]
        mctx = TYPE2CTX_MAP[block_type]
        p2m = POS2CTX_MAP[block_type]
        p2l = POS2CTX_LAST[block_type]
        sig = [0] * length
        k0, k1 = 0, maxpos
        koff = 0
        if not c1isdc:
            k0 += 1
            k1 += 1
            koff = 1
        got_last = False
        nsig = 0
        for k in range(k0, k1):
            if self.bin(off("map", mctx, p2m[k])):
                sig[k - koff] = 1
                nsig += 1
                if self.bin(off("last", mctx, p2l[k])):
                    got_last = True
                    break
        if not got_last:
            sig[maxpos - koff if c1isdc else maxpos] = 1
            nsig += 1
        # levels, reverse scan order
        octx = TYPE2CTX_ONE[block_type]
        coeffs = [0] * length
        c1, c2 = 1, 0
        for i in range(length - 1, -1, -1):
            if not sig[i]:
                continue
            if self.bin(off("one", octx, min(c1, 4))):
                a = 2 + self.ueg_level(off("abs", octx,
                                           min(c2, MAX_C2[block_type])))
                c2 += 1
                c1 = 0
            else:
                a = 1
                if c1:
                    c1 += 1
            coeffs[i] = -a if self.bypass() else a
        return coeffs
