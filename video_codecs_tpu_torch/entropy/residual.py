"""HEVC residual_coding syntax (spec 7.3.8.11 / 9.3.4.2.5-7), encode+decode.

The port's copy of video_codecs_tpu/entropy/residual.py, whole and as it
is; each function keeps its name and a comment gives the original's
line.

Parity references: hm-16.5rc1/source/Lib/TLibEncoder/TEncSbac.cpp codeCoeffNxN,
TLibDecoder/TDecSbac.cpp parseCoeffNxN, TLibCommon/TComTrQuant.cpp:
getSigCtxInc (context pattern switch), TComChromaFormat.cpp:96
getTUEntropyCodingParameters (firstSignificanceMapContext selection),
TComRom.cpp:589-598 (ctxIndMap4x4, g_uiGroupIdx, g_uiMinInGroup).

Host-side sequential syntax layer: operates on one TU's level block at a
time (numpy int32 [N, N], raster order [y][x]).  Sign data hiding and
transform skip not yet emitted (PPS flags off).
"""

from __future__ import annotations

import numpy as np

from video_codecs_tpu_torch.entropy import ctx as ctx_mod
from video_codecs_tpu_torch.entropy.cabac import CabacDecoder, CabacEncoder
from video_codecs_tpu_torch.utils import rom

GROUP_IDX = np.array([0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
                      8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9],
                     np.int32)
MIN_IN_GROUP = np.array([0, 1, 2, 3, 4, 6, 8, 12, 16, 24], np.int32)
CTX_IND_MAP_4x4 = np.array([0, 1, 4, 5, 2, 3, 4, 5,
                            6, 6, 8, 8, 7, 7, 8, 8], np.int32)

# significanceMapContextSetStart / sizes (ContextTables.h:85-88).
_SIG_START = {True: {"4x4": 0, "8x8": 9, "NxN": 21, "single": 27},
              False: {"4x4": 0, "8x8": 9, "NxN": 12, "single": 15}}
_NON_DIAG_8x8_OFFSET = {True: 6, False: 0}
_NOT_FIRST_GROUP_OFFSET = {True: 3, False: 0}
_SIG_CHROMA_BASE = 28  # luma sig contexts come first


# video_codecs_tpu/entropy/residual.py:37
def first_sig_map_ctx(log2_size: int, scan_type: int, is_luma: bool) -> int:
    if log2_size == 2:
        return _SIG_START[is_luma]["4x4"]
    if log2_size == 3:
        base = _SIG_START[is_luma]["8x8"]
        if scan_type != rom.SCAN_DIAG:
            base += _NON_DIAG_8x8_OFFSET[is_luma]
        return base
    return _SIG_START[is_luma]["NxN"]


# video_codecs_tpu/entropy/residual.py:48
def sig_ctx_inc(pattern: int, pos_x: int, pos_y: int, log2_size: int,
                is_luma: bool, first_ctx: int) -> int:
    """Context offset for sig_coeff_flag (TComTrQuant.cpp getSigCtxInc)."""
    if pos_x + pos_y == 0:
        return 0
    if log2_size == 2:
        return first_ctx + int(CTX_IND_MAP_4x4[4 * pos_y + pos_x])
    xp, yp = pos_x & 3, pos_y & 3
    if pattern == 0:
        tot = xp + yp
        cnt = 0 if tot >= 3 else (1 if tot >= 1 else 2)
    elif pattern == 1:
        cnt = 0 if yp >= 2 else (1 if yp >= 1 else 2)
    elif pattern == 2:
        cnt = 0 if xp >= 2 else (1 if xp >= 1 else 2)
    else:
        cnt = 2
    not_first_group = (pos_x >> 2) + (pos_y >> 2) > 0
    offset = (_NOT_FIRST_GROUP_OFFSET[is_luma] if not_first_group else 0) + cnt
    return first_ctx + offset


# video_codecs_tpu/entropy/residual.py:70
def _last_ctx_params(log2_size: int, is_luma: bool) -> tuple[int, int]:
    """(ctx offset into the 30-entry last_x/last_y arrays, ctx shift).

    Luma uses size-dependent offsets within contexts 0..14; chroma always
    starts at context 15 (TEncSbac codeLastSignificantXY blkSizeOffset).
    """
    if is_luma:
        return 3 * (log2_size - 2) + ((log2_size - 1) >> 2), (log2_size + 1) >> 2
    return 15, log2_size - 2


# video_codecs_tpu/entropy/residual.py:81
def encode_residual(enc: CabacEncoder, levels: np.ndarray, log2_size: int,
                    scan_type: int, is_luma: bool,
                    sign_hiding: bool = False) -> None:
    """Encode one TU's quantized levels [N, N] (raster [y][x], signed)."""
    n = 1 << log2_size
    scan = rom.scan_order(log2_size, scan_type)
    flat = levels.reshape(-1)
    coeffs = flat[scan]  # scan order
    nz = np.nonzero(coeffs)[0]
    assert nz.size > 0, "encode_residual requires cbf=1"
    last_scan_pos = int(nz[-1])

    # --- last position ---
    last_raster = int(scan[last_scan_pos])
    last_y, last_x = divmod(last_raster, n)
    if scan_type == rom.SCAN_VER:
        last_x, last_y = last_y, last_x
    _encode_last_xy(enc, last_x, last_y, log2_size, is_luma)

    # --- per coefficient-group coding ---
    num_cg = (n * n) >> 4
    cg_w = max(n >> 2, 1)
    cg_scan = rom.cg_scan_order(log2_size, scan_type)
    last_cg = last_scan_pos >> 4
    csbf = np.zeros(num_cg, np.int32)  # indexed by cg raster position
    for i in range(num_cg):
        cg_r = int(cg_scan[i])
        csbf[cg_r] = int(np.any(coeffs[i * 16:(i + 1) * 16] != 0))

    c1 = 1
    for i in range(last_cg, -1, -1):
        cg_raster = int(cg_scan[i])
        cg_y, cg_x = divmod(cg_raster, cg_w)
        right = int(csbf[cg_raster + 1]) if cg_x + 1 < cg_w else 0
        below = int(csbf[cg_raster + cg_w]) if cg_y + 1 < cg_w else 0
        pattern = right + 2 * below

        infer_sb_dc = 0
        if i < last_cg and i > 0:
            ctx = ctx_mod.off("sig_cg", (1 if (right or below) else 0) +
                              (0 if is_luma else 2))
            enc.encode_bin(ctx, int(csbf[cg_raster]))
            infer_sb_dc = 1
            if not csbf[cg_raster]:
                continue
        # The last CG and CG 0 are inferred significant (spec 7.3.8.11):
        # their sig flags are always coded, even if all zero (CG 0 case).

        cg_coeffs = coeffs[i * 16:(i + 1) * 16]
        inner = rom.scan_order(2, scan_type)  # 4x4 scan within CG
        first_ctx = first_sig_map_ctx(log2_size, scan_type, is_luma)
        sig_base = ctx_mod.off("sig_flag", 0 if is_luma else _SIG_CHROMA_BASE)
        single = first_ctx == _SIG_START[is_luma]["single"]

        start_n = (last_scan_pos - i * 16 - 1) if i == last_cg else 15
        num_sig_found = 0
        for nn in range(start_n, -1, -1):
            sig = int(cg_coeffs[nn] != 0)
            if nn > 0 or not infer_sb_dc:
                r_in = int(inner[nn])
                py, px = divmod(r_in, 4)
                pos_x = (cg_x << 2) + px
                pos_y = (cg_y << 2) + py
                if single:
                    sc = first_ctx
                else:
                    sc = sig_ctx_inc(pattern, pos_x, pos_y, log2_size,
                                     is_luma, first_ctx)
                enc.encode_bin(sig_base + sc, sig)
            if sig:
                infer_sb_dc = 0
                num_sig_found += 1

        # --- level coding within the CG ---
        sig_pos = [nn for nn in range(15, -1, -1)
                   if cg_coeffs[nn] != 0]  # reverse scan order (high->low)
        if not sig_pos:
            continue  # inferred-significant CG with no coeffs: no level data
        abs_coeff = [int(abs(cg_coeffs[nn])) for nn in sig_pos]
        signs = [1 if cg_coeffs[nn] < 0 else 0 for nn in sig_pos]

        hidden = sign_hiding and (sig_pos[0] - sig_pos[-1] > 3)

        ctx_set = (0 if (i == 0 or not is_luma) else 2)
        if c1 == 0:
            ctx_set += 1
        c1 = 1
        one_base = ctx_mod.off("one_flag",
                               (ctx_set * 4) if is_luma else (16 + ctx_set * 4))
        abs_base = ctx_mod.off("abs_flag", ctx_set if is_luma else (4 + ctx_set))

        num_c1 = min(len(abs_coeff), 8)
        first_c2_idx = -1
        for k in range(num_c1):
            symbol = int(abs_coeff[k] > 1)
            enc.encode_bin(one_base + c1, symbol)
            if symbol:
                c1 = 0
                if first_c2_idx == -1:
                    first_c2_idx = k
            elif 0 < c1 < 3:
                c1 += 1
        if first_c2_idx != -1:
            enc.encode_bin(abs_base, int(abs_coeff[first_c2_idx] > 2))
        if hidden:
            assert (sum(abs_coeff) & 1) == signs[-1], \
                "SBH parity not prepared (run quant.apply_sbh first)"
            for s in signs[:-1]:
                enc.encode_bypass(s)
        else:
            for s in signs:
                enc.encode_bypass(s)

        rice = 0
        first_coeff2 = 1
        for k, a in enumerate(abs_coeff):
            base_level = (2 + first_coeff2) if k < 8 else 1
            if a >= base_level:
                _encode_remainder(enc, a - base_level, rice)
                if a > (3 << rice):
                    rice = min(rice + 1, 4)
            if a >= 2:
                first_coeff2 = 0


# video_codecs_tpu/entropy/residual.py:206
def _encode_last_xy(enc: CabacEncoder, last_x: int, last_y: int,
                    log2_size: int, is_luma: bool) -> None:
    offset, shift = _last_ctx_params(log2_size, is_luma)
    gx, gy = int(GROUP_IDX[last_x]), int(GROUP_IDX[last_y])
    max_group = (log2_size << 1) - 1
    bx = ctx_mod.off("last_x")
    by = ctx_mod.off("last_y")
    for i in range(gx):
        enc.encode_bin(bx + offset + (i >> shift), 1)
    if gx < max_group:
        enc.encode_bin(bx + offset + (gx >> shift), 0)
    for i in range(gy):
        enc.encode_bin(by + offset + (i >> shift), 1)
    if gy < max_group:
        enc.encode_bin(by + offset + (gy >> shift), 0)
    if gx > 3:
        nbits = (gx >> 1) - 1
        enc.encode_bypass_bins(last_x - int(MIN_IN_GROUP[gx]), nbits)
    if gy > 3:
        nbits = (gy >> 1) - 1
        enc.encode_bypass_bins(last_y - int(MIN_IN_GROUP[gy]), nbits)


# video_codecs_tpu/entropy/residual.py:229
def _encode_remainder(enc: CabacEncoder, value: int, rice: int) -> None:
    """xWriteCoefRemainExGolomb (TEncSbac.cpp)."""
    if value < (3 << rice):
        length = value >> rice
        enc.encode_bypass_bins((1 << (length + 1)) - 2, length + 1)
        enc.encode_bypass_bins(value & ((1 << rice) - 1), rice)
    else:
        length = rice
        value -= 3 << rice
        while value >= (1 << length):
            value -= 1 << length
            length += 1
        enc.encode_bypass_bins((1 << (3 + length + 1 - rice)) - 2,
                               3 + length + 1 - rice)
        enc.encode_bypass_bins(value, length)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

# video_codecs_tpu/entropy/residual.py:250
def decode_residual(dec: CabacDecoder, log2_size: int, scan_type: int,
                    is_luma: bool, sign_hiding: bool = False) -> np.ndarray:
    """Decode one TU's levels -> [N, N] int32 raster (inverse of encode)."""
    n = 1 << log2_size
    scan = rom.scan_order(log2_size, scan_type)
    coeffs = np.zeros(n * n, np.int32)  # scan order

    last_x, last_y = _decode_last_xy(dec, log2_size, is_luma)
    if scan_type == rom.SCAN_VER:
        last_x, last_y = last_y, last_x
    last_raster = last_y * n + last_x
    last_scan_pos = int(np.nonzero(scan == last_raster)[0][0])

    num_cg = (n * n) >> 4
    cg_w = max(n >> 2, 1)
    cg_scan = rom.cg_scan_order(log2_size, scan_type)
    last_cg = last_scan_pos >> 4
    csbf = np.zeros(num_cg, np.int32)

    c1 = 1
    for i in range(last_cg, -1, -1):
        cg_raster = int(cg_scan[i])
        cg_y, cg_x = divmod(cg_raster, cg_w)
        right = int(csbf[cg_raster + 1]) if cg_x + 1 < cg_w else 0
        below = int(csbf[cg_raster + cg_w]) if cg_y + 1 < cg_w else 0
        pattern = right + 2 * below

        infer_sb_dc = 0
        if i == last_cg or i == 0:
            csbf[cg_raster] = 1
        else:
            ctx = ctx_mod.off("sig_cg", (1 if (right or below) else 0) +
                              (0 if is_luma else 2))
            csbf[cg_raster] = dec.decode_bin(ctx)
            infer_sb_dc = 1
        if not csbf[cg_raster]:
            continue

        inner = rom.scan_order(2, scan_type)
        first_ctx = first_sig_map_ctx(log2_size, scan_type, is_luma)
        sig_base = ctx_mod.off("sig_flag", 0 if is_luma else _SIG_CHROMA_BASE)
        single = first_ctx == _SIG_START[is_luma]["single"]

        sig = np.zeros(16, np.int32)
        if i == last_cg:
            sig[last_scan_pos - i * 16] = 1
            start_n = last_scan_pos - i * 16 - 1
        else:
            start_n = 15
        for nn in range(start_n, -1, -1):
            if nn > 0 or not infer_sb_dc:
                r_in = int(inner[nn])
                py, px = divmod(r_in, 4)
                pos_x = (cg_x << 2) + px
                pos_y = (cg_y << 2) + py
                if single:
                    sc = first_ctx
                else:
                    sc = sig_ctx_inc(pattern, pos_x, pos_y, log2_size,
                                     is_luma, first_ctx)
                sig[nn] = dec.decode_bin(sig_base + sc)
            else:
                sig[nn] = 1  # inferred DC significance
            if sig[nn] and nn > 0:
                infer_sb_dc = 0

        sig_pos = [nn for nn in range(15, -1, -1) if sig[nn]]
        if not sig_pos:
            continue  # inferred-significant CG decoded all-zero

        ctx_set = (0 if (i == 0 or not is_luma) else 2)
        if c1 == 0:
            ctx_set += 1
        c1 = 1
        one_base = ctx_mod.off("one_flag",
                               (ctx_set * 4) if is_luma else (16 + ctx_set * 4))
        abs_base = ctx_mod.off("abs_flag", ctx_set if is_luma else (4 + ctx_set))

        num_c1 = min(len(sig_pos), 8)
        greater1 = [0] * len(sig_pos)
        first_c2_idx = -1
        for k in range(num_c1):
            greater1[k] = dec.decode_bin(one_base + c1)
            if greater1[k]:
                c1 = 0
                if first_c2_idx == -1:
                    first_c2_idx = k
            elif 0 < c1 < 3:
                c1 += 1
        greater2 = 0
        if first_c2_idx != -1:
            greater2 = dec.decode_bin(abs_base)
        hidden = sign_hiding and (sig_pos[0] - sig_pos[-1] > 3)
        signs = [dec.decode_bypass()
                 for _ in range(len(sig_pos) - (1 if hidden else 0))]

        abs_coeff = []
        for k in range(len(sig_pos)):
            if k < 8:
                v = 1 + greater1[k]
                if k == first_c2_idx:
                    v += greater2
            else:
                v = 1
            abs_coeff.append(v)
        rice = 0
        first_coeff2 = 1
        for k in range(len(sig_pos)):
            base_level = (2 + first_coeff2) if k < 8 else 1
            if abs_coeff[k] == base_level:
                rem = _decode_remainder(dec, rice)
                abs_coeff[k] += rem
                if abs_coeff[k] > (3 << rice):
                    rice = min(rice + 1, 4)
            if abs_coeff[k] >= 2:
                first_coeff2 = 0
        if hidden:
            signs.append(sum(abs_coeff) & 1)  # inferred sign (parity rule)
        for k, nn in enumerate(sig_pos):
            coeffs[i * 16 + nn] = -abs_coeff[k] if signs[k] else abs_coeff[k]

    out = np.zeros(n * n, np.int32)
    out[scan] = coeffs
    return out.reshape(n, n)


# video_codecs_tpu/entropy/residual.py:376
def _decode_last_xy(dec: CabacDecoder, log2_size: int,
                    is_luma: bool) -> tuple[int, int]:
    offset, shift = _last_ctx_params(log2_size, is_luma)
    max_group = (log2_size << 1) - 1
    bx = ctx_mod.off("last_x")
    by = ctx_mod.off("last_y")
    gx = 0
    while gx < max_group and dec.decode_bin(bx + offset + (gx >> shift)):
        gx += 1
    gy = 0
    while gy < max_group and dec.decode_bin(by + offset + (gy >> shift)):
        gy += 1
    if gx > 3:
        nbits = (gx >> 1) - 1
        last_x = int(MIN_IN_GROUP[gx]) + dec.decode_bypass_bins(nbits)
    else:
        last_x = gx
    if gy > 3:
        nbits = (gy >> 1) - 1
        last_y = int(MIN_IN_GROUP[gy]) + dec.decode_bypass_bins(nbits)
    else:
        last_y = gy
    return last_x, last_y


# video_codecs_tpu/entropy/residual.py:401
def _decode_remainder(dec: CabacDecoder, rice: int) -> int:
    """xReadCoefRemainExGolomb (TDecSbac.cpp)."""
    prefix = 0
    while prefix < 32 and dec.decode_bypass():
        prefix += 1
    if prefix < 3:
        return (prefix << rice) + dec.decode_bypass_bins(rice)
    suffix = dec.decode_bypass_bins(prefix - 3 + rice)
    return suffix + (((1 << (prefix - 3)) + 2) << rice)

