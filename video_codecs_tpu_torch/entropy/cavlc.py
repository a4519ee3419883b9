"""H.264 CAVLC residual block coding (spec 9.2), encode + decode.

The port's copy of video_codecs_tpu/entropy/cavlc.py, whole and as it
is; each function keeps its name and a comment gives the original's line.

Parity reference: jm18.5/lencod/src/vlc.c (writeSyntaxElement_NumCoeff
TrailingOnes :822, ..._TotalZeros :996, ..._Run :1069, level coding in
writeCoeff4x4_CAVLC :1390) and ldecod/src/vlc.c read side.  The VLC code
tables are the standard's Tables 9-5/9-7/9-8/9-10.

A "residual block" here is a zig-zag-ordered coefficient list (up to 16
entries; 15 for AC-only; 4 for chroma DC).
"""

from __future__ import annotations

import numpy as np

from video_codecs_tpu_torch.entropy.bitstream import BitReader, BitWriter

# coeff_token length/code tables indexed [nc_class][trailing_ones][total_coeff]
# nc_class: 0 -> 0<=nC<2, 1 -> 2<=nC<4, 2 -> 4<=nC<8 (spec Table 9-5).
COEFF_TOKEN_LEN = np.array([
    [[1, 6, 8, 9, 10, 11, 13, 13, 13, 14, 14, 15, 15, 16, 16, 16, 16],
     [0, 2, 6, 8, 9, 10, 11, 13, 13, 14, 14, 15, 15, 15, 16, 16, 16],
     [0, 0, 3, 7, 8, 9, 10, 11, 13, 13, 14, 14, 15, 15, 16, 16, 16],
     [0, 0, 0, 5, 6, 7, 8, 9, 10, 11, 13, 14, 14, 15, 15, 16, 16]],
    [[2, 6, 6, 7, 8, 8, 9, 11, 11, 12, 12, 12, 13, 13, 13, 14, 14],
     [0, 2, 5, 6, 6, 7, 8, 9, 11, 11, 12, 12, 13, 13, 14, 14, 14],
     [0, 0, 3, 6, 6, 7, 8, 9, 11, 11, 12, 12, 13, 13, 13, 14, 14],
     [0, 0, 0, 4, 4, 5, 6, 6, 7, 9, 11, 11, 12, 13, 13, 13, 14]],
    [[4, 6, 6, 6, 7, 7, 7, 7, 8, 8, 9, 9, 9, 10, 10, 10, 10],
     [0, 4, 5, 5, 5, 5, 6, 6, 7, 8, 8, 9, 9, 9, 10, 10, 10],
     [0, 0, 4, 5, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 10],
     [0, 0, 0, 4, 4, 4, 4, 4, 5, 6, 7, 8, 8, 9, 10, 10, 10]],
], np.int32)

COEFF_TOKEN_CODE = np.array([
    [[1, 5, 7, 7, 7, 7, 15, 11, 8, 15, 11, 15, 11, 15, 11, 7, 4],
     [0, 1, 4, 6, 6, 6, 6, 14, 10, 14, 10, 14, 10, 1, 14, 10, 6],
     [0, 0, 1, 5, 5, 5, 5, 5, 13, 9, 13, 9, 13, 9, 13, 9, 5],
     [0, 0, 0, 3, 3, 4, 4, 4, 4, 4, 12, 12, 8, 12, 8, 12, 8]],
    [[3, 11, 7, 7, 7, 4, 7, 15, 11, 15, 11, 8, 15, 11, 7, 9, 7],
     [0, 2, 7, 10, 6, 6, 6, 6, 14, 10, 14, 10, 14, 10, 11, 8, 6],
     [0, 0, 3, 9, 5, 5, 5, 5, 13, 9, 13, 9, 13, 9, 6, 10, 5],
     [0, 0, 0, 5, 4, 6, 8, 4, 4, 4, 12, 8, 12, 12, 8, 1, 4]],
    [[15, 15, 11, 8, 15, 11, 9, 8, 15, 11, 15, 11, 8, 13, 9, 5, 1],
     [0, 14, 15, 12, 10, 8, 14, 10, 14, 14, 10, 14, 10, 7, 12, 8, 4],
     [0, 0, 13, 14, 11, 9, 13, 9, 13, 10, 13, 9, 13, 9, 11, 7, 3],
     [0, 0, 0, 12, 11, 10, 9, 8, 13, 12, 12, 12, 8, 12, 10, 6, 2]],
], np.int32)

# Chroma DC (4:2:0) coeff_token (spec Table 9-5, nC == -1).
CHROMA_DC_TOKEN_LEN = np.array(
    [[2, 6, 6, 6, 6], [0, 1, 6, 7, 8], [0, 0, 3, 7, 8], [0, 0, 0, 6, 7]],
    np.int32)
CHROMA_DC_TOKEN_CODE = np.array(
    [[1, 7, 4, 3, 2], [0, 1, 6, 3, 3], [0, 0, 1, 2, 2], [0, 0, 0, 5, 0]],
    np.int32)

# total_zeros for 4x4 blocks (spec Table 9-7/9-8): [total_coeff-1][total_zeros]
TOTAL_ZEROS_LEN = [
    [1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9],
    [3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6],
    [4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6],
    [5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5],
    [4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5],
    [6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6],
    [6, 5, 3, 3, 3, 2, 3, 4, 3, 6],
    [6, 4, 5, 3, 2, 2, 3, 3, 6],
    [6, 6, 4, 2, 2, 3, 2, 5],
    [5, 5, 3, 2, 2, 2, 4],
    [4, 4, 3, 3, 1, 3],
    [4, 4, 2, 1, 3],
    [3, 3, 1, 2],
    [2, 2, 1],
    [1, 1],
]
TOTAL_ZEROS_CODE = [
    [1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1],
    [7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0],
    [5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0],
    [3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0],
    [5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0],
    [1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0],
    [1, 1, 5, 4, 3, 3, 2, 1, 1, 0],
    [1, 1, 1, 3, 3, 2, 2, 1, 0],
    [1, 0, 1, 3, 2, 1, 1, 1],
    [1, 0, 1, 3, 2, 1, 1],
    [0, 1, 1, 2, 1, 3],
    [0, 1, 1, 1, 1],
    [0, 1, 1, 1],
    [0, 1, 1],
    [0, 1],
]

# Chroma DC total_zeros (4:2:0): [total_coeff-1][total_zeros]
CHROMA_DC_TZ_LEN = [[1, 2, 3, 3], [1, 2, 2], [1, 1]]
CHROMA_DC_TZ_CODE = [[1, 1, 1, 0], [1, 1, 0], [1, 0]]

# run_before (spec Table 9-10): [min(zeros_left,7)-1][run]
RUN_BEFORE_LEN = [
    [1, 1],
    [1, 2, 2],
    [2, 2, 2, 2],
    [2, 2, 2, 3, 3],
    [2, 2, 3, 3, 3, 3],
    [2, 3, 3, 3, 3, 3, 3],
    [3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11],
]
RUN_BEFORE_CODE = [
    [1, 0],
    [1, 1, 0],
    [3, 2, 1, 0],
    [3, 2, 1, 1, 0],
    [3, 2, 3, 2, 1, 0],
    [3, 0, 1, 3, 2, 5, 4],
    [7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1],
]


# video_codecs_tpu/entropy/cavlc.py:119
def nc_class(nc: int) -> int:
    if nc < 2:
        return 0
    if nc < 4:
        return 1
    return 2


# video_codecs_tpu/entropy/cavlc.py:127
def encode_block(w: BitWriter, coeffs: list[int], nc: int,
                 max_coeffs: int = 16) -> int:
    """Encode one zig-zag coefficient list; returns total_coeff (for nC
    bookkeeping).  nc == -1 selects the chroma-DC table."""
    nz = [(i, c) for i, c in enumerate(coeffs) if c != 0]
    total = len(nz)
    # trailing ones: up to 3 final +/-1 coefficients
    t1 = 0
    for i in range(total - 1, -1, -1):
        if abs(nz[i][1]) == 1 and t1 < 3:
            t1 += 1
        else:
            break
    if nc == -1:
        w.write(int(CHROMA_DC_TOKEN_CODE[t1][total]),
                int(CHROMA_DC_TOKEN_LEN[t1][total]))
    elif nc >= 8:
        if total == 0:
            w.write(3, 6)
        else:
            w.write(((total - 1) << 2) | t1, 6)
    else:
        cls = nc_class(nc)
        w.write(int(COEFF_TOKEN_CODE[cls][t1][total]),
                int(COEFF_TOKEN_LEN[cls][t1][total]))
    if total == 0:
        return 0

    # trailing-one signs (high freq -> low)
    for i in range(total - 1, total - 1 - t1, -1):
        w.write(1 if nz[i][1] < 0 else 0, 1)

    # remaining levels, high-freq -> low-freq
    suffix_len = 1 if (total > 10 and t1 < 3) else 0
    first = True
    for i in range(total - 1 - t1, -1, -1):
        actual = nz[i][1]
        level = actual
        if first and t1 < 3:
            # levels cannot be +/-1 here, shift magnitude down
            level = level - 1 if level > 0 else level + 1
        first = False
        code = 2 * abs(level) - 2 if level > 0 else -2 * level - 1
        _write_level(w, code, suffix_len)
        if suffix_len == 0:
            suffix_len = 1
        # threshold uses the actual reconstructed level (spec 9.2.2.1)
        if abs(actual) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1

    # total zeros
    max_zeros = max_coeffs - total
    zeros = nz[-1][0] + 1 - total
    if max_zeros > 0:
        if nc == -1:
            w.write(CHROMA_DC_TZ_CODE[total - 1][zeros],
                    CHROMA_DC_TZ_LEN[total - 1][zeros])
        else:
            w.write(TOTAL_ZEROS_CODE[total - 1][zeros],
                    TOTAL_ZEROS_LEN[total - 1][zeros])

    # run_before, high-freq -> low-freq
    zeros_left = zeros
    for i in range(total - 1, 0, -1):
        if zeros_left == 0:
            break
        run = nz[i][0] - nz[i - 1][0] - 1
        tab = min(zeros_left, 7) - 1
        w.write(RUN_BEFORE_CODE[tab][run], RUN_BEFORE_LEN[tab][run])
        zeros_left -= run
    return total


# video_codecs_tpu/entropy/cavlc.py:200
def _esc_base(prefix: int, suffix_len: int) -> int:
    """levelCode lower bound for prefix >= 16 (spec 9.2.2.1)."""
    return ((15 << suffix_len) + (15 if suffix_len == 0 else 0) +
            (1 << (prefix - 3)) - 4096)


# video_codecs_tpu/entropy/cavlc.py:206
def _write_level(w: BitWriter, code: int, suffix_len: int) -> None:
    """level_prefix + level_suffix (spec 9.2.2.1)."""
    if suffix_len == 0 and code < 14:
        w.write(1, code + 1)                     # unary
    elif suffix_len == 0 and code < 30:
        w.write(1, 15)                           # prefix 14
        w.write(code - 14, 4)
    elif suffix_len > 0 and (code >> suffix_len) < 15:
        prefix = code >> suffix_len
        w.write(1, prefix + 1)
        w.write(code & ((1 << suffix_len) - 1), suffix_len)
    elif code < _esc_base(16, suffix_len):
        w.write(1, 16)                           # prefix 15 escape, 12 bits
        w.write(code - (15 << suffix_len) - (15 if suffix_len == 0 else 0), 12)
    else:
        prefix = 16
        while code - _esc_base(prefix, suffix_len) >= (1 << (prefix - 3)):
            prefix += 1
        w.write(1, prefix + 1)
        w.write(code - _esc_base(prefix, suffix_len), prefix - 3)


# video_codecs_tpu/entropy/cavlc.py:228
def _read_level(r: BitReader, suffix_len: int) -> int:
    prefix = 0
    while r.read(1) == 0:
        prefix += 1
    if prefix >= 16:
        return _esc_base(prefix, suffix_len) + r.read(prefix - 3)
    if suffix_len == 0:
        if prefix < 14:
            code = prefix
        elif prefix == 14:
            code = 14 + r.read(4)
        else:
            code = 30 + r.read(12)
    else:
        if prefix < 15:
            code = (prefix << suffix_len) + r.read(suffix_len)
        else:
            code = (15 << suffix_len) + r.read(12)
    return code


# video_codecs_tpu/entropy/cavlc.py:249
def _read_vlc(r: BitReader, len_tab, code_tab) -> int:
    """Longest-prefix match of a (length, code) VLC table; returns index."""
    code = 0
    length = 0
    while length < 16:
        code = (code << 1) | r.read(1)
        length += 1
        for idx in range(len(len_tab)):
            if len_tab[idx] == length and code_tab[idx] == code:
                return idx
    raise ValueError("invalid VLC code")


# video_codecs_tpu/entropy/cavlc.py:262
def decode_block(r: BitReader, nc: int, max_coeffs: int = 16) -> list[int]:
    """Decode one zig-zag coefficient list (length max_coeffs)."""
    total, t1 = _read_coeff_token(r, nc)
    out = [0] * max_coeffs
    if total == 0:
        return out
    levels = []
    for _ in range(t1):
        levels.append(-1 if r.read(1) else 1)
    suffix_len = 1 if (total > 10 and t1 < 3) else 0
    first = True
    for k in range(total - t1):
        code = _read_level(r, suffix_len)
        if suffix_len == 0:
            suffix_len = 1
        if first and t1 < 3:
            code += 2
        first = False
        level = (code + 2) >> 1 if (code & 1) == 0 else -((code + 1) >> 1)
        levels.append(level)
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
    max_zeros = max_coeffs - total
    if max_zeros > 0:
        if nc == -1:
            zeros = _read_vlc(r, CHROMA_DC_TZ_LEN[total - 1],
                              CHROMA_DC_TZ_CODE[total - 1])
        else:
            zeros = _read_vlc(r, TOTAL_ZEROS_LEN[total - 1],
                              TOTAL_ZEROS_CODE[total - 1])
    else:
        zeros = 0
    # place coefficients: levels[] is high-freq first
    pos = total + zeros - 1
    zeros_left = zeros
    for k in range(total):
        out[pos] = levels[k]
        if k < total - 1:
            if zeros_left > 0:
                tab = min(zeros_left, 7) - 1
                run = _read_vlc(r, RUN_BEFORE_LEN[tab], RUN_BEFORE_CODE[tab])
            else:
                run = 0
            zeros_left -= run
            pos -= run + 1
    return out


# video_codecs_tpu/entropy/cavlc.py:310
def _read_coeff_token(r: BitReader, nc: int) -> tuple[int, int]:
    if nc >= 8:
        v = r.read(6)
        if v == 3:
            return 0, 0
        return (v >> 2) + 1, v & 3
    if nc == -1:
        len_tab, code_tab = CHROMA_DC_TOKEN_LEN, CHROMA_DC_TOKEN_CODE
    else:
        cls = nc_class(nc)
        len_tab, code_tab = COEFF_TOKEN_LEN[cls], COEFF_TOKEN_CODE[cls]
    # bit-serial longest-prefix match
    code = 0
    length = 0
    while length < 16:
        code = (code << 1) | r.read(1)
        length += 1
        for t1 in range(4):
            row_len = len_tab[t1]
            for total in range(len(row_len)):
                if int(row_len[total]) == length and int(code_tab[t1][total]) == code:
                    return total, t1
    raise ValueError("invalid coeff_token")


# Zig-zag scan for 4x4 blocks (spec 8.5.6).
ZIGZAG_4x4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
                      np.int32)
