"""H.264 4x4 integer transform, Hadamard DC transforms, quantization.

The port's copy of video_codecs_tpu/ops/h264_transform.py, whole and as
it is (the High profile's 8x8 transform included); each function keeps
its name and a comment gives the original's line.

Parity reference: jm18.5/lcommon/src/transform.c (forward4x4 :20,
inverse4x4 :70, hadamard4x4 :121), lencod quant4x4_normal.c; dequant per
spec 8.5.10-8.5.12 (V tables) — decoder side must be bit-exact.

All functions batch over a leading axis of 4x4 (or 2x2) blocks.
"""

from __future__ import annotations

import numpy as np

# Position classes in a 4x4: 0 for (0,0),(0,2),(2,0),(2,2); 1 for
# (1,1),(1,3),(3,1),(3,3); 2 otherwise.
_POS_CLASS = np.array([[0, 2, 0, 2], [2, 1, 2, 1],
                       [0, 2, 0, 2], [2, 1, 2, 1]], np.int32)

# Quant MF and dequant V tables per qp%6 and position class (spec 8.5.12.1).
_MF = np.array([[13107, 5243, 8066], [11916, 4660, 7490],
                [10082, 4194, 6554], [9362, 3647, 5825],
                [8192, 3355, 5243], [7282, 2893, 4559]], np.int64)
_V = np.array([[10, 16, 13], [11, 18, 14], [13, 20, 16],
               [14, 23, 18], [16, 25, 20], [18, 29, 23]], np.int64)

_CF = np.array([[1, 1, 1, 1], [2, 1, -1, -2],
                [1, -1, -1, 1], [1, -2, 2, -1]], np.int64)
_H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1],
                [1, -1, -1, 1], [1, -1, 1, -1]], np.int64)

# H.264 chroma QP mapping (Table 8-15), index = clipped qp 0..51.
CHROMA_QP = np.array(list(range(30)) +
                     [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37,
                      37, 37, 38, 38, 38, 39, 39, 39, 39], np.int32)


# video_codecs_tpu/ops/h264_transform.py:37
def forward4x4(res: np.ndarray) -> np.ndarray:
    """Core transform W = Cf X Cf^T over [..., 4, 4] int blocks."""
    x = res.astype(np.int64)
    return (_CF @ x @ _CF.T).astype(np.int64)


# video_codecs_tpu/ops/h264_transform.py:43
def hadamard4x4(x: np.ndarray) -> np.ndarray:
    """Plain H X H (the spec's inverse-side DC transform, no shift)."""
    return (_H4 @ x.astype(np.int64) @ _H4).astype(np.int64)


# video_codecs_tpu/ops/h264_transform.py:48
def fwd_hadamard4x4_dc(x: np.ndarray) -> np.ndarray:
    """Encoder-side luma DC transform: (H X H) >> 1 (JM transform.c:121)."""
    return ((_H4 @ x.astype(np.int64) @ _H4) >> 1).astype(np.int64)


# video_codecs_tpu/ops/h264_transform.py:53
def mf(qp: int) -> np.ndarray:
    return _MF[qp % 6][_POS_CLASS]


# video_codecs_tpu/ops/h264_transform.py:57
def vmat(qp: int) -> np.ndarray:
    return _V[qp % 6][_POS_CLASS]


# video_codecs_tpu/ops/h264_transform.py:61
def quant_ac(w: np.ndarray, qp: int, intra: bool = True) -> np.ndarray:
    """Quantize transformed blocks [..., 4, 4] (includes the DC position;
    callers zero it out for I_16x16 / chroma)."""
    qbits = 15 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    m = mf(qp)
    lv = (np.abs(w) * m + f) >> qbits
    return (np.sign(w) * lv).astype(np.int64)


# video_codecs_tpu/ops/h264_transform.py:71
def dequant_ac(levels: np.ndarray, qp: int) -> np.ndarray:
    """Spec 8.5.12.1: d = level * V << (qp/6) (no rounding)."""
    return (levels.astype(np.int64) * vmat(qp)) << (qp // 6)


# video_codecs_tpu/ops/h264_transform.py:76
def quant_luma_dc(dc_h: np.ndarray, qp: int, intra: bool = True) -> np.ndarray:
    """Quantize the Hadamard-transformed 4x4 luma DC block."""
    qbits = 15 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    m0 = int(_MF[qp % 6][0])
    lv = (np.abs(dc_h) * m0 + 2 * f) >> (qbits + 1)
    return (np.sign(dc_h) * lv).astype(np.int64)


# video_codecs_tpu/ops/h264_transform.py:85
def dequant_luma_dc(levels: np.ndarray, qp: int) -> np.ndarray:
    """Spec 8.5.10: inverse Hadamard THEN scale.

    LevelScale4x4 includes the flat weightScale of 16 (spec 8.5.9)."""
    f = hadamard4x4(levels)
    ls = int(_V[qp % 6][0]) << 4
    if qp >= 36:
        return (f * ls) << (qp // 6 - 6)
    shift = 6 - qp // 6
    return (f * ls + (1 << (shift - 1))) >> shift


# video_codecs_tpu/ops/h264_transform.py:97
def quant_chroma_dc(dc_h: np.ndarray, qp: int, intra: bool = True) -> np.ndarray:
    qbits = 15 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    m0 = int(_MF[qp % 6][0])
    lv = (np.abs(dc_h) * m0 + 2 * f) >> (qbits + 1)
    return (np.sign(dc_h) * lv).astype(np.int64)


# video_codecs_tpu/ops/h264_transform.py:105
def hadamard2x2(x: np.ndarray) -> np.ndarray:
    h = np.array([[1, 1], [1, -1]], np.int64)
    return (h @ x.astype(np.int64) @ h)


# video_codecs_tpu/ops/h264_transform.py:110
def dequant_chroma_dc(levels: np.ndarray, qp: int) -> np.ndarray:
    """Spec 8.5.11: f = H c H; dc = ((f * LS) << (qp/6)) >> 5, LS = 16*V0."""
    f = hadamard2x2(levels)
    ls = int(_V[qp % 6][0]) << 4
    return ((f * ls) << (qp // 6)) >> 5


# ---- 8x8 transform (High profile, spec 8.5.12.3 / 8.5.13) ----------------

# 8x8 quant/dequant position classes: row/col index i maps to class
# a(i%4) with a = [0, 1, 2, 1]; tables give the 3x3 class matrix per
# qp%6 (spec LevelScale8x8; JM q_matrix.c quant_coef8 / dequant_coef8 —
# spec-mandated constants, identical in every conforming codec).
_A8 = np.array([0, 1, 2, 1] * 2, np.int32)
_MF8 = np.array([
    [[13107, 12222, 16777], [12222, 11428, 15481], [16777, 15481, 20972]],
    [[11916, 11058, 14980], [11058, 10826, 14290], [14980, 14290, 19174]],
    [[10082, 9675, 12710], [9675, 8943, 11985], [12710, 11985, 15978]],
    [[9362, 8931, 11984], [8931, 8228, 11259], [11984, 11259, 14913]],
    [[8192, 7740, 10486], [7740, 7346, 9777], [10486, 9777, 13159]],
    [[7282, 6830, 9118], [6830, 6428, 8640], [9118, 8640, 11570]]],
    np.int64)
_V8 = np.array([
    [[20, 19, 25], [19, 18, 24], [25, 24, 32]],
    [[22, 21, 28], [21, 19, 26], [28, 26, 35]],
    [[26, 24, 33], [24, 23, 31], [33, 31, 42]],
    [[28, 26, 35], [26, 25, 33], [35, 33, 45]],
    [[32, 30, 40], [30, 28, 38], [40, 38, 51]],
    [[36, 34, 46], [34, 32, 43], [46, 43, 58]]], np.int64)


# video_codecs_tpu/ops/h264_transform.py:141
def mf8(qp: int) -> np.ndarray:
    return _MF8[qp % 6][_A8[:, None], _A8[None, :]]


# video_codecs_tpu/ops/h264_transform.py:145
def vmat8(qp: int) -> np.ndarray:
    return _V8[qp % 6][_A8[:, None], _A8[None, :]]


# video_codecs_tpu/ops/h264_transform.py:149
def _fwd8_1d(p):
    """One forward 8x8 butterfly pass along the last axis
    (JM lcommon transform.c forward8x8 :353 semantics, vectorized)."""
    a0 = p[..., 0] + p[..., 7]
    a1 = p[..., 1] + p[..., 6]
    a2 = p[..., 2] + p[..., 5]
    a3 = p[..., 3] + p[..., 4]
    b0, b1, b2, b3 = a0 + a3, a1 + a2, a0 - a3, a1 - a2
    a0 = p[..., 0] - p[..., 7]
    a1 = p[..., 1] - p[..., 6]
    a2 = p[..., 2] - p[..., 5]
    a3 = p[..., 3] - p[..., 4]
    b4 = a1 + a2 + ((a0 >> 1) + a0)
    b5 = a0 - a3 - ((a2 >> 1) + a2)
    b6 = a0 + a3 - ((a1 >> 1) + a1)
    b7 = a1 - a2 + ((a3 >> 1) + a3)
    return np.stack([b0 + b1, b4 + (b7 >> 2), b2 + (b3 >> 1),
                     b5 + (b6 >> 2), b0 - b1, b6 - (b5 >> 2),
                     (b2 >> 1) - b3, (b4 >> 2) - b7], axis=-1)


# video_codecs_tpu/ops/h264_transform.py:170
def forward8x8(res: np.ndarray) -> np.ndarray:
    """Forward 8x8 transform over [..., 8, 8] int blocks (rows then
    columns, matching JM's horizontal-then-vertical order)."""
    x = res.astype(np.int64)
    t = _fwd8_1d(x)                       # along rows (last axis)
    return _fwd8_1d(np.swapaxes(t, -1, -2)).swapaxes(-1, -2)


# video_codecs_tpu/ops/h264_transform.py:178
def _inv8_1d(p):
    """One inverse 8x8 butterfly pass along the last axis
    (spec 8.5.12.3; JM inverse8x8)."""
    a0 = p[..., 0] + p[..., 4]
    a1 = p[..., 0] - p[..., 4]
    a2 = p[..., 6] - (p[..., 2] >> 1)
    a3 = p[..., 2] + (p[..., 6] >> 1)
    b0, b2, b4, b6 = a0 + a3, a1 - a2, a1 + a2, a0 - a3
    a0 = -p[..., 3] + p[..., 5] - p[..., 7] - (p[..., 7] >> 1)
    a1 = p[..., 1] + p[..., 7] - p[..., 3] - (p[..., 3] >> 1)
    a2 = -p[..., 1] + p[..., 7] + p[..., 5] + (p[..., 5] >> 1)
    a3 = p[..., 3] + p[..., 5] + p[..., 1] + (p[..., 1] >> 1)
    b1 = a0 + (a3 >> 2)
    b3 = a1 + (a2 >> 2)
    b5 = a2 - (a1 >> 2)
    b7 = a3 - (a0 >> 2)
    return np.stack([b0 + b7, b2 - b5, b4 + b3, b6 + b1,
                     b6 - b1, b4 - b3, b2 + b5, b0 - b7], axis=-1)


# video_codecs_tpu/ops/h264_transform.py:198
def inverse8x8(d: np.ndarray) -> np.ndarray:
    """Inverse 8x8 transform over [..., 8, 8] dequantized coefficients,
    final rounding (x + 32) >> 6 (DQ_BITS_8 = 6)."""
    x = d.astype(np.int64)
    t = _inv8_1d(x)
    out = _inv8_1d(np.swapaxes(t, -1, -2)).swapaxes(-1, -2)
    return (out + 32) >> 6


# video_codecs_tpu/ops/h264_transform.py:207
def quant8x8(w: np.ndarray, qp: int, intra: bool = True) -> np.ndarray:
    """Quantize forward-transformed 8x8 blocks [..., 8, 8]
    (Q_BITS_8 = 16; offsets 682/342 per 2048 = 1/3 intra, 1/6 inter)."""
    qbits = 16 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    m = mf8(qp)
    lv = (np.abs(w) * m + f) >> qbits
    return (np.sign(w) * lv).astype(np.int64)


# video_codecs_tpu/ops/h264_transform.py:217
def dequant8x8(levels: np.ndarray, qp: int) -> np.ndarray:
    """Spec 8.5.13.2 with the flat weightScale 16:
    d = rshift_rnd((level * V8 * 16) << (qp/6), 6)  (JM ldecod
    read_comp_cabac.c:344, InvLevelScale8x8 = dequant_coef8 * 16)."""
    v = ((levels.astype(np.int64) * vmat8(qp)) << 4) << (qp // 6)
    return (v + 32) >> 6


# video_codecs_tpu/ops/h264_transform.py:225
def zigzag8x8() -> np.ndarray:
    """Classic 8x8 zigzag scan: flat raster indices in scan order
    (JM SNGL_SCAN8x8; generated from the diagonal rule, not copied)."""
    order = []
    for s in range(15):
        diag = [(s - j, j) for j in range(s + 1)
                if 0 <= s - j < 8 and 0 <= j < 8]
        if s % 2 == 1:
            diag.reverse()      # odd diagonals run top-right -> bottom-left
        order.extend(y * 8 + x for y, x in diag)
    return np.array(order, np.int64)


ZIGZAG_8x8 = zigzag8x8()


# video_codecs_tpu/ops/h264_transform.py:241
def inverse4x4(d: np.ndarray) -> np.ndarray:
    """Spec 8.5.12.2 butterfly inverse with final (x+32)>>6.

    d: [..., 4, 4] scaled coefficients (DC already substituted)."""
    d = d.astype(np.int64)
    e0 = d[..., 0, :] + d[..., 2, :]
    e1 = d[..., 0, :] - d[..., 2, :]
    e2 = (d[..., 1, :] >> 1) - d[..., 3, :]
    e3 = d[..., 1, :] + (d[..., 3, :] >> 1)
    g = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-2)
    f0 = g[..., :, 0] + g[..., :, 2]
    f1 = g[..., :, 0] - g[..., :, 2]
    f2 = (g[..., :, 1] >> 1) - g[..., :, 3]
    f3 = g[..., :, 1] + (g[..., :, 3] >> 1)
    h = np.stack([f0 + f3, f1 + f2, f1 - f2, f0 - f3], axis=-1)
    return (h + 32) >> 6
