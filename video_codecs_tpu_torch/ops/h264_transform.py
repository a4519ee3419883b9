"""H.264 4x4 integer transform, Hadamard DC transforms, quantization.

The port's copy of video_codecs_tpu/ops/h264_transform.py:1-116 and
:241-256, as it is; each function keeps its name and a comment gives the
original's line.  The 8x8 transform (:117-240) waits for transform8x8.

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
