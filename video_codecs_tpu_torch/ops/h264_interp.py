"""H.264 sub-pel interpolation (spec 8.4.2.2.1-2).

The port's copy of video_codecs_tpu/ops/h264_interp.py, whole and as
it is (the decoder's host MC; the device MC is ops/h264_dev.py); each
function keeps its name and a comment gives the original's line.

Luma: 6-tap {1,-5,20,20,-5,1} half-pel filter; quarter-pels are rounded
averages of the two nearest integer/half-pel samples (the standard
G a b c / d e f g / h i j k / n p q r grid). Center j is produced from
the *unrounded* horizontal intermediates (>>10 with +512).
Chroma: eighth-pel bilinear ((8-dx)(8-dy)A + ... + 32) >> 6.

Reference behavior: jm18.5/lcommon/src/mc_prediction.c get_block_luma /
get_block_chroma; sample positions are clamped to the picture (spec
Clip3 on xInt/yInt), which the clipped-index gather reproduces.
Host numpy implementation — the device path will batch these as
gathered matmuls like ops/interp.py does for HEVC.
"""

from __future__ import annotations

import numpy as np

_TAPS = np.array([1, -5, 20, 20, -5, 1], np.int64)


# video_codecs_tpu/ops/h264_interp.py:23
def _patch(ref: np.ndarray, x0: int, y0: int, w: int, h: int) -> np.ndarray:
    """Clamped (h, w) gather starting at (x0, y0) (may be out of bounds)."""
    H, W = ref.shape
    ys = np.clip(np.arange(y0, y0 + h), 0, H - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, W - 1)
    return ref[np.ix_(ys, xs)].astype(np.int64)


# video_codecs_tpu/ops/h264_interp.py:31
def _hfilt(a: np.ndarray) -> np.ndarray:
    """Horizontal 6-tap over axis 1; output width = a.shape[1] - 5."""
    return sum(int(_TAPS[k]) * a[:, k:a.shape[1] - 5 + k] for k in range(6))


# video_codecs_tpu/ops/h264_interp.py:36
def _vfilt(a: np.ndarray) -> np.ndarray:
    return sum(int(_TAPS[k]) * a[k:a.shape[0] - 5 + k, :] for k in range(6))


# video_codecs_tpu/ops/h264_interp.py:40
def mc_luma_np(ref: np.ndarray, x: int, y: int, mvx: int, mvy: int,
               w: int, h: int) -> np.ndarray:
    """Predict a (h, w) luma block at picture pos (x, y) with quarter-pel
    motion vector (mvx, mvy)."""
    xi, yi = x + (mvx >> 2), y + (mvy >> 2)
    dx, dy = mvx & 3, mvy & 3
    pat = _patch(ref, xi - 2, yi - 2, w + 6, h + 6)   # rows yi-2..yi+h+3

    G = pat[2:2 + h, 2:2 + w]
    if dx == 0 and dy == 0:
        return G.astype(np.int32)

    # unrounded horizontal intermediates at every row (for j), and the
    # rounded half-pels b (row y), s (row y+1)
    b1 = _hfilt(pat)                                  # (h+6, w+1)
    b_all = np.clip((b1 + 16) >> 5, 0, 255)
    b = b_all[2:2 + h, 0:w]
    s = b_all[3:3 + h, 0:w]
    # vertical half-pels at columns x (h_) and x+1 (m)
    h1 = _vfilt(pat)                                  # (h+1, w+6)
    h_all = np.clip((h1 + 16) >> 5, 0, 255)
    h_ = h_all[0:h, 2:2 + w]
    m = h_all[0:h, 3:3 + w]
    # center half-pel j from unrounded b1 columns
    j1 = _vfilt(b1)                                   # (h+1, w+1)
    j = np.clip((j1[0:h, 0:w] + 512) >> 10, 0, 255)

    Hn = pat[2:2 + h, 3:3 + w]                        # next integer right
    Mn = pat[3:3 + h, 2:2 + w]                        # next integer below

    grid = {
        (1, 0): (G + b + 1) >> 1,
        (2, 0): b,
        (3, 0): (b + Hn + 1) >> 1,
        (0, 1): (G + h_ + 1) >> 1,
        (0, 2): h_,
        (0, 3): (h_ + Mn + 1) >> 1,
        (2, 2): j,
        (2, 1): (b + j + 1) >> 1,
        (2, 3): (j + s + 1) >> 1,
        (1, 2): (h_ + j + 1) >> 1,
        (3, 2): (j + m + 1) >> 1,
        (1, 1): (b + h_ + 1) >> 1,
        (3, 1): (b + m + 1) >> 1,
        (1, 3): (h_ + s + 1) >> 1,
        (3, 3): (m + s + 1) >> 1,
    }
    return grid[(dx, dy)].astype(np.int32)


# video_codecs_tpu/ops/h264_interp.py:90
def mc_chroma_np(ref: np.ndarray, x: int, y: int, mvx: int, mvy: int,
                 w: int, h: int) -> np.ndarray:
    """Predict a (h, w) chroma block; mv is in quarter-LUMA units, i.e.
    eighth-pel for 4:2:0 chroma."""
    xi, yi = x + (mvx >> 3), y + (mvy >> 3)
    dx, dy = mvx & 7, mvy & 7
    pat = _patch(ref, xi, yi, w + 1, h + 1)
    A = pat[0:h, 0:w]
    B = pat[0:h, 1:1 + w]
    C = pat[1:1 + h, 0:w]
    D = pat[1:1 + h, 1:1 + w]
    out = ((8 - dx) * (8 - dy) * A + dx * (8 - dy) * B
           + (8 - dx) * dy * C + dx * dy * D + 32) >> 6
    return out.astype(np.int32)
