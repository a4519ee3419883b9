"""H.264 High-profile I_8x8 luma intra prediction (spec 8.3.2).

The port's copy of video_codecs_tpu/models/h264/intra8.py, whole and as
it is; each function keeps its name and a comment gives the original's
line.

Nine directional modes like I_4x4 but on 8x8 blocks, with the
low-pass reference-sample filtering of spec 8.3.2.2.1 applied before
prediction (all modes predict from the FILTERED samples).

Parity reference: jm18.5/lcommon/src (get_mb_block_pos / intra
chain), lencod/src/intra8x8.c:756 (mode loops + filtering),
ldecod/src/intra8x8_pred_normal.c.
"""

from __future__ import annotations

import numpy as np

from video_codecs_tpu_torch.models.h264.intra_codec import _decoded_before


# video_codecs_tpu/models/h264/intra8.py:19
def gather_ref8(rec, x, y, mb_w):
    """Neighbor samples for an 8x8 intra block: returns
    (l[8], t[16], c, avail).  Unavailable top-right (t[8..15]) is
    substituted with t[7] when the top row itself is available
    (spec 8.3.2.2)."""
    h, w = rec.shape
    gx4, gy4 = x // 4, y // 4

    def blk_ok(sx, sy):
        if sx < 0 or sy < 0 or sx >= w or sy >= h:
            return False
        return _decoded_before(sx // 4, sy // 4, gx4, gy4, mb_w)

    avail = {
        "l": blk_ok(x - 1, y),
        "t": blk_ok(x, y - 1),
        "tl": blk_ok(x - 1, y - 1),
        "tr": blk_ok(x + 8, y - 1),
    }
    l = np.array([rec[min(y + i, h - 1), x - 1] if avail["l"] else 0
                  for i in range(8)], np.int64)
    t = np.zeros(16, np.int64)
    if avail["t"]:
        t[:8] = rec[y - 1, x:x + 8]
        if avail["tr"]:
            t[8:] = rec[y - 1, x + 8:x + 16]
        else:
            t[8:] = t[7]
    c = int(rec[y - 1, x - 1]) if avail["tl"] else 0
    return l, t, c, avail


# video_codecs_tpu/models/h264/intra8.py:51
def filter_ref8(l, t, c, avail):
    """Reference-sample filtering (spec 8.3.2.2.1): 121 low-pass over
    the top row, left column and corner, with 31 end taps."""
    tf = t.copy()
    lf = l.copy()
    cf = c
    if avail["t"]:
        tf[0] = ((c + 2 * t[0] + t[1] + 2) >> 2) if avail["tl"] else \
            ((3 * t[0] + t[1] + 2) >> 2)
        tf[1:15] = (t[0:14] + 2 * t[1:15] + t[2:16] + 2) >> 2
        tf[15] = (t[14] + 3 * t[15] + 2) >> 2
    if avail["l"]:
        lf[0] = ((c + 2 * l[0] + l[1] + 2) >> 2) if avail["tl"] else \
            ((3 * l[0] + l[1] + 2) >> 2)
        lf[1:7] = (l[0:6] + 2 * l[1:7] + l[2:8] + 2) >> 2
        lf[7] = (l[6] + 3 * l[7] + 2) >> 2
    if avail["tl"]:
        if avail["t"] and avail["l"]:
            cf = (t[0] + 2 * c + l[0] + 2) >> 2
        elif avail["t"]:
            cf = (3 * c + t[0] + 2) >> 2
        elif avail["l"]:
            cf = (3 * c + l[0] + 2) >> 2
    return lf, tf, cf


# video_codecs_tpu/models/h264/intra8.py:77
def pred_luma8(l, t, c, avail, mode):
    """9-mode 8x8 intra prediction on FILTERED refs (8.3.2.2.2-10)."""
    out = np.zeros((8, 8), np.int64)
    # tt[0] = corner, tt[1 + i] = t[i]; ll[0] = corner, ll[1 + i] = l[i]
    tt = np.zeros(17, np.int64)
    tt[0] = c
    tt[1:] = t
    ll = np.zeros(9, np.int64)
    ll[0] = c
    ll[1:] = l
    if mode == 0:                    # vertical
        out[:, :] = t[:8]
    elif mode == 1:                  # horizontal
        out[:, :] = l[:, None]
    elif mode == 2:                  # DC
        if avail["t"] and avail["l"]:
            dc = (int(t[:8].sum()) + int(l.sum()) + 8) >> 4
        elif avail["t"]:
            dc = (int(t[:8].sum()) + 4) >> 3
        elif avail["l"]:
            dc = (int(l.sum()) + 4) >> 3
        else:
            dc = 128
        out[:, :] = dc
    elif mode == 3:                  # diagonal down-left
        for y in range(8):
            for x in range(8):
                if x == 7 and y == 7:
                    out[y, x] = (t[14] + 3 * t[15] + 2) >> 2
                else:
                    out[y, x] = (t[x + y] + 2 * t[x + y + 1] +
                                 t[x + y + 2] + 2) >> 2
    elif mode == 4:                  # diagonal down-right
        for y in range(8):
            for x in range(8):
                if x > y:
                    out[y, x] = (tt[x - y - 1] + 2 * tt[x - y] +
                                 tt[x - y + 1] + 2) >> 2
                elif x < y:
                    out[y, x] = (ll[y - x - 1] + 2 * ll[y - x] +
                                 ll[y - x + 1] + 2) >> 2
                else:
                    out[y, x] = (t[0] + 2 * c + l[0] + 2) >> 2
    elif mode == 5:                  # vertical-right
        for y in range(8):
            for x in range(8):
                z = 2 * x - y
                if z >= 0 and z % 2 == 0:
                    i = x - (y >> 1)
                    out[y, x] = (tt[i] + tt[i + 1] + 1) >> 1
                elif z >= 0:
                    i = x - (y >> 1)
                    out[y, x] = (tt[i - 1] + 2 * tt[i] + tt[i + 1] + 2) >> 2
                elif z == -1:
                    out[y, x] = (l[0] + 2 * c + t[0] + 2) >> 2
                else:
                    i = y - 2 * x    # ll[i] = p[-1, i - 1]
                    out[y, x] = (ll[i] + 2 * ll[i - 1] + ll[i - 2] + 2) >> 2
    elif mode == 6:                  # horizontal-down
        for y in range(8):
            for x in range(8):
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    i = y - (x >> 1)
                    out[y, x] = (ll[i] + ll[i + 1] + 1) >> 1
                elif z >= 0:
                    i = y - (x >> 1)
                    out[y, x] = (ll[i - 1] + 2 * ll[i] + ll[i + 1] + 2) >> 2
                elif z == -1:
                    out[y, x] = (l[0] + 2 * c + t[0] + 2) >> 2
                else:
                    i = x - 2 * y
                    out[y, x] = (tt[i] + 2 * tt[i - 1] + tt[i - 2] + 2) >> 2
    elif mode == 7:                  # vertical-left
        for y in range(8):
            for x in range(8):
                i = x + (y >> 1)
                if y % 2 == 0:
                    out[y, x] = (t[i] + t[i + 1] + 1) >> 1
                else:
                    out[y, x] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
    else:                            # 8: horizontal-up
        for y in range(8):
            for x in range(8):
                z = x + 2 * y
                i = y + (x >> 1)
                if z < 13 and z % 2 == 0:
                    out[y, x] = (l[i] + l[i + 1] + 1) >> 1
                elif z < 13:
                    out[y, x] = (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2
                elif z == 13:
                    out[y, x] = (l[6] + 3 * l[7] + 2) >> 2
                else:
                    out[y, x] = l[7]
    return np.clip(out, 0, 255)


# video_codecs_tpu/models/h264/intra8.py:174
def allowed_modes8(avail):
    modes = [2]
    if avail["t"]:
        modes += [0, 3, 7]
    if avail["l"]:
        modes += [1, 8]
    if avail["t"] and avail["l"] and avail["tl"]:
        modes += [4, 5, 6]
    return modes


# video_codecs_tpu/models/h264/intra8.py:185
def predict8(rec, x, y, mb_w, mode):
    """Gather + filter + predict one 8x8 block from a recon plane."""
    l, t, c, avail = gather_ref8(rec, x, y, mb_w)
    lf, tf, cf = filter_ref8(l, t, c, avail)
    return pred_luma8(lf, tf, cf, avail, mode)
