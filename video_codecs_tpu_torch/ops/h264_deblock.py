"""H.264 in-loop deblocking filter (spec 8.7), all-intra frame coding.

The port's copy of video_codecs_tpu/ops/h264_deblock.py, whole and as
it is; each function keeps its name and a comment gives the original's
line.

Vectorized per edge: every decision/filter value is computed from the
*original* samples of the edge window before any write-back, which is
exactly the reference semantics (JM loads L0..L3/R0..R3 up front —
jm18.5/ldecod/src/loop_filter_normal.c:548-614 strong,
:664-700 normal, :840-900 chroma). Ordering across edges is sequential
and matches JM's DeblockPicture (jm18.5/ldecod/src/loopFilter.c:44-69,
:483-640): macroblocks in raster order, each MB filtering its four
vertical luma edges (chroma at edges 0 and 2), then its four horizontal
edges, in place, so later edges see earlier edges' filtered samples.

All MBs here are intra in frame coding, so boundary strength is 4 on MB
edges and 3 on internal 4x4 edges — no bS derivation needed.
Alpha/beta/tc0 tables are the spec Tables 8-16/8-17
(jm18.5/ldecod/inc/loop_filter.h:36-48).
"""

from __future__ import annotations

import numpy as np

ALPHA_TABLE = np.array(
    [0] * 16
    + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28,
       32, 36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113,
       127, 144, 162, 182, 203, 226, 255, 255], np.int32)

BETA_TABLE = np.array(
    [0] * 16
    + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8,
       9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14,
       15, 15, 16, 16, 17, 17, 18, 18], np.int32)

# tc0 by [indexA][bS] for bS in 1..3 (column 0 unused).
CLIP_TAB = np.zeros((52, 4), np.int32)
CLIP_TAB[16:] = [
    (0, 0, 0, 0), (0, 0, 0, 1), (0, 0, 0, 1), (0, 0, 0, 1),
    (0, 0, 0, 1), (0, 0, 1, 1), (0, 0, 1, 1), (0, 1, 1, 1),
    (0, 1, 1, 1), (0, 1, 1, 1), (0, 1, 1, 1), (0, 1, 1, 2),
    (0, 1, 1, 2), (0, 1, 1, 2), (0, 1, 1, 2), (0, 1, 2, 3),
    (0, 1, 2, 3), (0, 2, 2, 3), (0, 2, 2, 4), (0, 2, 3, 4),
    (0, 2, 3, 4), (0, 3, 3, 5), (0, 3, 4, 6), (0, 3, 4, 6),
    (0, 4, 5, 7), (0, 4, 5, 8), (0, 4, 6, 9), (0, 5, 7, 10),
    (0, 6, 8, 11), (0, 6, 8, 13), (0, 7, 10, 14), (0, 8, 11, 16),
    (0, 9, 12, 18), (0, 10, 13, 20), (0, 11, 15, 23), (0, 13, 17, 25),
]


# video_codecs_tpu/ops/h264_deblock.py:50
def _edge_luma(win: np.ndarray, bs: np.ndarray, alpha: int, beta: int,
               tc0: np.ndarray) -> np.ndarray:
    """Filter one luma edge. win is (N, 8) = [p3 p2 p1 p0 q0 q1 q2 q3];
    bs and tc0 are per-row (N,) arrays (bS 0 rows pass through)."""
    w = win.astype(np.int32)
    bs = np.asarray(bs, np.int32)
    tc0 = np.asarray(tc0, np.int32)
    p3, p2, p1, p0, q0, q1, q2, q3 = (w[:, i] for i in range(8))
    filt = ((np.abs(p0 - q0) < alpha) & (np.abs(p1 - p0) < beta)
            & (np.abs(q1 - q0) < beta) & (bs > 0))
    ap = np.abs(p2 - p0) < beta
    aq = np.abs(q2 - q0) < beta
    out = w.copy()
    f4 = filt & (bs == 4)
    fn = filt & (bs < 4)
    # --- bS==4 strong / weak ---
    small = np.abs(p0 - q0) < ((alpha >> 2) + 2)
    weak_p = (2 * p1 + p0 + q1 + 2) >> 2
    weak_q = (2 * q1 + q0 + p1 + 2) >> 2
    sp = f4 & small & ap
    sq = f4 & small & aq
    # --- bS 1..3 normal ---
    tc = tc0 + ap.astype(np.int32) + aq.astype(np.int32)
    dif = np.clip((4 * (q0 - p0) + (p1 - q1) + 4) >> 3, -tc, tc)
    mid = (p0 + q0 + 1) >> 1
    dp1 = np.clip((p2 + mid - 2 * p1) >> 1, -tc0, tc0)
    dq1 = np.clip((q2 + mid - 2 * q1) >> 1, -tc0, tc0)

    out[:, 3] = np.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                         np.where(f4, weak_p,
                                  np.where(fn, np.clip(p0 + dif, 0, 255), p0)))
    out[:, 2] = np.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2,
                         np.where(fn & ap, p1 + dp1, p1))
    out[:, 1] = np.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    out[:, 4] = np.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                         np.where(f4, weak_q,
                                  np.where(fn, np.clip(q0 - dif, 0, 255), q0)))
    out[:, 5] = np.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2,
                         np.where(fn & aq, q1 + dq1, q1))
    out[:, 6] = np.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    return out


# video_codecs_tpu/ops/h264_deblock.py:93
def _edge_chroma(win: np.ndarray, bs: np.ndarray, alpha: int, beta: int,
                 tc0: np.ndarray) -> np.ndarray:
    """Filter one chroma edge. win is (N, 4) = [p1 p0 q0 q1]; bs/tc0 per row."""
    w = win.astype(np.int32)
    bs = np.asarray(bs, np.int32)
    tc0 = np.asarray(tc0, np.int32)
    p1, p0, q0, q1 = (w[:, i] for i in range(4))
    filt = ((np.abs(p0 - q0) < alpha) & (np.abs(p1 - p0) < beta)
            & (np.abs(q1 - q0) < beta) & (bs > 0))
    out = w.copy()
    f4 = filt & (bs == 4)
    fn = filt & (bs < 4)
    tc = tc0 + 1
    dif = np.clip((4 * (q0 - p0) + (p1 - q1) + 4) >> 3, -tc, tc)
    out[:, 1] = np.where(f4, (2 * p1 + p0 + q1 + 2) >> 2,
                         np.where(fn, np.clip(p0 + dif, 0, 255), p0))
    out[:, 2] = np.where(f4, (2 * q1 + q0 + p1 + 2) >> 2,
                         np.where(fn, np.clip(q0 - dif, 0, 255), q0))
    return out


# video_codecs_tpu/ops/h264_deblock.py:114
def deblock_frame(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                  qp: int, qpc: int,
                  bs_ver: np.ndarray, bs_hor: np.ndarray,
                  alpha_off: int = 0, beta_off: int = 0,
                  trans8: np.ndarray | None = None):
    """Deblock a reconstructed 4:2:0 frame with explicit bS maps.

    bs_ver[by, bx] is the strength of the vertical edge at x = 4*bx for
    luma rows [4*by, 4*by+4); bs_hor[by, bx] the horizontal edge at
    y = 4*by for columns [4*bx, 4*bx+4). Column/row 0 entries are the
    picture border and ignored. qp/qpc are the (uniform) luma and chroma
    QPs; alpha_off/beta_off are FilterOffsetA/B.  trans8 (optional,
    per-MB bool) marks 8x8-transform MBs whose internal luma 4-grid
    edges (offsets 4 and 12) are not filtered (spec 8.7 transform-size
    rule; chroma edges are unaffected in 4:2:0).
    """
    Y = y.astype(np.int32).copy()
    U = u.astype(np.int32).copy()
    V = v.astype(np.int32).copy()
    h, w = Y.shape

    ia = min(max(qp + alpha_off, 0), 51)
    ib = min(max(qp + beta_off, 0), 51)
    al, bl = int(ALPHA_TABLE[ia]), int(BETA_TABLE[ib])
    iac = min(max(qpc + alpha_off, 0), 51)
    ibc = min(max(qpc + beta_off, 0), 51)
    ac, bc = int(ALPHA_TABLE[iac]), int(BETA_TABLE[ibc])
    tcl = CLIP_TAB[ia]
    tcc = CLIP_TAB[iac]

    def luma_ver(x, y0):
        bs = np.repeat(bs_ver[y0 // 4:y0 // 4 + 4, x // 4], 4)
        if (al | bl) == 0 or not bs.any():
            return
        Y[y0:y0 + 16, x - 4:x + 4] = _edge_luma(
            Y[y0:y0 + 16, x - 4:x + 4], bs, al, bl, tcl[np.minimum(bs, 3)])

    def luma_hor(x0, yy):
        bs = np.repeat(bs_hor[yy // 4, x0 // 4:x0 // 4 + 4], 4)
        if (al | bl) == 0 or not bs.any():
            return
        win = Y[yy - 4:yy + 4, x0:x0 + 16].T
        Y[yy - 4:yy + 4, x0:x0 + 16] = _edge_luma(
            win, bs, al, bl, tcl[np.minimum(bs, 3)]).T

    def chroma_ver(P, cx, cy0):
        rows = np.arange(cy0, cy0 + 8)
        bs = bs_ver[(2 * rows) // 4, (2 * cx) // 4]
        if (ac | bc) == 0 or not bs.any():
            return
        P[cy0:cy0 + 8, cx - 2:cx + 2] = _edge_chroma(
            P[cy0:cy0 + 8, cx - 2:cx + 2], bs, ac, bc,
            tcc[np.minimum(bs, 3)])

    def chroma_hor(P, cx0, cy):
        cols = np.arange(cx0, cx0 + 8)
        bs = bs_hor[(2 * cy) // 4, (2 * cols) // 4]
        if (ac | bc) == 0 or not bs.any():
            return
        win = P[cy - 2:cy + 2, cx0:cx0 + 8].T
        P[cy - 2:cy + 2, cx0:cx0 + 8] = _edge_chroma(
            win, bs, ac, bc, tcc[np.minimum(bs, 3)]).T

    for mby in range(h // 16):
        for mbx in range(w // 16):
            x0, y0 = mbx * 16, mby * 16
            cx0, cy0 = mbx * 8, mby * 8
            t8 = trans8 is not None and bool(trans8[mby, mbx])
            # vertical edges, left to right
            for e in range(4):
                if e == 0 and mbx == 0:
                    continue
                if not (t8 and e in (1, 3)):
                    luma_ver(x0 + 4 * e, y0)
                if e in (0, 2):        # chroma_edge[0][e][YUV420]
                    for P in (U, V):
                        chroma_ver(P, cx0 + 2 * e, cy0)
            # horizontal edges, top to bottom
            for e in range(4):
                if e == 0 and mby == 0:
                    continue
                if not (t8 and e in (1, 3)):
                    luma_hor(x0, y0 + 4 * e)
                if e in (0, 2):
                    for P in (U, V):
                        chroma_hor(P, cx0, cy0 + 2 * e)
    return Y, U, V


# video_codecs_tpu/ops/h264_deblock.py:203
def intra_bs_maps(h: int, w: int):
    """bS maps for an all-intra frame: 4 on MB edges, 3 on internal
    4x4 edges (frame coding)."""
    h4, w4 = h // 4, w // 4
    bs_ver = np.full((h4, w4), 3, np.int32)
    bs_ver[:, ::4] = 4
    bs_hor = np.full((h4, w4), 3, np.int32)
    bs_hor[::4, :] = 4
    return bs_ver, bs_hor


# video_codecs_tpu/ops/h264_deblock.py:214
def deblock_frame_intra(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                        qp: int, qpc: int, alpha_off: int = 0,
                        beta_off: int = 0,
                        trans8: np.ndarray | None = None):
    """Deblock a reconstructed all-intra 4:2:0 frame; returns new planes."""
    bs_ver, bs_hor = intra_bs_maps(*y.shape)
    return deblock_frame(y, u, v, qp, qpc, bs_ver, bs_hor,
                         alpha_off, beta_off, trans8=trans8)
