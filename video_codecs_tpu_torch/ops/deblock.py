"""HEVC deblocking filter (spec 8.7.2), batched over all edges.

Counterpart of video_codecs_tpu/ops/deblock.py.  The tables and
`_luma_params` / `_chroma_params` are the port's copies (each function
keeps its name and a comment gives the original's line); the edge filters
are the reference's integer arithmetic on int32 tensors of any device.
Vertical edges of the whole picture are filtered first, then horizontal
edges on the result, each pass one tensor op over all edges and 4-line
segments; the horizontal pass runs the vertical filter on the transpose.

The edge QP is a scalar, or, in pictures whose CU QPs vary
(cu_qp_delta), a per-segment map: `deblock_420_bs(qp_map=...)` takes a
[bh, bw] per-block QP map (the host low-delay P coder and its decoder)
or, with `seg4`, the general decoder's per-4x4 map, and the filters
gather tc and beta (and, for chroma, QpC through CHROMA_QP_TABLE_420
after cQpOffset, spec 8.7.2.5.5) from the tables by the edge QPs
(QP_P + QP_Q + 1) >> 1 (spec 8.7.2.5.3).  `deblock_420_bs_np` is not a
numpy twin in the reference either: it runs the device function on the
host (here: on CPU tensors).
"""

from __future__ import annotations

import numpy as np
import torch

from video_codecs_tpu_torch.utils import rom
from video_codecs_tpu_torch.utils.device import const

# TComLoopFilter.cpp:59-67 (spec Tables 8-12).
TC_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11,
     13, 14, 16, 18, 20, 22, 24], np.int32)
BETA_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11, 12,
     13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38, 40, 42,
     44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64], np.int32)
INTRA_TC_OFFSET = 2  # BS=2 -> tc index + 2


# video_codecs_tpu/ops/deblock.py:39
def _luma_params(qp: int, bit_depth: int = 8) -> tuple[int, int]:
    scale = 1 << (bit_depth - 8)
    tc = int(TC_TABLE[min(max(qp + INTRA_TC_OFFSET, 0), 53)]) * scale
    beta = int(BETA_TABLE[min(max(qp, 0), 51)]) * scale
    return tc, beta


# video_codecs_tpu/ops/deblock.py:46
def _chroma_params(qp: int, bit_depth: int = 8) -> int:
    qpc = int(rom.CHROMA_QP_TABLE_420[min(max(qp, 0), 57)])
    scale = 1 << (bit_depth - 8)
    return int(TC_TABLE[min(max(qpc + INTRA_TC_OFFSET, 0), 53)]) * scale


def _edge_qps(qp, device) -> torch.Tensor:
    """A per-segment edge-QP map as an int32 tensor on `device`."""
    if not isinstance(qp, torch.Tensor):
        qp = torch.from_numpy(np.ascontiguousarray(qp))
    return qp.to(device, torch.int32)


# video_codecs_tpu/ops/deblock.py:52
def _filter_ver_edges_luma(plane: torch.Tensor, edges: np.ndarray, qp,
                           bit_depth: int = 8,
                           bs: torch.Tensor | None = None,
                           beta_off: int = 0,
                           tc_off: int = 0) -> torch.Tensor:
    """Filter vertical luma edges at columns `edges` of an int32 plane.

    bs: optional [E, H//4] boundary strength per 4-line segment (0/1/2);
    None means BS=2 everywhere (all-intra picture).
    qp: scalar, or [E, H//4] per-segment edge QP ((QP_P + QP_Q + 1) >> 1,
    spec 8.7.2.5.3) when CU QPs vary (cu_qp_delta): tc and beta are then
    table gathers by the QP tensor."""
    if edges.size == 0:
        return plane
    dev = plane.device
    scale = 1 << (bit_depth - 8)
    # slice beta/tc offsets shift the table indices by 2*offset_div2
    # before clipping (spec 8.7.2.5.3)
    bo, to = 2 * beta_off, 2 * tc_off
    scalar_qp = isinstance(qp, (int, np.integer))
    if scalar_qp:
        qp = int(qp)
        tc2 = int(TC_TABLE[min(max(qp + INTRA_TC_OFFSET + to, 0),
                               53)]) * scale
        tc1 = int(TC_TABLE[min(max(qp + to, 0), 53)]) * scale
        beta = int(BETA_TABLE[min(max(qp + bo, 0), 51)]) * scale
        if beta == 0 and tc2 == 0:
            return plane
    else:
        qpa = _edge_qps(qp, dev)                               # [E, S]
        tct, btt = const(TC_TABLE, dev), const(BETA_TABLE, dev)
        tc2 = tct[(qpa + INTRA_TC_OFFSET + to).clamp(0, 53).long()] * scale
        tc1 = tct[(qpa + to).clamp(0, 53).long()] * scale
        beta = btt[(qpa + bo).clamp(0, 51).long()] * scale
    h = plane.shape[0]
    maxval = (1 << bit_depth) - 1
    idx = torch.from_numpy(edges[:, None] + np.arange(-4, 4)[None, :]).to(
        dev, torch.int64)                                      # [E, 8]
    blk = plane[:, idx]                                        # [H, E, 8]
    blk = blk.transpose(0, 1).reshape(-1, h // 4, 4, 8)        # [E, S, 4, 8]
    p3, p2, p1, p0 = blk[..., 0], blk[..., 1], blk[..., 2], blk[..., 3]
    q0, q1, q2, q3 = blk[..., 4], blk[..., 5], blk[..., 6], blk[..., 7]

    dp = (p2 - 2 * p1 + p0).abs()     # [E, S, 4]
    dq = (q2 - 2 * q1 + q0).abs()
    d0 = dp[..., 0] + dq[..., 0]      # [E, S]
    d3 = dp[..., 3] + dq[..., 3]
    d = d0 + d3
    if bs is None:
        filt = d < beta
        tc = torch.full_like(d, tc2) if scalar_qp else tc2
    else:
        bs = bs.to(dev)
        tc = torch.where(bs == 2, tc2, tc1).int()              # [E, S]
        filt = (d < beta) & (bs > 0)

    def strong_line(i):
        return ((2 * (dp[..., i] + dq[..., i]) < (beta >> 2)) &
                (((p3[..., i] - p0[..., i]).abs() +
                  (q0[..., i] - q3[..., i]).abs()) < (beta >> 3)) &
                ((p0[..., i] - q0[..., i]).abs() < ((5 * tc + 1) >> 1)))

    strong = filt & strong_line(0) & strong_line(3)            # [E, S]
    dp_s = dp[..., 0] + dp[..., 3]
    dq_s = dq[..., 0] + dq[..., 3]
    side_thr = (beta + (beta >> 1)) >> 3
    dep1 = dp_s < side_thr
    deq1 = dq_s < side_thr

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    # ---- strong filter (3 samples each side) ----
    tcl = tc[..., None]                                        # [E, S, 1]
    sp0 = clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
               p0 - 2 * tcl, p0 + 2 * tcl)
    sp1 = clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - 2 * tcl, p1 + 2 * tcl)
    sp2 = clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
               p2 - 2 * tcl, p2 + 2 * tcl)
    sq0 = clip((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
               q0 - 2 * tcl, q0 + 2 * tcl)
    sq1 = clip((q2 + q1 + q0 + p0 + 2) >> 2, q1 - 2 * tcl, q1 + 2 * tcl)
    sq2 = clip((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3,
               q2 - 2 * tcl, q2 + 2 * tcl)

    # ---- weak filter ----
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    weak_on = delta.abs() < 10 * tcl
    dclip = clip(delta, -tcl, tcl)
    wp0 = (p0 + dclip).clamp(0, maxval)
    wq0 = (q0 - dclip).clamp(0, maxval)
    tch = tcl >> 1
    dp1 = clip((((p2 + p0 + 1) >> 1) - p1 + dclip) >> 1, -tch, tch)
    wq1d = clip((((q2 + q0 + 1) >> 1) - q1 - dclip) >> 1, -tch, tch)
    wp1 = (p1 + dp1).clamp(0, maxval)
    wq1 = (q1 + wq1d).clamp(0, maxval)

    st = strong[..., None]                                     # [E, S, 1]
    fl = filt[..., None]
    wk = fl & ~st & weak_on
    out_p0 = torch.where(st, sp0, torch.where(wk, wp0, p0))
    out_q0 = torch.where(st, sq0, torch.where(wk, wq0, q0))
    out_p1 = torch.where(st, sp1, torch.where(wk & dep1[..., None], wp1, p1))
    out_q1 = torch.where(st, sq1, torch.where(wk & deq1[..., None], wq1, q1))
    out_p2 = torch.where(st, sp2, p2)
    out_q2 = torch.where(st, sq2, q2)

    new = torch.stack([out_p2, out_p1, out_p0, out_q0, out_q1, out_q2], dim=-1)
    new = new.reshape(edges.size, h, 6).transpose(0, 1)        # [H, E, 6]
    widx = idx[:, 1:7]
    out = plane.clone()
    out[:, widx] = new.to(out.dtype)
    return out


# video_codecs_tpu/ops/deblock.py:161
def _filter_ver_edges_chroma(plane: torch.Tensor, edges: np.ndarray, qp,
                             bit_depth: int = 8,
                             mask: torch.Tensor | None = None,
                             tc_off: int = 0,
                             qp_off: int = 0) -> torch.Tensor:
    """Chroma vertical edges, filtered where BS==2 (spec 8.7.2.5.5).

    mask: optional [E, H_c] bool (BS==2 per line); None = everywhere.
    qp: scalar luma edge QP, or [E, H_c] per-line luma edge QPs."""
    if edges.size == 0:
        return plane
    scale = 1 << (bit_depth - 8)
    scalar_qp = isinstance(qp, (int, np.integer))
    if scalar_qp:
        # QpC = table[Clip3(0, 57, qP + cQpOffset)] with the PPS
        # cb/cr offset (spec 8.7.2.5.5)
        qpc = int(rom.CHROMA_QP_TABLE_420[min(max(int(qp) + qp_off, 0),
                                              57)])
        tc = int(TC_TABLE[min(max(qpc + INTRA_TC_OFFSET + 2 * tc_off,
                                  0), 53)]) * scale
        if tc == 0:
            return plane
    else:
        dev = plane.device
        qpa = _edge_qps(qp, dev) + qp_off
        qpc = const(rom.CHROMA_QP_TABLE_420, dev)[qpa.clamp(0, 57).long()]
        tc = (const(TC_TABLE, dev)[
            (qpc + INTRA_TC_OFFSET + 2 * tc_off).clamp(0, 53).long()]
            * scale).transpose(0, 1)                          # [H_c, E]
    maxval = (1 << bit_depth) - 1
    idx = torch.from_numpy(edges[:, None] + np.arange(-2, 2)[None, :]).to(
        plane.device, torch.int64)
    blk = plane[:, idx]                                        # [H, E, 4]
    p1, p0, q0, q1 = blk[..., 0], blk[..., 1], blk[..., 2], blk[..., 3]
    delta = ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3).clamp(-tc, tc)
    np0 = (p0 + delta).clamp(0, maxval)
    nq0 = (q0 - delta).clamp(0, maxval)
    if mask is not None:
        m = mask.to(plane.device).transpose(0, 1)              # [H, E]
        np0 = torch.where(m, np0, p0)
        nq0 = torch.where(m, nq0, q0)
    new = torch.stack([np0, nq0], dim=-1)                      # [H, E, 2]
    out = plane.clone()
    out[:, idx[:, 1:3]] = new.to(out.dtype)
    return out


# video_codecs_tpu/ops/deblock.py:210
def deblock_420(rec_y: torch.Tensor, rec_u: torch.Tensor,
                rec_v: torch.Tensor, qp: int, block: int = 16,
                bit_depth: int = 8):
    """Deblock an all-intra picture with a uniform `block` CU/TU grid.

    Vertical edges first (whole picture), then horizontal on the result
    (HM loopFilterPic order).  Horizontal = vertical kernel on transpose.
    """
    h, w = rec_y.shape
    ey = np.arange(block, w, block, dtype=np.int32)
    ex = np.arange(block, h, block, dtype=np.int32)
    cb = block // 2
    cey = np.arange(cb, w // 2, cb, dtype=np.int32)
    cex = np.arange(cb, h // 2, cb, dtype=np.int32)

    rec_y = _filter_ver_edges_luma(rec_y, ey, qp, bit_depth)
    rec_y = _filter_ver_edges_luma(rec_y.T, ex, qp, bit_depth).T
    out_c = []
    for p in (rec_u, rec_v):
        p = _filter_ver_edges_chroma(p, cey, qp, bit_depth)
        p = _filter_ver_edges_chroma(p.T, cex, qp, bit_depth).T
        out_c.append(p.contiguous())
    return rec_y.contiguous(), out_c[0], out_c[1]


# video_codecs_tpu/ops/deblock.py:238
def deblock_420_np(rec_y: np.ndarray, rec_u: np.ndarray, rec_v: np.ndarray,
                   qp: int, block: int = 16, bit_depth: int = 8):
    """deblock_420 on numpy planes, run on CPU tensors."""
    with torch.inference_mode():
        out = deblock_420(*(torch.from_numpy(np.asarray(p, np.int32))
                            for p in (rec_y, rec_u, rec_v)),
                          qp, block, bit_depth)
    return tuple(o.numpy() for o in out)


# video_codecs_tpu/ops/deblock.py:245
def deblock_420_bs(rec_y, rec_u, rec_v, qp,
                   bs_ver: np.ndarray, bs_hor: np.ndarray,
                   block: int = 16, bit_depth: int = 8,
                   qp_map=None, seg4: bool = False,
                   beta_off: int = 0, tc_off: int = 0,
                   cb_qp_off: int = 0, cr_qp_off: int = 0):
    """Deblock int32 planes with per-block-pair boundary strengths.

    bs_ver: [n_ver_edges, bh] BS between horizontally adjacent blocks;
    bs_hor: [n_hor_edges, bw] BS between vertically adjacent blocks
    (numpy arrays or tensors).  seg4: the maps are already per 4-sample
    segment ([E, H//4] / [E, W//4]); block must be 8.
    qp_map: optional [bh, bw] per-block luma QP (cu_qp_delta pictures),
    or with seg4 the [H//4, W//4] per-4x4 map of the general decoder;
    edge QPs follow spec 8.7.2.5.3: (QP_P + QP_Q + 1) >> 1."""
    dev = rec_y.device
    h, w = rec_y.shape
    ey = np.arange(block, w, block, dtype=np.int32)
    ex = np.arange(block, h, block, dtype=np.int32)
    segs = block // 4
    bs_ver = torch.as_tensor(bs_ver, device=dev)
    bs_hor = torch.as_tensor(bs_hor, device=dev)
    if seg4:
        assert block == 8
        bs_v, bs_h = bs_ver, bs_hor
    else:
        bs_v = bs_ver.repeat_interleave(segs, dim=1)
        bs_h = bs_hor.repeat_interleave(segs, dim=1)
    qp_v = qp_h = qp
    cqp_v = cqp_h = qp
    if qp_map is not None and seg4:
        # per-4x4 luma QP map (cu_qp_delta pictures, general decoder):
        # edge QP = (QP_P + QP_Q + 1) >> 1 per 4-sample segment
        # (spec 8.7.2.5.3)
        q4 = _edge_qps(qp_map, dev)                            # [H//4, W//4]
        cv = torch.as_tensor(ey // 4, dtype=torch.long, device=dev)
        rh = torch.as_tensor(ex // 4, dtype=torch.long, device=dev)
        qp_v = ((q4[:, cv - 1] + q4[:, cv] + 1) >> 1).T
        qp_h = (q4[rh - 1, :] + q4[rh, :] + 1) >> 1
        cqp_v = qp_v[1::2].repeat_interleave(2, dim=1)
        cqp_h = qp_h[1::2].repeat_interleave(2, dim=1)
    elif qp_map is not None:
        qm = _edge_qps(qp_map, dev)
        qe_v = (qm[:, :-1] + qm[:, 1:] + 1) >> 1               # [bh, E]
        qe_h = (qm[:-1, :] + qm[1:, :] + 1) >> 1               # [E, bw]
        qp_v = qe_v.T.repeat_interleave(segs, dim=1)           # [E, H//4]
        qp_h = qe_h.repeat_interleave(segs, dim=1)             # [E, W//4]
        step_ = 16 // block
        crep_ = block // 2
        cqp_v = qe_v.T[step_ - 1::step_].repeat_interleave(crep_, dim=1)
        cqp_h = qe_h[step_ - 1::step_].repeat_interleave(crep_, dim=1)
    rec_y = _filter_ver_edges_luma(rec_y, ey, qp_v, bit_depth, bs=bs_v,
                                   beta_off=beta_off, tc_off=tc_off)
    rec_y = _filter_ver_edges_luma(rec_y.T, ex, qp_h, bit_depth, bs=bs_h,
                                   beta_off=beta_off, tc_off=tc_off).T

    # Chroma edges always lie on the 16-luma-sample grid (spec 8.7.2); for
    # block=8 only every second luma edge has a chroma counterpart.
    step = 16 // block
    cey = np.arange(8, w // 2, 8, dtype=np.int32)
    cex = np.arange(8, h // 2, 8, dtype=np.int32)
    # chroma rows covered by one BS row: 4 luma = 2 chroma when seg4
    crep = 2 if seg4 else block // 2
    cm_v = (bs_ver[step - 1::step] == 2).repeat_interleave(crep, dim=1)
    cm_h = (bs_hor[step - 1::step] == 2).repeat_interleave(crep, dim=1)
    out_c = []
    for p, coff in ((rec_u, cb_qp_off), (rec_v, cr_qp_off)):
        p = _filter_ver_edges_chroma(p, cey, cqp_v, bit_depth, mask=cm_v,
                                     tc_off=tc_off, qp_off=coff)
        p = _filter_ver_edges_chroma(p.T, cex, cqp_h, bit_depth,
                                     mask=cm_h, tc_off=tc_off,
                                     qp_off=coff).T
        out_c.append(p)
    return rec_y.contiguous(), out_c[0].contiguous(), out_c[1].contiguous()


# video_codecs_tpu/ops/deblock.py:319
def deblock_420_bs_np(rec_y, rec_u, rec_v, qp, bs_ver, bs_hor,
                      block: int = 16, bit_depth: int = 8, qp_map=None,
                      seg4: bool = False, beta_off: int = 0,
                      tc_off: int = 0, cb_qp_off: int = 0,
                      cr_qp_off: int = 0):
    """deblock_420_bs on numpy planes, run on CPU tensors."""
    with torch.inference_mode():
        out = deblock_420_bs(*(torch.from_numpy(np.asarray(p, np.int32))
                               for p in (rec_y, rec_u, rec_v)),
                             qp, np.asarray(bs_ver), np.asarray(bs_hor),
                             block, bit_depth, qp_map=qp_map, seg4=seg4,
                             beta_off=beta_off, tc_off=tc_off,
                             cb_qp_off=cb_qp_off, cr_qp_off=cr_qp_off)
    return tuple(o.numpy() for o in out)
