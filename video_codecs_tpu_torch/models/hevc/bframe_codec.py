"""Flat 16x16 hierarchical-B syntax: the B block record, the spec merge
and AMVP derivations, the slice writer and the encoder base of the
random-access encoders.

The port's copy of the part of video_codecs_tpu/models/hevc/bframe_codec.py
that the flat device engines (models/hevc/inter_dev.py
`DeviceHierarchicalBEncoder`, `DeviceRandomAccessEncoder`) and the CTB32
quadtree encoder run, function by function (each keeps its name and a
comment gives the original's line): `BBlock`, `mv_scale`,
`derive_merge`, `derive_amvp_b`, `write_b_slice_header`, the
hierarchical-B GOP loop `encode_sequence_rab`, the CTB16 B slice and CU
writers and `_bs_maps_b`, the host twin of the device engines' BS maps.
Cut: the host B-picture decision loop `_encode_b_frame` (it raises; the
device engines override it), `parse_b_slice_header` and
`HierarchicalBDecoder` (the port decodes with models/hevc/decoder.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from video_codecs_tpu_torch.entropy import bitstream as bs
from video_codecs_tpu_torch.entropy import cabac, ctx, residual
from video_codecs_tpu_torch.models.hevc import inter_codec as pc
from video_codecs_tpu_torch.models.hevc import intra_codec as ic
from video_codecs_tpu_torch.utils import rom

DC = 1
NAL_TRAIL_N = 0
NAL_TRAIL_R = 1
MODE_INTER, MODE_INTRA = 0, 1
L0, L1 = 0, 1


# video_codecs_tpu/models/hevc/bframe_codec.py:42
@dataclasses.dataclass
class BBlock:
    pred_mode: int = MODE_INTRA
    skip: bool = False
    merge: bool = False
    inter_dir: int = 1            # 1 = L0, 2 = L1 (3 = BI unused)
    mv: dict = dataclasses.field(default_factory=dict)  # list -> (mvx, mvy)
    mvp_idx: int = 0
    mvd: tuple[int, int] = (0, 0)
    intra_mode: int = DC
    cbf_y: bool = False
    cbf_cb: bool = False
    cbf_cr: bool = False
    levels_y: np.ndarray | None = None
    levels_cb: np.ndarray | None = None
    levels_cr: np.ndarray | None = None


# video_codecs_tpu/models/hevc/bframe_codec.py:60
def mv_scale(mv: tuple[int, int], tb: int, td: int) -> tuple[int, int]:
    """Spec 8.5.3.2.8 temporal MV scaling (both refs short-term)."""
    if tb == td:
        return mv
    tx = (16384 + abs(td) // 2) // td
    dsf = max(-4096, min(4095, (tb * tx + 32) >> 6))
    out = []
    for c in mv:
        v = dsf * c
        v = (abs(v) + 127) >> 8
        v = -v if (dsf * c) < 0 else v
        out.append(max(-32768, min(32767, v)))
    return (out[0], out[1])


# video_codecs_tpu/models/hevc/bframe_codec.py:75
def derive_merge(info, bx, by, bw, bh,
                 is_b_slice: bool = False) -> tuple[int, dict]:
    """First merge candidate: copies interDir + MVs of the first available
    inter neighbor (A1, B1, B0, A0, B2); the zero fallback is
    BI-predictive in B slices (spec 8.5.3.2.3: zero candidates set both
    predFlagL0 and predFlagL1 for B)."""
    def nb(nbx, nby):
        if nbx < 0 or nby < 0 or nbx >= bw or nby >= bh:
            return None
        if nby > by or (nby == by and nbx > bx):
            return None
        b = info[nby][nbx]
        if b is None or b.pred_mode != MODE_INTER:
            return None
        return b

    for nbx, nby in ((bx - 1, by), (bx, by - 1), (bx + 1, by - 1),
                     (bx - 1, by + 1), (bx - 1, by - 1)):
        b = nb(nbx, nby)
        if b is not None:
            return b.inter_dir, dict(b.mv)
    if is_b_slice:
        return 3, {L0: (0, 0), L1: (0, 0)}
    return 1, {L0: (0, 0)}


# video_codecs_tpu/models/hevc/bframe_codec.py:101
def derive_amvp_b(info, bx, by, bw, bh, lx: int, poc: int,
                  ref_poc: dict) -> list[tuple[int, int]]:
    """AMVP for list lx (spec 8.5.3.2.6 with short-term refs + scaling).

    ref_poc: {L0: poc_of_l0_ref, L1: poc_of_l1_ref} of the CURRENT slice.
    Neighbor refs resolve through the same mapping (all pictures of a
    layer share the anchor structure, and B MVs are never referenced)."""
    target = ref_poc[lx]

    def nb(nbx, nby):
        if nbx < 0 or nby < 0 or nbx >= bw or nby >= bh:
            return None
        if nby > by or (nby == by and nbx > bx):
            return None
        b = info[nby][nbx]
        if b is None or b.pred_mode != MODE_INTER:
            return None
        return b

    def same_poc_mv(b):
        # pass 1: same reference picture, either list, no scaling
        for lst in (lx, 1 - lx):
            if lst in b.mv and ref_poc.get(lst) == target:
                return b.mv[lst]
        return None

    def scaled_mv(b):
        # pass 2: any available list, scaled by POC distances
        for lst in (lx, 1 - lx):
            if lst in b.mv:
                tb = poc - target
                td = poc - ref_poc[lst]
                return mv_scale(b.mv[lst], tb, td)
        return None

    a1 = nb(bx - 1, by)               # A0 (below-left) never available
    is_scaled = a1 is not None        # isScaledFlagLX
    mv_a = None
    if a1 is not None:
        mv_a = same_poc_mv(a1)
        if mv_a is None:
            mv_a = scaled_mv(a1)      # A's scaled pass

    mv_b = None
    for nbx, nby in ((bx + 1, by - 1), (bx, by - 1), (bx - 1, by - 1)):
        b = nb(nbx, nby)
        if b is not None:
            mv_b = same_poc_mv(b)
            if mv_b is not None:
                break
    if not is_scaled:                 # spec: promote B to A, rescan B scaled
        if mv_a is None:
            mv_a = mv_b
            mv_b = None
        for nbx, nby in ((bx + 1, by - 1), (bx, by - 1), (bx - 1, by - 1)):
            b = nb(nbx, nby)
            if b is not None:
                cand = scaled_mv(b)
                if cand is not None:
                    mv_b = cand
                    break

    out = []
    if mv_a is not None:
        out.append(tuple(mv_a))
    if mv_b is not None and (not out or tuple(mv_b) != out[0]):
        out.append(tuple(mv_b))
    while len(out) < 2:
        out.append((0, 0))
    return out[:2]


# video_codecs_tpu/models/hevc/bframe_codec.py:173
def write_b_slice_header(cfg, poc: int, is_anchor: bool,
                         neg_delta: int = 2):
    w = bs.BitWriter()
    w.flag(1)              # first_slice_segment_in_pic_flag
    w.ue(0)                # pps id
    w.ue(1 if is_anchor else 0)   # slice_type: P anchors, B otherwise
    w.write(poc & 255, 8)
    w.flag(0)              # short_term_ref_pic_set_sps_flag
    if is_anchor:
        w.ue(1)            # num_negative_pics
        w.ue(0)            # num_positive_pics
        w.ue(neg_delta - 1)  # delta_poc_s0_minus1
        w.flag(1)
    else:
        w.ue(1)
        w.ue(1)
        w.ue(0)            # neg delta 1
        w.flag(1)
        w.ue(0)            # pos delta 1
        w.flag(1)
    if cfg.sao:
        w.flag(1)          # slice_sao_luma_flag
        w.flag(1)          # slice_sao_chroma_flag
    w.flag(0)              # num_ref_idx_active_override_flag
    if not is_anchor:
        w.flag(0)          # mvd_l1_zero_flag
    w.ue(4)                # five_minus_max_num_merge_cand -> 1
    w.se(cfg.qp - 26)
    if not cfg.deblocking_disabled:
        w.flag(1)
    w.byte_alignment()
    return w


# video_codecs_tpu/models/hevc/bframe_codec.py:236
class HierarchicalBEncoder(pc.LowDelayEncoder):
    """I0 + P anchors (delta 2) + non-reference B pictures between."""

    # video_codecs_tpu/models/hevc/bframe_codec.py:239
    def encode_sequence_rab(self, frames):
        """frames in display order (even count preferred)."""
        cfg = self.cfg
        nals = self.stream_headers()
        recons: dict[int, tuple] = {}
        fn, rec = self.encode_frame(*frames[0])
        nals.extend(fn)
        recons[0] = rec
        prev_anchor_poc = 0
        poc = 2
        i = 2
        while i < len(frames):
            # anchor P at display index i (POC i)
            fnp, recp = self._encode_b_frame(
                frames[i], i, {L0: (prev_anchor_poc, recons[prev_anchor_poc])},
                is_anchor=True)
            nals.extend(fnp)
            recons[i] = recp
            # B between
            fnb, recb = self._encode_b_frame(
                frames[i - 1], i - 1,
                {L0: (prev_anchor_poc, recons[prev_anchor_poc]),
                 L1: (i, recons[i])}, is_anchor=False)
            nals.extend(fnb)
            recons[i - 1] = recb
            prev_anchor_poc = i
            i += 2
        if i - 1 < len(frames):   # trailing odd frame: extra anchor
            fnp, recp = self._encode_b_frame(
                frames[i - 1], i - 1,
                {L0: (prev_anchor_poc, recons[prev_anchor_poc])},
                is_anchor=True)
            nals.extend(fnp)
            recons[i - 1] = recp
        ordered = [recons[k] for k in sorted(recons)]
        return bs.annexb(nals), ordered

    # video_codecs_tpu/models/hevc/bframe_codec.py:276
    def _encode_b_frame(self, frame, poc, refs, is_anchor):
        """The host decision loop is not ported: the device engines
        (inter_dev.DeviceHierarchicalBEncoder and
        DeviceRandomAccessEncoder) code B and anchor P pictures."""
        raise NotImplementedError(
            "HierarchicalBEncoder._encode_b_frame: the host B coder is not "
            "ported (inter_dev.DeviceHierarchicalBEncoder)")

    # video_codecs_tpu/models/hevc/bframe_codec.py:438
    def _encode_b_slice(self, info, poc, is_anchor, ref_poc,
                        neg_delta=2, sao_params=None) -> bytes:
        cfg = self.cfg
        bw, bh = cfg.width // 16, cfg.height // 16
        w = write_b_slice_header(cfg, poc, is_anchor, neg_delta)
        init_row = ctx.P if is_anchor else ctx.B
        enc = cabac.CabacEncoder(w, ctx.init_states(init_row, cfg.qp))
        for by in range(bh):
            for bx in range(bw):
                if sao_params is not None:
                    ic.encode_sao_ctu(enc, sao_params, by * bw + bx,
                                      bx, by, bw, 0)
                self._encode_b_ctu(enc, info, bx, by, bw, bh, is_anchor)
                last = by == bh - 1 and bx == bw - 1
                enc.encode_terminate(1 if last else 0)
        enc.finish_slice()
        nal_type = NAL_TRAIL_R if is_anchor else NAL_TRAIL_N
        return bs.nal_unit(nal_type, w.data())

    # video_codecs_tpu/models/hevc/bframe_codec.py:457
    def _encode_b_ctu(self, enc, info, bx, by, bw, bh, is_anchor):
        b: BBlock = info[by][bx]
        left = info[by][bx - 1] if bx else None
        above = info[by - 1][bx] if by else None
        skip_ctx = (1 if (left and left.skip) else 0) + \
                   (1 if (above and above.skip) else 0)
        enc.encode_bin(ctx.off("skip_flag", skip_ctx), 1 if b.skip else 0)
        if b.skip:
            return
        enc.encode_bin(ctx.off("pred_mode"),
                       1 if b.pred_mode == MODE_INTRA else 0)
        if b.pred_mode == MODE_INTRA:
            left_mode = (left.intra_mode
                         if left and left.pred_mode == MODE_INTRA else DC)
            self._encode_intra_part(enc, _AsP(b), left_mode)
        else:
            enc.encode_bin(ctx.off("part_size"), 1)
            enc.encode_bin(ctx.off("merge_flag"), 1 if b.merge else 0)
            if not b.merge:
                if not is_anchor:  # B slice: inter_pred_idc
                    if b.inter_dir == 3:
                        enc.encode_bin(ctx.off("inter_dir", 0), 1)
                    else:
                        enc.encode_bin(ctx.off("inter_dir", 0), 0)
                        enc.encode_bin(ctx.off("inter_dir", 4),
                                       0 if b.inter_dir == 1 else 1)
                if b.inter_dir == 3:
                    self._encode_mvd(enc, b.mvd[L0])
                    enc.encode_bin(ctx.off("mvp_idx"), b.mvp_idx[L0])
                    self._encode_mvd(enc, b.mvd[L1])
                    enc.encode_bin(ctx.off("mvp_idx"), b.mvp_idx[L1])
                else:
                    self._encode_mvd(enc, b.mvd)
                    enc.encode_bin(ctx.off("mvp_idx"), b.mvp_idx)
            has_res = b.cbf_y or b.cbf_cb or b.cbf_cr
            if not b.merge:
                enc.encode_bin(ctx.off("qt_root_cbf"), 1 if has_res else 0)
                if not has_res:
                    return
            enc.encode_bin(ctx.off("cbf_chroma"), 1 if b.cbf_cb else 0)
            enc.encode_bin(ctx.off("cbf_chroma"), 1 if b.cbf_cr else 0)
            if b.cbf_cb or b.cbf_cr:
                enc.encode_bin(ctx.off("cbf_luma", 1), 1 if b.cbf_y else 0)
            else:
                assert b.cbf_y
            self._write_residuals(enc, b)
            return
        enc.encode_bin(ctx.off("cbf_chroma"), 1 if b.cbf_cb else 0)
        enc.encode_bin(ctx.off("cbf_chroma"), 1 if b.cbf_cr else 0)
        enc.encode_bin(ctx.off("cbf_luma", 1), 1 if b.cbf_y else 0)
        self._write_residuals(enc, b)

    # video_codecs_tpu/models/hevc/bframe_codec.py:509
    def _write_residuals(self, enc, b):
        sbh = self.cfg.sign_data_hiding
        if b.cbf_y:
            residual.encode_residual(enc, b.levels_y, 4, rom.SCAN_DIAG, True,
                                     sign_hiding=sbh)
        if b.cbf_cb:
            residual.encode_residual(enc, b.levels_cb, 3, rom.SCAN_DIAG,
                                     False, sign_hiding=sbh)
        if b.cbf_cr:
            residual.encode_residual(enc, b.levels_cr, 3, rom.SCAN_DIAG,
                                     False, sign_hiding=sbh)


# video_codecs_tpu/models/hevc/bframe_codec.py:522
class _AsP:
    """Adapter so the P-path intra syntax helper accepts BBlock."""

    # video_codecs_tpu/models/hevc/bframe_codec.py:525
    def __init__(self, b: BBlock) -> None:
        self.intra_mode = b.intra_mode


# video_codecs_tpu/models/hevc/bframe_codec.py:529
def _bs_maps_b(info, bw, bh, ref_poc):
    bs_ver = np.zeros((bw - 1, bh), np.int32)
    bs_hor = np.zeros((bh - 1, bw), np.int32)

    def bsv(a: BBlock, b: BBlock) -> int:
        if a.pred_mode == MODE_INTRA or b.pred_mode == MODE_INTRA:
            return 2
        if a.cbf_y or b.cbf_y:
            return 1
        if a.inter_dir != b.inter_dir:
            return 1  # different prediction structure / MV count
        if a.inter_dir == 3:
            for ll in (L0, L1):
                if (abs(a.mv[ll][0] - b.mv[ll][0]) >= 4 or
                        abs(a.mv[ll][1] - b.mv[ll][1]) >= 4):
                    return 1
            return 0
        lx = L0 if 1 & a.inter_dir else L1
        mva, mvb = a.mv[lx], b.mv[lx]
        if abs(mva[0] - mvb[0]) >= 4 or abs(mva[1] - mvb[1]) >= 4:
            return 1
        return 0

    for by in range(bh):
        for bx in range(1, bw):
            bs_ver[bx - 1, by] = bsv(info[by][bx - 1], info[by][bx])
    for by in range(1, bh):
        for bx in range(bw):
            bs_hor[by - 1, bx] = bsv(info[by - 1][bx], info[by][bx])
    return bs_ver, bs_hor
