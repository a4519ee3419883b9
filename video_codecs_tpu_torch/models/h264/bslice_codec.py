"""H.264 B slices: hierarchical-flat IBBP GOPs with spatial direct mode.

The port's copy of video_codecs_tpu/models/h264/bslice_codec.py, whole:
each function and class keeps its name and a comment gives the
original's line.  The B coder's integer searches run on the card stage
of the host P coder (`H264Encoder._card_stage`: one
`host_me.RefSearch`, i.e. one SAD-kernel launch, per list and B
picture, made on `device`, the card unless the caller passes "cpu"),
as its P anchors' do; its bi averages and direct predictions keep the
reference's `mc_luma_np` / `mc_chroma_np`.  The trace and statistics
wrappers of the entropy coders are cut.

Mirrors JM-18.5 B-slice behavior (reference: jm18.5 lencod/ldecod —
spatial direct derivation lcommon/src/mc_direct.c Get_Direct_Motion_Vectors
spatial branch, B mb_type CAVLC spec Table 7-14, CABAC writeMB_B_typeInfo
lencod/src/cabac.c:626, writeMB_Bskip_flagInfo :456, POC type 0 handling
lencod/src/lencod.c / ldecod/src/image.c decode_poc) without copying its
structure: the encoder reuses the whole-frame numpy passes of the P codec
and adds a second reference list, bi-prediction averaging, and the
spec-8.4.1.2.2 spatial direct with direct_8x8_inference colocated corners.

Toolset: the full B macroblock partition set of spec Table 7-14 —
16x16 (B_Direct_16x16 / B_L0 / B_L1 / B_Bi / B_Skip + intra), the 18
two-partition 16x8 / 8x16 types with per-partition L0/L1/Bi, and B_8x8
with 8x8-only sub_mb_types (B_Direct_8x8 / L0 / L1 / Bi) — encoded
with one reference per list (past anchor in L0, future anchor in L1);
the decoder additionally handles multi-reference lists with
per-partition ref_idx (JM streams).  Non-reference B pictures,
pic_order_cnt_type 0, CAVLC or CABAC (per-4x4 mvd and ref_idx context
grids per spec 9.3.3.1.1.6-7).
"""

from __future__ import annotations

import numpy as np

from video_codecs_tpu_torch.entropy import cavlc
from video_codecs_tpu_torch.entropy import h264_cabac as hc
from video_codecs_tpu_torch.entropy.bitstream import (
    BitReader, BitWriter, split_annexb)
from video_codecs_tpu_torch.ops import h264_transform as ht
from video_codecs_tpu_torch.ops.h264_deblock import deblock_frame
from video_codecs_tpu_torch.ops.h264_interp import mc_chroma_np, mc_luma_np
from video_codecs_tpu_torch.models.h264.intra_codec import (
    _BLK_X, _BLK_Y, _decoded_before, NcGrid, annexb, nal_unit, parse_pps,
    parse_sps, pred_luma16, strip_emulation_prevention, write_pps,
    write_sps, NAL_SPS, NAL_PPS, NAL_SLICE_IDR)
from video_codecs_tpu_torch.models.h264.inter_codec import (
    H264Decoder, H264Encoder, _CBP_FROM_CODE_INTER_420, _NCBP_INTER_420,
    _code_residual_16, _se_bits, _te_read, _ue_bits, median_mv_pred,
    mv_pred_part, wp_apply)

# direct_8x8_inference colocated corner 4x4 per 8x8 quadrant (spec 8.4.1.2.2)
_QUAD_COL = {(0, 0): (0, 0), (0, 1): (3, 0), (1, 0): (0, 3), (1, 1): (3, 3)}

# Two-partition B macroblock types (spec Table 7-14): mb_type 4 + 2*i is
# the 16x8 flavor of prediction pair i, 4 + 2*i + 1 the 8x16 flavor.
# Per-partition prediction modes: 0 = Pred_L0, 1 = Pred_L1, 2 = BiPred.
_B_PAIRS = [(0, 0), (1, 1), (0, 1), (1, 0), (0, 2), (1, 2),
            (2, 0), (2, 1), (2, 2)]
_B_RECT = {}          # mb_type -> (partition geometry, (mode0, mode1))
for _i, _pair in enumerate(_B_PAIRS):
    _B_RECT[4 + 2 * _i] = (((0, 0, 16, 8), (0, 8, 16, 8)), _pair)
    _B_RECT[5 + 2 * _i] = (((0, 0, 8, 16), (8, 0, 8, 16)), _pair)
# B sub_mb_type (spec Table 7-18): mode (0 = L0, 1 = L1, 2 = Bi,
# None = B_Direct_8x8) and sub-partition geometry within the 8x8.
# The encoder emits only 0..3; the decoder handles the full table
# (8x4 / 4x8 / 4x4 sub-partitions appear in JM streams).
_B_SUB_GEO = {
    0: (None, ((0, 0, 8, 8),)),
    1: (0, ((0, 0, 8, 8),)),
    2: (1, ((0, 0, 8, 8),)),
    3: (2, ((0, 0, 8, 8),)),
    4: (0, ((0, 0, 8, 4), (0, 4, 8, 4))),
    5: (0, ((0, 0, 4, 8), (4, 0, 4, 8))),
    6: (1, ((0, 0, 8, 4), (0, 4, 8, 4))),
    7: (1, ((0, 0, 4, 8), (4, 0, 4, 8))),
    8: (2, ((0, 0, 8, 4), (0, 4, 8, 4))),
    9: (2, ((0, 0, 4, 8), (4, 0, 4, 8))),
    10: (0, ((0, 0, 4, 4), (4, 0, 4, 4), (0, 4, 4, 4), (4, 4, 4, 4))),
    11: (1, ((0, 0, 4, 4), (4, 0, 4, 4), (0, 4, 4, 4), (4, 4, 4, 4))),
    12: (2, ((0, 0, 4, 4), (4, 0, 4, 4), (0, 4, 4, 4), (4, 4, 4, 4))),
}


# video_codecs_tpu/models/h264/bslice_codec.py:74
def _min_positive(a: int, b: int) -> int:
    """MinPositive (spec 8.4.1.2.2): min if both >= 0, else the max."""
    return min(a, b) if (a >= 0 and b >= 0) else max(a, b)


# video_codecs_tpu/models/h264/bslice_codec.py:79
def _neighbor_ref(refg, gx, gy, w4) -> int:
    """MinPositive over the A/B/C (D-fallback) neighbor refIdx values;
    unavailable or intra neighbors contribute -1 (refg stores -1)."""
    h4 = refg.shape[0]

    def nb(bx, by):
        if bx < 0 or by < 0 or bx >= w4 or by >= h4:
            return -1
        return int(refg[by, bx])

    a = nb(gx - 1, gy)
    b = nb(gx, gy - 1)
    c = nb(gx + 4, gy - 1)
    if gy - 1 < 0 or gx + 4 >= w4:
        c = nb(gx - 1, gy - 1)
    return _min_positive(_min_positive(a, b), c)


# video_codecs_tpu/models/h264/bslice_codec.py:97
def spatial_direct(mvg0, refg0, mvg1, refg1, gx, gy, w4,
                   col_mvg, col_refg):
    """Spatial direct 16x16 derivation (spec 8.4.1.2.2 with
    direct_8x8_inference_flag = 1): returns (ref0, ref1, mv0, mv1) where
    mvX are (2, 2, 2) per-8x8-quadrant vectors.  col_mvg/col_refg are the
    colocated picture's (RefPicList1[0]) list-0 motion field."""
    ref0 = _neighbor_ref(refg0, gx, gy, w4)
    ref1 = _neighbor_ref(refg1, gx, gy, w4)
    mv0 = np.zeros((2, 2, 2), np.int32)
    mv1 = np.zeros((2, 2, 2), np.int32)
    if ref0 < 0 and ref1 < 0:
        return 0, 0, mv0, mv1        # directZeroPredictionFlag
    mvp0 = median_mv_pred(mvg0, refg0, gx, gy, w4, ref=ref0) \
        if ref0 >= 0 else (0, 0)
    mvp1 = median_mv_pred(mvg1, refg1, gx, gy, w4, ref=ref1) \
        if ref1 >= 0 else (0, 0)
    for qy in range(2):
        for qx in range(2):
            cx4, cy4 = _QUAD_COL[(qy, qx)]
            cbx, cby = gx + cx4, gy + cy4
            col_zero = (int(col_refg[cby, cbx]) == 0
                        and abs(int(col_mvg[cby, cbx, 0])) <= 1
                        and abs(int(col_mvg[cby, cbx, 1])) <= 1)
            if ref0 >= 0 and not (ref0 == 0 and col_zero):
                mv0[qy, qx] = mvp0
            if ref1 >= 0 and not (ref1 == 0 and col_zero):
                mv1[qy, qx] = mvp1
    return ref0, ref1, mv0, mv1


# video_codecs_tpu/models/h264/bslice_codec.py:127
def bs_maps_b(intra_mb, nz_y, mv0, refpoc0, mv1, refpoc1):
    """Boundary-strength maps for a B frame at 4x4 granularity
    (spec 8.7.2.1): motion comparison over the unordered set of
    (reference picture, mv) pairs, canonicalized by sorting on POC.
    refpocX holds the POC of the referenced picture or -1 if list X is
    unused by that block."""
    mbh, mbw = intra_mb.shape
    h4, w4 = mbh * 4, mbw * 4
    intra4 = np.repeat(np.repeat(intra_mb, 4, 0), 4, 1)
    nz = nz_y > 0
    # canonical slots: A = lower-POC pair, B = the other (or unused = -1)
    used0 = refpoc0 >= 0
    used1 = refpoc1 >= 0
    swap = (used0 & used1 & (refpoc1 < refpoc0)) | (~used0 & used1)
    pa_poc = np.where(swap, refpoc1, refpoc0)
    pb_poc = np.where(swap, refpoc0, refpoc1)
    pa_mv = np.where(swap[..., None], mv1, mv0)
    pb_mv = np.where(swap[..., None], mv0, mv1)
    bs_ver = np.zeros((h4, w4), np.int32)
    bs_hor = np.zeros((h4, w4), np.int32)
    for axis, bs in ((1, bs_ver), (0, bs_hor)):
        if axis == 1:
            pi = (slice(None), slice(None, -1))
            qi = (slice(None), slice(1, None))
            tgt = bs[:, 1:]
            mb_edge = (np.arange(1, w4) % 4 == 0)[None, :]
        else:
            pi = (slice(None, -1), slice(None))
            qi = (slice(1, None), slice(None))
            tgt = bs[1:, :]
            mb_edge = (np.arange(1, h4) % 4 == 0)[:, None]
        any_intra = intra4[pi] | intra4[qi]
        any_nz = nz[pi] | nz[qi]
        ref_mismatch = (pa_poc[pi] != pa_poc[qi]) | (pb_poc[pi] != pb_poc[qi])
        dmv_a = (np.abs(pa_mv[pi] - pa_mv[qi]).max(axis=-1) >= 4) \
            & (pa_poc[pi] >= 0)
        dmv_b = (np.abs(pb_mv[pi] - pb_mv[qi]).max(axis=-1) >= 4) \
            & (pb_poc[pi] >= 0)
        tgt[...] = np.where(any_intra, np.where(mb_edge, 4, 3),
                            np.where(any_nz, 2,
                                     np.where(ref_mismatch | dmv_a | dmv_b,
                                              1, 0)))
    return bs_ver, bs_hor


# video_codecs_tpu/models/h264/bslice_codec.py:172
class H264BEncoder(H264Encoder):
    """IDR + P anchors + non-reference B pictures between anchors."""

    # video_codecs_tpu/models/h264/bslice_codec.py:175
    def __init__(self, width: int, height: int, qp: int = 28,
                 search_range: int = 16, b_frames: int = 1,
                 entropy: str = "cavlc", quant: str = "normal",
                 b_qp_offset: int = 0, b_parts: bool = True,
                 device="cuda") -> None:
        super().__init__(width, height, qp=qp, search_range=search_range,
                         entropy=entropy, quant=quant, device=device)
        assert b_frames >= 1
        self.b_frames = b_frames
        self.b_qp_offset = b_qp_offset
        self.b_parts = b_parts     # 16x8 / 8x16 / B_8x8 partition search

    # video_codecs_tpu/models/h264/bslice_codec.py:186
    def encode_sequence(self, frames):
        cabac = self.entropy == "cabac"
        mbw, mbh = self.w // 16, self.h // 16
        nals = [nal_unit(NAL_SPS, write_sps(mbw, mbh,
                                            profile=77 if cabac else 66,
                                            num_ref_frames=2, poc_type=0)),
                nal_unit(NAL_PPS, write_pps(cabac=cabac))]
        n = len(frames)
        recons: list = [None] * n
        y, u, v = frames[0]
        rbsp, rec = self.encode_frame(y, u, v, idr_id=0, poc=0)
        nals.append(nal_unit(NAL_SLICE_IDR, rbsp))
        recons[0] = rec
        zero_mv = np.zeros((mbh * 4, mbw * 4, 2), np.int32)
        zero_ref = np.full((mbh * 4, mbw * 4), -1, np.int32)
        dpb = [dict(rec=rec, poc=0, mvg=zero_mv, refg=zero_ref)]
        prev_ref_fn = 0
        pos = 0
        while pos < n - 1:
            nxt = min(pos + self.b_frames + 1, n - 1)
            fn = (prev_ref_fn + 1) & 0xFF
            y, u, v = frames[nxt]
            rbsp, rec = self._encode_p_frame(y, u, v, [dpb[0]["rec"]],
                                             fn, poc=2 * nxt)
            nals.append(nal_unit(1, rbsp, ref_idc=2))
            recons[nxt] = rec
            dpb.insert(0, dict(rec=rec, poc=2 * nxt,
                               mvg=self._prev_mvg.copy(),
                               refg=self._prev_refg.copy()))
            del dpb[2:]
            prev_ref_fn = fn
            bfn = (prev_ref_fn + 1) & 0xFF
            for i in range(pos + 1, nxt):
                rbsp, rec = self._encode_b_frame(frames[i], dpb[1], dpb[0],
                                                 bfn, 2 * i)
                nals.append(nal_unit(1, rbsp, ref_idc=0))
                recons[i] = rec
            pos = nxt
        return annexb(nals), recons

    # -- B frame -------------------------------------------------------
    # video_codecs_tpu/models/h264/bslice_codec.py:227
    def _encode_b_frame(self, frame, past, future, frame_num, poc):
        y, u, v = frame
        qp = min(self.qp + self.b_qp_offset, 51)
        qpc = int(ht.CHROMA_QP[min(max(qp, 0), 51)])
        mbw, mbh = self.w // 16, self.h // 16
        w4 = mbw * 4
        yv, uv, vv = (p.astype(np.int32) for p in (y, u, v))
        rec_y = np.zeros_like(yv)
        rec_u = np.zeros_like(uv)
        rec_v = np.zeros_like(vv)
        nc_y = NcGrid(mbw * 4, mbh * 4)
        nc_u = NcGrid(mbw * 2, mbh * 2)
        nc_v = NcGrid(mbw * 2, mbh * 2)
        self._mode4 = np.full((mbh * 4, mbw * 4), 2, np.int32)
        self._is_i4 = np.zeros((mbh, mbw), bool)
        mvg0 = np.zeros((mbh * 4, mbw * 4, 2), np.int32)
        refg0 = np.full((mbh * 4, mbw * 4), -1, np.int32)
        mvg1 = np.zeros((mbh * 4, mbw * 4, 2), np.int32)
        refg1 = np.full((mbh * 4, mbw * 4), -1, np.int32)
        refpoc0 = np.full((mbh * 4, mbw * 4), -1, np.int32)
        refpoc1 = np.full((mbh * 4, mbw * 4), -1, np.int32)
        intra_mb = np.zeros((mbh, mbw), bool)
        skip_arr = np.zeros((mbh, mbw), bool)
        direct_arr = np.zeros((mbh, mbw), bool)
        dec4 = np.zeros((mbh * 4, mbw * 4), bool)   # partition decode order
        # per-4x4 |mvd| for CABAC mvd contexts (spec 9.3.3.1.1.7) and
        # per-4x4 direct/skip coding for ref_idx contexts (9.3.3.1.1.6)
        mvd4 = np.zeros((mbh * 4, mbw * 4, 2, 2), np.int32)  # [list][comp]
        dir4 = np.zeros((mbh * 4, mbw * 4), bool)
        lam = 0.85 * 2.0 ** ((qp - 12) / 3.0)
        lam_me = lam ** 0.5
        zz = cavlc.ZIGZAG_4x4
        py_, pu_, pv_ = past["rec"]
        fy_, fu_, fv_ = future["rec"]
        # the card stage: both lists' SAD surfaces and phase planes
        me0, me1 = self._card_stage(y, [past["rec"], future["rec"]])

        w = BitWriter()
        w.ue(0)                  # first_mb_in_slice
        w.ue(6)                  # slice_type = B (all slices)
        w.ue(0)                  # pps_id
        w.write(frame_num & 0xFF, 8)
        w.write(poc & 0xFFFF, 16)    # pic_order_cnt_lsb
        w.flag(1)                # direct_spatial_mv_pred_flag
        w.flag(0)                # num_ref_idx_active_override (1 + 1)
        w.flag(0)                # ref_pic_list_modification_flag_l0
        w.flag(0)                # ref_pic_list_modification_flag_l1
        # non-reference picture: no dec_ref_pic_marking
        if self.entropy == "cabac":
            w.ue(0)              # cabac_init_idc
        w.se(qp - 26)            # slice_qp_delta
        w.ue(0)                  # disable_deblocking_filter_idc
        w.se(0)                  # slice_alpha_c0_offset_div2
        w.se(0)                  # slice_beta_offset_div2

        ce = None
        if self.entropy == "cabac":
            ce = hc.H264CabacEncoder(w, "P", qp, model=0)
            self._cbf = hc.CbfState(mbw, mbh)
            self._cbp_arr = np.zeros((mbh, mbw), np.int32)
            self._cipred = np.zeros((mbh, mbw), np.int32)

        def skip_terms(mbx, mby):
            a = 1 if (mbx > 0 and not skip_arr[mby, mbx - 1]) else 0
            b = 1 if (mby > 0 and not skip_arr[mby - 1, mbx]) else 0
            return a, b

        def type_ctx(mbx, mby):
            a = 1 if (mbx > 0 and not direct_arr[mby, mbx - 1]
                      and not skip_arr[mby, mbx - 1]) else 0
            b = 1 if (mby > 0 and not direct_arr[mby - 1, mbx]
                      and not skip_arr[mby - 1, mbx]) else 0
            return a + b

        def mvd_err(px4, py4, lst, comp):
            a = abs(int(mvd4[py4, px4 - 1, lst, comp])) if px4 > 0 else 0
            b = abs(int(mvd4[py4 - 1, px4, lst, comp])) if py4 > 0 else 0
            return a + b

        def direct_pred(mbx, mby, ref0, ref1, dmv0, dmv1):
            """Assemble the 16x16 direct prediction per 8x8 quadrant."""
            x, yy = mbx * 16, mby * 16
            cx, cy = mbx * 8, mby * 8
            pl = np.zeros((16, 16), np.int32)
            pu2 = np.zeros((8, 8), np.int32)
            pv2 = np.zeros((8, 8), np.int32)
            for qy in range(2):
                for qx in range(2):
                    m0 = dmv0[qy, qx]
                    m1 = dmv1[qy, qx]
                    bl = None
                    if ref0 >= 0:
                        bl = mc_luma_np(py_, x + 8 * qx, yy + 8 * qy,
                                        int(m0[0]), int(m0[1]), 8, 8)
                        bu = mc_chroma_np(pu_, cx + 4 * qx, cy + 4 * qy,
                                          int(m0[0]), int(m0[1]), 4, 4)
                        bv = mc_chroma_np(pv_, cx + 4 * qx, cy + 4 * qy,
                                          int(m0[0]), int(m0[1]), 4, 4)
                    if ref1 >= 0:
                        cl = mc_luma_np(fy_, x + 8 * qx, yy + 8 * qy,
                                        int(m1[0]), int(m1[1]), 8, 8)
                        cu = mc_chroma_np(fu_, cx + 4 * qx, cy + 4 * qy,
                                          int(m1[0]), int(m1[1]), 4, 4)
                        cv = mc_chroma_np(fv_, cx + 4 * qx, cy + 4 * qy,
                                          int(m1[0]), int(m1[1]), 4, 4)
                        if bl is not None:
                            bl = (bl + cl + 1) >> 1
                            bu = (bu + cu + 1) >> 1
                            bv = (bv + cv + 1) >> 1
                        else:
                            bl, bu, bv = cl, cu, cv
                    pl[8 * qy:8 * qy + 8, 8 * qx:8 * qx + 8] = bl
                    pu2[4 * qy:4 * qy + 4, 4 * qx:4 * qx + 4] = bu
                    pv2[4 * qy:4 * qy + 4, 4 * qx:4 * qx + 4] = bv
            return pl, pu2, pv2

        def best_part_mode(og, bx, by, px4, py4, pw_, ph_, shape,
                           t00, t01, t10, t11, td):
            """Best of Pred_L0 / Pred_L1 / BiPred for one partition with
            the tmp motion grids (decode-order predictor chaining)."""
            pmv0 = mv_pred_part(t00, t01, td, px4, py4, pw_ // 4,
                                ph_ // 4, 0, shape)
            c0, mx0, my0 = self._search(og, me0, bx, by, pmv0, lam_me,
                                        pw_, ph_)
            pmv1 = mv_pred_part(t10, t11, td, px4, py4, pw_ // 4,
                                ph_ // 4, 0, shape)
            c1, mx1, my1 = self._search(og, me1, bx, by, pmv1, lam_me,
                                        pw_, ph_)
            b0 = mc_luma_np(py_, bx, by, mx0, my0, pw_, ph_)
            b1 = mc_luma_np(fy_, bx, by, mx1, my1, pw_, ph_)
            bi_ = (b0 + b1 + 1) >> 1
            cbi_ = int(np.abs(og - bi_).sum()) + round(lam_me * (
                _se_bits(mx0 - pmv0[0]) + _se_bits(my0 - pmv0[1])
                + _se_bits(mx1 - pmv1[0]) + _se_bits(my1 - pmv1[1])))
            mode = min((c0, 0), (c1, 1), (cbi_, 2), key=lambda t: t[0])[1]
            info = {0: dict(mv=(mx0, my0), pmv=pmv0),
                    1: dict(mv=(mx1, my1), pmv=pmv1),
                    "preds": (b0, b1, bi_)}
            return (c0, c1, cbi_)[mode], mode, info

        def commit_tmp(t00, t01, t10, t11, td, px4, py4, pw_, ph_,
                       mode, info):
            r4 = (slice(py4, py4 + ph_ // 4), slice(px4, px4 + pw_ // 4))
            for lst in ((0,) if mode == 0 else (1,) if mode == 1
                        else (0, 1)):
                tm, tr = (t00, t01) if lst == 0 else (t10, t11)
                tm[r4] = info[lst]["mv"]
                tr[r4] = 0
            td[r4] = True

        def eval_rect(mbx, mby, vert):
            """Two-partition candidate (mb_type 4..21): each partition
            picks its own best of L0 / L1 / Bi."""
            x, yy = mbx * 16, mby * 16
            gx, gy = mbx * 4, mby * 4
            geo, base = ((((0, 0, 8, 16), (8, 0, 8, 16)), "8x16") if vert
                         else (((0, 0, 16, 8), (0, 8, 16, 8)), "16x8"))
            t00, t01 = mvg0.copy(), refg0.copy()
            t10, t11 = mvg1.copy(), refg1.copy()
            td = dec4.copy()
            tot, parts = 0, []
            for pi, (ox, oy, pw_, ph_) in enumerate(geo):
                og = yv[yy + oy:yy + oy + ph_, x + ox:x + ox + pw_]
                px4, py4 = gx + ox // 4, gy + oy // 4
                c, mode, info = best_part_mode(
                    og, x + ox, yy + oy, px4, py4, pw_, ph_,
                    f"{base}_{pi}", t00, t01, t10, t11, td)
                commit_tmp(t00, t01, t10, t11, td, px4, py4, pw_, ph_,
                           mode, info)
                parts.append((ox, oy, pw_, ph_, mode, info))
                tot += c
            mbt = 4 + 2 * _B_PAIRS.index((parts[0][4], parts[1][4])) \
                + (1 if vert else 0)
            return tot + round(lam_me * _ue_bits(mbt)), mbt, parts, None

        def eval_b8x8(mbx, mby, dp_y, dp_u, dp_v, d_ref0, d_ref1,
                      d_mv0, d_mv1):
            """B_8x8 candidate: per 8x8 quadrant best of B_Direct_8x8 /
            B_L0_8x8 / B_L1_8x8 / B_Bi_8x8 (8x8-only sub_mb_types)."""
            x, yy = mbx * 16, mby * 16
            gx, gy = mbx * 4, mby * 4
            t00, t01 = mvg0.copy(), refg0.copy()
            t10, t11 = mvg1.copy(), refg1.copy()
            td = dec4.copy()
            tot = round(lam_me * _ue_bits(22))
            parts, subs = [], []
            for b8 in range(4):
                qy, qx = b8 >> 1, b8 & 1
                ox, oy = qx * 8, qy * 8
                og = yv[yy + oy:yy + oy + 8, x + ox:x + ox + 8]
                px4, py4 = gx + 2 * qx, gy + 2 * qy
                c, mode, info = best_part_mode(
                    og, x + ox, yy + oy, px4, py4, 8, 8, "",
                    t00, t01, t10, t11, td)
                c += round(lam_me * _ue_bits(mode + 1))
                cd = int(np.abs(
                    og - dp_y[oy:oy + 8, ox:ox + 8]).sum()) \
                    + round(lam_me * _ue_bits(0))
                r4 = (slice(py4, py4 + 2), slice(px4, px4 + 2))
                if cd <= c:          # B_Direct_8x8
                    subs.append(0)
                    if d_ref0 >= 0:
                        t00[r4] = d_mv0[qy, qx]
                        t01[r4] = d_ref0
                    if d_ref1 >= 0:
                        t10[r4] = d_mv1[qy, qx]
                        t11[r4] = d_ref1
                    td[r4] = True
                    parts.append((ox, oy, 8, 8, None, None))
                    tot += cd
                else:
                    subs.append(mode + 1)
                    commit_tmp(t00, t01, t10, t11, td, px4, py4, 8, 8,
                               mode, info)
                    parts.append((ox, oy, 8, 8, mode, info))
                    tot += c
            return tot, 22, parts, subs

        if not hasattr(self, "mb_type_stats"):
            self.mb_type_stats = {}   # chosen B mb_type histogram
        skip_run = 0
        for mby in range(mbh):
            for mbx in range(mbw):
                x, yy = mbx * 16, mby * 16
                cx, cy = mbx * 8, mby * 8
                gx, gy = mbx * 4, mby * 4
                orig = yv[yy:yy + 16, x:x + 16]
                last_mb = (mby == mbh - 1 and mbx == mbw - 1)

                # --- candidates ---
                d_ref0, d_ref1, d_mv0, d_mv1 = spatial_direct(
                    mvg0, refg0, mvg1, refg1, gx, gy, w4,
                    future["mvg"], future["refg"])
                dp_y, dp_u, dp_v = direct_pred(mbx, mby, d_ref0, d_ref1,
                                               d_mv0, d_mv1)
                cost_d = int(np.abs(orig - dp_y).sum()) + round(lam_me * 1)

                pmv0 = median_mv_pred(mvg0, refg0, gx, gy, w4, ref=0)
                c0, mx0, my0 = self._search(orig, me0, x, yy, pmv0, lam_me)
                c0 += round(lam_me * 3)
                pmv1 = median_mv_pred(mvg1, refg1, gx, gy, w4, ref=0)
                c1, mx1, my1 = self._search(orig, me1, x, yy, pmv1, lam_me)
                c1 += round(lam_me * 3)
                bl0 = mc_luma_np(py_, x, yy, mx0, my0, 16, 16)
                bl1 = mc_luma_np(fy_, x, yy, mx1, my1, 16, 16)
                bi = (bl0 + bl1 + 1) >> 1
                cbi = int(np.abs(orig - bi).sum()) + round(lam_me * (
                    5 + _se_bits(mx0 - pmv0[0]) + _se_bits(my0 - pmv0[1])
                    + _se_bits(mx1 - pmv1[0]) + _se_bits(my1 - pmv1[1])))
                isad = min(
                    int(np.abs(orig - pred_luma16(rec_y, x, yy, m)).sum())
                    for m in ([2] + ([0] if mby else [])
                              + ([1] if mbx else []))) + round(lam_me * 24)

                best_c, best = min((cost_d, 0), (c0, 1), (c1, 2),
                                   (cbi, 3), (isad, 4),
                                   key=lambda t: t[0])
                part_sel = None
                if self.b_parts:
                    for ev in (eval_rect(mbx, mby, False),
                               eval_rect(mbx, mby, True),
                               eval_b8x8(mbx, mby, dp_y, dp_u, dp_v,
                                         d_ref0, d_ref1, d_mv0, d_mv1)):
                        if ev[0] < best_c:
                            best_c, part_sel = ev[0], ev

                if part_sel is None and best == 4:
                    # intra MB in a B slice (mb_type offset 23)
                    if ce is not None:
                        a, b = skip_terms(mbx, mby)
                        ce.mb_skip_flag_b(0, a, b)
                        self._encode_mb(w, yv, uv, vv, rec_y, rec_u, rec_v,
                                        nc_y, nc_u, nc_v, mbx, mby, qp, qpc,
                                        ce=ce, b_ctx=type_ctx(mbx, mby))
                        ce.final(1 if last_mb else 0)
                    else:
                        w.ue(skip_run)
                        skip_run = 0
                        self._encode_mb(w, yv, uv, vv, rec_y, rec_u, rec_v,
                                        nc_y, nc_u, nc_v, mbx, mby, qp, qpc,
                                        mb_type_offset=23)
                    intra_mb[mby, mbx] = True
                    dec4[gy:gy + 4, gx:gx + 4] = True
                    self.mb_type_stats["intra"] = \
                        self.mb_type_stats.get("intra", 0) + 1
                    continue

                # --- chosen inter prediction + per-list motion bookkeeping
                # mvds entries: (list, mvd_x, mvd_y, bx4, by4) in syntax
                # order (all list-0 partition mvds, then all list-1)
                mbt, subs = best, None
                if part_sel is not None:
                    _, mbt, parts, subs = part_sel
                    pred = np.zeros((16, 16), np.int32)
                    pu = np.zeros((8, 8), np.int32)
                    pv = np.zeros((8, 8), np.int32)
                    mvds0, mvds1 = [], []
                    for ox, oy, pw_, ph_, mode, info in parts:
                        px4, py4 = gx + ox // 4, gy + oy // 4
                        r4 = (slice(py4, py4 + ph_ // 4),
                              slice(px4, px4 + pw_ // 4))
                        sl_y = (slice(oy, oy + ph_), slice(ox, ox + pw_))
                        sl_c = (slice(oy // 2, (oy + ph_) // 2),
                                slice(ox // 2, (ox + pw_) // 2))
                        if mode is None:        # B_Direct_8x8 sub
                            qy, qx = oy // 8, ox // 8
                            pred[sl_y] = dp_y[sl_y]
                            pu[sl_c] = dp_u[sl_c]
                            pv[sl_c] = dp_v[sl_c]
                            if d_ref0 >= 0:
                                mvg0[r4] = d_mv0[qy, qx]
                                refg0[r4] = d_ref0
                                refpoc0[r4] = past["poc"]
                            if d_ref1 >= 0:
                                mvg1[r4] = d_mv1[qy, qx]
                                refg1[r4] = d_ref1
                                refpoc1[r4] = future["poc"]
                            dir4[r4] = True
                            dec4[r4] = True
                            continue
                        lists = ((0,) if mode == 0 else
                                 (1,) if mode == 1 else (0, 1))
                        cps = []
                        for lst in lists:
                            mvx_, mvy_ = info[lst]["mv"]
                            pmx_, pmy_ = info[lst]["pmv"]
                            (mvds0 if lst == 0 else mvds1).append(
                                (lst, mvx_ - pmx_, mvy_ - pmy_, px4, py4))
                            mvd4[r4[0], r4[1], lst, 0] = mvx_ - pmx_
                            mvd4[r4[0], r4[1], lst, 1] = mvy_ - pmy_
                            if lst == 0:
                                mvg0[r4] = (mvx_, mvy_)
                                refg0[r4] = 0
                                refpoc0[r4] = past["poc"]
                                su, sv = pu_, pv_
                            else:
                                mvg1[r4] = (mvx_, mvy_)
                                refg1[r4] = 0
                                refpoc1[r4] = future["poc"]
                                su, sv = fu_, fv_
                            cps.append((
                                mc_chroma_np(su, cx + ox // 2,
                                             cy + oy // 2, mvx_, mvy_,
                                             pw_ // 2, ph_ // 2),
                                mc_chroma_np(sv, cx + ox // 2,
                                             cy + oy // 2, mvx_, mvy_,
                                             pw_ // 2, ph_ // 2)))
                        dec4[r4] = True
                        pred[sl_y] = info["preds"][mode]
                        if len(cps) == 2:
                            pu[sl_c] = (cps[0][0] + cps[1][0] + 1) >> 1
                            pv[sl_c] = (cps[0][1] + cps[1][1] + 1) >> 1
                        else:
                            pu[sl_c], pv[sl_c] = cps[0]
                    mvds = mvds0 + mvds1
                elif best == 0:
                    pred, pu, pv = dp_y, dp_u, dp_v
                    for qy in range(2):
                        for qx in range(2):
                            sy = slice(gy + 2 * qy, gy + 2 * qy + 2)
                            sx = slice(gx + 2 * qx, gx + 2 * qx + 2)
                            if d_ref0 >= 0:
                                mvg0[sy, sx] = d_mv0[qy, qx]
                                refg0[sy, sx] = d_ref0
                                refpoc0[sy, sx] = past["poc"]
                            if d_ref1 >= 0:
                                mvg1[sy, sx] = d_mv1[qy, qx]
                                refg1[sy, sx] = d_ref1
                                refpoc1[sy, sx] = future["poc"]
                    dir4[gy:gy + 4, gx:gx + 4] = True
                    mvds = []
                elif best == 1:
                    pred = bl0
                    pu = mc_chroma_np(pu_, cx, cy, mx0, my0, 8, 8)
                    pv = mc_chroma_np(pv_, cx, cy, mx0, my0, 8, 8)
                    mvg0[gy:gy + 4, gx:gx + 4] = (mx0, my0)
                    refg0[gy:gy + 4, gx:gx + 4] = 0
                    refpoc0[gy:gy + 4, gx:gx + 4] = past["poc"]
                    mvds = [(0, mx0 - pmv0[0], my0 - pmv0[1], gx, gy)]
                elif best == 2:
                    pred = bl1
                    pu = mc_chroma_np(fu_, cx, cy, mx1, my1, 8, 8)
                    pv = mc_chroma_np(fv_, cx, cy, mx1, my1, 8, 8)
                    mvg1[gy:gy + 4, gx:gx + 4] = (mx1, my1)
                    refg1[gy:gy + 4, gx:gx + 4] = 0
                    refpoc1[gy:gy + 4, gx:gx + 4] = future["poc"]
                    mvds = [(1, mx1 - pmv1[0], my1 - pmv1[1], gx, gy)]
                else:
                    pred = bi
                    pu = (mc_chroma_np(pu_, cx, cy, mx0, my0, 8, 8)
                          + mc_chroma_np(fu_, cx, cy, mx1, my1, 8, 8)
                          + 1) >> 1
                    pv = (mc_chroma_np(pv_, cx, cy, mx0, my0, 8, 8)
                          + mc_chroma_np(fv_, cx, cy, mx1, my1, 8, 8)
                          + 1) >> 1
                    mvg0[gy:gy + 4, gx:gx + 4] = (mx0, my0)
                    refg0[gy:gy + 4, gx:gx + 4] = 0
                    refpoc0[gy:gy + 4, gx:gx + 4] = past["poc"]
                    mvg1[gy:gy + 4, gx:gx + 4] = (mx1, my1)
                    refg1[gy:gy + 4, gx:gx + 4] = 0
                    refpoc1[gy:gy + 4, gx:gx + 4] = future["poc"]
                    mvds = [(0, mx0 - pmv0[0], my0 - pmv0[1], gx, gy),
                            (1, mx1 - pmv1[0], my1 - pmv1[1], gx, gy)]

                self.mb_type_stats[mbt] = self.mb_type_stats.get(mbt, 0) + 1

                # --- residual ---
                res = orig - pred
                blk = res.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)
                lv = self._quant_ac(ht.forward4x4(blk), qp, intra=False)
                cbp_luma = 0
                for i8 in range(4):
                    ids = [4 * i8 + k for k in range(4)]
                    if any(lv[_BLK_Y[i], _BLK_X[i]].any() for i in ids):
                        cbp_luma |= 1 << i8
                c_dc_q, c_ac_q = [], []
                for comp, (co, cp) in enumerate(
                        ((uv[cy:cy + 8, cx:cx + 8], pu),
                         (vv[cy:cy + 8, cx:cx + 8], pv))):
                    cres = co - cp
                    cwt = ht.forward4x4(
                        cres.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3))
                    cdc = cwt[:, :, 0, 0].copy()
                    c_dc_q.append(
                        ht.quant_chroma_dc(ht.hadamard2x2(cdc), qpc))
                    acq = ht.quant_ac(cwt, qpc)
                    acq[:, :, 0, 0] = 0
                    c_ac_q.append(acq)
                cbp_chroma = 2 if any(q.any() for q in c_ac_q) else (
                    1 if any(q.any() for q in c_dc_q) else 0)
                cbp = cbp_luma | (cbp_chroma << 4)

                if mbt == 0 and cbp == 0:
                    # B_Skip
                    skip_arr[mby, mbx] = True
                    direct_arr[mby, mbx] = True
                    dec4[gy:gy + 4, gx:gx + 4] = True
                    if ce is not None:
                        a, b = skip_terms(mbx, mby)
                        ce.mb_skip_flag_b(1, a, b)
                        self._cbf.mark(mbx, mby)
                        ce.final(1 if last_mb else 0)
                    else:
                        skip_run += 1
                    rec_y[yy:yy + 16, x:x + 16] = pred
                    rec_u[cy:cy + 8, cx:cx + 8] = pu
                    rec_v[cy:cy + 8, cx:cx + 8] = pv
                    for bx4 in range(4):
                        for by4 in range(4):
                            nc_y.set(gx + bx4, gy + by4, 0)
                    for grid in (nc_u, nc_v):
                        for bx2 in range(2):
                            for by2 in range(2):
                                grid.set(mbx * 2 + bx2, mby * 2 + by2, 0)
                    continue

                if mbt == 0:
                    direct_arr[mby, mbx] = True
                if part_sel is None:
                    dec4[gy:gy + 4, gx:gx + 4] = True
                    for lst, dx, dy, _, _ in mvds:
                        mvd4[gy:gy + 4, gx:gx + 4, lst, 0] = dx
                        mvd4[gy:gy + 4, gx:gx + 4, lst, 1] = dy

                if ce is not None:
                    self._write_b_mb_cabac(ce, mbx, mby, mbt, subs, mvds,
                                           cbp, lv, c_dc_q, c_ac_q,
                                           skip_terms, type_ctx, mvd_err)
                    for i8 in range(4):
                        for k in range(4):
                            idx = 4 * i8 + k
                            nc_y.set(gx + _BLK_X[idx], gy + _BLK_Y[idx],
                                     int((lv[_BLK_Y[idx],
                                             _BLK_X[idx]] != 0).sum())
                                     if cbp_luma & (1 << i8) else 0)
                    for comp, grid in ((0, nc_u), (1, nc_v)):
                        for idx in range(4):
                            x4, y4 = idx & 1, idx >> 1
                            nn = (int((c_ac_q[comp][y4, x4] != 0).sum())
                                  if cbp_chroma == 2 else 0)
                            grid.set(mbx * 2 + x4, mby * 2 + y4, nn)
                    ce.final(1 if last_mb else 0)
                else:
                    w.ue(skip_run)
                    skip_run = 0
                    w.ue(mbt)               # mb_type 0..22
                    if mbt == 22:
                        for s_ in subs:
                            w.ue(s_)        # sub_mb_type (8x8 rows)
                    # ref_idx not coded: one reference per list
                    for lst, dx, dy, _, _ in mvds:
                        w.se(dx)
                        w.se(dy)
                    w.ue(_NCBP_INTER_420[cbp])
                    if cbp:
                        w.se(0)              # mb_qp_delta
                    for i8 in range(4):
                        for k in range(4):
                            idx = 4 * i8 + k
                            x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                            if cbp_luma & (1 << i8):
                                _code_residual_16(w, lv[y4, x4], nc_y,
                                                  gx + x4, gy + y4)
                            else:
                                nc_y.set(gx + x4, gy + y4, 0)
                    if cbp_chroma:
                        for comp in (0, 1):
                            dcs = c_dc_q[comp]
                            cavlc.encode_block(
                                w, [int(dcs[0, 0]), int(dcs[0, 1]),
                                    int(dcs[1, 0]), int(dcs[1, 1])], -1, 4)
                    for comp, grid in ((0, nc_u), (1, nc_v)):
                        for idx in range(4):
                            x4, y4 = idx & 1, idx >> 1
                            if cbp_chroma == 2:
                                coeffs = \
                                    c_ac_q[comp][y4, x4].reshape(16)[zz][1:]
                                total = cavlc.encode_block(
                                    w, [int(c) for c in coeffs],
                                    grid.nc(mbx * 2 + x4, mby * 2 + y4), 15)
                            else:
                                total = 0
                            grid.set(mbx * 2 + x4, mby * 2 + y4, total)

                # --- reconstruction ---
                d = ht.dequant_ac(lv, qp)
                for i8 in range(4):
                    if not (cbp_luma & (1 << i8)):
                        for k in range(4):
                            idx = 4 * i8 + k
                            d[_BLK_Y[idx], _BLK_X[idx]] = 0
                rec_y[yy:yy + 16, x:x + 16] = np.clip(
                    pred + ht.inverse4x4(d)
                    .transpose(0, 2, 1, 3).reshape(16, 16), 0, 255)
                for comp, (plane, cp) in enumerate(
                        ((rec_u, pu), (rec_v, pv))):
                    cdc_deq = (ht.dequant_chroma_dc(c_dc_q[comp], qpc)
                               if cbp_chroma else np.zeros((2, 2), np.int64))
                    cd = ht.dequant_ac(
                        c_ac_q[comp] if cbp_chroma == 2
                        else np.zeros_like(c_ac_q[comp]), qpc)
                    cd[:, :, 0, 0] = cdc_deq
                    plane[cy:cy + 8, cx:cx + 8] = np.clip(
                        cp + ht.inverse4x4(cd)
                        .transpose(0, 2, 1, 3).reshape(8, 8), 0, 255)

        if ce is not None:
            ce.finish()
        else:
            if skip_run:
                w.ue(skip_run)
            w.rbsp_trailing_bits()

        bs_ver, bs_hor = bs_maps_b(intra_mb, nc_y.tc, mvg0, refpoc0,
                                   mvg1, refpoc1)
        rec_y, rec_u, rec_v = deblock_frame(rec_y, rec_u, rec_v, qp, qpc,
                                            bs_ver, bs_hor)
        return w.data(), (rec_y, rec_u, rec_v)

    # video_codecs_tpu/models/h264/bslice_codec.py:790
    def _write_b_mb_cabac(self, ce, mbx, mby, mbt, subs, mvds, cbp, lv,
                          c_dc_q, c_ac_q, skip_terms, type_ctx, mvd_err):
        """CABAC syntax for one non-skip B MB (direct / 16x16 modes /
        16x8 / 8x16 two-partition types / B_8x8 with 8x8 subs).

        Parity: jm18.5/lencod/src/cabac.c writeMB_Bskip_flagInfo :456,
        writeMB_B_typeInfo :626, writeMVD :1152, writeCBP :1326; residual
        blocks via entropy/h264_cabac.py (LUMA_4x4 category).
        """
        zz = cavlc.ZIGZAG_4x4
        cbf = self._cbf
        a, b = skip_terms(mbx, mby)
        ce.mb_skip_flag_b(0, a, b)
        ce.mb_type_b(mbt, type_ctx(mbx, mby))
        if mbt == 22:
            for s_ in subs:
                ce.sub_mb_type_b(s_)
        # ref_idx not coded: one reference per list
        for lst, dx, dy, bx4, by4 in mvds:
            ce.mvd(dx, 0, mvd_err(bx4, by4, lst, 0))
            ce.mvd(dy, 1, mvd_err(bx4, by4, lst, 1))

        def nbr(dx, dy):
            nx, ny = mbx + dx, mby + dy
            if nx < 0 or ny < 0:
                return None
            return {"cbp": int(self._cbp_arr[ny, nx]), "ipcm": False}

        ce.cbp(cbp, nbr(0, -1), nbr(-1, 0))
        self._cbp_arr[mby, mbx] = cbp
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        if cbp:
            ce.mb_qp_delta(0, False)
        cur_bits = 0
        for i8 in range(4):
            if not (cbp_luma & (1 << i8)):
                continue
            for k in range(4):
                idx = 4 * i8 + k
                x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                coeffs = [int(c) for c in lv[y4, x4].reshape(16)[zz]]
                ctx = cbf.ctx_ac(mbx, mby, x4, y4, 1, 4, cur_bits, False)
                ce.residual_block(hc.LUMA_4x4, coeffs, ctx)
                if any(coeffs):
                    cur_bits |= 1 << (1 + 4 * y4 + x4)
                    cbf.set_bit(mbx, mby, 1 + 4 * y4 + x4)
        if cbp_chroma:
            for comp, bit in ((0, hc.CbfState.U_DC_BIT),
                              (1, hc.CbfState.V_DC_BIT)):
                dcs = c_dc_q[comp]
                lst = [int(dcs[0, 0]), int(dcs[0, 1]),
                       int(dcs[1, 0]), int(dcs[1, 1])]
                ctx = cbf.ctx_dc(mbx, mby, bit, False)
                ce.residual_block(hc.CHROMA_DC, lst, ctx)
                if any(lst):
                    cbf.set_bit(mbx, mby, bit)
        if cbp_chroma == 2:
            for comp, base in ((0, hc.CbfState.U_AC_BASE),
                               (1, hc.CbfState.V_AC_BASE)):
                for idx in range(4):
                    x4, y4 = idx & 1, idx >> 1
                    coeffs = [int(c) for c in
                              c_ac_q[comp][y4, x4].reshape(16)[zz][1:]]
                    ctx = cbf.ctx_ac(mbx, mby, x4, y4, base, 2,
                                     cur_bits, False)
                    ce.residual_block(hc.CHROMA_AC, coeffs, ctx)
                    if any(coeffs):
                        cur_bits |= 1 << (base + 4 * y4 + x4)
                        cbf.set_bit(mbx, mby, base + 4 * y4 + x4)
        cbf.mark(mbx, mby)


# video_codecs_tpu/models/h264/bslice_codec.py:863
class H264BDecoder(H264Decoder):
    """Decodes IDR + P + B streams (poc_type 0) with display reordering."""

    # video_codecs_tpu/models/h264/bslice_codec.py:866
    def __init__(self) -> None:
        super().__init__()
        self.entries: list[dict] = []   # reference pictures, newest first
        self._ext_dpb = True            # list0 managed by this class
        self._pmsb = 0
        self._plsb = 0

    # video_codecs_tpu/models/h264/bslice_codec.py:873
    def _poc_calc(self, lsb: int, is_ref: bool) -> int:
        """PicOrderCnt for poc_type 0 (spec 8.2.1.1)."""
        max_lsb = 1 << self.sps_info["log2_max_poc_lsb"]
        if lsb < self._plsb and self._plsb - lsb >= max_lsb // 2:
            msb = self._pmsb + max_lsb
        elif lsb > self._plsb and lsb - self._plsb > max_lsb // 2:
            msb = self._pmsb - max_lsb
        else:
            msb = self._pmsb
        if is_ref:
            self._pmsb, self._plsb = msb, lsb
        return msb + lsb

    # video_codecs_tpu/models/h264/bslice_codec.py:886
    def decode(self, stream: bytes) -> list:
        items = []          # (period, poc, rec) for display reordering
        period = -1
        for nal in split_annexb(stream):
            nal_type = nal[0] & 0x1F
            ref_idc = nal[0] >> 5
            rbsp = strip_emulation_prevention(nal[1:])
            if nal_type == NAL_SPS:
                wmb, hmb, info = parse_sps(rbsp, full=True)
                self.size = (wmb, hmb)
                self.sps_info = info
                self.max_refs = max(info["num_ref_frames"], 1)
            elif nal_type == NAL_PPS:
                self.dbf_present, self.cabac, ppsinfo = \
                    parse_pps(rbsp, full=True)
                self.default_l0 = ppsinfo["num_ref_idx_l0_default_active"]
                self.wbp_idc = ppsinfo["weighted_bipred_idc"]
            elif nal_type in (NAL_SLICE_IDR, 1):
                r0 = BitReader(rbsp)
                assert r0.ue() == 0
                st = r0.ue()
                mbw, mbh = self.size
                if nal_type == NAL_SLICE_IDR:
                    period += 1
                    self.entries = []
                    self._pmsb = self._plsb = 0
                    rec = self._decode_slice(rbsp)
                    zero_mv = np.zeros((mbh * 4, mbw * 4, 2), np.int32)
                    zero_ref = np.full((mbh * 4, mbw * 4), -1, np.int32)
                    self.entries.insert(0, dict(rec=rec, poc=0, mvg=zero_mv,
                                                refg=zero_ref))
                    items.append((period, 0, rec))
                elif st in (0, 5):
                    r0.ue()                       # pps_id
                    r0.read(self.sps_info["log2_max_frame_num"])
                    lsb = r0.read(self.sps_info["log2_max_poc_lsb"]) \
                        if self.sps_info["poc_type"] == 0 else 0
                    poc = self._poc_calc(lsb, is_ref=ref_idc != 0)
                    self.dpb = [e["rec"] for e in self.entries]
                    r1 = BitReader(rbsp)
                    r1.ue(), r1.ue()
                    rec = self._decode_p_slice(r1)
                    mvg, refg = self._last_mv
                    self.entries.insert(0, dict(rec=rec, poc=poc, mvg=mvg,
                                                refg=refg))
                    del self.entries[self.max_refs:]
                    items.append((period, poc, rec))
                elif st in (1, 6):
                    poc, rec = self._decode_b_slice(rbsp, ref_idc)
                    items.append((period, poc, rec))
                else:
                    raise AssertionError(f"unsupported slice_type {st}")
        items.sort(key=lambda t: (t[0], t[1]))
        return [rec for _, _, rec in items]

    # video_codecs_tpu/models/h264/bslice_codec.py:942
    def _decode_b_slice(self, rbsp: bytes, ref_idc: int):
        mbw, mbh = self.size
        w4 = mbw * 4
        r = BitReader(rbsp)
        assert r.ue() == 0              # first_mb_in_slice
        assert r.ue() in (1, 6)         # slice_type B
        assert r.ue() == 0              # pps_id
        r.read(self.sps_info["log2_max_frame_num"])   # frame_num
        lsb = r.read(self.sps_info["log2_max_poc_lsb"])
        poc = self._poc_calc(lsb, is_ref=ref_idc != 0)
        assert r.flag() == 1, "temporal direct unsupported"
        n0 = n1 = 1
        if r.flag():                    # num_ref_idx_active_override
            n0 = r.ue() + 1
            n1 = r.ue() + 1
        assert r.flag() == 0            # ref_pic_list_modification_l0
        assert r.flag() == 0            # ref_pic_list_modification_l1
        wbp_idc = getattr(self, "wbp_idc", 0)
        wtab = None
        if wbp_idc == 1:                # explicit B weighted prediction
            logd = r.ue()               # luma_log2_weight_denom
            logdc = r.ue()              # chroma_log2_weight_denom

            def _wlist(n):
                out = []
                for _ in range(n):
                    ws = [1 << logd, 1 << logdc, 1 << logdc]
                    os_ = [0, 0, 0]
                    if r.flag():
                        ws[0] = r.se()
                        os_[0] = r.se()
                    if r.flag():
                        for j in (1, 2):
                            ws[j] = r.se()
                            os_[j] = r.se()
                    out.append((tuple(ws), tuple(os_)))
                return out

            wtab = dict(logd=logd, logdc=logdc,
                        l=[_wlist(n0), _wlist(n1)])
        if ref_idc:
            assert r.flag() == 0, "MMCO unsupported"  # sliding window
        cabac = getattr(self, "cabac", False)
        model = r.ue() if cabac else 0
        qp = 26 + r.se()
        dbf_idc, aoff, boff = 0, 0, 0
        if self.dbf_present:
            dbf_idc = r.ue()
            if dbf_idc != 1:
                aoff = 2 * r.se()
                boff = 2 * r.se()
        qpc = int(ht.CHROMA_QP[min(max(qp, 0), 51)])

        # RefPicList init by POC (spec 8.2.4.2.3, frame coding)
        past = sorted((e for e in self.entries if e["poc"] < poc),
                      key=lambda e: -e["poc"])
        future = sorted((e for e in self.entries if e["poc"] > poc),
                        key=lambda e: e["poc"])
        l0 = past + future
        l1 = future + past
        assert n0 <= len(l0) and n1 <= len(l1), "ref list underrun"
        col = l1[0]                    # colocated picture for direct

        def _implicit_w(ref0, ref1):
            """Implicit bipred weights from POC distances (spec
            8.4.2.3.1; jm18.5 weighted_prediction.c
            compute_implicit_weights)."""
            poc0, poc1 = l0[ref0]["poc"], l1[ref1]["poc"]
            if poc0 == poc1:
                return 32, 32
            tb = max(-128, min(127, poc - poc0))
            td = max(-128, min(127, poc1 - poc0))
            tx = (16384 + abs(td) // 2) // td if td > 0 else \
                -((16384 + abs(td) // 2) // -td)
            dsf = max(-1024, min(1023, (tb * tx + 32) >> 6))
            w1 = dsf >> 2
            if w1 < -64 or w1 > 128:
                return 32, 32
            return 64 - w1, w1

        def wp_uni(planes, lst, ref_i):
            """Explicit WP on a uni-predicted (y, u, v) triple."""
            if wtab is None:
                return planes
            ws, os_ = wtab["l"][lst][ref_i]
            return (wp_apply(planes[0], ws[0], os_[0], wtab["logd"]),
                    wp_apply(planes[1], ws[1], os_[1], wtab["logdc"]),
                    wp_apply(planes[2], ws[2], os_[2], wtab["logdc"]))

        def wp_bi(p0, p1, ref0, ref1):
            """Bi-prediction combine: default average, explicit
            (8.4.2.3.2) or implicit (8.4.2.3.1) weighting."""
            if wtab is not None:
                w0s, o0s = wtab["l"][0][ref0]
                w1s, o1s = wtab["l"][1][ref1]
                out = []
                for c in range(3):
                    ld = wtab["logd"] if c == 0 else wtab["logdc"]
                    a = p0[c].astype(np.int64)
                    b = p1[c].astype(np.int64)
                    v = ((a * w0s[c] + b * w1s[c] + (1 << ld))
                         >> (ld + 1)) + ((o0s[c] + o1s[c] + 1) >> 1)
                    out.append(np.clip(v, 0, 255).astype(np.int32))
                return tuple(out)
            if wbp_idc == 2:
                w0, w1 = _implicit_w(ref0, ref1)
                return tuple(np.clip(
                    (p0[c].astype(np.int64) * w0
                     + p1[c].astype(np.int64) * w1 + 32) >> 6,
                    0, 255).astype(np.int32) for c in range(3))
            return tuple((p0[c] + p1[c] + 1) >> 1 for c in range(3))

        rec_y = np.zeros((mbh * 16, mbw * 16), np.int32)
        rec_u = np.zeros((mbh * 8, mbw * 8), np.int32)
        rec_v = np.zeros_like(rec_u)
        nc_y = NcGrid(mbw * 4, mbh * 4)
        nc_u = NcGrid(mbw * 2, mbh * 2)
        nc_v = NcGrid(mbw * 2, mbh * 2)
        mvg0 = np.zeros((mbh * 4, mbw * 4, 2), np.int32)
        refg0 = np.full((mbh * 4, mbw * 4), -1, np.int32)
        mvg1 = np.zeros((mbh * 4, mbw * 4, 2), np.int32)
        refg1 = np.full((mbh * 4, mbw * 4), -1, np.int32)
        refpoc0 = np.full((mbh * 4, mbw * 4), -1, np.int32)
        refpoc1 = np.full((mbh * 4, mbw * 4), -1, np.int32)
        intra_mb = np.zeros((mbh, mbw), bool)
        mode4 = np.full((mbh * 4, mbw * 4), 2, np.int32)
        is_i4 = np.zeros((mbh, mbw), bool)
        dec4 = np.zeros((mbh * 4, mbw * 4), bool)   # partition decode order
        zz = cavlc.ZIGZAG_4x4

        def pred_mode4(gx4, gy4):
            def nbr(sx4, sy4):
                if sx4 < 0 or sy4 < 0 or sx4 >= mbw * 4 or sy4 >= mbh * 4:
                    return None
                if not _decoded_before(sx4, sy4, gx4, gy4, mbw):
                    return None
                if not is_i4[sy4 // 4, sx4 // 4]:
                    return 2
                return int(mode4[sy4, sx4])
            a = nbr(gx4 - 1, gy4)
            b = nbr(gx4, gy4 - 1)
            if a is None or b is None:
                return 2
            return min(a, b)

        def mc_pair(entry, x, yy, cx, cy, mvx, mvy, bw, bh):
            ey, eu, ev = entry["rec"]
            return (mc_luma_np(ey, x, yy, mvx, mvy, bw, bh),
                    mc_chroma_np(eu, cx, cy, mvx, mvy, bw // 2, bh // 2),
                    mc_chroma_np(ev, cx, cy, mvx, mvy, bw // 2, bh // 2))

        def direct_recon(mbx, mby, apply=True, quad=None):
            """Derive spatial-direct motion; optionally write the MC
            prediction into the recon planes (B_Skip / B_Direct).  With
            quad=(qy, qx) only that 8x8 quadrant is derived/committed
            (B_Direct_8x8 sub-macroblock) and its planes returned."""
            gx, gy = mbx * 4, mby * 4
            x, yy = mbx * 16, mby * 16
            cx, cy = mbx * 8, mby * 8
            d_ref0, d_ref1, d_mv0, d_mv1 = spatial_direct(
                mvg0, refg0, mvg1, refg1, gx, gy, w4,
                col["mvg"], col["refg"])
            pl = np.zeros((16, 16), np.int32)
            pu = np.zeros((8, 8), np.int32)
            pv = np.zeros((8, 8), np.int32)
            for qy in range(2):
                for qx in range(2):
                    if quad is not None and (qy, qx) != quad:
                        continue
                    bl = bu = bv = None
                    if d_ref0 >= 0:
                        bl, bu, bv = mc_pair(
                            l0[d_ref0], x + 8 * qx, yy + 8 * qy,
                            cx + 4 * qx, cy + 4 * qy,
                            int(d_mv0[qy, qx, 0]), int(d_mv0[qy, qx, 1]),
                            8, 8)
                    if d_ref1 >= 0:
                        cl, cu, cv = mc_pair(
                            l1[d_ref1], x + 8 * qx, yy + 8 * qy,
                            cx + 4 * qx, cy + 4 * qy,
                            int(d_mv1[qy, qx, 0]), int(d_mv1[qy, qx, 1]),
                            8, 8)
                        if bl is not None:
                            bl, bu, bv = wp_bi((bl, bu, bv),
                                               (cl, cu, cv),
                                               d_ref0, d_ref1)
                        else:
                            bl, bu, bv = wp_uni((cl, cu, cv), 1, d_ref1)
                    elif bl is not None:
                        bl, bu, bv = wp_uni((bl, bu, bv), 0, d_ref0)
                    pl[8 * qy:8 * qy + 8, 8 * qx:8 * qx + 8] = bl
                    pu[4 * qy:4 * qy + 4, 4 * qx:4 * qx + 4] = bu
                    pv[4 * qy:4 * qy + 4, 4 * qx:4 * qx + 4] = bv
                    sy = slice(gy + 2 * qy, gy + 2 * qy + 2)
                    sx = slice(gx + 2 * qx, gx + 2 * qx + 2)
                    if d_ref0 >= 0:
                        mvg0[sy, sx] = d_mv0[qy, qx]
                        refg0[sy, sx] = d_ref0
                        refpoc0[sy, sx] = l0[d_ref0]["poc"]
                    if d_ref1 >= 0:
                        mvg1[sy, sx] = d_mv1[qy, qx]
                        refg1[sy, sx] = d_ref1
                        refpoc1[sy, sx] = l1[d_ref1]["poc"]
            if quad is not None:
                qy, qx = quad
                return (pl[8 * qy:8 * qy + 8, 8 * qx:8 * qx + 8],
                        pu[4 * qy:4 * qy + 4, 4 * qx:4 * qx + 4],
                        pv[4 * qy:4 * qy + 4, 4 * qx:4 * qx + 4])
            if apply:
                rec_y[yy:yy + 16, x:x + 16] = pl
                rec_u[cy:cy + 8, cx:cx + 8] = pu
                rec_v[cy:cy + 8, cx:cx + 8] = pv
            return pl, pu, pv

        def clear_nc(mbx, mby):
            gx, gy = mbx * 4, mby * 4
            for bx4 in range(4):
                for by4 in range(4):
                    nc_y.set(gx + bx4, gy + by4, 0)
            for grid in (nc_u, nc_v):
                for bx2 in range(2):
                    for by2 in range(2):
                        grid.set(mbx * 2 + bx2, mby * 2 + by2, 0)

        def add_residual(mbx, mby, pred, pu, pv, lv, cbp, c_dc_q, c_ac_q):
            x, yy = mbx * 16, mby * 16
            cx, cy = mbx * 8, mby * 8
            cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
            d = ht.dequant_ac(lv, qp)
            for i8 in range(4):
                if not (cbp_luma & (1 << i8)):
                    for k in range(4):
                        idx = 4 * i8 + k
                        d[_BLK_Y[idx], _BLK_X[idx]] = 0
            rec_y[yy:yy + 16, x:x + 16] = np.clip(
                pred + ht.inverse4x4(d)
                .transpose(0, 2, 1, 3).reshape(16, 16), 0, 255)
            for comp, (plane, cp) in enumerate(((rec_u, pu), (rec_v, pv))):
                cdc_deq = (ht.dequant_chroma_dc(c_dc_q[comp], qpc)
                           if cbp_chroma else np.zeros((2, 2), np.int64))
                cd = ht.dequant_ac(
                    c_ac_q[comp] if cbp_chroma == 2
                    else np.zeros_like(c_ac_q[comp]), qpc)
                cd[:, :, 0, 0] = cdc_deq
                plane[cy:cy + 8, cx:cx + 8] = np.clip(
                    cp + ht.inverse4x4(cd)
                    .transpose(0, 2, 1, 3).reshape(8, 8), 0, 255)

        def store_part(px4, py4, pw4, ph4, lst, ref_i, mvx, mvy):
            r4 = (slice(py4, py4 + ph4), slice(px4, px4 + pw4))
            if lst == 0:
                mvg0[r4] = (mvx, mvy)
                refg0[r4] = ref_i
                refpoc0[r4] = l0[ref_i]["poc"]
            else:
                mvg1[r4] = (mvx, mvy)
                refg1[r4] = ref_i
                refpoc1[r4] = l1[ref_i]["poc"]

        def store_uni(mbx, mby, lst, ref_i, mvx, mvy):
            store_part(mbx * 4, mby * 4, 4, 4, lst, ref_i, mvx, mvy)

        def decode_parts(mbx, mby, geo, modes, base, refs, mvd_p):
            """Reconstruct a partitioned B MB: per-partition predictor
            derivation in decode order, motion commit, MC, averaging.
            modes[pi] is None for B_Direct_8x8 subs.  Returns the
            assembled 16x16/8x8 prediction planes."""
            gx, gy = mbx * 4, mby * 4
            x, yy = mbx * 16, mby * 16
            cx, cy = mbx * 8, mby * 8
            pred = np.zeros((16, 16), np.int32)
            pu = np.zeros((8, 8), np.int32)
            pv = np.zeros((8, 8), np.int32)
            for pi, (ox, oy, pw_, ph_) in enumerate(geo):
                px4, py4 = gx + ox // 4, gy + oy // 4
                sl_y = (slice(oy, oy + ph_), slice(ox, ox + pw_))
                sl_c = (slice(oy // 2, (oy + ph_) // 2),
                        slice(ox // 2, (ox + pw_) // 2))
                if modes[pi] is None:          # B_Direct_8x8
                    pred[sl_y], pu[sl_c], pv[sl_c] = direct_recon(
                        mbx, mby, apply=False, quad=(oy // 8, ox // 8))
                    dec4[py4:py4 + 2, px4:px4 + 2] = True
                    continue
                lists = ((0,) if modes[pi] == 0 else
                         (1,) if modes[pi] == 1 else (0, 1))
                preds = []
                for lst in lists:
                    mg, rg = (mvg0, refg0) if lst == 0 else (mvg1, refg1)
                    ref_i = refs[pi][lst]
                    pmv = mv_pred_part(mg, rg, dec4, px4, py4, pw_ // 4,
                                       ph_ // 4, ref_i,
                                       f"{base}_{pi}" if base else "")
                    dx, dy = mvd_p[pi][lst]
                    mvx, mvy = pmv[0] + dx, pmv[1] + dy
                    store_part(px4, py4, pw_ // 4, ph_ // 4, lst, ref_i,
                               mvx, mvy)
                    ent = l0[ref_i] if lst == 0 else l1[ref_i]
                    preds.append(mc_pair(ent, x + ox, yy + oy,
                                         cx + ox // 2, cy + oy // 2,
                                         mvx, mvy, pw_, ph_))
                dec4[py4:py4 + ph_ // 4, px4:px4 + pw_ // 4] = True
                if len(preds) == 2:
                    pred[sl_y], pu[sl_c], pv[sl_c] = wp_bi(
                        preds[0], preds[1], refs[pi][0], refs[pi][1])
                else:
                    pred[sl_y], pu[sl_c], pv[sl_c] = wp_uni(
                        preds[0], lists[0], refs[pi][lists[0]])
            return pred, pu, pv

        if cabac:
            self._decode_b_mbs_cabac(
                r, qp, qpc, model, rec_y, rec_u, rec_v, nc_y, nc_u, nc_v,
                mvg0, refg0, mvg1, refg1, intra_mb, mode4, is_i4,
                pred_mode4, direct_recon, clear_nc, add_residual, store_uni,
                mc_pair, l0, l1, n0, n1, decode_parts, dec4)
        else:
            n_mbs = mbw * mbh
            addr = 0
            while addr < n_mbs:
                run = r.ue()
                for _ in range(run):
                    direct_recon(addr % mbw, addr // mbw)
                    clear_nc(addr % mbw, addr // mbw)
                    dec4[(addr // mbw) * 4:(addr // mbw) * 4 + 4,
                         (addr % mbw) * 4:(addr % mbw) * 4 + 4] = True
                    addr += 1
                if addr >= n_mbs:
                    break
                mbx, mby = addr % mbw, addr // mbw
                addr += 1
                mb_type = r.ue()
                gx, gy = mbx * 4, mby * 4
                if mb_type >= 23:
                    intra_mb[mby, mbx] = True
                    dec4[gy:gy + 4, gx:gx + 4] = True
                    if mb_type == 23:
                        self._decode_i4_mb(r, None, rec_y, rec_u, rec_v,
                                           nc_y, nc_u, nc_v, mbx, mby,
                                           qp, qpc, mode4, is_i4, pred_mode4)
                    else:
                        self._decode_i16_mb(r, mb_type - 24, rec_y, rec_u,
                                            rec_v, nc_y, nc_u, nc_v,
                                            mbx, mby, qp, qpc)
                    continue
                assert mb_type <= 22, f"unsupported B mb_type {mb_type}"
                if mb_type == 0:
                    pred, pu, pv = direct_recon(mbx, mby, apply=False)
                    dec4[gy:gy + 4, gx:gx + 4] = True
                else:
                    if mb_type <= 3:
                        geo = ((0, 0, 16, 16),)
                        modes, base = (mb_type - 1,), ""
                        grp = [0]
                    elif mb_type <= 21:
                        geo, modes = _B_RECT[mb_type]
                        base = "16x8" if mb_type % 2 == 0 else "8x16"
                        grp = [0, 1]
                    else:
                        subs_ = [r.ue() for _ in range(4)]
                        assert max(subs_) <= 12, \
                            f"invalid B sub_mb_type {subs_}"
                        geo, modes, grp, base = [], [], [], ""
                        for b8, s_ in enumerate(subs_):
                            mode, sgeo = _B_SUB_GEO[s_]
                            for sx, sy, pw_, ph_ in sgeo:
                                geo.append(((b8 & 1) * 8 + sx,
                                            (b8 >> 1) * 8 + sy, pw_, ph_))
                                modes.append(mode)
                                grp.append(b8)
                    uses = [() if m is None else
                            ((0,) if m == 0 else
                             (1,) if m == 1 else (0, 1)) for m in modes]
                    nparts = len(geo)
                    # ref_idx is coded once per partition group (per MB
                    # partition, or per 8x8 sub-macroblock for B_8x8)
                    ngrp = max(grp) + 1
                    refs_g = [[0, 0] for _ in range(ngrp)]
                    for lst in (0, 1):
                        na = n0 if lst == 0 else n1
                        if na > 1:
                            for g in range(ngrp):
                                if any(grp[pi] == g and lst in uses[pi]
                                       for pi in range(nparts)):
                                    refs_g[g][lst] = _te_read(r, na - 1)
                    refs = [refs_g[grp[pi]] for pi in range(nparts)]
                    mvd_p = [[None, None] for _ in range(nparts)]
                    for lst in (0, 1):
                        for pi in range(nparts):
                            if lst in uses[pi]:
                                mvd_p[pi][lst] = (r.se(), r.se())
                    pred, pu, pv = decode_parts(mbx, mby, geo, modes,
                                                base, refs, mvd_p)
                cbp = _CBP_FROM_CODE_INTER_420[r.ue()]
                cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
                if cbp:
                    assert r.se() == 0      # mb_qp_delta
                lv = np.zeros((4, 4, 4, 4), np.int64)
                for i8 in range(4):
                    for k in range(4):
                        idx = 4 * i8 + k
                        x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                        if cbp_luma & (1 << i8):
                            coeffs = cavlc.decode_block(
                                r, nc_y.nc(gx + x4, gy + y4), 16)
                            flat = np.zeros(16, np.int64)
                            flat[zz] = coeffs
                            lv[y4, x4] = flat.reshape(4, 4)
                            nc_y.set(gx + x4, gy + y4,
                                     sum(1 for c in coeffs if c))
                        else:
                            nc_y.set(gx + x4, gy + y4, 0)
                c_dc_q = [np.zeros((2, 2), np.int64) for _ in range(2)]
                c_ac_q = [np.zeros((2, 2, 4, 4), np.int64) for _ in range(2)]
                if cbp_chroma:
                    for comp in (0, 1):
                        lst = cavlc.decode_block(r, -1, 4)
                        c_dc_q[comp][0, 0], c_dc_q[comp][0, 1] = \
                            lst[0], lst[1]
                        c_dc_q[comp][1, 0], c_dc_q[comp][1, 1] = \
                            lst[2], lst[3]
                for comp, grid in ((0, nc_u), (1, nc_v)):
                    for idx in range(4):
                        x4, y4 = idx & 1, idx >> 1
                        if cbp_chroma == 2:
                            coeffs = cavlc.decode_block(
                                r, grid.nc(mbx * 2 + x4, mby * 2 + y4), 15)
                            flat = np.zeros(16, np.int64)
                            flat[zz[1:]] = coeffs
                            c_ac_q[comp][y4, x4] = flat.reshape(4, 4)
                            grid.set(mbx * 2 + x4, mby * 2 + y4,
                                     sum(1 for c in coeffs if c))
                        else:
                            grid.set(mbx * 2 + x4, mby * 2 + y4, 0)
                add_residual(mbx, mby, pred, pu, pv, lv, cbp, c_dc_q, c_ac_q)

        if dbf_idc != 1:
            bs_ver, bs_hor = bs_maps_b(intra_mb, nc_y.tc, mvg0, refpoc0,
                                       mvg1, refpoc1)
            rec_y, rec_u, rec_v = deblock_frame(rec_y, rec_u, rec_v, qp, qpc,
                                                bs_ver, bs_hor, aoff, boff)
        return poc, (rec_y, rec_u, rec_v)

    # video_codecs_tpu/models/h264/bslice_codec.py:1389
    def _decode_b_mbs_cabac(self, r, qp, qpc, model, rec_y, rec_u, rec_v,
                            nc_y, nc_u, nc_v, mvg0, refg0, mvg1, refg1,
                            intra_mb, mode4, is_i4, pred_mode4,
                            direct_recon, clear_nc, add_residual, store_uni,
                            mc_pair, l0, l1, n0, n1, decode_parts, dec4):
        """CABAC B-slice MB loop (mirror of the encoder's CABAC path)."""
        mbw, mbh = self.size
        w4 = mbw * 4
        zz = cavlc.ZIGZAG_4x4
        cd = hc.H264CabacDecoder(r, "P", qp, model)
        cbf = hc.CbfState(mbw, mbh)
        cbp_arr = np.zeros((mbh, mbw), np.int32)
        cipred = np.zeros((mbh, mbw), np.int32)
        skip = np.zeros((mbh, mbw), bool)
        direct = np.zeros((mbh, mbw), bool)
        # per-4x4 |mvd| / direct-coding grids for the mvd and ref_idx
        # context derivations (spec 9.3.3.1.1.6-7)
        mvd4 = np.zeros((mbh * 4, mbw * 4, 2, 2), np.int32)
        dir4 = np.zeros((mbh * 4, mbw * 4), bool)
        i16 = np.zeros((mbh, mbw), bool)

        def mvd_err(px4, py4, lst, comp):
            a = abs(int(mvd4[py4, px4 - 1, lst, comp])) if px4 > 0 else 0
            b = abs(int(mvd4[py4 - 1, px4, lst, comp])) if py4 > 0 else 0
            return a + b

        for mby in range(mbh):
            for mbx in range(mbw):
                x, yy = mbx * 16, mby * 16
                cx, cy = mbx * 8, mby * 8
                gx, gy = mbx * 4, mby * 4
                last_mb = (mby == mbh - 1 and mbx == mbw - 1)
                a = 1 if (mbx > 0 and not skip[mby, mbx - 1]) else 0
                b = 1 if (mby > 0 and not skip[mby - 1, mbx]) else 0
                if cd.mb_skip_flag_b(a, b):
                    skip[mby, mbx] = True
                    direct[mby, mbx] = True
                    dir4[gy:gy + 4, gx:gx + 4] = True
                    dec4[gy:gy + 4, gx:gx + 4] = True
                    direct_recon(mbx, mby)
                    clear_nc(mbx, mby)
                    cbf.mark(mbx, mby)
                    assert cd.final() == (1 if last_mb else 0)
                    continue
                ta = 1 if (mbx > 0 and not direct[mby, mbx - 1]
                           and not skip[mby, mbx - 1]) else 0
                tb = 1 if (mby > 0 and not direct[mby - 1, mbx]
                           and not skip[mby - 1, mbx]) else 0
                act, i16_sym = cd.mb_type_b(ta + tb)
                if act >= 23:
                    intra_mb[mby, mbx] = True
                    dec4[gy:gy + 4, gx:gx + 4] = True
                    self._decode_intra_mb_cabac(
                        cd, 6 if act == 23 else 7, i16_sym, mbx, mby, qp,
                        qpc, rec_y, rec_u, rec_v, cbf, cbp_arr, cipred,
                        mode4, is_i4, pred_mode4, i16)
                    assert cd.final() == (1 if last_mb else 0)
                    continue
                assert act <= 22, f"unsupported B mb_type act {act}"
                if act == 0:
                    direct[mby, mbx] = True
                    dir4[gy:gy + 4, gx:gx + 4] = True
                    dec4[gy:gy + 4, gx:gx + 4] = True
                    pred, pu, pv = direct_recon(mbx, mby, apply=False)
                else:
                    subs = None
                    if act <= 3:
                        geo = ((0, 0, 16, 16),)
                        modes, base = (act - 1,), ""
                        grp = [0]
                        grp_r4 = [(gx, gy, 4, 4)]
                    elif act <= 21:
                        geo, modes = _B_RECT[act]
                        base = "16x8" if act % 2 == 0 else "8x16"
                        grp = [0, 1]
                        grp_r4 = [(gx + ox // 4, gy + oy // 4,
                                   pw_ // 4, ph_ // 4)
                                  for ox, oy, pw_, ph_ in geo]
                    else:
                        subs = [cd.sub_mb_type_b() for _ in range(4)]
                        assert max(subs) <= 12, \
                            f"invalid B sub_mb_type {subs}"
                        geo, modes, grp, base = [], [], [], ""
                        grp_r4 = []
                        for b8, s_ in enumerate(subs):
                            mode, sgeo = _B_SUB_GEO[s_]
                            ox8, oy8 = (b8 & 1) * 8, (b8 >> 1) * 8
                            grp_r4.append((gx + ox8 // 4, gy + oy8 // 4,
                                           2, 2))
                            if mode is None:
                                dir4[gy + oy8 // 4:gy + oy8 // 4 + 2,
                                     gx + ox8 // 4:gx + ox8 // 4 + 2] \
                                    = True
                            for sx, sy, pw_, ph_ in sgeo:
                                geo.append((ox8 + sx, oy8 + sy, pw_, ph_))
                                modes.append(mode)
                                grp.append(b8)
                    uses = [() if m is None else
                            ((0,) if m == 0 else
                             (1,) if m == 1 else (0, 1)) for m in modes]
                    nparts = len(geo)
                    ngrp = max(grp) + 1
                    refs_g = [[0, 0] for _ in range(ngrp)]
                    for lst in (0, 1):
                        na = n0 if lst == 0 else n1
                        if na <= 1:
                            continue
                        for g in range(ngrp):
                            if not any(grp[pi] == g and lst in uses[pi]
                                       for pi in range(nparts)):
                                continue
                            px4, py4, pw4, ph4 = grp_r4[g]
                            rg = refg0 if lst == 0 else refg1
                            # readRefFrame_CABAC: neighbor term is 0 when
                            # the neighboring partition is direct/skip
                            ra = 1 if (px4 > 0 and not dir4[py4, px4 - 1]
                                       and rg[py4, px4 - 1] > 0) else 0
                            rb = 1 if (py4 > 0 and not dir4[py4 - 1, px4]
                                       and rg[py4 - 1, px4] > 0) else 0
                            ref_i = cd.ref_idx(ra + 2 * rb)
                            refs_g[g][lst] = ref_i
                            # parsed refIdx made visible to later
                            # partitions' ref contexts (9.3.3.1.1.6)
                            rg[py4:py4 + ph4, px4:px4 + pw4] = ref_i
                    refs = [refs_g[grp[pi]] for pi in range(nparts)]
                    mvd_p = [[None, None] for _ in range(nparts)]
                    for lst in (0, 1):
                        for pi in range(nparts):
                            if lst not in uses[pi]:
                                continue
                            ox, oy, pw_, ph_ = geo[pi]
                            px4, py4 = gx + ox // 4, gy + oy // 4
                            dx = cd.mvd(0, mvd_err(px4, py4, lst, 0))
                            dy = cd.mvd(1, mvd_err(px4, py4, lst, 1))
                            mvd_p[pi][lst] = (dx, dy)
                            mvd4[py4:py4 + ph_ // 4,
                                 px4:px4 + pw_ // 4, lst, 0] = dx
                            mvd4[py4:py4 + ph_ // 4,
                                 px4:px4 + pw_ // 4, lst, 1] = dy
                    pred, pu, pv = decode_parts(mbx, mby, geo, modes,
                                                base, refs, mvd_p)

                def nbr(dx, dy):
                    nx, ny = mbx + dx, mby + dy
                    if nx < 0 or ny < 0:
                        return None
                    return {"cbp": int(cbp_arr[ny, nx]), "ipcm": False}

                cbp = cd.cbp(nbr(0, -1), nbr(-1, 0))
                cbp_arr[mby, mbx] = cbp
                cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
                if cbp:
                    assert cd.mb_qp_delta(False) == 0, "dqp unsupported"
                cur_bits = 0
                lv = np.zeros((4, 4, 4, 4), np.int64)
                for i8 in range(4):
                    for k in range(4):
                        idx = 4 * i8 + k
                        x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                        if not (cbp_luma & (1 << i8)):
                            nc_y.set(gx + x4, gy + y4, 0)
                            continue
                        ctx = cbf.ctx_ac(mbx, mby, x4, y4, 1, 4,
                                         cur_bits, False)
                        coeffs = cd.residual_block(hc.LUMA_4x4, 16, ctx)
                        flat = np.zeros(16, np.int64)
                        flat[zz] = coeffs
                        lv[y4, x4] = flat.reshape(4, 4)
                        nc_y.set(gx + x4, gy + y4,
                                 sum(1 for c in coeffs if c))
                        if any(coeffs):
                            cur_bits |= 1 << (1 + 4 * y4 + x4)
                            cbf.set_bit(mbx, mby, 1 + 4 * y4 + x4)
                c_dc_q = [np.zeros((2, 2), np.int64) for _ in range(2)]
                c_ac_q = [np.zeros((2, 2, 4, 4), np.int64)
                          for _ in range(2)]
                if cbp_chroma:
                    for comp, bit in ((0, hc.CbfState.U_DC_BIT),
                                      (1, hc.CbfState.V_DC_BIT)):
                        ctx = cbf.ctx_dc(mbx, mby, bit, False)
                        lst = cd.residual_block(hc.CHROMA_DC, 4, ctx)
                        c_dc_q[comp][0, 0], c_dc_q[comp][0, 1] = \
                            lst[0], lst[1]
                        c_dc_q[comp][1, 0], c_dc_q[comp][1, 1] = \
                            lst[2], lst[3]
                        if any(lst):
                            cbf.set_bit(mbx, mby, bit)
                for comp, grid in ((0, nc_u), (1, nc_v)):
                    base = (hc.CbfState.U_AC_BASE if comp == 0
                            else hc.CbfState.V_AC_BASE)
                    for idx in range(4):
                        x4, y4 = idx & 1, idx >> 1
                        if cbp_chroma != 2:
                            grid.set(mbx * 2 + x4, mby * 2 + y4, 0)
                            continue
                        ctx = cbf.ctx_ac(mbx, mby, x4, y4, base, 2,
                                         cur_bits, False)
                        coeffs = cd.residual_block(hc.CHROMA_AC, 15, ctx)
                        flat = np.zeros(16, np.int64)
                        flat[zz[1:]] = coeffs
                        c_ac_q[comp][y4, x4] = flat.reshape(4, 4)
                        grid.set(mbx * 2 + x4, mby * 2 + y4,
                                 sum(1 for c in coeffs if c))
                        if any(coeffs):
                            cur_bits |= 1 << (base + 4 * y4 + x4)
                            cbf.set_bit(mbx, mby, base + 4 * y4 + x4)
                cbf.mark(mbx, mby)
                add_residual(mbx, mby, pred, pu, pv, lv, cbp,
                             c_dc_q, c_ac_q)
                assert cd.final() == (1 if last_mb else 0)
