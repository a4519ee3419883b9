"""H.264 baseline IPPP codec: P slices with P_Skip / P_L0 partitions /
intra MBs, CAVLC.

The port's copy of the baseline CAVLC half of
video_codecs_tpu/models/h264/inter_codec.py.  Each function and class
kept is carried as it is under its own name, with a comment giving the
original's line.  Kept: the MV prediction and motion-grid helpers, the
P-frame boundary strengths, `_code_residual_16`, the single-reference
IPPP sequence driver of `H264Encoder` and the CAVLC `H264Decoder`
(P_Skip, all four P partition types, intra MBs in P slices).  Cut, with
the branches behind them: the host motion search and host P coder
(`_search*`, `_subpel_refine`, `_encode_p_frame` -- the device engine of
models/h264/inter_dev.py codes P pictures), CABAC, weighted prediction,
the 8x8 transform, several references in the encoder, long-term
references, list reordering, MMCO and error concealment.  The
constructors and the decoder raise NotImplementedError on those.

Mirrors the JM encoder/decoder behavior (reference: jm18.5 lencod/ldecod —
mv prediction lcommon/src/mv_prediction.c GetMotionVectorPredictorNormal,
skip derivation ldecod/src/macroblock.c skip_macroblock, inter CBP me(v)
mapping lencod/src/vlc.c:31 NCBP[1][cbp][1], deblock strengths
ldecod/src/loop_filter_normal.c get_strength_*).
"""

from __future__ import annotations

import numpy as np

from video_codecs_tpu_torch.entropy import cavlc
from video_codecs_tpu_torch.entropy.bitstream import (
    BitReader, split_annexb, strip_emulation_prevention)
from video_codecs_tpu_torch.models.h264 import dpb as dpb_mod
from video_codecs_tpu_torch.models.h264.intra_codec import (
    _BLK_X, _BLK_Y, _decoded_before, _parse_baseline_pps,
    H264IntraDecoder, H264IntraEncoder, NcGrid, annexb, nal_unit,
    parse_sps, write_pps, write_sps, NAL_SPS, NAL_PPS, NAL_SLICE_IDR)
from video_codecs_tpu_torch.ops import h264_transform as ht
from video_codecs_tpu_torch.ops.h264_deblock import deblock_frame
from video_codecs_tpu_torch.ops.h264_interp import mc_chroma_np, mc_luma_np

# coded_block_pattern me(v) mapping for Inter MBs, 4:2:0
# (spec Table 9-4 codeNum column 2; jm18.5/lencod/src/vlc.c:31 NCBP[1][cbp][1])
_NCBP_INTER_420 = [
    0, 2, 3, 7, 4, 8, 17, 13, 5, 18, 9, 14, 10, 15, 16, 11,
    1, 32, 33, 36, 34, 37, 44, 40, 35, 45, 38, 41, 39, 42, 43, 19,
    6, 24, 25, 20, 26, 21, 46, 28, 27, 47, 22, 29, 23, 30, 31, 12,
]
_CBP_FROM_CODE_INTER_420 = [0] * 48
for _cbp, _code in enumerate(_NCBP_INTER_420):
    _CBP_FROM_CODE_INTER_420[_code] = _cbp


# video_codecs_tpu/models/h264/inter_codec.py:43
def _se_bits(v: int) -> int:
    v = int(v)
    idx = 2 * v - 1 if v > 0 else -2 * v
    return 2 * (idx + 1).bit_length() - 1


# video_codecs_tpu/models/h264/inter_codec.py:49
def _te_write(w, v: int, cmax: int) -> None:
    """Truncated exp-Golomb te(v) (spec 9.1.1), used for ref_idx_l0."""
    if cmax == 1:
        w.flag(1 - v)
    else:
        w.ue(v)


# video_codecs_tpu/models/h264/inter_codec.py:57
def _te_read(r, cmax: int) -> int:
    if cmax == 1:
        return 1 - r.flag()
    return r.ue()


# video_codecs_tpu/models/h264/inter_codec.py:63
def _te_bits(v: int, cmax: int) -> int:
    return 1 if cmax == 1 else 2 * (v + 1).bit_length() - 1


# video_codecs_tpu/models/h264/inter_codec.py:67
def mv_pred_part(mvg, refg, dec4, gx, gy, pw4, ph4, ref: int = 0,
                 shape: str = ""):
    """Partition L0 MV predictor (spec 8.4.1.3): median of A/B/C with
    the only-A, single-matching-ref and 16x8/8x16 directional special
    cases.  refg is -1 for intra or unavailable blocks (predict mv 0);
    dec4 marks 4x4 blocks already decoded (partition decode order —
    None means everything inside the picture counts as decoded).
    shape: '' | '16x8_0' | '16x8_1' | '8x16_0' | '8x16_1'."""
    h4, w4 = refg.shape

    def nb(bx, by):
        if bx < 0 or by < 0 or bx >= w4 or by >= h4:
            return None                       # outside picture
        if dec4 is not None and not dec4[by, bx]:
            return None                       # not yet decoded
        return (int(refg[by, bx]), int(mvg[by, bx, 0]), int(mvg[by, bx, 1]))

    A = nb(gx - 1, gy)
    B = nb(gx, gy - 1)
    C = nb(gx + pw4, gy - 1)
    if C is None:
        C = nb(gx - 1, gy - 1)                # fall back to D
    # directional shortcuts for the rectangular MB partitions
    if shape == "16x8_0" and B is not None and B[0] == ref:
        return B[1], B[2]
    if shape == "16x8_1" and A is not None and A[0] == ref:
        return A[1], A[2]
    if shape == "8x16_0" and A is not None and A[0] == ref:
        return A[1], A[2]
    if shape == "8x16_1" and C is not None and C[0] == ref:
        return C[1], C[2]
    if B is None and C is None and A is not None:
        return A[1], A[2]
    cands = [A, B, C]
    match = [c for c in cands if c is not None and c[0] == ref]
    if len(match) == 1:
        return match[0][1], match[0][2]
    xs = [c[1] if c is not None else 0 for c in cands]
    ys = [c[2] if c is not None else 0 for c in cands]
    med = lambda a: sorted(a)[1]
    return med(xs), med(ys)


# video_codecs_tpu/models/h264/inter_codec.py:110
def median_mv_pred(mvg, refg, gx, gy, w4, ref: int = 0):
    """16x16 MV predictor (kept as the whole-MB entry point)."""
    return mv_pred_part(mvg, refg, None, gx, gy, 4, 4, ref)


# MB partition geometry: mb_type -> [(off_x, off_y, w, h)]
_P_PARTS = {1: ((0, 0, 16, 8), (0, 8, 16, 8)),
            2: ((0, 0, 8, 16), (8, 0, 8, 16))}
# sub_mb_type -> [(off_x, off_y, w, h)] within the 8x8 block
_SUB_PARTS = {0: ((0, 0, 8, 8),),
              1: ((0, 0, 8, 4), (0, 4, 8, 4)),
              2: ((0, 0, 4, 8), (4, 0, 4, 8)),
              3: ((0, 0, 4, 4), (4, 0, 4, 4), (0, 4, 4, 4), (4, 4, 4, 4))}


# video_codecs_tpu/models/h264/inter_codec.py:125
def _commit_part(mvg, refg, dec4, gx, gy, ox, oy, pw, ph, ref_i, mv):
    """Write one partition's motion into the 4x4 grids + decode mask."""
    x4, y4 = gx + ox // 4, gy + oy // 4
    mvg[y4:y4 + ph // 4, x4:x4 + pw // 4] = mv
    refg[y4:y4 + ph // 4, x4:x4 + pw // 4] = ref_i
    if dec4 is not None:
        dec4[y4:y4 + ph // 4, x4:x4 + pw // 4] = True


# video_codecs_tpu/models/h264/inter_codec.py:134
def skip_mv(mvg, refg, gx, gy, w4):
    """P_Skip motion vector (spec 8.4.1.1)."""
    h4 = mvg.shape[0]
    if gx - 1 < 0 or gy - 1 < 0:
        return 0, 0
    a = (int(refg[gy, gx - 1]), int(mvg[gy, gx - 1, 0]),
         int(mvg[gy, gx - 1, 1]))
    b = (int(refg[gy - 1, gx]), int(mvg[gy - 1, gx, 0]),
         int(mvg[gy - 1, gx, 1]))
    if a == (0, 0, 0) or b == (0, 0, 0):
        return 0, 0
    return median_mv_pred(mvg, refg, gx, gy, w4)


# video_codecs_tpu/models/h264/inter_codec.py:148
def bs_maps_p(intra_mb, nz_y, mvg, refg):
    """Boundary-strength maps for a P frame at 4x4 granularity
    (spec 8.7.2.1 for frame coding, one reference)."""
    mbh, mbw = intra_mb.shape
    h4, w4 = mbh * 4, mbw * 4
    intra4 = np.repeat(np.repeat(intra_mb, 4, 0), 4, 1)
    nz = nz_y > 0
    bs_ver = np.zeros((h4, w4), np.int32)
    bs_hor = np.zeros((h4, w4), np.int32)
    for axis, bs in ((1, bs_ver), (0, bs_hor)):
        if axis == 1:
            pi, qi = (slice(None), slice(None, -1)), (slice(None), slice(1, None))
            tgt = bs[:, 1:]
            mb_edge = (np.arange(1, w4) % 4 == 0)[None, :]
        else:
            pi, qi = (slice(None, -1), slice(None)), (slice(1, None), slice(None))
            tgt = bs[1:, :]
            mb_edge = (np.arange(1, h4) % 4 == 0)[:, None]
        any_intra = intra4[pi] | intra4[qi]
        any_nz = nz[pi] | nz[qi]
        dmv = np.abs(mvg[pi] - mvg[qi]).max(axis=-1) >= 4
        dref = refg[pi] != refg[qi]
        tgt[...] = np.where(any_intra, np.where(mb_edge, 4, 3),
                            np.where(any_nz, 2,
                                     np.where(dmv | dref, 1, 0)))
    return bs_ver, bs_hor


# video_codecs_tpu/models/h264/inter_codec.py:241
def _code_residual_16(w, lv, nc_grid, gx, gy):
    coeffs = lv.reshape(16)[cavlc.ZIGZAG_4x4]
    total = cavlc.encode_block(w, [int(c) for c in coeffs],
                               nc_grid.nc(gx, gy), 16)
    nc_grid.set(gx, gy, total)


# video_codecs_tpu/models/h264/inter_codec.py:248
def _ue_bits(v: int) -> int:
    return 2 * (v + 1).bit_length() - 1


# video_codecs_tpu/models/h264/inter_codec.py:264
class H264Encoder(H264IntraEncoder):
    """IPPP: IDR then P frames, one (deblocked) reference.

    The P pictures are coded by a subclass (the device engine overrides
    `_encode_p_frame`); this class has no host P coder."""

    # video_codecs_tpu/models/h264/inter_codec.py:267
    def __init__(self, width: int, height: int, qp: int = 28,
                 search_range: int = 16, gop: int = 0,
                 entropy: str = "cavlc", perceptual: str = "",
                 n_refs: int = 1, quant: str = "normal",
                 me: str = "full", weighted_pred: bool = False,
                 partitions: bool = True,
                 transform8x8: bool = False,
                 long_term: bool = False, lt_period: int = 0,
                 reorder: str = "", intra_refresh: int = 0) -> None:
        super().__init__(width, height, qp=qp, deblock=True, entropy=entropy,
                         perceptual=perceptual, quant=quant,
                         transform8x8=transform8x8)
        cut = {"n_refs": n_refs != 1, "me": me != "full",
               "weighted_pred": weighted_pred, "partitions": not partitions,
               "long_term": long_term or lt_period > 0,
               "reorder": reorder != "", "intra_refresh": intra_refresh}
        bad = [k for k, v in cut.items() if v]
        if bad:
            raise NotImplementedError(
                f"H264Encoder: {', '.join(bad)} not ported (one reference, "
                "full search, all partitions, no WP/long-term/reordering/"
                "intra refresh)")
        self.sr = search_range
        self.gop = gop                 # 0 = only first frame is IDR
        self.n_refs = n_refs           # sliding-window DPB size (list0)

    # video_codecs_tpu/models/h264/inter_codec.py:302
    def encode_sequence(self, frames):
        nals = [nal_unit(NAL_SPS, write_sps(self.w // 16, self.h // 16,
                                            num_ref_frames=self.n_refs)),
                nal_unit(NAL_PPS, write_pps())]
        recons = []
        dpb = dpb_mod.Dpb(self.n_refs, 8)
        frame_num = 0
        for idx, (y, u, v) in enumerate(frames):
            is_idr = not dpb.pics or (self.gop and idx % self.gop == 0)
            if is_idr:
                rbsp, rec = self.encode_frame(y, u, v, idr_id=idx & 1)
                nals.append(nal_unit(NAL_SLICE_IDR, rbsp))
                dpb.idr_reset()
                dpb.mark(dpb_mod.RefPic(rec, frame_num=0))
                frame_num = 1
            else:
                refs = [p.planes for p in dpb.default_list0(frame_num)]
                rbsp, rec = self._encode_p_frame(y, u, v, refs, frame_num)
                nals.append(nal_unit(1, rbsp, ref_idc=2))
                dpb.mark(dpb_mod.RefPic(rec, frame_num=frame_num))
                frame_num = (frame_num + 1) & 0xFF
            recons.append(rec)
        return annexb(nals), recons

    # video_codecs_tpu/models/h264/inter_codec.py:654
    def _encode_p_frame(self, y, u, v, refs, frame_num):
        raise NotImplementedError(
            "no host P coder in the port: use DeviceH264Encoder")


# video_codecs_tpu/models/h264/inter_codec.py:1173
class H264Decoder(H264IntraDecoder):
    """Decodes IDR + P (IPPP) baseline CAVLC streams."""

    # video_codecs_tpu/models/h264/inter_codec.py:1176
    def __init__(self, conceal: int = 0) -> None:
        """conceal: only 0 (errors raise); concealment is not ported."""
        if conceal:
            raise NotImplementedError("error concealment is not ported")
        super().__init__()
        self.dpb = []            # list0: most recently decoded first
        self.max_refs = 1
        self._next_fn = 0

    # video_codecs_tpu/models/h264/inter_codec.py:1214
    def _push(self, rec, frames, fn=None, is_ref=True):
        frames.append(rec)
        if fn is None:
            fn = self._next_fn
        if is_ref:
            self._dpbm.mark(dpb_mod.RefPic(rec, frame_num=fn))
        # default skip reference
        self.dpb = [p.planes
                    for p in self._dpbm.default_list0(fn)] or [rec]

    # video_codecs_tpu/models/h264/inter_codec.py:1231
    def _idr_lt_flag(self, rbsp) -> bool:
        """long_term_reference_flag of an IDR slice header."""
        r = BitReader(rbsp)
        r.ue(), r.ue(), r.ue()
        info = getattr(self, "sps_info", {})
        r.read(info.get("log2_max_frame_num", 8))
        r.ue()                     # idr_pic_id
        if info.get("poc_type", 2) == 0:
            r.read(info["log2_max_poc_lsb"])
        r.flag()                   # no_output_of_prior_pics
        return bool(r.flag())

    # video_codecs_tpu/models/h264/inter_codec.py:1243
    def decode(self, stream: bytes) -> list:
        frames = []
        for nal in split_annexb(stream):
            nal_type = nal[0] & 0x1F
            rbsp = strip_emulation_prevention(nal[1:])
            if nal_type == NAL_SPS:
                wmb, hmb, info = parse_sps(rbsp, full=True)
                self.size = (wmb, hmb)
                self.sps_info = info
                self.max_refs = max(info["num_ref_frames"], 1)
                self._dpbm = dpb_mod.Dpb(self.max_refs,
                                         info["log2_max_frame_num"])
            elif nal_type == NAL_PPS:
                self.dbf_present, ppsinfo = _parse_baseline_pps(rbsp)
                self.default_l0 = ppsinfo["num_ref_idx_l0_default_active"]
            elif nal_type in (NAL_SLICE_IDR, 1):
                self._cur_ref_idc = nal[0] >> 5
                if nal_type == NAL_SLICE_IDR:
                    self.dpb = []        # IDR: sliding window resets
                    self._dpbm.idr_reset()
                    if self._idr_lt_flag(rbsp):
                        raise NotImplementedError(
                            "long-term reference pictures are not decoded")
                rec = self._decode_any_slice(rbsp, nal_type == NAL_SLICE_IDR)
                if nal_type == NAL_SLICE_IDR:
                    self._push(rec, frames, fn=0)
                else:
                    self._push(rec, frames,
                               fn=getattr(self, "_cur_fn", None),
                               is_ref=self._cur_ref_idc != 0)
                self._next_fn = 1 if nal_type == NAL_SLICE_IDR else \
                    (self._next_fn + 1) & 0xFF
        return frames

    # video_codecs_tpu/models/h264/inter_codec.py:1302
    def _decode_any_slice(self, rbsp, is_idr):
        r = BitReader(rbsp)
        assert r.ue() == 0
        st = r.ue()
        if st in (2, 7):
            # re-parse with the intra decoder path (it re-reads the header)
            return self._decode_slice(rbsp)
        assert st in (0, 5), f"unsupported slice_type {st}"
        return self._decode_p_slice(r)

    # video_codecs_tpu/models/h264/inter_codec.py:1312
    def _decode_p_slice(self, r):
        mbw, mbh = self.size
        w4 = mbw * 4
        assert r.ue() == 0          # pps_id
        info = getattr(self, "sps_info", {})
        fn = r.read(info.get("log2_max_frame_num", 8))
        self._cur_fn = fn
        if info.get("poc_type", 2) == 0:
            self._last_poc_lsb = r.read(
                self.sps_info["log2_max_poc_lsb"])  # pic_order_cnt_lsb
        n_active = getattr(self, "default_l0", 1)
        if r.flag():                # num_ref_idx_active_override_flag
            n_active = r.ue() + 1   # num_ref_idx_l0_active_minus1
        # ref_pic_list_modification (spec 7.3.3.1 / 8.2.4.3)
        if r.flag():
            raise NotImplementedError("ref_pic_list_modification is not "
                                      "decoded")
        list0 = self._dpbm.default_list0(fn)
        self.dpb = [p.planes for p in list0[:max(n_active, 1)]]
        assert n_active <= len(self.dpb), "ref list underrun"
        # dec_ref_pic_marking (spec 7.3.3.3 / 8.2.5.4)
        if self._cur_ref_idc and r.flag():  # adaptive_ref_pic_marking
            raise NotImplementedError("MMCO is not decoded")
        qp = 26 + r.se()
        dbf_idc, aoff, boff = 0, 0, 0
        if self.dbf_present:
            dbf_idc = r.ue()
            if dbf_idc != 1:
                aoff = 2 * r.se()
                boff = 2 * r.se()
        qpc = int(ht.CHROMA_QP[min(max(qp, 0), 51)])

        rec_y = np.zeros((mbh * 16, mbw * 16), np.int32)
        rec_u = np.zeros((mbh * 8, mbw * 8), np.int32)
        rec_v = np.zeros_like(rec_u)
        nc_y = NcGrid(mbw * 4, mbh * 4)
        nc_u = NcGrid(mbw * 2, mbh * 2)
        nc_v = NcGrid(mbw * 2, mbh * 2)
        mvg = np.zeros((mbh * 4, mbw * 4, 2), np.int32)
        refg = np.full((mbh * 4, mbw * 4), -1, np.int32)
        dec4 = np.zeros((mbh * 4, mbw * 4), bool)
        intra_mb = np.zeros((mbh, mbw), bool)
        mode4 = np.full((mbh * 4, mbw * 4), 2, np.int32)
        is_i4 = np.zeros((mbh, mbw), bool)
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

        skip_ref = self.dpb[0]   # P_Skip always references list0[0]

        def decode_skip(mbx, mby):
            gx, gy = mbx * 4, mby * 4
            mvx, mvy = skip_mv(mvg, refg, gx, gy, w4)
            mvg[gy:gy + 4, gx:gx + 4] = (mvx, mvy)
            refg[gy:gy + 4, gx:gx + 4] = 0
            dec4[gy:gy + 4, gx:gx + 4] = True
            x, yy = mbx * 16, mby * 16
            cx, cy = mbx * 8, mby * 8
            rec_y[yy:yy + 16, x:x + 16] = mc_luma_np(
                skip_ref[0], x, yy, mvx, mvy, 16, 16)
            rec_u[cy:cy + 8, cx:cx + 8] = mc_chroma_np(
                skip_ref[1], cx, cy, mvx, mvy, 8, 8)
            rec_v[cy:cy + 8, cx:cx + 8] = mc_chroma_np(
                skip_ref[2], cx, cy, mvx, mvy, 8, 8)
            for bx4 in range(4):
                for by4 in range(4):
                    nc_y.set(gx + bx4, gy + by4, 0)
            for grid in (nc_u, nc_v):
                for bx2 in range(2):
                    for by2 in range(2):
                        grid.set(mbx * 2 + bx2, mby * 2 + by2, 0)

        n_mbs = mbw * mbh
        addr = 0
        while addr < n_mbs:
            run = r.ue()
            for _ in range(run):
                decode_skip(addr % mbw, addr // mbw)
                addr += 1
            if addr >= n_mbs:
                break
            mbx, mby = addr % mbw, addr // mbw
            addr += 1
            mb_type = r.ue()
            if mb_type >= 5:
                intra_mb[mby, mbx] = True
                dec4[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = True
                if mb_type == 5:
                    self._decode_i4_mb(r, None, rec_y, rec_u, rec_v,
                                       nc_y, nc_u, nc_v, mbx, mby,
                                       qp, qpc, mode4, is_i4,
                                       pred_mode4)
                else:
                    self._decode_i16_mb(r, mb_type - 6, rec_y, rec_u, rec_v,
                                        nc_y, nc_u, nc_v, mbx, mby, qp, qpc)
                continue
            assert mb_type <= 4, f"unsupported P mb_type {mb_type}"
            gx, gy = mbx * 4, mby * 4
            x, yy = mbx * 16, mby * 16
            cx, cy = mbx * 8, mby * 8
            if mb_type == 0:
                ref_i = _te_read(r, n_active - 1) if n_active > 1 else 0
                pmv = mv_pred_part(mvg, refg, dec4, gx, gy, 4, 4, ref_i)
                parts = [(0, 0, 16, 16, ref_i,
                          (pmv[0] + r.se(), pmv[1] + r.se()))]
                for ox, oy, pw_, ph_, ri_, mv_ in parts:
                    _commit_part(mvg, refg, dec4, gx, gy, ox, oy, pw_,
                                 ph_, ri_, mv_)
            else:
                parts = self._parse_p_parts_cavlc(r, mb_type, mvg, refg,
                                                  dec4, gx, gy, n_active)
            pred = np.zeros((16, 16), np.int32)
            pu = np.zeros((8, 8), np.int32)
            pv = np.zeros((8, 8), np.int32)
            for ox, oy, pw_, ph_, ri_, (mvx, mvy) in parts:
                rpy, rpu, rpv = self.dpb[ri_]
                pred[oy:oy + ph_, ox:ox + pw_] = mc_luma_np(
                    rpy, x + ox, yy + oy, mvx, mvy, pw_, ph_)
                pu[oy // 2:(oy + ph_) // 2, ox // 2:(ox + pw_) // 2] = \
                    mc_chroma_np(rpu, cx + ox // 2, cy + oy // 2, mvx, mvy,
                                 pw_ // 2, ph_ // 2)
                pv[oy // 2:(oy + ph_) // 2, ox // 2:(ox + pw_) // 2] = \
                    mc_chroma_np(rpv, cx + ox // 2, cy + oy // 2, mvx, mvy,
                                 pw_ // 2, ph_ // 2)
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
                    c_dc_q[comp][0, 0], c_dc_q[comp][0, 1] = lst[0], lst[1]
                    c_dc_q[comp][1, 0], c_dc_q[comp][1, 1] = lst[2], lst[3]
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

            rec_y[yy:yy + 16, x:x + 16] = np.clip(
                pred + ht.inverse4x4(ht.dequant_ac(lv, qp))
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

        if dbf_idc != 1:
            bs_ver, bs_hor = bs_maps_p(intra_mb, nc_y.tc, mvg, refg)
            rec_y, rec_u, rec_v = deblock_frame(rec_y, rec_u, rec_v, qp, qpc,
                                                bs_ver, bs_hor, aoff, boff)
        return rec_y, rec_u, rec_v

    # video_codecs_tpu/models/h264/inter_codec.py:1624
    def _parse_p_parts_cavlc(self, r, mb_type, mvg, refg, dec4, gx, gy,
                             n_active):
        """mb_pred / sub_mb_pred parse for P partitions (spec 7.3.5.2):
        all ref_idx first, then all MVDs; MV reconstruction follows
        partition decode order so each predictor sees the earlier
        partitions' final motion."""
        out = []
        if mb_type in (1, 2):
            geo = _P_PARTS[mb_type]
            refs = [(_te_read(r, n_active - 1) if n_active > 1 else 0)
                    for _ in geo]
            mvds = [(r.se(), r.se()) for _ in geo]
            base = "16x8" if mb_type == 1 else "8x16"
            for pi, (ox, oy, pw_, ph_) in enumerate(geo):
                pmv = mv_pred_part(mvg, refg, dec4, gx + ox // 4,
                                   gy + oy // 4, pw_ // 4, ph_ // 4,
                                   refs[pi], f"{base}_{pi}")
                mv = (pmv[0] + mvds[pi][0], pmv[1] + mvds[pi][1])
                _commit_part(mvg, refg, dec4, gx, gy, ox, oy, pw_, ph_,
                             refs[pi], mv)
                out.append((ox, oy, pw_, ph_, refs[pi], mv))
            return out
        # P_8x8 (3) / P_8x8ref0 (4)
        subs = [r.ue() for _ in range(4)]
        assert all(s <= 3 for s in subs), subs
        if mb_type == 3 and n_active > 1:
            refs = [_te_read(r, n_active - 1) for _ in range(4)]
        else:
            refs = [0, 0, 0, 0]
        mvds = [[(r.se(), r.se()) for _ in _SUB_PARTS[subs[b8]]]
                for b8 in range(4)]
        for b8 in range(4):
            ox8, oy8 = (b8 & 1) * 8, (b8 >> 1) * 8
            for si, (sx, sy, pw_, ph_) in enumerate(_SUB_PARTS[subs[b8]]):
                ox, oy = ox8 + sx, oy8 + sy
                pmv = mv_pred_part(mvg, refg, dec4, gx + ox // 4,
                                   gy + oy // 4, pw_ // 4, ph_ // 4,
                                   refs[b8])
                mv = (pmv[0] + mvds[b8][si][0], pmv[1] + mvds[b8][si][1])
                _commit_part(mvg, refg, dec4, gx, gy, ox, oy, pw_, ph_,
                             refs[b8], mv)
                out.append((ox, oy, pw_, ph_, refs[b8], mv))
        return out
