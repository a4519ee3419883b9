"""H.264 IPPP codec: the reference's host P coder (P_Skip, P_L0
partitions down to 4x4, intra MBs, several references, full / EPZS /
UMHex search, CAVLC and CABAC, Main and High profile with the 8x8
transform) and its decoder.

The port's copy of video_codecs_tpu/models/h264/inter_codec.py.  Each
function and class kept is carried as it is under its own name, with a
comment giving the original's line.  The host coder's integer SADs and
sub-pel candidates come from its card stage (models/h264/host_me.py:
one SAD-kernel launch and 16 phase planes per reference and P picture)
instead of per-call numpy; its decisions, in the reference's order and
types, stay on the host.  Every option of the reference's coder and
decoder is carried: weighted prediction of P slices, perceptual RDO,
long-term references with MMCO, list reordering, intra refresh and
error concealment, and the trace / statistics wrappers of the CABAC
coder and decoder (utils/trace.py, utils/coding_stats.py).

Mirrors the JM encoder/decoder behavior (reference: jm18.5 lencod/ldecod —
mv prediction lcommon/src/mv_prediction.c GetMotionVectorPredictorNormal,
skip derivation ldecod/src/macroblock.c skip_macroblock, inter CBP me(v)
mapping lencod/src/vlc.c:31 NCBP[1][cbp][1], deblock strengths
ldecod/src/loop_filter_normal.c get_strength_*).
"""

from __future__ import annotations

import numpy as np
import torch

from video_codecs_tpu_torch.entropy import cavlc
from video_codecs_tpu_torch.entropy import h264_cabac as hc
from video_codecs_tpu_torch.entropy.bitstream import (
    BitReader, BitWriter, split_annexb, strip_emulation_prevention)
from video_codecs_tpu_torch.models.h264 import dpb as dpb_mod
from video_codecs_tpu_torch.models.h264 import host_me
from video_codecs_tpu_torch.models.h264.intra_codec import (
    _BLK_X, _BLK_Y, _decoded_before,
    H264IntraDecoder, H264IntraEncoder, NcGrid, annexb, gather_ref4,
    nal_unit, parse_pps, parse_sps, pred_chroma8, pred_luma4, pred_luma16,
    write_pps, write_sps, NAL_SPS, NAL_PPS, NAL_SLICE_IDR)
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


# video_codecs_tpu/models/h264/inter_codec.py:176
def wp_apply(pred, w: int, o: int, logd: int):
    """Explicit weighted prediction on an interpolated block
    (spec 8.4.2.3.2 / jm18.5 weighted_prediction.c)."""
    p = pred.astype(np.int64)
    if logd > 0:
        out = ((p * w + (1 << (logd - 1))) >> logd) + o
    else:
        out = p * w + o
    return np.clip(out, 0, 255).astype(np.int32)


# video_codecs_tpu/models/h264/inter_codec.py:187
def estimate_wp(cur_planes, ref_planes, logd: int = 6):
    """AC/DC weight+offset estimation per plane (wp_lms.c:887 shape)."""
    ws, os_ = [], []
    for c, r in zip(cur_planes, ref_planes):
        c = np.asarray(c, np.float64)
        r = np.asarray(r, np.float64)
        dc_c, dc_r = c.mean(), r.mean()
        ac_c = np.abs(c - dc_c).sum()
        ac_r = np.abs(r - dc_r).sum()
        w = int(round((1 << logd) * ac_c / ac_r)) if ac_r > 0 else (1 << logd)
        w = max(-128, min(127, w))
        o = int(round(dc_c - (w * dc_r) / (1 << logd)))
        ws.append(w)
        os_.append(max(-128, min(127, o)))
    return dict(w=tuple(ws), o=tuple(os_), logd=logd)


# video_codecs_tpu/models/h264/inter_codec.py:204
def write_pred_weight_table(w, wp_list, logd: int):
    """pred_weight_table (spec 7.3.3.2), P slice, list0 only."""
    w.ue(logd)                       # luma_log2_weight_denom
    w.ue(logd)                       # chroma_log2_weight_denom
    for wp in wp_list:
        default_l = wp["w"][0] == (1 << logd) and wp["o"][0] == 0
        w.flag(0 if default_l else 1)
        if not default_l:
            w.se(wp["w"][0])
            w.se(wp["o"][0])
        default_c = all(wp["w"][j] == (1 << logd) and wp["o"][j] == 0
                        for j in (1, 2))
        w.flag(0 if default_c else 1)
        if not default_c:
            for j in (1, 2):
                w.se(wp["w"][j])
                w.se(wp["o"][j])


# video_codecs_tpu/models/h264/inter_codec.py:223
def parse_pred_weight_table(r, n_active: int):
    logd = r.ue()
    logdc = r.ue()
    out = []
    for _ in range(n_active):
        ws = [1 << logd, 1 << logdc, 1 << logdc]
        os_ = [0, 0, 0]
        if r.flag():
            ws[0] = r.se()
            os_[0] = r.se()
        if r.flag():
            for j in (1, 2):
                ws[j] = r.se()
                os_[j] = r.se()
        out.append(dict(w=tuple(ws), o=tuple(os_), logd=logd, logdc=logdc))
    return out


# video_codecs_tpu/models/h264/inter_codec.py:241
def _code_residual_16(w, lv, nc_grid, gx, gy):
    coeffs = lv.reshape(16)[cavlc.ZIGZAG_4x4]
    total = cavlc.encode_block(w, [int(c) for c in coeffs],
                               nc_grid.nc(gx, gy), 16)
    nc_grid.set(gx, gy, total)


# video_codecs_tpu/models/h264/inter_codec.py:248
def _ue_bits(v: int) -> int:
    return 2 * (v + 1).bit_length() - 1


# video_codecs_tpu/models/h264/inter_codec.py:252
def _b8_first_parts(parts):
    """First sub-partition of each 8x8 block (the ref_idx carriers of a
    P_8x8 MB; refs are signalled per 8x8, spec 7.3.5.2)."""
    out, seen = [], set()
    for p in parts:
        b8 = (p[0] // 8, p[1] // 8)
        if b8 not in seen:
            seen.add(b8)
            out.append(p)
    return out


# video_codecs_tpu/models/h264/inter_codec.py:264
class H264Encoder(H264IntraEncoder):
    """IPPP: IDR then P frames, the n_refs most recent (deblocked)
    pictures as references; the reference's host P coder.

    Its integer SADs and sub-pel candidates come from the card stage
    (`host_me.RefSearch`, one per reference and P picture) on `device`,
    the card unless the caller passes "cpu"; the decisions, the
    transforms and the entropy coder run on the host as the reference's.
    With `reorder` the card stage follows the reordered list, so
    `refs[0]` is the long-term picture there too."""

    # video_codecs_tpu/models/h264/inter_codec.py:267
    def __init__(self, width: int, height: int, qp: int = 28,
                 search_range: int = 16, gop: int = 0,
                 entropy: str = "cavlc", perceptual: str = "",
                 n_refs: int = 1, quant: str = "normal",
                 me: str = "full", weighted_pred: bool = False,
                 partitions: bool = True,
                 transform8x8: bool = False,
                 long_term: bool = False, lt_period: int = 0,
                 reorder: str = "", intra_refresh: int = 0,
                 device="cuda") -> None:
        super().__init__(width, height, qp=qp, deblock=True, entropy=entropy,
                         perceptual=perceptual, quant=quant,
                         transform8x8=transform8x8, device=device)
        # DPB command surface (mbuffer.c parity):
        #   long_term: mark the IDR long-term (long_term_reference_flag)
        #   lt_period: every Nth P ref replaces the long-term via MMCO 4+6
        #   reorder:   "lt_first" emits ref_pic_list_modification moving
        #              the long-term picture to ref_idx 0
        self.long_term = long_term or lt_period > 0
        self.lt_period = lt_period
        assert reorder in ("", "lt_first")
        self.reorder = reorder
        assert me in ("full", "epzs", "umhex")
        self.sr = search_range
        self.gop = gop                 # 0 = only first frame is IDR
        self.n_refs = n_refs           # sliding-window DPB size (list0)
        self.me = me                   # integer ME engine (mv_search.c:143)
        self.weighted_pred = weighted_pred
        self.partitions = partitions   # 16x8/8x16/P8x8 mode loops (md_low)
        self._wp = None                # per-ref WP params of this slice
        self._prev_mvg = None          # temporal predictor source (EPZS)
        # intrarefresh.c semantics: N MBs per P picture forced to intra,
        # cycling through the picture so every MB refreshes periodically
        self.intra_refresh = intra_refresh
        self._refresh_cursor = 0

    # video_codecs_tpu/models/h264/inter_codec.py:302
    def encode_sequence(self, frames):
        from video_codecs_tpu_torch.models.h264 import dpb as dpb_mod
        cabac = self.entropy == "cabac"
        profile = 100 if self.transform8x8 else (77 if cabac else 66)
        n_sps_refs = self.n_refs + (1 if self.long_term else 0)
        nals = [nal_unit(NAL_SPS, write_sps(self.w // 16, self.h // 16,
                                            profile=profile,
                                            num_ref_frames=n_sps_refs)),
                nal_unit(NAL_PPS, write_pps(
                    cabac=cabac, weighted_pred=self.weighted_pred,
                    transform8x8=self.transform8x8))]
        recons = []
        dpb = dpb_mod.Dpb(n_sps_refs, 8)
        frame_num = 0
        n_p = 0
        for idx, (y, u, v) in enumerate(frames):
            is_idr = not dpb.pics or (self.gop and idx % self.gop == 0)
            if is_idr:
                rbsp, rec = self.encode_frame(y, u, v, idr_id=idx & 1)
                nals.append(nal_unit(NAL_SLICE_IDR, rbsp))
                dpb.idr_reset()
                dpb.mark(dpb_mod.RefPic(
                    rec, frame_num=0,
                    lt_idx=0 if self.long_term else None))
                frame_num = 1
                n_p = 0
            else:
                list0 = dpb.default_list0(frame_num)
                cmds = None
                if self.reorder == "lt_first" and \
                        any(p.long_term for p in list0):
                    lt = next(p for p in list0 if p.long_term)
                    cmds = [(2, lt.lt_idx)]
                    list0 = dpb.apply_reorder(list0, cmds, frame_num,
                                              len(list0))
                refs = [p.planes for p in list0]
                n_p += 1
                mmco = None
                if self.lt_period and n_p % self.lt_period == 0:
                    # cap MaxLongTermFrameIdx at 0 (evicts the previous
                    # long-term) then mark the current picture long-term
                    mmco = [(4, 1), (6, 0)]
                rbsp, rec = self._encode_p_frame(y, u, v, refs, frame_num,
                                                 reorder_cmds=cmds,
                                                 mmco=mmco)
                nals.append(nal_unit(1, rbsp, ref_idc=2))
                dpb.mark(dpb_mod.RefPic(rec, frame_num=frame_num), mmco)
                frame_num = (frame_num + 1) & 0xFF
            recons.append(rec)
        return annexb(nals), recons

    def _card_stage(self, y, refs) -> list:
        """One `host_me.RefSearch` per reference: the picture's integer
        SAD surfaces and sub-pel phase planes, made on `self.device`."""
        return [host_me.RefSearch(y, r[0], self.sr, self.device)
                for r in refs]

    # -- motion search -----------------------------------------------------
    # video_codecs_tpu/models/h264/inter_codec.py:354
    def _search(self, orig, me, x, y, pred_mv, lam, pw: int = 16,
                ph: int = 16):
        sr = self.sr
        px = min(max(pred_mv[0] >> 2, -sr), sr)
        py = min(max(pred_mv[1] >> 2, -sr), sr)
        # integer full search: the (2sr+1)^2 window of the card's SAD
        # surface around the clamped predictor
        sad = me.window(x, y, pw, ph, px, py)              # (2sr+1, 2sr+1)
        dxs = (np.arange(-sr, sr + 1) + px) * 4
        bits_x = np.array([_se_bits(d - pred_mv[0]) for d in dxs])
        dys = (np.arange(-sr, sr + 1) + py) * 4
        bits_y = np.array([_se_bits(d - pred_mv[1]) for d in dys])
        cost = sad + np.round(lam * (bits_y[:, None] + bits_x[None, :]))
        iy_, ix_ = np.unravel_index(int(np.argmin(cost)), cost.shape)
        best = (int(cost[iy_, ix_]), int(dxs[ix_]), int(dys[iy_]))
        return self._subpel_refine(orig, me, x, y, pred_mv, lam, best,
                                   pw, ph)

    # video_codecs_tpu/models/h264/inter_codec.py:379
    def _subpel_refine(self, orig, me, x, y, pred_mv, lam, best,
                       pw: int = 16, ph: int = 16):
        """Half then quarter-pel refinement around the integer best."""
        for step in (2, 1):
            _, bx, by = best
            for dy in (-step, 0, step):
                for dx in (-step, 0, step):
                    if dx == 0 and dy == 0:
                        continue
                    mvx, mvy = bx + dx, by + dy
                    blk = me.block(x, y, mvx, mvy, pw, ph)
                    cost = int(np.abs(orig - blk).sum()) + round(
                        lam * (_se_bits(mvx - pred_mv[0])
                               + _se_bits(mvy - pred_mv[1])))
                    if cost < best[0]:
                        best = (cost, mvx, mvy)
        return best

    # video_codecs_tpu/models/h264/inter_codec.py:397
    def _search_epzs(self, orig, me, x, y, pred_mv, lam,
                     mvg, refg, gx, gy, w4, prev_mvg):
        """EPZS integer search (jm18.5/lencod/src/me_epzs.c semantics):
        a predictor set (median/zero/left/top/topright/temporally
        colocated) is tested first, a low-SAD hit terminates early,
        otherwise a small-diamond pattern refines iteratively; sub-pel
        refinement is shared with full search."""
        sr = self.sr

        def fp(v):
            return min(max(int(round(v / 4.0)), -sr), sr)

        cands = {(fp(pred_mv[0]), fp(pred_mv[1])), (0, 0)}
        if gx > 0 and refg[gy, gx - 1] >= 0:
            cands.add((fp(mvg[gy, gx - 1, 0]), fp(mvg[gy, gx - 1, 1])))
        if gy > 0 and refg[gy - 1, gx] >= 0:
            cands.add((fp(mvg[gy - 1, gx, 0]), fp(mvg[gy - 1, gx, 1])))
        if gy > 0 and gx + 4 < w4 and refg[gy - 1, gx + 4] >= 0:
            cands.add((fp(mvg[gy - 1, gx + 4, 0]),
                       fp(mvg[gy - 1, gx + 4, 1])))
        if prev_mvg is not None:
            cands.add((fp(prev_mvg[gy, gx, 0]), fp(prev_mvg[gy, gx, 1])))
        seen = {}

        def cost_at(fx, fy):
            if (fx, fy) in seen:
                return seen[(fx, fy)]
            mvx, mvy = fx * 4, fy * 4
            c = me.sad16(x, y, fx, fy) + round(
                lam * (_se_bits(mvx - pred_mv[0])
                       + _se_bits(mvy - pred_mv[1])))
            seen[(fx, fy)] = c
            return c

        best = min(((cost_at(fx, fy), fx, fy) for fx, fy in cands))
        # early termination on a confident predictor hit (EPZS T2)
        if best[0] >= 2 * 256:
            for _ in range(2 * sr):          # small diamond walk
                _, bx, by = best
                step = [(1, 0), (-1, 0), (0, 1), (0, -1)]
                nxt = min(((cost_at(min(max(bx + dx, -sr), sr),
                                    min(max(by + dy, -sr), sr)),
                            min(max(bx + dx, -sr), sr),
                            min(max(by + dy, -sr), sr))
                           for dx, dy in step))
                if nxt[0] >= best[0]:
                    break
                best = nxt
        best = (best[0], best[1] * 4, best[2] * 4)
        return self._subpel_refine(orig, me, x, y, pred_mv, lam, best)

    # 16-point uneven multi-hexagon ring and the 6-point extended hexagon
    # of UMHexagonS (jm18.5/lencod/src/me_umhex.c, JVT-F017).
    _UMHEX_BIG = ((-4, 2), (-4, 1), (-4, 0), (-4, -1), (-4, -2),
                  (4, 2), (4, 1), (4, 0), (4, -1), (4, -2),
                  (-2, 3), (0, 4), (2, 3), (-2, -3), (0, -4), (2, -3))
    _UMHEX_HEX = ((-2, 0), (2, 0), (-1, 2), (1, 2), (-1, -2), (1, -2))

    # video_codecs_tpu/models/h264/inter_codec.py:458
    def _search_umhex(self, orig, me, x, y, pred_mv, lam,
                      mvg, refg, gx, gy, w4):
        """UMHexagonS integer search (jm18.5/lencod/src/me_umhex.c
        `UMHEXIntegerPelBlockMotionSearch` semantics): predictor start
        point (median/zero/left/up/up-right), early termination on a
        confident hit, then the four JVT-F017 stages — unsymmetrical
        cross (full-width horizontal, half-height vertical, step 2),
        5x5 small full search, uneven multi-hexagon-grid of 16-point
        rings at growing scale, and extended hexagon + small-diamond
        convergence.  Stream conformance does not depend on the search
        trajectory, only quality does."""
        sr = self.sr

        def fp(v):
            return min(max(int(round(v / 4.0)), -sr), sr)

        cands = {(fp(pred_mv[0]), fp(pred_mv[1])), (0, 0)}
        if gx > 0 and refg[gy, gx - 1] >= 0:
            cands.add((fp(mvg[gy, gx - 1, 0]), fp(mvg[gy, gx - 1, 1])))
        if gy > 0 and refg[gy - 1, gx] >= 0:
            cands.add((fp(mvg[gy - 1, gx, 0]), fp(mvg[gy - 1, gx, 1])))
        if gy > 0 and gx + 4 < w4 and refg[gy - 1, gx + 4] >= 0:
            cands.add((fp(mvg[gy - 1, gx + 4, 0]), fp(mvg[gy - 1, gx + 4, 1])))

        seen = {}

        def cost_at(fx, fy):
            fx = min(max(fx, -sr), sr)
            fy = min(max(fy, -sr), sr)
            if (fx, fy) in seen:
                return seen[(fx, fy)], fx, fy
            mvx, mvy = fx * 4, fy * 4
            c = me.sad16(x, y, fx, fy) + round(
                lam * (_se_bits(mvx - pred_mv[0])
                       + _se_bits(mvy - pred_mv[1])))
            seen[(fx, fy)] = c
            return c, fx, fy

        def scan(points, best):
            for px_, py_ in points:
                c = cost_at(px_, py_)
                if c[0] < best[0]:
                    best = c
            return best

        best = min(cost_at(fx, fy) for fx, fy in cands)
        # stage gates mirror me_umhex.c's block-type thresholds in spirit:
        # a start point already under ~1 grey level/pel skips the wide
        # stages and goes straight to hexagon convergence.
        if best[0] >= 256:
            bx, by = best[1], best[2]
            # 1. unsymmetrical cross
            cross = [(bx + dx, by) for dx in range(-sr, sr + 1, 2)]
            cross += [(bx, by + dy) for dy in range(-sr // 2, sr // 2 + 1, 2)]
            best = scan(cross, best)
            # 2. 5x5 small full search
            bx, by = best[1], best[2]
            best = scan([(bx + dx, by + dy)
                         for dy in range(-2, 3) for dx in range(-2, 3)], best)
            # 3. uneven multi-hexagon grid
            bx, by = best[1], best[2]
            for scale in range(1, max(sr // 4, 1) + 1):
                best = scan([(bx + dx * scale, by + dy * scale)
                             for dx, dy in self._UMHEX_BIG], best)
        # 4. extended hexagon-based search: hexagon until centered …
        for _ in range(2 * sr):
            bx, by = best[1], best[2]
            nxt = scan([(bx + dx, by + dy) for dx, dy in self._UMHEX_HEX],
                       best)
            if nxt[0] >= best[0]:
                break
            best = nxt
        # … then small diamond until centered
        for _ in range(2 * sr):
            bx, by = best[1], best[2]
            nxt = scan([(bx + 1, by), (bx - 1, by), (bx, by + 1),
                        (bx, by - 1)], best)
            if nxt[0] >= best[0]:
                break
            best = nxt
        best = (best[0], best[1] * 4, best[2] * 4)
        return self._subpel_refine(orig, me, x, y, pred_mv, lam, best)

    # video_codecs_tpu/models/h264/inter_codec.py:542
    def _write_p_mb_cabac(self, ce, mbx, mby, mb_type, parts, subs, cbp,
                          lv, c_dc_q, c_ac_q, skip_ctx_terms, n_active,
                          refg, mvd4, mb_t8=False, lv8=None):
        """CABAC syntax for one non-skip inter P MB (any partitioning).

        Parity: jm18.5/lencod/src/cabac.c writeMB_Pskip_flagInfo :424,
        writeMB_P_typeInfo :520, writeB8_typeInfo :584, writeRefPic
        :1016 (per-partition ctx), writeMVD :1152 (neighbor-partition
        |mvd| ctx at 4x4 granularity), writeCBP :1326, writeDquant
        :1116, residual blocks via entropy/h264_cabac.py.
        """
        from video_codecs_tpu_torch.entropy import h264_cabac as hc
        from video_codecs_tpu_torch.entropy import cavlc as _cavlc
        zz = _cavlc.ZIGZAG_4x4
        cbf = self._cbf
        gx, gy = mbx * 4, mby * 4
        a, b = skip_ctx_terms(mbx, mby)
        ce.mb_skip_flag_p(0, a, b)
        ce.mb_type_p({0: 1, 1: 2, 2: 3, 3: 4}[mb_type])
        if mb_type == 3:
            for s in subs:
                ce.sub_mb_type_p(s)
        if n_active > 1:
            ref_parts = (parts if mb_type != 3 else _b8_first_parts(parts))
            for (ox, oy, pw_, ph_, ri_, _, _) in ref_parts:
                # ctxIdxInc (spec 9.3.3.1.1.6): neighbor partitions with
                # ref > 0, at 4x4 granularity
                x4, y4 = gx + ox // 4, gy + oy // 4
                ra = 1 if (x4 > 0 and refg[y4, x4 - 1] > 0) else 0
                rb = 1 if (y4 > 0 and refg[y4 - 1, x4] > 0) else 0
                ce.ref_idx(ri_, ra + 2 * rb)
        for (ox, oy, pw_, ph_, ri_, mv_, pmv_) in parts:
            x4, y4 = gx + ox // 4, gy + oy // 4
            mvdx, mvdy = mv_[0] - pmv_[0], mv_[1] - pmv_[1]
            for comp, d in ((0, mvdx), (1, mvdy)):
                ea = int(mvd4[y4, x4 - 1, comp]) if x4 > 0 else 0
                eb = int(mvd4[y4 - 1, x4, comp]) if y4 > 0 else 0
                ce.mvd(d, comp, ea + eb)
            mvd4[y4:y4 + ph_ // 4, x4:x4 + pw_ // 4] = (abs(mvdx),
                                                        abs(mvdy))

        def nbr(dx, dy):
            nx, ny = mbx + dx, mby + dy
            if nx < 0 or ny < 0:
                return None
            return {"cbp": int(self._cbp_arr[ny, nx]), "ipcm": False}

        ce.cbp(cbp, nbr(0, -1), nbr(-1, 0))
        self._cbp_arr[mby, mbx] = cbp
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        from video_codecs_tpu_torch.models.h264.intra_codec import _BLK_X, _BLK_Y
        if self.transform8x8 and cbp_luma and \
                all(p_[2] >= 8 and p_[3] >= 8 for p_ in parts):
            ta = 1 if (mbx > 0 and self._trans8[mby, mbx - 1]) else 0
            tb = 1 if (mby > 0 and self._trans8[mby - 1, mbx]) else 0
            ce.transform_size_8x8_flag(1 if mb_t8 else 0, ta + tb)
        if cbp:
            ce.mb_qp_delta(0, False)
        cur_bits = 0
        if mb_t8:
            for b8 in range(4):
                if not (cbp_luma & (1 << b8)):
                    continue
                coeffs = [int(c) for c in
                          lv8[b8].reshape(64)[ht.ZIGZAG_8x8]]
                ce.residual_block(hc.LUMA_8x8, coeffs, 0, code_cbf=False)
                if any(coeffs):
                    for k in range(4):
                        idx = 4 * b8 + k
                        x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                        cur_bits |= 1 << (1 + 4 * y4 + x4)
                        cbf.set_bit(mbx, mby, 1 + 4 * y4 + x4)
        for i8 in range(4):
            if mb_t8:
                break
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

    # -- P frame -----------------------------------------------------------
    # video_codecs_tpu/models/h264/inter_codec.py:654
    def _encode_p_frame(self, y, u, v, refs, frame_num, poc=None,
                        reorder_cmds=None, mmco=None):
        qp = self.qp
        qpc = int(ht.CHROMA_QP[min(max(qp, 0), 51)])
        mbw, mbh = self.w // 16, self.h // 16
        w4 = mbw * 4
        yv, uv, vv = (p.astype(np.int32) for p in (y, u, v))
        n_active = len(refs)
        ref_y, ref_u, ref_v = refs[0]
        rec_y = np.zeros_like(yv)
        rec_u = np.zeros_like(uv)
        rec_v = np.zeros_like(vv)
        nc_y = NcGrid(mbw * 4, mbh * 4)
        nc_u = NcGrid(mbw * 2, mbh * 2)
        nc_v = NcGrid(mbw * 2, mbh * 2)
        self._mode4 = np.full((mbh * 4, mbw * 4), 2, np.int32)
        self._is_i4 = np.zeros((mbh, mbw), bool)
        self._trans8 = np.zeros((mbh, mbw), bool)
        nz8 = np.zeros((mbh * 4, mbw * 4), bool)
        mvg = np.zeros((mbh * 4, mbw * 4, 2), np.int32)
        refg = np.full((mbh * 4, mbw * 4), -1, np.int32)
        dec4 = np.zeros((mbh * 4, mbw * 4), bool)
        mvd4 = np.zeros((mbh * 4, mbw * 4, 2), np.int32)   # |mvd| per comp
        intra_mb = np.zeros((mbh, mbw), bool)
        lam = 0.85 * 2.0 ** ((qp - 12) / 3.0)
        lam_me = lam ** 0.5
        if self.att:
            self._eta = self._att_eta(y)
        zz = cavlc.ZIGZAG_4x4
        # the card stage: every reference's SAD surfaces and phase planes,
        # in the (reordered) list's order
        mes = self._card_stage(y, refs)

        w = BitWriter()
        w.ue(0)                  # first_mb_in_slice
        w.ue(5)                  # slice_type = P (all slices)
        w.ue(0)                  # pps_id
        w.write(frame_num & 0xFF, 8)
        if poc is not None:      # pic_order_cnt_lsb (poc_type 0 streams)
            w.write(poc & 0xFFFF, 16)
        if n_active > 1:
            w.flag(1)            # num_ref_idx_active_override_flag
            w.ue(n_active - 1)   # num_ref_idx_l0_active_minus1
        else:
            w.flag(0)            # num_ref_idx_active_override_flag
        if reorder_cmds:         # ref_pic_list_modification (7.3.3.1)
            w.flag(1)
            for op, arg in reorder_cmds:
                w.ue(op)
                w.ue(arg - 1 if op in (0, 1) else arg)
            w.ue(3)              # end of commands
        else:
            w.flag(0)            # ref_pic_list_modification_flag_l0
        self._wp = None
        if self.weighted_pred:
            self._wp = [estimate_wp((yv, uv, vv), refs[ri])
                        for ri in range(n_active)]
            write_pred_weight_table(w, self._wp, 6)
        if mmco:                 # dec_ref_pic_marking (7.3.3.3)
            w.flag(1)            # adaptive_ref_pic_marking_mode_flag
            for cmd in mmco:
                op = cmd[0]
                w.ue(op)
                if op in (1, 3):
                    w.ue(cmd[1] - 1)   # difference_of_pic_nums_minus1
                if op == 2:
                    w.ue(cmd[1])
                if op == 3:
                    w.ue(cmd[2])
                if op == 4:
                    w.ue(cmd[1])       # max_long_term_frame_idx_plus1
                if op == 6:
                    w.ue(cmd[1])       # long_term_frame_idx
            w.ue(0)              # op 0: end
        else:
            w.flag(0)            # adaptive_ref_pic_marking_mode_flag
        if self.entropy == "cabac":
            w.ue(0)              # cabac_init_idc
        w.se(qp - 26)            # slice_qp_delta
        w.ue(0)                  # disable_deblocking_filter_idc
        w.se(0)                  # slice_alpha_c0_offset_div2
        w.se(0)                  # slice_beta_offset_div2

        ce = None
        if self.entropy == "cabac":
            from video_codecs_tpu_torch.entropy import h264_cabac as hc
            ce = hc.H264CabacEncoder(w, "P", qp, model=0)
            from video_codecs_tpu_torch.utils import trace as _tr
            ce = _tr.wrap_syntax(ce, "write")
            from video_codecs_tpu_torch.utils import coding_stats as _cs
            ce = _cs.wrap_stats(ce)
            self._cbf = hc.CbfState(mbw, mbh)
            self._cbp_arr = np.zeros((mbh, mbw), np.int32)
            self._cipred = np.zeros((mbh, mbw), np.int32)
            self._skip = np.zeros((mbh, mbw), bool)
            self._decoded = np.zeros((mbh, mbw), bool)

        def skip_ctx_terms(mbx, mby):
            a = 1 if (mbx > 0 and not self._skip[mby, mbx - 1]) else 0
            b = 1 if (mby > 0 and not self._skip[mby - 1, mbx]) else 0
            return a, b

        refresh_set: set = set()
        if self.intra_refresh:
            nmb = mbw * mbh
            nref = min(self.intra_refresh, nmb)
            c0 = self._refresh_cursor
            refresh_set = {(c0 + i) % nmb for i in range(nref)}
            self._refresh_cursor = (c0 + nref) % nmb

        skip_run = 0
        for mby in range(mbh):
            for mbx in range(mbw):
                x, yy = mbx * 16, mby * 16
                cx, cy = mbx * 8, mby * 8
                gx, gy = mbx * 4, mby * 4
                orig = yv[yy:yy + 16, x:x + 16]
                last_mb = (mby == mbh - 1 and mbx == mbw - 1)

                lam_me_mb = lam_me if self._eta is None else \
                    (lam * float(self._eta[mby, mbx])) ** 0.5
                smv = skip_mv(mvg, refg, gx, gy, w4)
                best_ref, cost, mvx, mvy, pmv = 0, None, 0, 0, (0, 0)
                for ri in range(n_active):
                    pmv_r = median_mv_pred(mvg, refg, gx, gy, w4, ref=ri)
                    if self.me == "epzs":
                        c_r, mx_r, my_r = self._search_epzs(
                            orig, mes[ri], x, yy, pmv_r, lam_me_mb,
                            mvg, refg, gx, gy, w4,
                            self._prev_mvg if ri == 0 else None)
                    elif self.me == "umhex":
                        c_r, mx_r, my_r = self._search_umhex(
                            orig, mes[ri], x, yy, pmv_r, lam_me_mb,
                            mvg, refg, gx, gy, w4)
                    else:
                        c_r, mx_r, my_r = self._search(
                            orig, mes[ri], x, yy, pmv_r, lam_me_mb)
                    if n_active > 1:
                        c_r += round(lam_me_mb
                                     * _te_bits(ri, n_active - 1))
                    if cost is None or c_r < cost:
                        best_ref, cost, mvx, mvy, pmv = \
                            ri, c_r, mx_r, my_r, pmv_r

                # ---- partition mode loops (md_low.c:38 semantics) ----
                # candidate: (cost, mb_type, parts, subs); parts carry
                # (off_x, off_y, w, h, ref, mv, pmv) in decode order
                best_mode = (cost + round(lam_me_mb * 1), 0,
                             [(0, 0, 16, 16, best_ref, (mvx, mvy), pmv)],
                             None)

                def me_part(tmp, og, px_, py_, pw_, ph_, ri, shape):
                    pmv_r = mv_pred_part(tmp[0], tmp[1], tmp[2],
                                         px_ // 4, py_ // 4, pw_ // 4,
                                         ph_ // 4, ri, shape)
                    c, mx, my = self._search(og, mes[ri], px_, py_,
                                             pmv_r, lam_me_mb, pw_, ph_)
                    return c, (mx, my), pmv_r

                def eval_rect(mbt):
                    geo = _P_PARTS[mbt]
                    base = "16x8" if mbt == 1 else "8x16"
                    tmp = (mvg.copy(), refg.copy(), dec4.copy())
                    tot = round(lam_me_mb * 3)      # ue(mb_type)
                    parts = []
                    for pi, (ox, oy, pw_, ph_) in enumerate(geo):
                        og = yv[yy + oy:yy + oy + ph_, x + ox:x + ox + pw_]
                        bp = None
                        for ri in range(n_active):
                            c, mv_, pmv_r = me_part(
                                tmp, og, x + ox, yy + oy, pw_, ph_, ri,
                                f"{base}_{pi}")
                            if n_active > 1:
                                c += round(lam_me_mb
                                           * _te_bits(ri, n_active - 1))
                            if bp is None or c < bp[0]:
                                bp = (c, ri, mv_, pmv_r)
                        c, ri, mv_, pmv_r = bp
                        _commit_part(tmp[0], tmp[1], tmp[2], gx, gy, ox,
                                     oy, pw_, ph_, ri, mv_)
                        parts.append((ox, oy, pw_, ph_, ri, mv_, pmv_r))
                        tot += c
                    return tot, parts

                def eval_p8x8():
                    tmp = (mvg.copy(), refg.copy(), dec4.copy())
                    tot = round(lam_me_mb * 5)      # ue(3)
                    parts, subs = [], []
                    for b8 in range(4):
                        ox8, oy8 = (b8 & 1) * 8, (b8 >> 1) * 8
                        og8 = yv[yy + oy8:yy + oy8 + 8,
                                 x + ox8:x + ox8 + 8]
                        b8_ref = None
                        for ri in range(n_active):
                            c, mv_, pmv_r = me_part(
                                tmp, og8, x + ox8, yy + oy8, 8, 8, ri, "")
                            if n_active > 1:
                                c += round(lam_me_mb
                                           * _te_bits(ri, n_active - 1))
                            if b8_ref is None or c < b8_ref[0]:
                                b8_ref = (c, ri)
                        ri = b8_ref[1]
                        bs_ = None
                        for smode, sgeo in _SUB_PARTS.items():
                            t2 = (tmp[0].copy(), tmp[1].copy(),
                                  tmp[2].copy())
                            ct = round(lam_me_mb * _ue_bits(smode))
                            sp = []
                            for (sx, sy, pw_, ph_) in sgeo:
                                ox, oy = ox8 + sx, oy8 + sy
                                og = yv[yy + oy:yy + oy + ph_,
                                        x + ox:x + ox + pw_]
                                c, mv_, pmv_r = me_part(
                                    t2, og, x + ox, yy + oy, pw_, ph_,
                                    ri, "")
                                _commit_part(t2[0], t2[1], t2[2], gx, gy,
                                             ox, oy, pw_, ph_, ri, mv_)
                                sp.append((ox, oy, pw_, ph_, ri, mv_,
                                           pmv_r))
                                ct += c
                            if bs_ is None or ct < bs_[0]:
                                bs_ = (ct, smode, sp)
                        ct, smode, sp = bs_
                        for (ox, oy, pw_, ph_, ri_, mv_, _) in sp:
                            _commit_part(tmp[0], tmp[1], tmp[2], gx, gy,
                                         ox, oy, pw_, ph_, ri_, mv_)
                        parts.extend(sp)
                        subs.append(smode)
                        tot += ct + (round(lam_me_mb
                                           * _te_bits(ri, n_active - 1))
                                     if n_active > 1 else 0)
                    return tot, parts, subs

                if self.partitions:
                    for mbt in (1, 2):
                        c_m, parts_m = eval_rect(mbt)
                        if c_m < best_mode[0]:
                            best_mode = (c_m, mbt, parts_m, None)
                    c_m, parts_m, subs_m = eval_p8x8()
                    if c_m < best_mode[0]:
                        best_mode = (c_m, 3, parts_m, subs_m)

                # crude intra/inter decision: best I_16x16 pred SAD
                isad = min(
                    int(np.abs(orig - pred_luma16(rec_y, x, yy, m)).sum())
                    for m in ([2] + ([0] if mby else [])
                              + ([1] if mbx else [])))
                if (mby * mbw + mbx) in refresh_set or \
                        isad + round(lam_me_mb * 8) < best_mode[0]:
                    # intra MB inside the P slice (mode choice or forced
                    # by the cyclic intra-refresh map, intrarefresh.c)
                    if ce is not None:
                        a, b = skip_ctx_terms(mbx, mby)
                        ce.mb_skip_flag_p(0, a, b)
                        self._encode_mb(w, yv, uv, vv, rec_y, rec_u, rec_v,
                                        nc_y, nc_u, nc_v, mbx, mby, qp, qpc,
                                        ce=ce, p_slice=True)
                        ce.final(1 if last_mb else 0)
                    else:
                        w.ue(skip_run)
                        skip_run = 0
                        self._encode_mb(w, yv, uv, vv, rec_y, rec_u, rec_v,
                                        nc_y, nc_u, nc_v, mbx, mby, qp, qpc,
                                        mb_type_offset=5)
                    intra_mb[mby, mbx] = True
                    dec4[gy:gy + 4, gx:gx + 4] = True
                    # refg stays -1, mv stays 0
                    continue

                _, mb_type_sel, parts, subs = best_mode
                best_ref = parts[0][4]
                mvx, mvy = parts[0][5]
                pred = np.zeros((16, 16), np.int32)
                pu = np.zeros((8, 8), np.int32)
                pv = np.zeros((8, 8), np.int32)
                for (ox, oy, pw_, ph_, ri_, mv_, _) in parts:
                    rpy, rpu, rpv = refs[ri_]
                    pl = mc_luma_np(rpy, x + ox, yy + oy, mv_[0], mv_[1],
                                    pw_, ph_)
                    pcu = mc_chroma_np(rpu, cx + ox // 2, cy + oy // 2,
                                       mv_[0], mv_[1], pw_ // 2, ph_ // 2)
                    pcv = mc_chroma_np(rpv, cx + ox // 2, cy + oy // 2,
                                       mv_[0], mv_[1], pw_ // 2, ph_ // 2)
                    if self._wp is not None:
                        wp = self._wp[ri_]
                        pl = wp_apply(pl, wp["w"][0], wp["o"][0],
                                      wp["logd"])
                        pcu = wp_apply(pcu, wp["w"][1], wp["o"][1],
                                       wp["logd"])
                        pcv = wp_apply(pcv, wp["w"][2], wp["o"][2],
                                       wp["logd"])
                    pred[oy:oy + ph_, ox:ox + pw_] = pl
                    pu[oy // 2:(oy + ph_) // 2, ox // 2:(ox + pw_) // 2] \
                        = pcu
                    pv[oy // 2:(oy + ph_) // 2, ox // 2:(ox + pw_) // 2] \
                        = pcv

                res = orig - pred
                blk = res.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)
                lv = self._quant_ac(ht.forward4x4(blk), qp, intra=False)
                # ---- 4x4 vs 8x8 transform decision (High profile) ----
                mb_t8 = False
                lv8 = None
                if self.transform8x8 and \
                        all(p_[2] >= 8 and p_[3] >= 8 for p_ in parts):
                    lv8 = [ht.quant8x8(ht.forward8x8(
                        res[(b >> 1) * 8:(b >> 1) * 8 + 8,
                            (b & 1) * 8:(b & 1) * 8 + 8]), qp, intra=False)
                        for b in range(4)]
                    r4 = ht.inverse4x4(ht.dequant_ac(lv, qp)) \
                        .transpose(0, 2, 1, 3).reshape(16, 16)
                    r8 = np.zeros((16, 16), np.int64)
                    for b in range(4):
                        ox8, oy8 = (b & 1) * 8, (b >> 1) * 8
                        r8[oy8:oy8 + 8, ox8:ox8 + 8] = ht.inverse8x8(
                            ht.dequant8x8(lv8[b], qp))
                    lam_mb = lam if self._eta is None else \
                        lam * float(self._eta[mby, mbx])
                    c4 = int(np.abs(res - r4).sum()) + \
                        round(lam_mb * 3 * int((lv != 0).sum()))
                    c8 = int(np.abs(res - r8).sum()) + \
                        round(lam_mb * 3 * int(sum((q != 0).sum()
                                                   for q in lv8)))
                    mb_t8 = c8 < c4 and any(q.any() for q in lv8)
                cbp_luma = 0
                if mb_t8:
                    for b in range(4):
                        if lv8[b].any():
                            cbp_luma |= 1 << b
                else:
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
                    c_dc_q.append(ht.quant_chroma_dc(ht.hadamard2x2(cdc), qpc))
                    acq = ht.quant_ac(cwt, qpc)
                    acq[:, :, 0, 0] = 0
                    c_ac_q.append(acq)
                cbp_chroma = 2 if any(q.any() for q in c_ac_q) else (
                    1 if any(q.any() for q in c_dc_q) else 0)
                cbp = cbp_luma | (cbp_chroma << 4)

                for (ox, oy, pw_, ph_, ri_, mv_, _) in parts:
                    _commit_part(mvg, refg, dec4, gx, gy, ox, oy, pw_,
                                 ph_, ri_, mv_)

                if mb_type_sel == 0 and cbp == 0 and best_ref == 0 and \
                        (mvx, mvy) == smv:
                    # P_Skip: recon is the prediction, nothing coded
                    if ce is not None:
                        a, b = skip_ctx_terms(mbx, mby)
                        ce.mb_skip_flag_p(1, a, b)
                        self._skip[mby, mbx] = True
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
                    for comp in (nc_u, nc_v):
                        for bx2 in range(2):
                            for by2 in range(2):
                                comp.set(mbx * 2 + bx2, mby * 2 + by2, 0)
                    continue

                if mb_t8:
                    self._trans8[mby, mbx] = True
                    for b in range(4):
                        if lv8[b].any():
                            bx4, by4 = (b & 1) * 2, (b >> 1) * 2
                            nz8[gy + by4:gy + by4 + 2,
                                gx + bx4:gx + bx4 + 2] = True
                if ce is not None:
                    self._write_p_mb_cabac(ce, mbx, mby, mb_type_sel,
                                           parts, subs, cbp, lv, c_dc_q,
                                           c_ac_q, skip_ctx_terms,
                                           n_active, refg, mvd4,
                                           mb_t8=mb_t8, lv8=lv8)
                    for i8 in range(4):
                        for k in range(4):
                            idx = 4 * i8 + k
                            nc_y.set(gx + _BLK_X[idx], gy + _BLK_Y[idx],
                                     0 if mb_t8 else
                                     int((lv[_BLK_Y[idx],
                                             _BLK_X[idx]] != 0).sum())
                                     if cbp_luma & (1 << i8) else 0)
                    for comp, grid in ((0, nc_u), (1, nc_v)):
                        for idx in range(4):
                            x4, y4 = idx & 1, idx >> 1
                            n = (int((c_ac_q[comp][y4, x4] != 0).sum())
                                 if cbp_chroma == 2 else 0)
                            grid.set(mbx * 2 + x4, mby * 2 + y4, n)
                    ce.final(1 if last_mb else 0)
                else:
                    w.ue(skip_run)
                    skip_run = 0
                    w.ue(mb_type_sel)            # mb_type
                    if mb_type_sel == 3:
                        for s in subs:           # sub_mb_type (7.3.5.2)
                            w.ue(s)
                    if n_active > 1:
                        ref_parts = (parts if mb_type_sel != 3 else
                                     _b8_first_parts(parts))
                        for p_ in ref_parts:
                            _te_write(w, p_[4], n_active - 1)
                    for (_, _, _, _, _, mv_, pmv_) in parts:
                        w.se(mv_[0] - pmv_[0])   # mvd_l0 x
                        w.se(mv_[1] - pmv_[1])   # mvd_l0 y
                    w.ue(_NCBP_INTER_420[cbp])   # coded_block_pattern me(v)
                    if self.transform8x8 and cbp_luma and \
                            all(p_[2] >= 8 and p_[3] >= 8 for p_ in parts):
                        w.flag(1 if mb_t8 else 0)  # transform_size_8x8
                    if cbp:
                        w.se(0)                  # mb_qp_delta
                    # luma residual: 16-coeff blocks per coded 8x8 group
                    for i8 in range(4):
                        if mb_t8:
                            lv64 = lv8[i8].reshape(64)[ht.ZIGZAG_8x8]
                            for k in range(4):
                                idx = 4 * i8 + k
                                x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                                if cbp_luma & (1 << i8):
                                    coeffs = lv64[4 * np.arange(16) + k]
                                    total = cavlc.encode_block(
                                        w, [int(cc) for cc in coeffs],
                                        nc_y.nc(gx + x4, gy + y4), 16)
                                else:
                                    total = 0
                                nc_y.set(gx + x4, gy + y4, total)
                            continue
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

                # recon
                if mb_t8:
                    res8 = np.zeros((16, 16), np.int64)
                    for b in range(4):
                        if not (cbp_luma & (1 << b)):
                            continue
                        ox8, oy8 = (b & 1) * 8, (b >> 1) * 8
                        res8[oy8:oy8 + 8, ox8:ox8 + 8] = ht.inverse8x8(
                            ht.dequant8x8(lv8[b], qp))
                    rec_y[yy:yy + 16, x:x + 16] = np.clip(pred + res8,
                                                          0, 255)
                else:
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
                    crec = np.clip(cp + ht.inverse4x4(cd)
                                   .transpose(0, 2, 1, 3).reshape(8, 8),
                                   0, 255)
                    plane[cy:cy + 8, cx:cx + 8] = crec

        if ce is not None:
            ce.finish()
        else:
            if skip_run:
                w.ue(skip_run)
            w.rbsp_trailing_bits()

        bs_ver, bs_hor = bs_maps_p(intra_mb,
                                   nc_y.tc + nz8.astype(np.int32),
                                   mvg, refg)
        rec_y, rec_u, rec_v = deblock_frame(
            rec_y, rec_u, rec_v, qp, qpc, bs_ver, bs_hor,
            trans8=self._trans8 if self._trans8.any() else None)
        self._prev_mvg = mvg.copy()    # EPZS temporal predictors
        self._prev_refg = refg.copy()  # colocated motion for B direct
        return w.data(), (rec_y, rec_u, rec_v)


# video_codecs_tpu/models/h264/inter_codec.py:1173
class H264Decoder(H264IntraDecoder):
    """Decodes IDR + P (IPPP) baseline CAVLC streams."""

    # video_codecs_tpu/models/h264/inter_codec.py:1176
    def __init__(self, conceal: int = 0) -> None:
        """conceal: 0 = off (errors raise), 1 = frame copy, 2 = motion
        copy (jm18.5/ldecod ConcealMode semantics / erc_do_p.c)."""
        super().__init__()
        self.dpb = []            # list0: most recently decoded first
        self.max_refs = 1
        self.conceal = conceal
        self.concealed: list[int] = []
        self._last_mv = None     # (mvg, refg) of the last decoded P slice
        self._next_fn = 0

    # video_codecs_tpu/models/h264/inter_codec.py:1187
    def _conceal_frame(self):
        """Synthesize a lost picture from dpb[0]: frame copy, or motion
        copy reusing the previous picture's MV field (erc_do_p.c)."""
        ref = self.dpb[0]
        if self.conceal != 2 or self._last_mv is None:
            return tuple(p.copy() for p in ref)
        mvg, refg = self._last_mv
        mbw, mbh = self.size
        rec_y = np.zeros((mbh * 16, mbw * 16), np.int32)
        rec_u = np.zeros((mbh * 8, mbw * 8), np.int32)
        rec_v = np.zeros_like(rec_u)
        for mby in range(mbh):
            for mbx in range(mbw):
                gx, gy = mbx * 4, mby * 4
                mvx = mvy = 0
                if refg[gy, gx] >= 0:
                    mvx, mvy = int(mvg[gy, gx, 0]), int(mvg[gy, gx, 1])
                x, yy = mbx * 16, mby * 16
                cx, cy = mbx * 8, mby * 8
                rec_y[yy:yy + 16, x:x + 16] = mc_luma_np(
                    ref[0], x, yy, mvx, mvy, 16, 16)
                rec_u[cy:cy + 8, cx:cx + 8] = mc_chroma_np(
                    ref[1], cx, cy, mvx, mvy, 8, 8)
                rec_v[cy:cy + 8, cx:cx + 8] = mc_chroma_np(
                    ref[2], cx, cy, mvx, mvy, 8, 8)
        return rec_y, rec_u, rec_v

    # video_codecs_tpu/models/h264/inter_codec.py:1214
    def _push(self, rec, frames, fn=None, lt=False, mmco=None,
              is_ref=True):
        frames.append(rec)
        if getattr(self, "_ext_dpb", False) or not hasattr(self, "_dpbm"):
            self.dpb.insert(0, rec)
            del self.dpb[self.max_refs:]
            return
        from video_codecs_tpu_torch.models.h264 import dpb as dpb_mod
        if fn is None:
            fn = self._next_fn
        if is_ref:
            self._dpbm.mark(dpb_mod.RefPic(
                rec, frame_num=fn, lt_idx=0 if lt else None), mmco)
        # mirror for concealment + default skip reference
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
        from video_codecs_tpu_torch.entropy.bitstream import split_annexb
        frames = []
        for nal in split_annexb(stream):
            nal_type = nal[0] & 0x1F
            rbsp = strip_emulation_prevention(nal[1:])
            if nal_type == NAL_SPS:
                wmb, hmb, info = parse_sps(rbsp, full=True)
                self.size = (wmb, hmb)
                self.sps_info = info
                self.max_refs = max(info["num_ref_frames"], 1)
                from video_codecs_tpu_torch.models.h264 import dpb as dpbm
                self._dpbm = dpbm.Dpb(self.max_refs,
                                      info["log2_max_frame_num"])
            elif nal_type == NAL_PPS:
                self.dbf_present, self.cabac, ppsinfo = \
                    parse_pps(rbsp, full=True)
                self.default_l0 = ppsinfo["num_ref_idx_l0_default_active"]
                self.wp_enabled = ppsinfo.get("weighted_pred", False)
                self.trans8_enabled = ppsinfo.get("transform_8x8_mode",
                                                  False)
            elif nal_type in (NAL_SLICE_IDR, 1):
                self._cur_ref_idc = nal[0] >> 5
                if nal_type == NAL_SLICE_IDR:
                    self.dpb = []        # IDR: sliding window resets
                    if hasattr(self, "_dpbm"):
                        self._dpbm.idr_reset()
                elif self.conceal and self.dpb:
                    # frame_num gap = lost picture(s): synthesize them
                    r0 = BitReader(rbsp)
                    r0.ue(), r0.ue(), r0.ue()
                    fn = r0.read(8)
                    gap = (fn - self._next_fn) & 0xFF
                    for _ in range(min(gap, 16)):
                        self.concealed.append(len(frames))
                        self._push(self._conceal_frame(), frames)
                        self._next_fn = (self._next_fn + 1) & 0xFF
                if self.conceal and self.dpb:
                    try:
                        rec = self._decode_any_slice(
                            rbsp, nal_type == NAL_SLICE_IDR)
                    except Exception:
                        self.concealed.append(len(frames))
                        rec = self._conceal_frame()
                else:
                    rec = self._decode_any_slice(
                        rbsp, nal_type == NAL_SLICE_IDR)
                if nal_type == NAL_SLICE_IDR:
                    self._push(rec, frames, fn=0,
                               lt=self._idr_lt_flag(rbsp))
                else:
                    self._push(rec, frames,
                               fn=getattr(self, "_cur_fn", None),
                               mmco=getattr(self, "_cur_mmco", None),
                               is_ref=getattr(self, "_cur_ref_idc", 1) != 0)
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
        ext = getattr(self, "_ext_dpb", False) or \
            not hasattr(self, "_dpbm")
        # ref_pic_list_modification (spec 7.3.3.1 / 8.2.4.3)
        cmds = []
        if r.flag():
            while True:
                op = r.ue()         # reordering_of_pic_nums_idc
                if op == 3:
                    break
                cmds.append((op, r.ue() + 1) if op in (0, 1)
                            else (op, r.ue()))
        if not ext:
            list0 = self._dpbm.default_list0(fn)
            if cmds:
                list0 = self._dpbm.apply_reorder(list0, cmds, fn, n_active)
            else:
                list0 = list0[:max(n_active, 1)]
            self.dpb = [p.planes for p in list0]
        else:
            assert not cmds, "external DPB: list reordering unsupported"
        assert n_active <= len(self.dpb), "ref list underrun"
        self._wp = None
        if getattr(self, "wp_enabled", False):
            self._wp = parse_pred_weight_table(r, n_active)
        # dec_ref_pic_marking (spec 7.3.3.3 / 8.2.5.4)
        self._cur_mmco = None
        if getattr(self, "_cur_ref_idc", 1):
            if r.flag():            # adaptive_ref_pic_marking_mode_flag
                assert not ext, "external DPB: MMCO unsupported"
                mmco = []
                while True:
                    op = r.ue()     # memory_management_control_operation
                    if op == 0:
                        break
                    args = []
                    if op in (1, 3):
                        args.append(r.ue() + 1)
                    if op == 2:
                        args.append(r.ue())
                    if op in (3, 6):
                        args.append(r.ue())
                    if op == 4:
                        args.append(r.ue())
                    mmco.append((op, *args))
                self._cur_mmco = mmco
        cabac = getattr(self, "cabac", False)
        model = r.ue() if cabac else 0  # cabac_init_idc
        qp = 26 + r.se()
        dbf_idc, aoff, boff = 0, 0, 0
        if self.dbf_present:
            dbf_idc = r.ue()
            if dbf_idc != 1:
                aoff = 2 * r.se()
                boff = 2 * r.se()
        qpc = int(ht.CHROMA_QP[min(max(qp, 0), 51)])
        ref_y, ref_u, ref_v = self.dpb[0]

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
        trans8 = np.zeros((mbh, mbw), bool)     # 8x8-transform MBs
        nz8 = np.zeros((mbh * 4, mbw * 4), bool)  # their coded-8x8 marks
        t8_on = getattr(self, "trans8_enabled", False)
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
            rec_y[yy:yy + 16, x:x + 16] = self._mc_wp(
                mc_luma_np(skip_ref[0], x, yy, mvx, mvy, 16, 16), 0, 0)
            rec_u[cy:cy + 8, cx:cx + 8] = self._mc_wp(
                mc_chroma_np(skip_ref[1], cx, cy, mvx, mvy, 8, 8), 0, 1)
            rec_v[cy:cy + 8, cx:cx + 8] = self._mc_wp(
                mc_chroma_np(skip_ref[2], cx, cy, mvx, mvy, 8, 8), 0, 2)
            for bx4 in range(4):
                for by4 in range(4):
                    nc_y.set(gx + bx4, gy + by4, 0)
            for grid in (nc_u, nc_v):
                for bx2 in range(2):
                    for by2 in range(2):
                        grid.set(mbx * 2 + bx2, mby * 2 + by2, 0)

        if cabac:
            self._decode_p_mbs_cabac(
                r, qp, qpc, model, rec_y, rec_u, rec_v, ref_y, ref_u, ref_v,
                nc_y, nc_u, nc_v, mvg, refg, intra_mb, mode4, is_i4,
                pred_mode4, decode_skip, n_active=n_active, dec4=dec4,
                trans8=trans8, nz8=nz8)
            if dbf_idc != 1:
                bs_ver, bs_hor = bs_maps_p(intra_mb,
                                           nc_y.tc + nz8.astype(np.int32),
                                           mvg, refg)
                rec_y, rec_u, rec_v = deblock_frame(
                    rec_y, rec_u, rec_v, qp, qpc, bs_ver, bs_hor, aoff, boff,
                    trans8=trans8 if trans8.any() else None)
            self._last_mv = (mvg.copy(), refg.copy())
            return rec_y, rec_u, rec_v

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
                    if t8_on and r.flag():   # transform_size_8x8_flag
                        trans8[mby, mbx] = True
                        self._decode_i8_mb(r, rec_y, rec_u, rec_v,
                                           nc_y, nc_u, nc_v, mbx, mby,
                                           qp, qpc, mode4, is_i4,
                                           pred_mode4)
                    else:
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
                pred[oy:oy + ph_, ox:ox + pw_] = self._mc_wp(
                    mc_luma_np(rpy, x + ox, yy + oy, mvx, mvy, pw_, ph_),
                    ri_, 0)
                pu[oy // 2:(oy + ph_) // 2, ox // 2:(ox + pw_) // 2] = \
                    self._mc_wp(mc_chroma_np(
                        rpu, cx + ox // 2, cy + oy // 2, mvx, mvy,
                        pw_ // 2, ph_ // 2), ri_, 1)
                pv[oy // 2:(oy + ph_) // 2, ox // 2:(ox + pw_) // 2] = \
                    self._mc_wp(mc_chroma_np(
                        rpv, cx + ox // 2, cy + oy // 2, mvx, mvy,
                        pw_ // 2, ph_ // 2), ri_, 2)
            cbp = _CBP_FROM_CODE_INTER_420[r.ue()]
            cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
            mb_t8 = False
            if t8_on and cbp_luma and \
                    all(p[2] >= 8 and p[3] >= 8 for p in parts):
                mb_t8 = bool(r.flag())   # transform_size_8x8_flag
                trans8[mby, mbx] = mb_t8
            if cbp:
                assert r.se() == 0      # mb_qp_delta
            lv = np.zeros((4, 4, 4, 4), np.int64)
            lv8 = [np.zeros((8, 8), np.int64) for _ in range(4)]
            for i8 in range(4):
                if mb_t8:
                    lv64 = np.zeros(64, np.int64)
                    for k in range(4):
                        idx = 4 * i8 + k
                        x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                        if cbp_luma & (1 << i8):
                            coeffs = cavlc.decode_block(
                                r, nc_y.nc(gx + x4, gy + y4), 16)
                            lv64[4 * np.arange(16) + k] = coeffs
                            nc_y.set(gx + x4, gy + y4,
                                     sum(1 for c in coeffs if c))
                        else:
                            nc_y.set(gx + x4, gy + y4, 0)
                    flat = np.zeros(64, np.int64)
                    flat[ht.ZIGZAG_8x8] = lv64
                    lv8[i8] = flat.reshape(8, 8)
                    if lv64.any():
                        x4, y4 = (i8 & 1) * 2, (i8 >> 1) * 2
                        nz8[gy + y4:gy + y4 + 2, gx + x4:gx + x4 + 2] = True
                    continue
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

            if mb_t8:
                res = np.zeros((16, 16), np.int64)
                for i8 in range(4):
                    ox, oy = (i8 & 1) * 8, (i8 >> 1) * 8
                    res[oy:oy + 8, ox:ox + 8] = ht.inverse8x8(
                        ht.dequant8x8(lv8[i8], qp))
                rec_y[yy:yy + 16, x:x + 16] = np.clip(pred + res, 0, 255)
            else:
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
            bs_ver, bs_hor = bs_maps_p(intra_mb,
                                       nc_y.tc + nz8.astype(np.int32),
                                       mvg, refg)
            rec_y, rec_u, rec_v = deblock_frame(rec_y, rec_u, rec_v, qp, qpc,
                                                bs_ver, bs_hor, aoff, boff,
                                                trans8=trans8
                                                if trans8.any() else None)
        self._last_mv = (mvg.copy(), refg.copy())
        return rec_y, rec_u, rec_v

    # video_codecs_tpu/models/h264/inter_codec.py:1615
    def _mc_wp(self, pred, ref_idx: int, comp: int):
        """Apply the slice's explicit WP to an interpolated block."""
        wp = getattr(self, "_wp", None)
        if wp is None:
            return pred
        e = wp[ref_idx]
        logd = e["logd"] if comp == 0 else e["logdc"]
        return wp_apply(pred, e["w"][comp], e["o"][comp], logd)

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

    # video_codecs_tpu/models/h264/inter_codec.py:1668
    def _decode_p_mbs_cabac(self, r, qp, qpc, model, rec_y, rec_u, rec_v,
                            ref_y, ref_u, ref_v, nc_y, nc_u, nc_v, mvg,
                            refg, intra_mb, mode4, is_i4, pred_mode4,
                            decode_skip, n_active=1, dec4=None,
                            trans8=None, nz8=None):
        """CABAC P-slice MB loop (mirror of the encoder's CABAC path)."""
        from video_codecs_tpu_torch.entropy import h264_cabac as hc
        mbw, mbh = self.size
        w4 = mbw * 4
        zz = cavlc.ZIGZAG_4x4
        cd = hc.H264CabacDecoder(r, "P", qp, model)
        from video_codecs_tpu_torch.utils import trace as _tr
        cd = _tr.wrap_syntax(cd, "read")
        from video_codecs_tpu_torch.utils import coding_stats as _cs
        cd = _cs.wrap_stats(cd)
        cbf = hc.CbfState(mbw, mbh)
        cbp_arr = np.zeros((mbh, mbw), np.int32)
        cipred = np.zeros((mbh, mbw), np.int32)
        skip = np.zeros((mbh, mbw), bool)
        mvd4 = np.zeros((mbh * 4, mbw * 4, 2), np.int32)
        i16 = np.zeros((mbh, mbw), bool)
        if dec4 is None:
            dec4 = np.zeros((mbh * 4, mbw * 4), bool)

        def mvd_err4(x4, y4, comp):
            a = int(mvd4[y4, x4 - 1, comp]) if x4 > 0 else 0
            b = int(mvd4[y4 - 1, x4, comp]) if y4 > 0 else 0
            return a + b

        for mby in range(mbh):
            for mbx in range(mbw):
                x, yy = mbx * 16, mby * 16
                cx, cy = mbx * 8, mby * 8
                gx, gy = mbx * 4, mby * 4
                last_mb = (mby == mbh - 1 and mbx == mbw - 1)
                a = 1 if (mbx > 0 and not skip[mby, mbx - 1]) else 0
                b = 1 if (mby > 0 and not skip[mby - 1, mbx]) else 0
                if cd.mb_skip_flag_p(a, b):
                    skip[mby, mbx] = True
                    decode_skip(mbx, mby)
                    cbf.mark(mbx, mby)
                    assert cd.final() == (1 if last_mb else 0)
                    continue
                act, i16_sym = cd.mb_type_p()
                if act in (6, 7):
                    # intra MB in P slice
                    intra_mb[mby, mbx] = True
                    dec4[gy:gy + 4, gx:gx + 4] = True
                    self._decode_intra_mb_cabac(
                        cd, act, i16_sym, mbx, mby, qp, qpc, rec_y, rec_u,
                        rec_v, cbf, cbp_arr, cipred, mode4, is_i4,
                        pred_mode4, i16, trans8=trans8)
                    assert cd.final() == (1 if last_mb else 0)
                    continue
                assert act in (1, 2, 3, 4), f"P mb_type act {act}"
                # geometry + sub types (read order per spec 7.3.5.2)
                if act == 1:
                    geo = [(0, 0, 16, 16)]
                    shapes = [""]
                elif act == 2:
                    geo = list(_P_PARTS[1])
                    shapes = ["16x8_0", "16x8_1"]
                elif act == 3:
                    geo = list(_P_PARTS[2])
                    shapes = ["8x16_0", "8x16_1"]
                else:
                    subs = [cd.sub_mb_type_p() for _ in range(4)]
                    geo, shapes = [], []
                    for b8 in range(4):
                        ox8, oy8 = (b8 & 1) * 8, (b8 >> 1) * 8
                        for (sx, sy, pw_, ph_) in _SUB_PARTS[subs[b8]]:
                            geo.append((ox8 + sx, oy8 + sy, pw_, ph_))
                            shapes.append("")
                # ref indices: per partition (per 8x8 block for P_8x8)
                refs_i = []
                if act == 4:
                    b8refs = []
                    for b8 in range(4):
                        ri = 0
                        if n_active > 1:
                            x4 = gx + ((b8 & 1) * 8) // 4
                            y4 = gy + ((b8 >> 1) * 8) // 4
                            ra = 1 if (x4 > 0 and refg[y4, x4 - 1] > 0) \
                                else 0
                            rb = 1 if (y4 > 0 and refg[y4 - 1, x4] > 0) \
                                else 0
                            ri = cd.ref_idx(ra + 2 * rb)
                        b8refs.append(ri)
                        # visible to the next 8x8's ref ctx (JM stores
                        # refs immediately)
                        refg[gy + ((b8 >> 1) * 8) // 4:
                             gy + ((b8 >> 1) * 8) // 4 + 2,
                             gx + ((b8 & 1) * 8) // 4:
                             gx + ((b8 & 1) * 8) // 4 + 2] = ri
                    for (ox, oy, _, _) in geo:
                        refs_i.append(b8refs[(oy // 8) * 2 + ox // 8])
                else:
                    for (ox, oy, pw_, ph_) in geo:
                        ri = 0
                        if n_active > 1:
                            x4, y4 = gx + ox // 4, gy + oy // 4
                            ra = 1 if (x4 > 0 and refg[y4, x4 - 1] > 0) \
                                else 0
                            rb = 1 if (y4 > 0 and refg[y4 - 1, x4] > 0) \
                                else 0
                            ri = cd.ref_idx(ra + 2 * rb)
                        refs_i.append(ri)
                        refg[gy + oy // 4:gy + (oy + ph_) // 4,
                             gx + ox // 4:gx + (ox + pw_) // 4] = ri
                # MVDs + reconstruction in partition decode order
                parts = []
                for pi, (ox, oy, pw_, ph_) in enumerate(geo):
                    x4, y4 = gx + ox // 4, gy + oy // 4
                    mvdx = cd.mvd(0, mvd_err4(x4, y4, 0))
                    mvdy = cd.mvd(1, mvd_err4(x4, y4, 1))
                    pmv = mv_pred_part(mvg, refg, dec4, x4, y4, pw_ // 4,
                                       ph_ // 4, refs_i[pi], shapes[pi])
                    mv = (pmv[0] + mvdx, pmv[1] + mvdy)
                    _commit_part(mvg, refg, dec4, gx, gy, ox, oy, pw_,
                                 ph_, refs_i[pi], mv)
                    mvd4[y4:y4 + ph_ // 4, x4:x4 + pw_ // 4] = \
                        (abs(mvdx), abs(mvdy))
                    parts.append((ox, oy, pw_, ph_, refs_i[pi], mv))
                pred = np.zeros((16, 16), np.int32)
                pred_u = np.zeros((8, 8), np.int32)
                pred_v = np.zeros((8, 8), np.int32)
                for (ox, oy, pw_, ph_, ri_, (mvx, mvy)) in parts:
                    rpy, rpu, rpv = self.dpb[ri_]
                    pred[oy:oy + ph_, ox:ox + pw_] = self._mc_wp(
                        mc_luma_np(rpy, x + ox, yy + oy, mvx, mvy, pw_,
                                   ph_), ri_, 0)
                    pred_u[oy // 2:(oy + ph_) // 2,
                           ox // 2:(ox + pw_) // 2] = self._mc_wp(
                        mc_chroma_np(rpu, cx + ox // 2, cy + oy // 2,
                                     mvx, mvy, pw_ // 2, ph_ // 2), ri_, 1)
                    pred_v[oy // 2:(oy + ph_) // 2,
                           ox // 2:(ox + pw_) // 2] = self._mc_wp(
                        mc_chroma_np(rpv, cx + ox // 2, cy + oy // 2,
                                     mvx, mvy, pw_ // 2, ph_ // 2), ri_, 2)

                def nbr(dx, dy):
                    nx, ny = mbx + dx, mby + dy
                    if nx < 0 or ny < 0:
                        return None
                    return {"cbp": int(cbp_arr[ny, nx]), "ipcm": False}

                cbp = cd.cbp(nbr(0, -1), nbr(-1, 0))
                cbp_arr[mby, mbx] = cbp
                cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
                mb_t8 = False
                if getattr(self, "trans8_enabled", False) and \
                        trans8 is not None and cbp_luma and \
                        all(g[2] >= 8 and g[3] >= 8 for g in geo):
                    ta = 1 if (mbx > 0 and trans8[mby, mbx - 1]) else 0
                    tb = 1 if (mby > 0 and trans8[mby - 1, mbx]) else 0
                    mb_t8 = bool(cd.transform_size_8x8_flag(ta + tb))
                    trans8[mby, mbx] = mb_t8
                if cbp:
                    assert cd.mb_qp_delta(False) == 0, "dqp unsupported"
                cur_bits = 0
                lv = np.zeros((4, 4, 4, 4), np.int64)
                lv8 = [np.zeros((8, 8), np.int64) for _ in range(4)]
                if mb_t8:
                    for b8 in range(4):
                        if not (cbp_luma & (1 << b8)):
                            continue
                        coeffs = cd.residual_block(hc.LUMA_8x8, 64, 0,
                                                   code_cbf=False)
                        flat = np.zeros(64, np.int64)
                        flat[ht.ZIGZAG_8x8] = coeffs
                        lv8[b8] = flat.reshape(8, 8)
                        if any(coeffs):
                            bx4, by4 = (b8 & 1) * 2, (b8 >> 1) * 2
                            if nz8 is not None:
                                nz8[gy + by4:gy + by4 + 2,
                                    gx + bx4:gx + bx4 + 2] = True
                            for k in range(4):
                                idx = 4 * b8 + k
                                x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                                cur_bits |= 1 << (1 + 4 * y4 + x4)
                                cbf.set_bit(mbx, mby, 1 + 4 * y4 + x4)
                for i8 in range(4):
                    if mb_t8:
                        break
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
                c_ac_q = [np.zeros((2, 2, 4, 4), np.int64) for _ in range(2)]
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

                if mb_t8:
                    res = np.zeros((16, 16), np.int64)
                    for b8 in range(4):
                        ox, oy = (b8 & 1) * 8, (b8 >> 1) * 8
                        res[oy:oy + 8, ox:ox + 8] = ht.inverse8x8(
                            ht.dequant8x8(lv8[b8], qp))
                    rec_y[yy:yy + 16, x:x + 16] = np.clip(pred + res,
                                                          0, 255)
                else:
                    d = ht.dequant_ac(lv, qp)
                    rec_y[yy:yy + 16, x:x + 16] = np.clip(
                        pred + ht.inverse4x4(d)
                        .transpose(0, 2, 1, 3).reshape(16, 16), 0, 255)
                for comp, (plane, cp) in enumerate(
                        ((rec_u, pred_u), (rec_v, pred_v))):
                    cdc_deq = (ht.dequant_chroma_dc(c_dc_q[comp], qpc)
                               if cbp_chroma
                               else np.zeros((2, 2), np.int64))
                    cdq = ht.dequant_ac(
                        c_ac_q[comp] if cbp_chroma == 2
                        else np.zeros_like(c_ac_q[comp]), qpc)
                    cdq[:, :, 0, 0] = cdc_deq
                    plane[cy:cy + 8, cx:cx + 8] = np.clip(
                        cp + ht.inverse4x4(cdq)
                        .transpose(0, 2, 1, 3).reshape(8, 8), 0, 255)
                assert cd.final() == (1 if last_mb else 0)

    # video_codecs_tpu/models/h264/inter_codec.py:1930
    def _decode_intra_mb_cabac(self, cd, act, i16_sym, mbx, mby, qp, qpc,
                               rec_y, rec_u, rec_v, cbf, cbp_arr, cipred,
                               mode4, is_i4, pred_mode4, i16, trans8=None):
        """Intra MB inside a CABAC P slice (act 6 = I_4x4/I_8x8,
        7 = I_16x16)."""
        from video_codecs_tpu_torch.entropy import h264_cabac as hc
        from video_codecs_tpu_torch.models.h264 import intra8
        mbw, mbh = self.size
        zz = cavlc.ZIGZAG_4x4
        x, y = mbx * 16, mby * 16
        cx, cy = mbx * 8, mby * 8
        use_i4 = act == 6
        is_i4[mby, mbx] = use_i4
        i16[mby, mbx] = not use_i4
        use_i8 = False
        if use_i4 and trans8 is not None and \
                getattr(self, "trans8_enabled", False):
            ta = 1 if (mbx > 0 and trans8[mby, mbx - 1]) else 0
            tb = 1 if (mby > 0 and trans8[mby - 1, mbx]) else 0
            use_i8 = bool(cd.transform_size_8x8_flag(ta + tb))
            trans8[mby, mbx] = use_i8
        modes = []
        if use_i8:
            for b8 in range(4):
                bx4, by4 = (b8 & 1) * 2, (b8 >> 1) * 2
                pm = pred_mode4(mbx * 4 + bx4, mby * 4 + by4)
                m = cd.intra4x4_pred_mode(pm)
                modes.append(m)
                mode4[mby * 4 + by4:mby * 4 + by4 + 2,
                      mbx * 4 + bx4:mbx * 4 + bx4 + 2] = m
        elif use_i4:
            for idx in range(16):
                x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                pm = pred_mode4(mbx * 4 + x4, mby * 4 + y4)
                m = cd.intra4x4_pred_mode(pm)
                modes.append(m)
                mode4[mby * 4 + y4, mbx * 4 + x4] = m
        else:
            code = i16_sym
            lmode = code % 4
            cbp_chroma = (code // 4) % 3
            cbp_luma = 15 if code >= 12 else 0
        ca = 1 if (mbx > 0 and cipred[mby, mbx - 1] != 0) else 0
        cb = 1 if (mby > 0 and cipred[mby - 1, mbx] != 0) else 0
        cmode = cd.intra_chroma_pred_mode(ca + cb)
        cipred[mby, mbx] = cmode

        def nbr(dx, dy):
            nx, ny = mbx + dx, mby + dy
            if nx < 0 or ny < 0:
                return None
            return {"cbp": int(cbp_arr[ny, nx]), "ipcm": False}

        if use_i4:
            cbp = cd.cbp(nbr(0, -1), nbr(-1, 0))
            cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        else:
            cbp = cbp_luma | (cbp_chroma << 4)
        cbp_arr[mby, mbx] = cbp
        if (not use_i4) or cbp:
            assert cd.mb_qp_delta(False) == 0, "dqp unsupported"

        cur_bits = 0
        dc_q = np.zeros((4, 4), np.int64)
        if not use_i4:
            ctx = cbf.ctx_dc(mbx, mby, hc.CbfState.LUMA_DC_BIT, True)
            dc_list = cd.residual_block(hc.LUMA_16DC, 16, ctx)
            flat = np.zeros(16, np.int64)
            flat[zz] = dc_list
            dc_q = flat.reshape(4, 4)
            if any(dc_list):
                cur_bits |= 1 << hc.CbfState.LUMA_DC_BIT
                cbf.set_bit(mbx, mby, hc.CbfState.LUMA_DC_BIT)
        levels4 = [np.zeros((4, 4), np.int64) for _ in range(16)]
        levels8 = [np.zeros((8, 8), np.int64) for _ in range(4)]
        ac_q = np.zeros((4, 4, 4, 4), np.int64)
        if use_i8:
            for b8 in range(4):
                if not (cbp_luma & (1 << b8)):
                    continue
                coeffs = cd.residual_block(hc.LUMA_8x8, 64, 0,
                                           code_cbf=False)
                flat = np.zeros(64, np.int64)
                flat[ht.ZIGZAG_8x8] = coeffs
                levels8[b8] = flat.reshape(8, 8)
                if any(coeffs):
                    for k in range(4):
                        idx = 4 * b8 + k
                        x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                        cur_bits |= 1 << (1 + 4 * y4 + x4)
                        cbf.set_bit(mbx, mby, 1 + 4 * y4 + x4)
        for i8 in range(4):
            if use_i8:
                break
            for k in range(4):
                idx = 4 * i8 + k
                x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                if use_i4:
                    if not (cbp_luma & (1 << i8)):
                        continue
                    ctx = cbf.ctx_ac(mbx, mby, x4, y4, 1, 4, cur_bits, True)
                    coeffs = cd.residual_block(hc.LUMA_4x4, 16, ctx)
                    flat = np.zeros(16, np.int64)
                    flat[zz] = coeffs
                    levels4[idx] = flat.reshape(4, 4)
                else:
                    if not cbp_luma:
                        continue
                    ctx = cbf.ctx_ac(mbx, mby, x4, y4, 1, 4, cur_bits, True)
                    coeffs = cd.residual_block(hc.LUMA_16AC, 15, ctx)
                    flat = np.zeros(16, np.int64)
                    flat[zz[1:]] = coeffs
                    ac_q[y4, x4] = flat.reshape(4, 4)
                if any(coeffs):
                    cur_bits |= 1 << (1 + 4 * y4 + x4)
                    cbf.set_bit(mbx, mby, 1 + 4 * y4 + x4)
        c_dc_q = [np.zeros((2, 2), np.int64) for _ in range(2)]
        c_ac_q = [np.zeros((2, 2, 4, 4), np.int64) for _ in range(2)]
        if cbp_chroma:
            for comp, bit in ((0, hc.CbfState.U_DC_BIT),
                              (1, hc.CbfState.V_DC_BIT)):
                ctx = cbf.ctx_dc(mbx, mby, bit, True)
                lst = cd.residual_block(hc.CHROMA_DC, 4, ctx)
                c_dc_q[comp][0, 0], c_dc_q[comp][0, 1] = lst[0], lst[1]
                c_dc_q[comp][1, 0], c_dc_q[comp][1, 1] = lst[2], lst[3]
                if any(lst):
                    cbf.set_bit(mbx, mby, bit)
        if cbp_chroma == 2:
            for comp, base in ((0, hc.CbfState.U_AC_BASE),
                               (1, hc.CbfState.V_AC_BASE)):
                for idx in range(4):
                    x4, y4 = idx & 1, idx >> 1
                    ctx = cbf.ctx_ac(mbx, mby, x4, y4, base, 2,
                                     cur_bits, True)
                    coeffs = cd.residual_block(hc.CHROMA_AC, 15, ctx)
                    flat = np.zeros(16, np.int64)
                    flat[zz[1:]] = coeffs
                    c_ac_q[comp][y4, x4] = flat.reshape(4, 4)
                    if any(coeffs):
                        cur_bits |= 1 << (base + 4 * y4 + x4)
                        cbf.set_bit(mbx, mby, base + 4 * y4 + x4)
        cbf.mark(mbx, mby)

        # ---- reconstruction ----
        from video_codecs_tpu_torch.models.h264.intra_codec import (
            gather_ref4, pred_luma4)
        if use_i8:
            for b8 in range(4):
                ox, oy = (b8 & 1) * 8, (b8 >> 1) * 8
                pb = intra8.predict8(rec_y, x + ox, y + oy, mbw, modes[b8])
                d8 = ht.inverse8x8(ht.dequant8x8(levels8[b8], qp))
                rec_y[y + oy:y + oy + 8, x + ox:x + ox + 8] = \
                    np.clip(pb + d8, 0, 255)
        elif use_i4:
            for idx in range(16):
                x4, y4 = _BLK_X[idx], _BLK_Y[idx]
                px, py = x + x4 * 4, y + y4 * 4
                l, t, c, av = gather_ref4(rec_y, px, py, mbw)
                pb = pred_luma4(l, t, c, av, modes[idx])
                d4 = ht.dequant_ac(levels4[idx], qp)
                rec_y[py:py + 4, px:px + 4] = np.clip(
                    pb + ht.inverse4x4(d4), 0, 255)
        else:
            pred = pred_luma16(rec_y, x, y, lmode)
            dc_deq = ht.dequant_luma_dc(dc_q, qp)
            d = ht.dequant_ac(ac_q, qp)
            d[:, :, 0, 0] = dc_deq
            rr = ht.inverse4x4(d)
            rec_y[y:y + 16, x:x + 16] = np.clip(
                pred + rr.transpose(0, 2, 1, 3).reshape(16, 16), 0, 255)
        from video_codecs_tpu_torch.models.h264.intra_codec import pred_chroma8
        for comp, plane in ((0, rec_u), (1, rec_v)):
            cpred = pred_chroma8(plane, cx, cy, cmode)
            cdc_deq = ht.dequant_chroma_dc(c_dc_q[comp], qpc)
            cdq = ht.dequant_ac(c_ac_q[comp], qpc)
            cdq[:, :, 0, 0] = cdc_deq
            cr2 = ht.inverse4x4(cdq)
            plane[cy:cy + 8, cx:cx + 8] = np.clip(
                cpred + cr2.transpose(0, 2, 1, 3).reshape(8, 8), 0, 255)
