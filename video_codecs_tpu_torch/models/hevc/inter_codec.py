"""The reference's host low-delay P (IPPP) coder and its decoder.

The port's copy of video_codecs_tpu/models/hevc/inter_codec.py; each
function keeps its name and a comment gives the original's line.
`LowDelayEncoder` is what the reference's encoder CLI builds for any
low-delay HM cfg, HM's encoder_lowdelay_P_main.cfg included: CTB = CU =
PU = 16, 1-4 L0 references, merge (up to 5 candidates with TMVP),
AMVP, skip, explicit weighted prediction (one reference, as the
reference allows), CTU-level QP (cu_qp_delta, with an optional
`ctu_rc` = ratectrl.CtuRateControl), SAO, HRD timing SEI and the
long-term IDR; the IDR is `IntraEncoder.encode_frame` (the host CTB
loop at cfg.rdoq, ops/rdoq.rdoq_np at "full").  `encode_p_frame` runs:

  pass 1 on the encoder's device: `me.motion_search` for each reference
    (the SAD kernel on the card) and `decide_modes`' 35-mode sweep, one
    copy back each;
  pass 2 on the host, the reference's raster loop in numpy: merge / AMVP
    candidates (models/hevc/motion.py, whose AMVP list is the spec's),
    the numpy MC twins, the 8x8 SATD of the merge and intra candidates
    (`_satd8`, the port's `hadamard_satd_8x8` on CPU tensors, one call a
    block: on the card each would be a launch and a sync), mode choice
    and `code_tb_np`;
  the picture deblock with BS maps and, with cu_qp_delta, the per-block
    QP map on the encoder's device (`deblock_420_bs`); with `cfg.sao` the
    SAO decision from the device statistics (`_sao_decide_apply`, the SAO
    kernel); CABAC and the picture-hash SEI on the host.

The floats stay the reference's float64 numpy: `estimate_wp_params`,
`CtuRateControl.ctu_qps` and the lambda-weighted costs.  `encode_frames`
takes a picture-level rate controller (models/hevc/ratectrl.py),
resumes from a checkpoint state (models/hevc/checkpoint.py) and, with
`cfg.long_term_idr`, raises ValueError in the two cases the reference
writes wrongly (a picture past POC 255, a checkpoint resume).
`LowDelayDecoder` decodes these streams (and, with conceal=True, copies
the previous picture for a P slice it cannot parse, as the reference
does); models/hevc/decoder.GeneralDecoder decodes them too.  Not ported:
the single-candidate flat MV predictors `derive_merge_candidate` and
`derive_amvp`, which the reference calls nowhere.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from video_codecs_tpu_torch.entropy import bitstream as bs
from video_codecs_tpu_torch.entropy import cabac, ctx, residual
from video_codecs_tpu_torch.models.hevc import checkpoint, headers, motion
from video_codecs_tpu_torch.models.hevc import intra_codec as ic
from video_codecs_tpu_torch.models.hevc import sei as sei_mod
from video_codecs_tpu_torch.ops import cost as cost_ops
from video_codecs_tpu_torch.ops import deblock as deblock_ops
from video_codecs_tpu_torch.ops import interp
from video_codecs_tpu_torch.ops import intra as intra_ops
from video_codecs_tpu_torch.ops import me as me_ops
from video_codecs_tpu_torch.ops import quant as quant_ops
from video_codecs_tpu_torch.ops import sao as sao_ops
from video_codecs_tpu_torch.ops import transform as tr_ops
from video_codecs_tpu_torch.utils import rom
from video_codecs_tpu_torch.utils.device import to_device

DC = 1
NAL_TRAIL_R = 1

MODE_INTER, MODE_INTRA = 0, 1


# video_codecs_tpu/models/hevc/inter_codec.py:44
@dataclasses.dataclass
class BlockInfo:
    """Per-16x16-block coding state (the SoA row of TComDataCU)."""
    pred_mode: int = MODE_INTRA   # MODE_INTER / MODE_INTRA
    skip: bool = False
    merge: bool = False
    merge_idx: int = 0
    mvp_idx: int = 0
    mvd: tuple[int, int] = (0, 0)
    mv: tuple[int, int] = (0, 0)  # final quarter-pel MV (inter only)
    ref_idx: int = 0              # L0 reference index
    ref_poc: int = 0              # POC of the used reference
    intra_mode: int = DC
    qp: int = 0                   # final CU QP (cu_qp_delta pictures)
    qp_delta: int = 0
    cbf_y: bool = False
    cbf_cb: bool = False
    cbf_cr: bool = False
    levels_y: np.ndarray | None = None
    levels_cb: np.ndarray | None = None
    levels_cr: np.ndarray | None = None


# video_codecs_tpu/models/hevc/inter_codec.py:122
def mvd_bits_estimate(mvd: tuple[int, int]) -> int:
    b = 2
    for c in mvd:
        a = abs(c)
        if a > 0:
            b += 1
        if a > 1:
            b += 2 * max(int(math.log2(a)), 1)
    return b


# video_codecs_tpu/models/hevc/inter_codec.py:133
def compute_bs_maps(info, bw, bh):
    """Boundary strengths between adjacent blocks (spec 8.7.2.4)."""
    bs_ver = np.zeros((bw - 1, bh), np.int32)
    bs_hor = np.zeros((bh - 1, bw), np.int32)

    def bs(a: BlockInfo, b: BlockInfo) -> int:
        if a.pred_mode == MODE_INTRA or b.pred_mode == MODE_INTRA:
            return 2
        if a.cbf_y or b.cbf_y:
            return 1
        if a.ref_poc != b.ref_poc:     # different reference pictures
            return 1                   # (spec 8.7.2.4 / HM
        if (abs(a.mv[0] - b.mv[0]) >= 4) or (abs(a.mv[1] - b.mv[1]) >= 4):
            return 1                   # xGetBoundaryStrengthSingle :417)
        return 0

    for by in range(bh):
        for bx in range(1, bw):
            bs_ver[bx - 1, by] = bs(info[by][bx - 1], info[by][bx])
    for by in range(1, bh):
        for bx in range(bw):
            bs_hor[by - 1, bx] = bs(info[by - 1][bx], info[by][bx])
    return bs_ver, bs_hor


# video_codecs_tpu/models/hevc/inter_codec.py:158
def estimate_wp_params(cur, ref) -> dict:
    """Per-slice explicit-WP weight/offset estimation per plane
    (WeightPredAnalysis.cpp xCalcACDCParamSlice + xEstimateWPParamSlice
    behavior: weight from the AC-energy ratio, offset from the DC gap)."""
    ws, os_ = [], []
    for c, r in zip(cur, ref):
        c = c.astype(np.float64)
        r = r.astype(np.float64)
        dc_c, dc_r = c.mean(), r.mean()
        ac_c = np.abs(c - dc_c).sum()
        ac_r = np.abs(r - dc_r).sum()
        w = int(round(64.0 * ac_c / ac_r)) if ac_r > 0 else 64
        w = max(1, min(127, w))
        o = int(round(dc_c - (w * dc_r) / 64.0))
        ws.append(w)
        os_.append(max(-128, min(127, o)))
    return dict(denom=6, denom_c=6, w=tuple(ws), o=tuple(os_))


WP_IDENTITY = dict(denom=6, denom_c=6, w=(64, 64, 64), o=(0, 0, 0))


# video_codecs_tpu/models/hevc/inter_codec.py:180
def write_p_slice_header(cfg: headers.HevcConfig, poc: int,
                         wp: dict | None = None, n_refs: int = 1):
    w = bs.BitWriter()
    w.flag(1)          # first_slice_segment_in_pic_flag
    w.ue(0)            # slice_pic_parameter_set_id
    w.ue(1)            # slice_type = P
    w.write(poc & 255, 8)  # slice_pic_order_cnt_lsb
    w.flag(0)          # short_term_ref_pic_set_sps_flag
    if cfg.long_term_idr:
        # empty short-term RPS; the single reference is the IDR signalled
        # as a long-term picture (spec 7.3.6.1 lt section)
        assert n_refs == 1 and not cfg.temporal_mvp, \
            "long_term_idr mode: 1 ref, no TMVP"
        w.ue(0)        # num_negative_pics
        w.ue(0)        # num_positive_pics
        w.ue(1)        # num_long_term_pics (num_long_term_sps absent: 0 in SPS)
        w.write(0, 8)  # poc_lsb_lt = 0 (the IDR)
        w.flag(1)      # used_by_curr_pic_lt_flag
        w.flag(0)      # delta_poc_msb_present_flag
    else:
        # st_ref_pic_set: n_refs negative refs at deltas 1..n_refs
        w.ue(n_refs)       # num_negative_pics
        w.ue(0)            # num_positive_pics
        for _ in range(n_refs):
            w.ue(0)        # delta_poc_s0_minus1[i]
            w.flag(1)      # used_by_curr_pic_s0_flag[i]
    if cfg.temporal_mvp:
        w.flag(1)      # slice_temporal_mvp_enabled_flag
    if cfg.sao:
        w.flag(1)      # slice_sao_luma_flag
        w.flag(1)      # slice_sao_chroma_flag
    if n_refs != 1:    # pps default is 1 active reference
        w.flag(1)      # num_ref_idx_active_override_flag
        w.ue(n_refs - 1)
    else:
        w.flag(0)
    if cfg.temporal_mvp:
        # P slice: collocated_from_l0 inferred 1; idx coded when >1 refs
        if n_refs > 1:
            w.ue(0)    # collocated_ref_idx = 0
    if cfg.weighted_pred:
        assert n_refs == 1, "WP with multiple references: later round"
        # pred_weight_table (spec 7.3.6.3), single L0 reference
        wp = wp or WP_IDENTITY
        denom, denom_c = wp["denom"], wp["denom_c"]
        w.ue(denom)                   # luma_log2_weight_denom
        w.se(denom_c - denom)         # delta_chroma_log2_weight_denom
        luma_on = (wp["w"][0], wp["o"][0]) != (1 << denom, 0)
        chroma_on = any((wp["w"][j], wp["o"][j]) != (1 << denom_c, 0)
                        for j in (1, 2))
        w.flag(1 if luma_on else 0)   # luma_weight_l0_flag[0]
        w.flag(1 if chroma_on else 0)  # chroma_weight_l0_flag[0]
        if luma_on:
            w.se(wp["w"][0] - (1 << denom))   # delta_luma_weight_l0
            w.se(wp["o"][0])                  # luma_offset_l0
        if chroma_on:
            for j in (1, 2):
                w.se(wp["w"][j] - (1 << denom_c))
                # delta_chroma_offset (TDecCAVLC xParsePredWeightTable
                # inverse: offset = clip(delta + 128 - (128*w >> denom)))
                w.se(wp["o"][j] + ((128 * wp["w"][j]) >> denom_c) - 128)
    w.ue(5 - cfg.merge_cands)  # five_minus_max_num_merge_cand
    w.se(cfg.qp - 26)  # slice_qp_delta
    if not cfg.deblocking_disabled:
        w.flag(1)      # slice_loop_filter_across_slices_enabled_flag
    w.byte_alignment()
    return w


# video_codecs_tpu/models/hevc/inter_codec.py:249
def parse_p_slice_header(rbsp: bytes, pps: headers.PpsInfo,
                         sps_tmvp: bool = False, sps_sao: bool = False,
                         sps_lt: bool = False):
    r = bs.BitReader(rbsp)
    assert r.flag() == 1
    assert r.ue() == 0
    st = r.ue()
    assert st == 1, "only P slices supported here"
    poc = r.read(8)
    assert r.flag() == 0
    n_neg = r.ue()
    assert r.ue() == 0, "no positive refs in LD-P"
    for _ in range(n_neg):
        assert r.ue() == 0 and r.flag() == 1, "unit-delta RPS expected"
    lt_pocs = ()
    if sps_lt:
        n_lt = r.ue()           # num_long_term_pics (num_long_term_sps: 0)
        pocs = []
        for _ in range(n_lt):
            lsb = r.read(8)     # poc_lsb_lt
            assert r.flag() == 1, "unused lt pics unexpected here"
            assert r.flag() == 0, "delta_poc_msb unexpected (short POCs)"
            pocs.append(lsb)
        lt_pocs = tuple(pocs)
    tmvp = False
    if sps_tmvp:
        tmvp = bool(r.flag())
    sao = False
    if sps_sao:
        sao = bool(r.flag())
        assert bool(r.flag()) == sao, "joint luma+chroma SAO expected"
    n_refs = 1
    if r.flag():       # num_ref_idx_active_override
        n_refs = r.ue() + 1
    if tmvp and n_refs > 1:
        assert r.ue() == 0, "collocated_ref_idx must be 0 in this build"
    wp = None
    if pps.weighted_pred:
        denom = r.ue()
        denom_c = denom + r.se()
        luma_on = r.flag()
        chroma_on = r.flag()
        ws = [1 << denom, 1 << denom_c, 1 << denom_c]
        os_ = [0, 0, 0]
        if luma_on:
            ws[0] = (1 << denom) + r.se()
            os_[0] = r.se()
        if chroma_on:
            for j in (1, 2):
                ws[j] = (1 << denom_c) + r.se()
                delta = r.se()
                os_[j] = max(-128, min(
                    127, delta + 128 - ((128 * ws[j]) >> denom_c)))
        wp = dict(denom=denom, denom_c=denom_c, w=tuple(ws), o=tuple(os_))
    merge_cands = 5 - r.ue()
    qp = pps.init_qp + r.se()
    if not pps.deblocking_disabled:
        r.flag()
    assert r.flag() == 1
    r.byte_align()
    return PSliceInfo(poc=poc, qp=qp, data_offset_bits=r.bit_pos(), wp=wp,
                      n_refs=n_refs, merge_cands=merge_cands, tmvp=tmvp,
                      sao=sao, lt_pocs=lt_pocs)


# video_codecs_tpu/models/hevc/inter_codec.py:314
@dataclasses.dataclass
class PSliceInfo:
    poc: int
    qp: int
    data_offset_bits: int
    wp: dict | None = None
    n_refs: int = 1
    merge_cands: int = 1
    tmvp: bool = False
    sao: bool = False
    lt_pocs: tuple = ()      # long-term reference POC lsbs (L0 tail)


# video_codecs_tpu/models/hevc/inter_codec.py:331
class LowDelayEncoder(ic.IntraEncoder):
    """IPPP encoder: frame 0 IDR intra, then P frames."""

    # video_codecs_tpu/models/hevc/inter_codec.py:334
    def __init__(self, cfg: headers.HevcConfig, search_range: int = 8,
                 me_method: str = "auto", *, device="cuda") -> None:
        super().__init__(cfg, device=device)
        self.search_range = search_range
        # "full" (HM FastSearch:0) | "tz" (FastSearch:1) | "auto"
        self.me_method = me_method
    # video_codecs_tpu/models/hevc/inter_codec.py:341
    def encode_sequence_ldp(self, frames, rate_control=None):
        """IPPP encode; optional rate controller (models.hevc.ratectrl)
        drives per-picture QP through slice_qp_delta."""
        nals = self.stream_headers()
        frame_nals, recons, _ = self.encode_frames(frames, None, rate_control)
        nals.extend(frame_nals)
        return bs.annexb(nals), recons

    # video_codecs_tpu/models/hevc/inter_codec.py:349
    def encode_frames(self, frames, start_state=None, rate_control=None):
        """Encode pictures, optionally resuming from a checkpoint state;
        returns (nal list, recons, final EncoderState).  The picture QP
        comes from the rate controller's `pick_qp()` when one is given,
        else from `qp_schedule` when an encoder sets one.  With
        `cfg.long_term_idr` the two cases the reference writes wrongly
        raise ValueError before anything is coded: a picture past POC
        255 (the 8-bit POC lsb of the long-term entry wraps, and a
        decoder then takes POC 256 for the IDR) and a resume from a
        checkpoint (the entry signals lsb 0 for a reference that is not
        the IDR)."""
        frames = list(frames)
        if self.cfg.long_term_idr:
            if self.cfg.temporal_mvp:
                raise ValueError("long_term_idr needs temporal_mvp off "
                                 "(write_p_slice_header's terms)")
            if start_state is not None:
                raise ValueError(
                    "long_term_idr with a start_state: the reference "
                    "signals the IDR (poc_lsb_lt 0) for a reference that "
                    "is the checkpoint's last picture")
            if len(frames) > 256:
                raise ValueError(
                    f"long_term_idr over {len(frames)} pictures: past POC "
                    "255 the 8-bit poc_lsb_lt of the IDR matches POC 256 "
                    "too, and the reference signals no MSB")
        nals: list[bytes] = []
        recons = []
        dpb: list[tuple] = []    # [(poc, planes, MotionField)] newest first
        poc0 = 0
        if start_state is not None:
            poc0 = start_state.poc
            dpb = list(getattr(start_state, "dpb", ()) or ())
            if not dpb and start_state.ref is not None:
                bw = self.cfg.width // 16
                bh = self.cfg.height // 16
                dpb = [(poc0 - 1, start_state.ref,
                        motion.MotionField.empty(bw, bh, poc0 - 1))]
            checkpoint.restore_rc(start_state, rate_control)
        self.frame_qps: list[int] = []
        for k, (y, u, v) in enumerate(frames):
            poc = poc0 + k
            if rate_control is not None:
                self.cfg.qp = rate_control.pick_qp()
            else:
                sched = getattr(self, "qp_schedule", None)
                if sched is not None:
                    self.cfg.qp = sched(poc)
            self.frame_qps.append(self.cfg.qp)
            if poc == 0:
                frame_nals, rec = self.encode_frame(y, u, v)
                bw, bh = self.cfg.width // 16, self.cfg.height // 16
                mf = motion.MotionField.empty(bw, bh, poc)
            else:
                # long_term_idr: the only active reference is the IDR,
                # kept alive as a long-term picture (oldest DPB entry)
                refs = [dpb[-1]] if self.cfg.long_term_idr else dpb
                frame_nals, rec, mf = self.encode_p_frame(y, u, v, refs, poc)
            if rate_control is not None:
                # the picture's bits and its luma MAD, in float64 numpy
                # as the reference computes them (a summation order of
                # its own could move a later round() in pick_qp)
                bits = 8 * sum(len(n) for n in frame_nals)
                mad = float(np.mean(np.abs(
                    rec[0].astype(np.float64) - y.astype(np.float64))))
                rate_control.update(bits, mad)
            if self.cfg.timing_sei:
                # HRD SEI prefix: buffering period on the IRAP AU,
                # pic timing on every AU (TEncGOP xCreate*SEI wiring)
                msgs: list = []
                if poc == poc0:
                    msgs.append(sei_mod.BufferingPeriod(
                        initial_cpb_removal_delay=90000))
                msgs.append(sei_mod.PictureTiming(
                    au_cpb_removal_delay_minus1=max(0, poc - poc0 - 1),
                    pic_dpb_output_delay=1))
                frame_nals.insert(0, sei_mod.sei_nal(msgs))
            nals.extend(frame_nals)
            recons.append(rec)
            dpb.insert(0, (poc, rec, mf))
            if self.cfg.long_term_idr:
                # keep the short-term window plus the long-term IDR tail
                dpb[:] = dpb[:self.cfg.num_refs] + \
                    [e for e in dpb[self.cfg.num_refs:] if e[0] == 0]
            else:
                del dpb[self.cfg.num_refs:]
        final = checkpoint.capture(poc0 + len(recons),
                                   dpb[0][1] if dpb else None, rate_control)
        final.dpb = tuple(dpb)
        return nals, recons, final

    # video_codecs_tpu/models/hevc/inter_codec.py:420
    def encode_p_frame(self, y, u, v, dpb, poc):
        """Encode one P picture against the DPB (newest-first list of
        (poc, planes, MotionField)); returns (nals, recon, MotionField).

        The reference's decisions and arithmetic, in four stages that the
        port places: pass 1 on the encoder's device (`_p_pass1`), the
        raster decision and reconstruction in numpy on the host
        (`_p_raster`), the deblock on the device (`_p_deblock`), then
        with `cfg.sao` `_sao_decide_apply`, and CABAC.  Weighted
        prediction with more than one reference raises ValueError (the
        reference asserts it in `write_p_slice_header`)."""
        cfg = self.cfg
        bw, bh = cfg.width // 16, cfg.height // 16
        nb = bw * bh
        qp = cfg.qp
        refs = dpb[:cfg.num_refs]
        n_refs = len(refs)
        ref_pocs = [p for (p, _, _) in refs]
        ref_planes = [tuple(pl.astype(np.int32) for pl in planes)
                      for (_, planes, _) in refs]
        col_field = refs[0][2] if cfg.temporal_mvp else None
        yv, uv, vv = (np.asarray(p).astype(np.int32) for p in (y, u, v))

        wp = None
        if cfg.weighted_pred:
            if n_refs != 1:
                raise ValueError(
                    f"weighted prediction with {n_refs} references: the "
                    "reference writes a pred_weight_table for one "
                    "(write_p_slice_header)")
            wp = estimate_wp_params((yv, uv, vv), ref_planes[0])

        cur = np.stack([yv[b // bw * 16:b // bw * 16 + 16,
                           b % bw * 16:b % bw * 16 + 16] for b in range(nb)])
        me_per_ref, intra_modes = self._p_pass1(y, cur, ref_planes)

        qp_map = None
        if cfg.cu_qp_delta:
            # CTU-level rate control: per-block QP from ME complexity
            # (TEncRateCtrl getLCUTargetBpp/getLCUEstLambdaAndQP analog)
            satd_map = me_per_ref[0][2].reshape(bh, bw).astype(np.float64)
            if getattr(self, "ctu_rc", None) is not None:
                qp_map = self.ctu_rc.ctu_qps(qp, satd_map)
            else:
                w_ = satd_map + 1.0
                rel = np.log2(w_ / np.exp(np.log(w_).mean()))
                qp_map = np.clip(qp - np.round(rel).astype(int), qp - 3,
                                 qp + 3).clip(1, 51)

        info, (rec_y, rec_u, rec_v) = self._p_raster(
            (yv, uv, vv), cur, ref_planes, ref_pocs, poc, col_field, wp,
            me_per_ref, intra_modes, qp_map)

        # motion field of this picture (TMVP source for later pictures)
        mf = motion.MotionField.empty(bw, bh, poc)
        for by in range(bh):
            for bx in range(bw):
                b = info[by][bx]
                if b.pred_mode == MODE_INTER:
                    mf.inter[by, bx] = True
                    mf.mv[by, bx] = b.mv
                    mf.ref_poc[by, bx] = b.ref_poc

        if not cfg.deblocking_disabled:
            rec_y, rec_u, rec_v = self._p_deblock((rec_y, rec_u, rec_v),
                                                  info)

        sao_params = None
        if cfg.sao:
            sao_params, (rec_y, rec_u, rec_v) = self._sao_decide_apply(
                (yv, uv, vv), (rec_y, rec_u, rec_v))

        slice_nal = self._encode_p_slice(info, poc, wp, n_refs, sao_params)
        sei_nal = self._hash_sei(rec_y, rec_u, rec_v)
        return [slice_nal, sei_nal], (rec_y, rec_u, rec_v), mf

    def _p_pass1(self, y, cur, ref_planes):
        """Pass 1 on the encoder's device: the quarter-pel motion search
        of every 16x16 block against each reference (`me.motion_search`:
        the SAD kernel on the card), one copy back per reference, then
        `decide_modes`' intra sweep.  Returns ([(mvx, mvy, satd)] per
        reference as numpy, the [bh, bw] intra modes)."""
        cfg = self.cfg
        bw, bh = cfg.width // 16, cfg.height // 16
        dev = self.device
        x0 = np.tile(np.arange(bw, dtype=np.int32) * 16, bh)
        y0 = np.repeat(np.arange(bh, dtype=np.int32) * 16, bw)
        me_per_ref = []
        with torch.inference_mode():
            cur_t = to_device(cur, dev)
            x0_t, y0_t = to_device(x0, dev), to_device(y0, dev)
            for planes in ref_planes:
                mvx, mvy, satd = me_ops.motion_search(
                    to_device(planes[0], dev), cur_t, x0_t, y0_t, 16,
                    self.search_range, self.me_method)
                me_per_ref.append(tuple(a.cpu().numpy()
                                        for a in (mvx, mvy, satd)))
        return me_per_ref, self.decide_modes(y)

    def _p_raster(self, planes, cur, ref_planes, ref_pocs, poc, col_field,
                  wp, me_per_ref, intra_modes, qp_map):
        """Pass 2, the reference's raster loop (inter_codec.py:446-612)
        in numpy on the host: per block the merge candidates' and each
        reference's AMVP costs (SATD + lambda * bits), the intra
        candidate, the choice, the residual coding with `code_tb_np` at
        the block's QP and the reconstruction.  Returns (BlockInfo grid,
        recon planes before the loop filters)."""
        cfg = self.cfg
        bw, bh = cfg.width // 16, cfg.height // 16
        qp = cfg.qp
        yv, uv, vv = planes
        n_refs = len(ref_planes)

        def mcl(r, xx, yy, mvx, mvy):
            ref_y = ref_planes[r][0]
            if wp is None:
                return interp.mc_luma_np(ref_y, xx, yy, mvx, mvy, 16)
            return interp.mc_luma_wp_np(ref_y, xx, yy, mvx, mvy, 16,
                                        wp["w"][0], wp["o"][0], wp["denom"])

        def mcc(r, comp, cx, cy, mvx, mvy):
            plane = ref_planes[r][1 + comp]
            if wp is None:
                return interp.mc_chroma_np(plane, cx, cy, mvx, mvy, 8)
            return interp.mc_chroma_wp_np(plane, cx, cy, mvx, mvy, 8,
                                          wp["w"][1 + comp],
                                          wp["o"][1 + comp], wp["denom_c"])

        sl = math.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0))
        prev_qp = qp
        rec_y = np.zeros_like(yv)
        rec_u = np.zeros_like(uv)
        rec_v = np.zeros_like(vv)
        info: list[list[BlockInfo | None]] = [
            [None] * bw for _ in range(bh)]
        grid = motion.NeighborGrid(info, bw, bh)

        for by in range(bh):
            for bx in range(bw):
                i = by * bw + bx
                xx, yy = bx * 16, by * 16
                oy = cur[i]

                # merge candidates (full list, spec order + pruning)
                merge_list = motion.merge_candidates(
                    grid, bx, by, ref_pocs, poc, col_field,
                    cfg.merge_cands, cfg.temporal_mvp)
                merge_preds = [mcl(m_ref, xx, yy, *m_mv)
                               for (m_mv, m_ref) in merge_list]
                imode = int(intra_modes[by, bx])
                ref_arr = ic.build_ref_np(rec_y, xx, yy, 16)
                pred_intra = intra_ops.predict_intra_np(ref_arr, imode, 4)
                # the SATDs of every merge candidate and of the intra
                # candidate in one call
                satds = _satd8(oy, merge_preds + [pred_intra])
                best_merge = None
                for m_idx, (m_mv, m_ref) in enumerate(merge_list):
                    pm = merge_preds[m_idx]
                    c = satds[m_idx] + round(sl * (2 + m_idx))
                    if best_merge is None or c < best_merge[0]:
                        best_merge = (c, m_idx, m_mv, m_ref, pm)
                cost_merge = best_merge[0]

                # explicit ME: best reference by SATD + rate
                best_me = None
                for r in range(n_refs):
                    mvx_r, mvy_r, satd_r = me_per_ref[r]
                    me_mv = (int(mvx_r[i]), int(mvy_r[i]))
                    amvp = motion.amvp_candidates(
                        grid, bx, by, r, ref_pocs, poc, col_field,
                        cfg.temporal_mvp)
                    mvds = [(me_mv[0] - p[0], me_mv[1] - p[1]) for p in amvp]
                    bits = [mvd_bits_estimate(d) for d in mvds]
                    mvp_idx = 0 if bits[0] <= bits[1] else 1
                    c = int(satd_r[i]) + round(
                        sl * (4 + r + bits[mvp_idx]))
                    if best_me is None or c < best_me[0]:
                        best_me = (c, r, me_mv, mvp_idx, mvds[mvp_idx])
                cost_me = best_me[0]

                satd_intra = satds[-1]
                cost_intra = satd_intra + round(sl * 9)

                b = BlockInfo()
                if cost_intra <= min(cost_merge, cost_me):
                    b.pred_mode = MODE_INTRA
                    b.intra_mode = imode
                    pred = pred_intra
                else:
                    b.pred_mode = MODE_INTER
                    if cost_merge <= cost_me:
                        _, m_idx, m_mv, m_ref, pm = best_merge
                        b.merge = True
                        b.merge_idx = m_idx
                        b.mv = tuple(m_mv)
                        b.ref_idx = m_ref
                        b.ref_poc = ref_pocs[m_ref]
                        pred = pm
                    else:
                        _, r, me_mv, mvp_idx, mvd = best_me
                        b.merge = False
                        b.mv = me_mv
                        b.ref_idx = r
                        b.ref_poc = ref_pocs[r]
                        b.mvp_idx = mvp_idx
                        b.mvd = mvd
                        pred = mcl(r, xx, yy, *me_mv)

                # luma TB (per-CU QP when cu_qp_delta is on)
                bqp = int(qp_map[by, bx]) if qp_map is not None else qp
                bqp_c = ic.chroma_qp(bqp)
                lv, rec = ic.code_tb_np(oy, pred, bqp, 4, dst=False,
                                        sbh=cfg.sign_data_hiding)
                b.cbf_y = bool(lv.any())
                b.levels_y = lv if b.cbf_y else None
                # chroma TBs
                cx, cy = xx // 2, yy // 2
                for comp, (po, pr) in enumerate(((uv, rec_u), (vv, rec_v))):
                    if b.pred_mode == MODE_INTRA:
                        refc = ic.build_ref_np(pr, cx, cy, 8)
                        predc = intra_ops.predict_intra_np(refc, imode, 3,
                                                           is_luma=False)
                    else:
                        predc = mcc(b.ref_idx, comp, cx, cy,
                                    b.mv[0], b.mv[1])
                    lvc, recc = ic.code_tb_np(po[cy:cy + 8, cx:cx + 8],
                                              predc, bqp_c, 3, dst=False,
                                              sbh=cfg.sign_data_hiding)
                    cbf = bool(lvc.any())
                    if comp == 0:
                        b.cbf_cb = cbf
                        b.levels_cb = lvc if cbf else None
                    else:
                        b.cbf_cr = cbf
                        b.levels_cr = lvc if cbf else None
                    pr[cy:cy + 8, cx:cx + 8] = recc

                # AMVP CU with no residual: rqt_root_cbf=0; merge CU with no
                # residual: becomes skip.
                no_resid = not (b.cbf_y or b.cbf_cb or b.cbf_cr)
                if b.pred_mode == MODE_INTER and b.merge and no_resid:
                    b.skip = True
                if cfg.cu_qp_delta:
                    if no_resid:
                        b.qp = prev_qp     # no delta coded: QP = qPY_PRED
                    else:
                        b.qp = bqp
                        b.qp_delta = bqp - prev_qp
                        prev_qp = bqp
                else:
                    b.qp = qp
                rec_y[yy:yy + 16, xx:xx + 16] = rec if b.cbf_y else pred
                info[by][bx] = b
        return info, (rec_y, rec_u, rec_v)

    def _p_deblock(self, recs, info):
        """The picture deblock with the BS maps and, with cu_qp_delta,
        the per-CU QP map (inter_codec.py:625-632) on the encoder's
        device, one copy each way."""
        cfg = self.cfg
        bw, bh = cfg.width // 16, cfg.height // 16
        bs_ver, bs_hor = compute_bs_maps(info, bw, bh)
        dq_map = None
        if cfg.cu_qp_delta:
            dq_map = np.array([[info[r][c].qp for c in range(bw)]
                               for r in range(bh)], np.int32)
        with torch.inference_mode():
            out = deblock_ops.deblock_420_bs(
                *(to_device(p, self.device) for p in recs), cfg.qp,
                bs_ver, bs_hor, qp_map=dq_map)
            return tuple(o.cpu().numpy() for o in out)
    # video_codecs_tpu/models/hevc/inter_codec.py:645
    def _encode_p_slice(self, info, poc, wp=None, n_refs: int = 1,
                        sao_params=None) -> bytes:
        cfg = self.cfg
        bw, bh = cfg.width // 16, cfg.height // 16
        w = write_p_slice_header(cfg, poc, wp, n_refs)
        states = ctx.init_states(ctx.P, cfg.qp)
        enc = cabac.CabacEncoder(w, states)
        for by in range(bh):
            for bx in range(bw):
                if sao_params is not None:
                    ic.encode_sao_ctu(enc, sao_params, by * bw + bx,
                                      bx, by, bw, 0)
                self._encode_p_ctu(enc, info, bx, by, bw, bh, n_refs)
                last = (by == bh - 1 and bx == bw - 1)
                enc.encode_terminate(1 if last else 0)
        enc.finish_slice()
        return bs.nal_unit(NAL_TRAIL_R, w.data())
    # video_codecs_tpu/models/hevc/inter_codec.py:663
    def _encode_merge_idx(self, enc, idx: int) -> None:
        """merge_idx TR binarization: first bin ctx, rest bypass
        (TEncSbac codeMergeIndex)."""
        if self.cfg.merge_cands <= 1:
            return
        enc.encode_bin(ctx.off("merge_idx"), 1 if idx > 0 else 0)
        if idx > 0:
            for k in range(1, idx):
                enc.encode_bypass(1)
            if idx < self.cfg.merge_cands - 1:
                enc.encode_bypass(0)

    # video_codecs_tpu/models/hevc/inter_codec.py:675
    @staticmethod
    def _encode_ref_idx(enc, idx: int, n_refs: int) -> None:
        """ref_idx TR binarization: bins 0/1 ctx-coded, rest bypass
        (TEncSbac codeRefFrmIdx; spec 9.3.3 Table 9-40)."""
        if n_refs <= 1:
            return
        enc.encode_bin(ctx.off("ref_idx", 0), 1 if idx > 0 else 0)
        if idx > 0 and n_refs > 2:
            for k in range(1, n_refs - 1):
                bin_v = 1 if idx > k else 0
                if k == 1:
                    enc.encode_bin(ctx.off("ref_idx", 1), bin_v)
                else:
                    enc.encode_bypass(bin_v)
                if not bin_v:
                    break

    # video_codecs_tpu/models/hevc/inter_codec.py:692
    def _encode_p_ctu(self, enc, info, bx, by, bw, bh, n_refs):
        b: BlockInfo = info[by][bx]
        left = info[by][bx - 1] if bx else None
        above = info[by - 1][bx] if by else None
        skip_ctx = (1 if (left and left.skip) else 0) + \
                   (1 if (above and above.skip) else 0)
        enc.encode_bin(ctx.off("skip_flag", skip_ctx), 1 if b.skip else 0)
        if b.skip:
            self._encode_merge_idx(enc, b.merge_idx)
            return
        enc.encode_bin(ctx.off("pred_mode"),
                       1 if b.pred_mode == MODE_INTRA else 0)
        if b.pred_mode == MODE_INTRA:
            left_mode = (left.intra_mode
                         if left and left.pred_mode == MODE_INTRA else DC)
            self._encode_intra_part(enc, b, left_mode)
        else:
            enc.encode_bin(ctx.off("part_size"), 1)  # PART_2Nx2N
            enc.encode_bin(ctx.off("merge_flag"), 1 if b.merge else 0)
            if b.merge:
                self._encode_merge_idx(enc, b.merge_idx)
            if not b.merge:
                self._encode_ref_idx(enc, b.ref_idx, n_refs)
                self._encode_mvd(enc, b.mvd)
                enc.encode_bin(ctx.off("mvp_idx"), b.mvp_idx)
            has_resid = b.cbf_y or b.cbf_cb or b.cbf_cr
            if not b.merge:
                enc.encode_bin(ctx.off("qt_root_cbf"), 1 if has_resid else 0)
                if not has_resid:
                    return
            # transform tree depth 0
            enc.encode_bin(ctx.off("cbf_chroma"), 1 if b.cbf_cb else 0)
            enc.encode_bin(ctx.off("cbf_chroma"), 1 if b.cbf_cr else 0)
            if b.cbf_cb or b.cbf_cr:
                enc.encode_bin(ctx.off("cbf_luma", 1), 1 if b.cbf_y else 0)
            else:
                assert b.cbf_y, "inter rootCbf=1 with all-zero cbfs"
            if self.cfg.cu_qp_delta and has_resid:
                encode_cu_qp_delta(enc, b.qp_delta)
            if b.cbf_y:
                residual.encode_residual(enc, b.levels_y, 4, rom.SCAN_DIAG, True, sign_hiding=self.cfg.sign_data_hiding)
            if b.cbf_cb:
                residual.encode_residual(enc, b.levels_cb, 3, rom.SCAN_DIAG, False, sign_hiding=self.cfg.sign_data_hiding)
            if b.cbf_cr:
                residual.encode_residual(enc, b.levels_cr, 3, rom.SCAN_DIAG, False, sign_hiding=self.cfg.sign_data_hiding)
            return
        # intra CU residual (always coded cbfs)
        enc.encode_bin(ctx.off("cbf_chroma"), 1 if b.cbf_cb else 0)
        enc.encode_bin(ctx.off("cbf_chroma"), 1 if b.cbf_cr else 0)
        enc.encode_bin(ctx.off("cbf_luma", 1), 1 if b.cbf_y else 0)
        if self.cfg.cu_qp_delta and (b.cbf_y or b.cbf_cb or b.cbf_cr):
            encode_cu_qp_delta(enc, b.qp_delta)
        if b.cbf_y:
            residual.encode_residual(enc, b.levels_y, 4, rom.SCAN_DIAG, True, sign_hiding=self.cfg.sign_data_hiding)
        if b.cbf_cb:
            residual.encode_residual(enc, b.levels_cb, 3, rom.SCAN_DIAG, False, sign_hiding=self.cfg.sign_data_hiding)
        if b.cbf_cr:
            residual.encode_residual(enc, b.levels_cr, 3, rom.SCAN_DIAG, False, sign_hiding=self.cfg.sign_data_hiding)
    # video_codecs_tpu/models/hevc/inter_codec.py:751
    def _encode_intra_part(self, enc, b: BlockInfo, left_mode: int):
        enc.encode_bin(ctx.off("part_size"), 1)  # 2Nx2N
        mpm = ic.mpm_list(left_mode)
        mode = b.intra_mode
        if mode in mpm:
            enc.encode_bin(ctx.off("prev_intra_luma_pred"), 1)
            idx = mpm.index(mode)
            enc.encode_bypass(0 if idx == 0 else 1)
            if idx:
                enc.encode_bypass(idx - 1)
        else:
            enc.encode_bin(ctx.off("prev_intra_luma_pred"), 0)
            rem = mode
            for c in sorted(mpm, reverse=True):
                if mode > c:
                    rem -= 1
            enc.encode_bypass_bins(rem, 5)
        enc.encode_bin(ctx.off("chroma_pred_mode"), 0)  # DM

    # video_codecs_tpu/models/hevc/inter_codec.py:770
    def _encode_mvd(self, enc, mvd):
        ax, ay = abs(mvd[0]), abs(mvd[1])
        enc.encode_bin(ctx.off("mvd", 0), 1 if ax > 0 else 0)
        enc.encode_bin(ctx.off("mvd", 0), 1 if ay > 0 else 0)
        if ax > 0:
            enc.encode_bin(ctx.off("mvd", 1), 1 if ax > 1 else 0)
        if ay > 0:
            enc.encode_bin(ctx.off("mvd", 1), 1 if ay > 1 else 0)
        for a, v in ((ax, mvd[0]), (ay, mvd[1])):
            if a > 0:
                if a > 1:
                    _write_eg1(enc, a - 2)
                enc.encode_bypass(1 if v < 0 else 0)


# video_codecs_tpu/models/hevc/inter_codec.py:788
def _write_eg1(enc, symbol: int) -> None:
    """1st-order Exp-Golomb, bypass (HM xWriteEpExGolomb count=1)."""
    count = 1
    while symbol >= (1 << count):
        enc.encode_bypass(1)
        symbol -= 1 << count
        count += 1
    enc.encode_bypass(0)
    enc.encode_bypass_bins(symbol, count)


# video_codecs_tpu/models/hevc/inter_codec.py:799
def _read_eg1(dec) -> int:
    count = 1
    value = 0
    while dec.decode_bypass():
        value += 1 << count
        count += 1
    return value + dec.decode_bypass_bins(count)


# video_codecs_tpu/models/hevc/inter_codec.py:808
def encode_cu_qp_delta(enc, delta: int) -> None:
    """cu_qp_delta_abs TU(5)+EG0 with ctx dqp[0]/dqp[1], then sign
    (TEncSbac codeDeltaQP; spec 9.3.3.8)."""
    a = abs(delta)
    pre = min(a, 5)
    if pre == 0:
        enc.encode_bin(ctx.off("dqp", 0), 0)
    else:
        enc.encode_bin(ctx.off("dqp", 0), 1)
        for _ in range(1, pre):
            enc.encode_bin(ctx.off("dqp", 1), 1)
        if pre < 5:
            enc.encode_bin(ctx.off("dqp", 1), 0)
    if a >= 5:
        sym = a - 5            # 0th-order Exp-Golomb, bypass
        count = 0
        while sym >= (1 << count):
            enc.encode_bypass(1)
            sym -= 1 << count
            count += 1
        enc.encode_bypass(0)
        if count:
            enc.encode_bypass_bins(sym, count)
    if a:
        enc.encode_bypass(1 if delta < 0 else 0)


# video_codecs_tpu/models/hevc/inter_codec.py:835
def decode_cu_qp_delta(dec) -> int:
    a = 0
    if dec.decode_bin(ctx.off("dqp", 0)):
        a = 1
        while a < 5 and dec.decode_bin(ctx.off("dqp", 1)):
            a += 1
    if a >= 5:
        count = 0
        value = 0
        while dec.decode_bypass():
            value += 1 << count
            count += 1
        if count:
            value += dec.decode_bypass_bins(count)
        a = 5 + value
    if a and dec.decode_bypass():
        return -a
    return a


# video_codecs_tpu/models/hevc/inter_codec.py:855
def _satd8(a: np.ndarray, preds: list) -> list[int]:
    """The 8x8 Hadamard SATD of one 16x16 block against each of `preds`.

    The reference computes one SATD a call, a device dispatch each, about
    six a block in its raster loop.  The port takes a block's candidates
    (its merge candidates and its intra prediction) together and runs
    the port's `hadamard_satd_8x8` once on CPU tensors: on the card each
    call would be a launch and a synchronisation for a few hundred
    samples.  The integers are the reference's, on any device."""
    b = torch.from_numpy(np.stack([np.asarray(p, np.int32) for p in preds]))
    a = torch.from_numpy(np.asarray(a, np.int32))[None]
    return cost_ops.hadamard_satd_8x8(a, b).tolist()


# video_codecs_tpu/models/hevc/inter_codec.py:866
class LowDelayDecoder(ic.IntraDecoder):
    """Decodes IDR + TRAIL_R P-slice streams of this build.

    With conceal=True, lost/corrupt P pictures are concealed by frame copy
    (the reference's erc_do_p.c frame-copy mode; SURVEY.md §5 failure
    detection) so packet-loss streams still yield a full-length output.
    """

    # video_codecs_tpu/models/hevc/inter_codec.py:874
    def __init__(self, conceal: bool = False) -> None:
        super().__init__()
        self._dpb: list[tuple] = []   # (poc, planes, MotionField) newest 1st
        self.conceal = conceal
        self.concealed: list[int] = []
        # decoder-analyser style mode statistics (dec_statistics.c parity)
        self.stats: dict = {"merge_idx": {}, "ref_idx": {}}

    # video_codecs_tpu/models/hevc/inter_codec.py:882
    @property
    def _ref(self):
        return self._dpb[0][1] if self._dpb else None

    # video_codecs_tpu/models/hevc/inter_codec.py:886
    def _store(self, poc, frame, mf=None):
        if mf is None:
            bw = self.cfg.width // 16
            bh = self.cfg.height // 16
            mf = motion.MotionField.empty(bw, bh, poc)
        self._dpb.insert(0, (poc, frame, mf))
        if self.cfg.long_term_idr:
            self._dpb[:] = self._dpb[:8] + \
                [e for e in self._dpb[8:] if e[0] == 0]
        else:
            del self._dpb[8:]

    # video_codecs_tpu/models/hevc/inter_codec.py:900
    def decode(self, stream: bytes):
        frames = []
        for nal in bs.split_annexb(stream):
            nal_type = (nal[0] >> 1) & 0x3F
            rbsp = bs.strip_emulation_prevention(nal[2:])
            if nal_type == bs.NAL_VPS:
                continue
            if nal_type == bs.NAL_SPS:
                self.cfg = headers.parse_sps(rbsp)
            elif nal_type == bs.NAL_PPS:
                self.pps = headers.parse_pps(rbsp)
            elif nal_type in (bs.NAL_IDR_W_RADL, bs.NAL_IDR_N_LP, bs.NAL_CRA):
                frame = self._decode_slice(rbsp, nal_type)
                frames.append(frame)
                self._dpb = []
                self._store(0, frame)
            elif nal_type == NAL_TRAIL_R:
                if self.conceal:
                    try:
                        frame, poc, mf = self._decode_p_slice(rbsp)
                    except Exception:
                        frame = tuple(p.copy() for p in self._ref)
                        poc = self._dpb[0][0] + 1
                        mf = None
                        self.concealed.append(len(frames))
                else:
                    frame, poc, mf = self._decode_p_slice(rbsp)
                frames.append(frame)
                self._store(poc, frame, mf)
            elif nal_type == bs.NAL_SUFFIX_SEI:
                import hashlib
                md5s = self._parse_hash_sei(rbsp)
                if md5s and frames:
                    ok = all(
                        hashlib.md5(frames[-1][i].astype(np.uint8).tobytes())
                        .digest() == md5s[i] for i in range(3))
                    self.hash_status.append(ok)
        return frames

    # video_codecs_tpu/models/hevc/inter_codec.py:939
    def _decode_p_slice(self, rbsp: bytes):
        cfg, pps = self.cfg, self.pps
        h = parse_p_slice_header(rbsp, pps, sps_tmvp=cfg.temporal_mvp,
                                 sps_sao=cfg.sao, sps_lt=cfg.long_term_idr)
        poc, qp, wp = h.poc, h.qp, h.wp
        qp_c = ic.chroma_qp(qp)
        bw, bh = cfg.width // 16, cfg.height // 16
        if h.lt_pocs:
            # L0 = st-used pics (none here) + long-term pics, lsb-matched
            refs = []
            for lsb in h.lt_pocs:
                cand = [e for e in self._dpb if (e[0] & 255) == lsb]
                assert cand, f"long-term reference lsb {lsb} not in DPB"
                refs.append(max(cand, key=lambda e: e[0]))
        else:
            refs = self._dpb[:h.n_refs]
        assert len(refs) == h.n_refs, "missing reference pictures"
        ref_pocs = [p for (p, _, _) in refs]
        ref_planes = [tuple(pl.astype(np.int32) for pl in planes)
                      for (_, planes, _) in refs]
        col_field = refs[0][2] if h.tmvp else None

        data = rbsp[h.data_offset_bits // 8:]
        states = ctx.init_states(ctx.P, qp)
        dec = cabac.CabacDecoder(bs.BitReader(data), states)

        rec_y = np.zeros((cfg.height, cfg.width), np.int32)
        rec_u = np.zeros((cfg.height // 2, cfg.width // 2), np.int32)
        rec_v = np.zeros_like(rec_u)
        info: list[list[BlockInfo | None]] = [[None] * bw for _ in range(bh)]
        grid = motion.NeighborGrid(info, bw, bh)
        self._prev_qp = qp           # qPY_PREV (QG == CTB == CU here)
        sao_params = [[None] * 3 for _ in range(bw * bh)]

        for by in range(bh):
            for bx in range(bw):
                if h.sao:
                    ic.decode_sao_ctu(dec, sao_params, by * bw + bx,
                                      bx, by, bw, 0)
                b = self._decode_p_ctu(dec, info, grid, bx, by, h, ref_pocs,
                                       poc, col_field)
                info[by][bx] = b
                xx, yy = bx * 16, by * 16
                cx, cy = xx // 2, yy // 2
                if b.pred_mode == MODE_INTRA:
                    ref_arr = ic.build_ref_np(rec_y, xx, yy, 16)
                    pred = intra_ops.predict_intra_np(ref_arr, b.intra_mode, 4)
                else:
                    ref_y = ref_planes[b.ref_idx][0]
                    pred = (interp.mc_luma_np(ref_y, xx, yy, *b.mv, 16)
                            if wp is None else
                            interp.mc_luma_wp_np(ref_y, xx, yy, *b.mv, 16,
                                                 wp["w"][0], wp["o"][0],
                                                 wp["denom"]))
                rec_y[yy:yy + 16, xx:xx + 16] = _recon_tb(
                    pred, b.levels_y, b.qp, 4)
                bqp_c = ic.chroma_qp(b.qp)
                for comp, pr in ((0, rec_u), (1, rec_v)):
                    if b.pred_mode == MODE_INTRA:
                        refc = ic.build_ref_np(pr, cx, cy, 8)
                        predc = intra_ops.predict_intra_np(
                            refc, b.intra_mode, 3, is_luma=False)
                    else:
                        rp = ref_planes[b.ref_idx][1 + comp]
                        predc = (interp.mc_chroma_np(rp, cx, cy, *b.mv, 8)
                                 if wp is None else
                                 interp.mc_chroma_wp_np(
                                     rp, cx, cy, *b.mv, 8,
                                     wp["w"][1 + comp], wp["o"][1 + comp],
                                     wp["denom_c"]))
                    lvc = b.levels_cb if comp == 0 else b.levels_cr
                    pr[cy:cy + 8, cx:cx + 8] = _recon_tb(predc, lvc, bqp_c, 3)
                end = dec.decode_terminate()
                last = (by == bh - 1 and bx == bw - 1)
                assert end == (1 if last else 0)

        mf = motion.MotionField.empty(bw, bh, poc)
        for by in range(bh):
            for bx in range(bw):
                b = info[by][bx]
                if b.pred_mode == MODE_INTER:
                    mf.inter[by, bx] = True
                    mf.mv[by, bx] = b.mv
                    mf.ref_poc[by, bx] = b.ref_poc

        if not pps.deblocking_disabled:
            bs_ver, bs_hor = compute_bs_maps(info, bw, bh)
            dq_map = None
            if pps.cu_qp_delta:
                dq_map = np.array([[info[r][c].qp for c in range(bw)]
                                   for r in range(bh)], np.int32)
            rec_y, rec_u, rec_v = deblock_ops.deblock_420_bs_np(
                rec_y, rec_u, rec_v, qp, bs_ver, bs_hor, qp_map=dq_map)
        if h.sao:
            # the reference's apply_ctu loop, with each EO class's map
            # computed once per plane instead of once per CTB
            rec_y, rec_u, rec_v = (
                sao_ops.apply_ctus(p, [p3[c] for p3 in sao_params],
                                   16 if c == 0 else 8, bw)
                for c, p in enumerate((rec_y, rec_u, rec_v)))
        return (rec_y, rec_u, rec_v), poc, mf

    # video_codecs_tpu/models/hevc/inter_codec.py:1050
    def _apply_dqp(self, dec, b, parse: bool = True) -> None:
        """Per-CU QP derivation (spec 8.6.1 with QG == CTB == CU: the
        predictor collapses to the previous CU's QP in decode order)."""
        if not self.pps.cu_qp_delta:
            b.qp = self._prev_qp
            return
        has_res = b.cbf_y or b.cbf_cb or b.cbf_cr
        if parse and has_res:
            delta = decode_cu_qp_delta(dec)
            b.qp_delta = delta
            b.qp = ((self._prev_qp + delta + 52) % 52)
            self._prev_qp = b.qp
        else:
            b.qp = self._prev_qp

    # video_codecs_tpu/models/hevc/inter_codec.py:1065
    def _decode_merge_idx(self, dec, merge_cands: int) -> int:
        if merge_cands <= 1:
            return 0
        if not dec.decode_bin(ctx.off("merge_idx")):
            return 0
        idx = 1
        while idx < merge_cands - 1 and dec.decode_bypass():
            idx += 1
        return idx

    # video_codecs_tpu/models/hevc/inter_codec.py:1075
    @staticmethod
    def _decode_ref_idx(dec, n_refs: int) -> int:
        if n_refs <= 1:
            return 0
        if not dec.decode_bin(ctx.off("ref_idx", 0)):
            return 0
        idx = 1
        for k in range(1, n_refs - 1):
            bin_v = (dec.decode_bin(ctx.off("ref_idx", 1)) if k == 1
                     else dec.decode_bypass())
            if not bin_v:
                break
            idx += 1
        return idx

    # video_codecs_tpu/models/hevc/inter_codec.py:1090
    def _decode_p_ctu(self, dec, info, grid, bx, by, h, ref_pocs, poc,
                      col_field) -> BlockInfo:
        b = BlockInfo()
        bw, bh = self.cfg.width // 16, self.cfg.height // 16
        left = info[by][bx - 1] if bx else None
        above = info[by - 1][bx] if by else None
        skip_ctx = (1 if (left and left.skip) else 0) + \
                   (1 if (above and above.skip) else 0)

        # skip CUs carry no residual: QP = qPY_PRED (no delta coded)
        def apply_merge(idx):
            cands = motion.merge_candidates(grid, bx, by, ref_pocs, poc,
                                            col_field, h.merge_cands, h.tmvp)
            b.merge_idx = idx
            b.mv, b.ref_idx = cands[idx]
            b.ref_poc = ref_pocs[b.ref_idx]
            self.stats["merge_idx"][idx] = \
                self.stats["merge_idx"].get(idx, 0) + 1

        if dec.decode_bin(ctx.off("skip_flag", skip_ctx)):
            b.skip = True
            b.merge = True
            b.pred_mode = MODE_INTER
            apply_merge(self._decode_merge_idx(dec, h.merge_cands))
            b.qp = self._prev_qp
            return b
        if dec.decode_bin(ctx.off("pred_mode")):
            b.pred_mode = MODE_INTRA
            assert dec.decode_bin(ctx.off("part_size")) == 1
            left_mode = (left.intra_mode
                         if left and left.pred_mode == MODE_INTRA else DC)
            mpm = ic.mpm_list(left_mode)
            if dec.decode_bin(ctx.off("prev_intra_luma_pred")):
                idx = 0 if dec.decode_bypass() == 0 else 1 + dec.decode_bypass()
                b.intra_mode = mpm[idx]
            else:
                rem = dec.decode_bypass_bins(5)
                for c in sorted(mpm):
                    if rem >= c:
                        rem += 1
                b.intra_mode = rem
            assert dec.decode_bin(ctx.off("chroma_pred_mode")) == 0
            b.cbf_cb = bool(dec.decode_bin(ctx.off("cbf_chroma")))
            b.cbf_cr = bool(dec.decode_bin(ctx.off("cbf_chroma")))
            b.cbf_y = bool(dec.decode_bin(ctx.off("cbf_luma", 1)))
            self._apply_dqp(dec, b)
        else:
            b.pred_mode = MODE_INTER
            assert dec.decode_bin(ctx.off("part_size")) == 1
            b.merge = bool(dec.decode_bin(ctx.off("merge_flag")))
            if b.merge:
                apply_merge(self._decode_merge_idx(dec, h.merge_cands))
            else:
                b.ref_idx = self._decode_ref_idx(dec, h.n_refs)
                self.stats["ref_idx"][b.ref_idx] = \
                    self.stats["ref_idx"].get(b.ref_idx, 0) + 1
                b.ref_poc = ref_pocs[b.ref_idx]
                b.mvd = self._decode_mvd(dec)
                b.mvp_idx = dec.decode_bin(ctx.off("mvp_idx"))
                amvp = motion.amvp_candidates(grid, bx, by, b.ref_idx,
                                              ref_pocs, poc, col_field,
                                              h.tmvp)
                p = amvp[b.mvp_idx]
                b.mv = (p[0] + b.mvd[0], p[1] + b.mvd[1])
            if not b.merge:
                if not dec.decode_bin(ctx.off("qt_root_cbf")):
                    self._apply_dqp(dec, b, parse=False)
                    return b
            b.cbf_cb = bool(dec.decode_bin(ctx.off("cbf_chroma")))
            b.cbf_cr = bool(dec.decode_bin(ctx.off("cbf_chroma")))
            if b.cbf_cb or b.cbf_cr:
                b.cbf_y = bool(dec.decode_bin(ctx.off("cbf_luma", 1)))
            else:
                b.cbf_y = True  # inferred (rootCbf promised residual)
            self._apply_dqp(dec, b)
        if b.cbf_y:
            b.levels_y = residual.decode_residual(dec, 4, rom.SCAN_DIAG, True, sign_hiding=self.pps.sign_data_hiding)
        if b.cbf_cb:
            b.levels_cb = residual.decode_residual(dec, 3, rom.SCAN_DIAG, False, sign_hiding=self.pps.sign_data_hiding)
        if b.cbf_cr:
            b.levels_cr = residual.decode_residual(dec, 3, rom.SCAN_DIAG, False, sign_hiding=self.pps.sign_data_hiding)
        return b

    # video_codecs_tpu/models/hevc/inter_codec.py:1175
    @staticmethod
    def _decode_mvd(dec) -> tuple[int, int]:
        gx = dec.decode_bin(ctx.off("mvd", 0))
        gy = dec.decode_bin(ctx.off("mvd", 0))
        g1x = dec.decode_bin(ctx.off("mvd", 1)) if gx else 0
        g1y = dec.decode_bin(ctx.off("mvd", 1)) if gy else 0
        out = []
        for g, g1 in ((gx, g1x), (gy, g1y)):
            if not g:
                out.append(0)
                continue
            a = 1
            if g1:
                a = 2 + _read_eg1(dec)
            sign = dec.decode_bypass()
            out.append(-a if sign else a)
        return (out[0], out[1])


# video_codecs_tpu/models/hevc/inter_codec.py:1194
def _recon_tb(pred: np.ndarray, levels: np.ndarray | None, qp: int,
              log2: int) -> np.ndarray:
    if levels is None:
        return pred.astype(np.int32)
    dq = quant_ops.dequantize_np(levels, qp, log2)
    r = tr_ops.inverse_transform_np(dq, log2)
    return np.clip(pred + r, 0, 255).astype(np.int32)
