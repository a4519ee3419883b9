"""Host half of the HEVC low-delay P encoder: the per-block coding state,
the P-slice header and CABAC syntax, the picture loop over the DPB, and
the helpers the random-access encoders share (the MVD rate estimate, the
merge-index and MVD binarizations, the decoder's Exp-Golomb read).

The port's copy of video_codecs_tpu/models/hevc/inter_codec.py; each
function keeps its name and a comment gives the original's line.  The
P pictures are coded by the device engine
(models/hevc/inter_dev.DeviceLowDelayEncoder); this module's
`encode_p_frame`, the host decision loop, raises NotImplementedError.
`encode_frames` takes a picture-level rate controller
(models/hevc/ratectrl.py), resumes from a checkpoint state
(models/hevc/checkpoint.py), writes the HRD timing SEI of
models/hevc/sei.py (`cfg.timing_sei`) and keeps the IDR as the one
long-term reference (`cfg.long_term_idr`; the two cases the reference
writes wrongly, a picture past POC 255 and a checkpoint resume, raise
ValueError); the P slice carries the sao() syntax (`cfg.sao`).  Cut:
weighted prediction and cu_qp_delta.  Not ported: the P-slice parser
and `LowDelayDecoder` (the port decodes with
models/hevc/decoder.GeneralDecoder), the weighted-prediction estimate
and the single-candidate flat MV predictors.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from video_codecs_tpu_torch.entropy import bitstream as bs
from video_codecs_tpu_torch.entropy import cabac, ctx, residual
from video_codecs_tpu_torch.models.hevc import checkpoint, headers, motion
from video_codecs_tpu_torch.models.hevc import intra_codec as ic
from video_codecs_tpu_torch.models.hevc import sei as sei_mod
from video_codecs_tpu_torch.utils import rom

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


# video_codecs_tpu/models/hevc/inter_codec.py:180
def write_p_slice_header(cfg: headers.HevcConfig, poc: int, n_refs: int = 1):
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
    w.ue(5 - cfg.merge_cands)  # five_minus_max_num_merge_cand
    w.se(cfg.qp - 26)  # slice_qp_delta
    if not cfg.deblocking_disabled:
        w.flag(1)      # slice_loop_filter_across_slices_enabled_flag
    w.byte_alignment()
    return w


# video_codecs_tpu/models/hevc/inter_codec.py:331
class LowDelayEncoder(ic.IntraEncoder):
    """IPPP encoder: frame 0 IDR intra, then P frames."""

    # video_codecs_tpu/models/hevc/inter_codec.py:334
    def __init__(self, cfg: headers.HevcConfig, search_range: int = 8,
                 me_method: str = "auto") -> None:
        super().__init__(cfg)
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
        """The host decision loop is not ported: the device engine
        (inter_dev.DeviceLowDelayEncoder) codes P pictures."""
        raise NotImplementedError(
            "LowDelayEncoder.encode_p_frame: the host P coder is not ported "
            "(inter_dev.DeviceLowDelayEncoder)")

    # video_codecs_tpu/models/hevc/inter_codec.py:645
    def _encode_p_slice(self, info, poc, n_refs: int = 1,
                        sao_params=None) -> bytes:
        cfg = self.cfg
        bw, bh = cfg.width // 16, cfg.height // 16
        w = write_p_slice_header(cfg, poc, n_refs)
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
