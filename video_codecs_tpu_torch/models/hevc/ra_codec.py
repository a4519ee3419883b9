"""Random-access hierarchical-B GOP loop: GOPEntry tables, the RA
slice header, the coding-order loop `encode_sequence_ra`, the flat
16x16 RA slice writer `_encode_b_slice` and `_encode_b_frame`, which
tags the picture's reference-ness for its NAL type.

The port's copy of the part of video_codecs_tpu/models/hevc/ra_codec.py
that the random-access encoders (the CTB32 quadtree one of
models/hevc/inter_qt.py and the flat CTB16 one of
models/hevc/inter_dev.py) run; each function keeps its name and a
comment gives the original's line.  Cut: the HM cfg parser
`parse_gop_entries`, `parse_ra_slice_header` and `RandomAccessDecoder`
(the port decodes with models/hevc/decoder.py).
"""

from __future__ import annotations

import dataclasses

from video_codecs_tpu_torch.entropy import bitstream as bs
from video_codecs_tpu_torch.entropy import cabac, ctx
from video_codecs_tpu_torch.models.hevc import bframe_codec as bc
from video_codecs_tpu_torch.models.hevc import headers
from video_codecs_tpu_torch.models.hevc import intra_codec as ic

L0, L1 = 0, 1
NAL_TRAIL_N, NAL_TRAIL_R = 0, 1


# video_codecs_tpu/models/hevc/ra_codec.py:36
@dataclasses.dataclass
class GOPEntry:
    """One FrameN line (TEncCfg.h:49-88)."""
    slice_type: str = "B"
    poc: int = 0                  # display offset within the GOP (1..GOP)
    qp_offset: int = 0
    qp_factor: float = 1.0
    tc_offset_div2: int = 0
    beta_offset_div2: int = 0
    temporal_id: int = 0
    num_ref_pics_active: int = 1
    ref_pics: tuple = ()          # POC deltas (negative = past)


# The stock encoder_randomaccess_main.cfg GOP-8 pyramid (cfg:24-33).
GOP8_RA = (
    GOPEntry("B", 8, 1, 0.442, 0, 0, 0, 2, (-8, -12, -16)),
    GOPEntry("B", 4, 2, 0.3536, 0, 0, 1, 2, (-4, -8, 4)),
    GOPEntry("B", 2, 3, 0.3536, 0, 0, 2, 2, (-2, -6, 2, 6)),
    GOPEntry("B", 1, 4, 0.68, 0, 0, 3, 2, (-1, 1, 3, 7)),
    GOPEntry("B", 3, 4, 0.68, 0, 0, 3, 2, (-1, -3, 1, 5)),
    GOPEntry("B", 6, 3, 0.3536, 0, 0, 2, 2, (-2, -6, 2)),
    GOPEntry("B", 5, 4, 0.68, 0, 0, 3, 2, (-1, -5, 1, 3)),
    GOPEntry("B", 7, 4, 0.68, 0, 0, 3, 2, (-1, -3, -7, 1)),
)


# video_codecs_tpu/models/hevc/ra_codec.py:84
def write_ra_slice_header(cfg, poc: int, slice_type: int, qp: int,
                          neg: list[tuple[int, bool]],
                          pos: list[tuple[int, bool]],
                          n0: int = 1, n1: int = 1):
    """B/P slice header with an explicit multi-entry RPS.

    neg: [(delta_poc, used)] with delta < 0, closest first;
    pos: [(delta_poc, used)] with delta > 0, closest first;
    n0/n1: num_ref_idx_active per list (override written when != 1).
    """
    w = bs.BitWriter()
    w.flag(1)                      # first_slice_segment_in_pic_flag
    w.ue(0)                        # pps id
    w.ue(slice_type)               # 0 = B, 1 = P
    w.write(poc & 255, 8)
    w.flag(0)                      # short_term_ref_pic_set_sps_flag
    w.ue(len(neg))
    w.ue(len(pos))
    prev = 0
    for d, used in neg:
        w.ue(prev - d - 1)         # delta_poc_s0_minus1 (gap to previous)
        w.flag(1 if used else 0)
        prev = d
    prev = 0
    for d, used in pos:
        w.ue(d - prev - 1)
        w.flag(1 if used else 0)
        prev = d
    if cfg.temporal_mvp:
        w.flag(1)                  # slice_temporal_mvp_enabled_flag
    if cfg.sao:
        w.flag(1)                  # slice_sao_luma_flag
        w.flag(1)                  # slice_sao_chroma_flag
    override = n0 != 1 or (slice_type == 0 and n1 != 1)
    w.flag(1 if override else 0)   # num_ref_idx_active_override
    if override:
        w.ue(n0 - 1)
        if slice_type == 0:
            w.ue(n1 - 1)
    if slice_type == 0:
        w.flag(0)                  # mvd_l1_zero_flag
    if cfg.temporal_mvp:
        if slice_type == 0:
            w.flag(0)              # collocated_from_l0 = 0 (list 1)
        col_l0 = slice_type != 0   # P slices: inferred 1
        if (col_l0 and n0 > 1) or (not col_l0 and n1 > 1):
            w.ue(0)                # collocated_ref_idx
    w.ue(5 - cfg.merge_cands)      # five_minus_max_num_merge_cand
    w.se(qp - 26)
    if not cfg.deblocking_disabled:
        w.flag(1)
    w.byte_alignment()
    return w


# video_codecs_tpu/models/hevc/ra_codec.py:180
class RandomAccessEncoder(bc.HierarchicalBEncoder):
    """GOP-driven hierarchical-B encoder (BASELINE config 3 structure)."""

    # video_codecs_tpu/models/hevc/ra_codec.py:183
    def __init__(self, cfg: headers.HevcConfig, gop: tuple = GOP8_RA,
                 search_range: int = 8, me_method: str = "auto") -> None:
        super().__init__(cfg, search_range, me_method)
        self.gop = tuple(gop)
        self.gop_size = max(e.poc for e in gop)

    # video_codecs_tpu/models/hevc/ra_codec.py:189
    def encode_sequence_ra(self, frames):
        """frames in display order; returns (annexb stream, recons in
        display order)."""
        cfg = self.cfg
        base_qp = cfg.qp
        nals = self.stream_headers()
        recons: dict[int, tuple] = {}
        dpb: dict[int, tuple] = {}

        cfg.qp = base_qp
        fn, rec = self.encode_frame(*frames[0])
        nals.extend(fn)
        recons[0] = rec
        dpb[0] = rec

        n = len(frames)
        gop_start = 0
        while gop_start < n - 1:
            for e in self.gop:
                poc = gop_start + e.poc
                if poc >= n:
                    continue
                refs_all = sorted(
                    p for p in (poc + d for d in e.ref_pics)
                    if p in dpb)
                past = [p for p in refs_all if p < poc]
                fut = [p for p in refs_all if p > poc]
                assert past, f"picture {poc} has no past reference"
                refs = {L0: (past[-1], dpb[past[-1]])}
                is_anchor = not fut
                if fut:
                    refs[L1] = (fut[0], dpb[fut[0]])
                # spec 8.3.4 reference lists from the RPS "used" sets:
                # L0 = usedPast (closest first) + usedFut, L1 = usedFut +
                # usedPast, each truncated to the active count (GOPEntry
                # num_ref_pics_active; multi-ref engines read these via
                # self._cur_ref_lists, legacy engines keep `refs`)
                na = min(getattr(self, "num_refs_active", 1),
                         len(past) + len(fut))
                used_past = list(reversed(past))[:na]
                used_fut = fut[:na]
                l0 = (used_past + used_fut)[:na]
                l1 = (used_fut + used_past)[:na] if fut else []
                self._cur_ref_lists = (
                    [(p, dpb[p]) for p in l0],
                    [(p, dpb[p]) for p in l1])
                used = set(l0) | set(l1)
                self._cur_rps = (
                    [(p - poc, p in used) for p in reversed(past)],
                    [(p - poc, p in used) for p in fut])
                cfg.qp = base_qp + e.qp_offset
                fnb, recb = self._encode_b_frame(frames[poc], poc, refs,
                                                 is_anchor)
                self._cur_rps = None
                nals.extend(fnb)
                recons[poc] = recb
                if e.temporal_id < 3:      # leaves are non-reference
                    dpb[poc] = recb
                # retention: keep only pictures future entries may need
                keep = {poc}
                for e2 in self.gop:
                    for d in e2.ref_pics:
                        keep.add(gop_start + e2.poc + d)
                        keep.add(gop_start + self.gop_size + e2.poc + d)
                dpb = {p: v for p, v in dpb.items() if p in keep}
            gop_start += self.gop_size
        cfg.qp = base_qp
        return bs.annexb(nals), [recons[k] for k in sorted(recons)]

    # video_codecs_tpu/models/hevc/ra_codec.py:258
    def _encode_b_slice(self, info, poc, is_anchor, ref_poc, neg_delta=2,
                        sao_params=None):
        rps = getattr(self, "_cur_rps", None)
        if rps is None:
            return super()._encode_b_slice(info, poc, is_anchor, ref_poc,
                                           neg_delta, sao_params)
        cfg = self.cfg
        bw, bh = cfg.width // 16, cfg.height // 16
        neg, pos = rps
        w = write_ra_slice_header(cfg, poc, 1 if is_anchor else 0,
                                  cfg.qp, neg, pos)
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
        nal_type = NAL_TRAIL_R if self._cur_is_ref else NAL_TRAIL_N
        return bs.nal_unit(nal_type, w.data())

    # video_codecs_tpu/models/hevc/ra_codec.py:283
    def _encode_b_frame(self, frame, poc, refs, is_anchor):
        # tag reference-ness for the NAL type before serialization
        e = next((e for e in self.gop
                  if (poc - e.poc) % self.gop_size == 0), None)
        self._cur_is_ref = e is None or e.temporal_id < 3
        return super()._encode_b_frame(frame, poc, refs, is_anchor)
