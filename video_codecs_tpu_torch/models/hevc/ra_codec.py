"""Random-access hierarchical-B GOP loop driven by GOPEntry tables:
HM's `FrameN:` cfg lines (`parse_gop_entries`), the RA slice header
(written and parsed), the coding-order loop `encode_sequence_ra`, the
flat 16x16 RA slice writer `_encode_b_slice`, `_encode_b_frame`, which
tags the picture's reference-ness for its NAL type, and
`RandomAccessDecoder`.

The port's copy of video_codecs_tpu/models/hevc/ra_codec.py; each
function keeps its name and a comment gives the original's line.
`RandomAccessEncoder` is what the reference's encoder CLI builds for
HM's encoder_randomaccess_main.cfg: the host flat 16x16 B coder of
models/hevc/bframe_codec.py under the GOP table.  The device encoders
(the CTB32 quadtree one of models/hevc/inter_qt.py and the flat CTB16
one of models/hevc/inter_dev.py) derive from it.  `RandomAccessDecoder`
runs on the host with the numpy twins, as the reference's does;
models/hevc/decoder.GeneralDecoder decodes the same streams.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from video_codecs_tpu_torch.entropy import bitstream as bs
from video_codecs_tpu_torch.entropy import cabac, ctx
from video_codecs_tpu_torch.models.hevc import bframe_codec as bc
from video_codecs_tpu_torch.models.hevc import headers
from video_codecs_tpu_torch.models.hevc import intra_codec as ic
from video_codecs_tpu_torch.models.hevc import inter_codec as pc
from video_codecs_tpu_torch.ops import deblock as deblock_ops
from video_codecs_tpu_torch.ops import interp
from video_codecs_tpu_torch.ops import intra as intra_ops
from video_codecs_tpu_torch.ops import sao as sao_ops

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


# video_codecs_tpu/models/hevc/ra_codec.py:63
def parse_gop_entries(cfg_text: str) -> list[GOPEntry]:
    """Parse FrameN lines from an HM cfg (TAppEncCfg GOPEntry istream)."""
    out = []
    for m in re.finditer(r"^Frame(\d+)\s*:\s*(.+)$", cfg_text, re.M):
        f = m.group(2).split("#")[0].split()
        st, poc, qpo, qpf = f[0], int(f[1]), int(f[2]), float(f[3])
        tc, beta, tid = int(f[4]), int(f[5]), int(f[6])
        n_active, n_refs = int(f[7]), int(f[8])
        refs = tuple(int(x) for x in f[9:9 + n_refs])
        out.append(GOPEntry(st, poc, qpo, qpf, tc, beta, tid,
                            n_active, refs))
    out.sort(key=lambda e: e.poc)
    # restore coding order: the file lists entries in coding order already
    order = []
    for m in re.finditer(r"^Frame(\d+)\s*:\s*(.+)$", cfg_text, re.M):
        f = m.group(2).split("#")[0].split()
        order.append(int(f[1]))
    by_poc = {e.poc: e for e in out}
    return [by_poc[p] for p in order]



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


# video_codecs_tpu/models/hevc/ra_codec.py:139
def parse_ra_slice_header(rbsp: bytes, pps, sps_sao: bool = False,
                          sps_tmvp: bool = False):
    r = bs.BitReader(rbsp)
    assert r.flag() == 1
    assert r.ue() == 0
    st = r.ue()
    poc = r.read(8)
    assert r.flag() == 0
    n_neg, n_pos = r.ue(), r.ue()
    neg, pos = [], []
    prev = 0
    for _ in range(n_neg):
        prev = prev - r.ue() - 1
        neg.append((prev, bool(r.flag())))
    prev = 0
    for _ in range(n_pos):
        prev = prev + r.ue() + 1
        pos.append((prev, bool(r.flag())))
    if sps_tmvp:
        assert r.flag() == 0, \
            "TMVP RA streams: decode with GeneralDecoder"
    sao = False
    if sps_sao:
        sao = bool(r.flag())
        assert bool(r.flag()) == sao, "joint luma+chroma SAO expected"
    if r.flag():                   # num_ref_idx_active_override
        n0 = 1 + r.ue()
        n1 = (1 + r.ue()) if st == 0 else 1
        assert n0 == 1 and n1 == 1, \
            "multi-ref RA streams: decode with GeneralDecoder"
    if st == 0:
        r.flag()                   # mvd_l1_zero
    merge_cands = 5 - r.ue()
    qp = pps.init_qp + r.se()
    if not pps.deblocking_disabled:
        r.flag()
    assert r.flag() == 1
    r.byte_align()
    return st, poc, qp, neg, pos, merge_cands, r.bit_pos(), sao



# video_codecs_tpu/models/hevc/ra_codec.py:180
class RandomAccessEncoder(bc.HierarchicalBEncoder):
    """GOP-driven hierarchical-B encoder (BASELINE config 3 structure)."""

    # video_codecs_tpu/models/hevc/ra_codec.py:183
    def __init__(self, cfg: headers.HevcConfig, gop: tuple = GOP8_RA,
                 search_range: int = 8, me_method: str = "auto", *,
                 device="cuda") -> None:
        """The flat RA header signals cfg.merge_cands while the flat CU
        writer codes no merge_idx (`_encode_b_ctu`): merge_cands other
        than 1 raises ValueError, as TMVP does (HierarchicalBEncoder)."""
        if self.flat_syntax and cfg.merge_cands != 1:
            raise ValueError(
                f"{type(self).__name__}: merge_cands must be 1: the flat "
                "CU writer codes no merge_idx (bframe_codec._encode_b_ctu) "
                "while the slice header signals MaxNumMergeCand")
        super().__init__(cfg, search_range, me_method, device=device)
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


# video_codecs_tpu/models/hevc/ra_codec.py:291
class RandomAccessDecoder(bc.HierarchicalBDecoder):
    """Decodes GOPEntry-driven RA streams (RPS-derived reference lists)."""

    # video_codecs_tpu/models/hevc/ra_codec.py:294
    def decode(self, stream: bytes):
        from video_codecs_tpu_torch.models.hevc.decoder import \
            _strip_ep_with_pos
        import hashlib
        out: dict[int, tuple] = {}
        self._dpb: dict[int, tuple] = {}
        last_poc = None
        for nal in bs.split_annexb(stream):
            nal_type = (nal[0] >> 1) & 0x3F
            # the emulation bytes' positions convert tile / WPP
            # entry points (intra_codec.substream_starts)
            rbsp, self._cur_emu = _strip_ep_with_pos(nal[2:])
            if nal_type == bs.NAL_VPS:
                continue
            if nal_type == bs.NAL_SPS:
                self.cfg = headers.parse_sps(rbsp)
            elif nal_type == bs.NAL_PPS:
                self.pps = headers.parse_pps(rbsp)
            elif nal_type in (bs.NAL_IDR_W_RADL, bs.NAL_IDR_N_LP):
                frame = self._decode_slice(rbsp, nal_type)
                out[0] = frame
                self._dpb = {0: frame}
                last_poc = 0
            elif nal_type in (NAL_TRAIL_N, NAL_TRAIL_R):
                poc, frame = self._decode_ra_slice(rbsp,
                                                   nal_type == NAL_TRAIL_R)
                out[poc] = frame
                last_poc = poc
            elif nal_type == bs.NAL_SUFFIX_SEI:
                md5s = self._parse_hash_sei(rbsp)
                if md5s and last_poc is not None:
                    ok = all(hashlib.md5(out[last_poc][i].astype(np.uint8)
                                         .tobytes()).digest() == md5s[i]
                             for i in range(3))
                    self.hash_status.append(ok)
        return [out[k] for k in sorted(out)]

    # video_codecs_tpu/models/hevc/ra_codec.py:327
    def _decode_ra_slice(self, rbsp: bytes, is_ref: bool):
        st, poc, qp, neg, pos, merge_cands, off_bits, sao_on = \
            parse_ra_slice_header(rbsp, self.pps, sps_sao=self.cfg.sao)
        is_anchor = st == 1
        used_past = [poc + d for d, u in neg if u]
        used_fut = [poc + d for d, u in pos if u]
        ref_poc = {L0: max(used_past)}
        if not is_anchor:
            ref_poc[L1] = min(used_fut)
        frame = self._decode_b_body(rbsp, off_bits, poc, qp, is_anchor,
                                    ref_poc, sao_on=sao_on)
        # DPB: retain RPS pictures + this one (if referenced)
        keep = {poc + d for d, _ in neg} | {poc + d for d, _ in pos}
        self._dpb = {p: v for p, v in self._dpb.items() if p in keep}
        if is_ref:
            self._dpb[poc] = frame
        return poc, frame

    # video_codecs_tpu/models/hevc/ra_codec.py:345
    def _decode_b_body(self, rbsp, off_bits, poc, qp, is_anchor, ref_poc,
                       sao_on: bool = False):
        """CTU decode shared with the 2-level decoder (ref planes from the
        RPS-selected DPB pictures)."""
        cfg, pps = self.cfg, self.pps
        ref_planes = {lx: tuple(p.astype(np.int32)
                                for p in self._dpb[rp])
                      for lx, rp in ref_poc.items()}
        qp_c = ic.chroma_qp(qp)
        bw, bh = cfg.width // 16, cfg.height // 16
        data = rbsp[off_bits // 8:]
        init_row = ctx.P if is_anchor else ctx.B
        dec = cabac.CabacDecoder(bs.BitReader(data),
                                 ctx.init_states(init_row, qp))
        rec_y = np.zeros((cfg.height, cfg.width), np.int32)
        rec_u = np.zeros((cfg.height // 2, cfg.width // 2), np.int32)
        rec_v = np.zeros_like(rec_u)
        info = [[None] * bw for _ in range(bh)]
        sbh = pps.sign_data_hiding
        sao_params = [[None] * 3 for _ in range(bw * bh)]

        for by in range(bh):
            for bx in range(bw):
                if sao_on:
                    ic.decode_sao_ctu(dec, sao_params, by * bw + bx,
                                      bx, by, bw, 0)
                b = self._decode_b_ctu(dec, info, bx, by, bw, bh, is_anchor,
                                       poc, ref_poc, sbh)
                info[by][bx] = b
                xx, yy = bx * 16, by * 16
                cx, cy = xx // 2, yy // 2
                if b.pred_mode == bc.MODE_INTRA:
                    ref = ic.build_ref_np(rec_y, xx, yy, 16)
                    pred = intra_ops.predict_intra_np(ref, b.intra_mode, 4)
                elif b.inter_dir == 3:
                    pred = interp.mc_luma_bi_np(
                        ref_planes[L0][0], ref_planes[L1][0], xx, yy,
                        b.mv[L0], b.mv[L1], 16)
                else:
                    lx = L0 if 1 & b.inter_dir else L1
                    pred = interp.mc_luma_np(ref_planes[lx][0], xx, yy,
                                             *b.mv[lx], 16)
                rec_y[yy:yy + 16, xx:xx + 16] = pc._recon_tb(
                    pred, b.levels_y, qp, 4)
                for comp, pr in ((0, rec_u), (1, rec_v)):
                    if b.pred_mode == bc.MODE_INTRA:
                        refc = ic.build_ref_np(pr, cx, cy, 8)
                        predc = intra_ops.predict_intra_np(
                            refc, b.intra_mode, 3, is_luma=False)
                    elif b.inter_dir == 3:
                        predc = interp.mc_chroma_bi_np(
                            ref_planes[L0][1 + comp],
                            ref_planes[L1][1 + comp], cx, cy,
                            b.mv[L0], b.mv[L1], 8)
                    else:
                        lx = L0 if 1 & b.inter_dir else L1
                        predc = interp.mc_chroma_np(
                            ref_planes[lx][1 + comp], cx, cy, *b.mv[lx], 8)
                    lvc = b.levels_cb if comp == 0 else b.levels_cr
                    pr[cy:cy + 8, cx:cx + 8] = pc._recon_tb(predc, lvc,
                                                            qp_c, 3)
                end = dec.decode_terminate()
                last = by == bh - 1 and bx == bw - 1
                assert end == (1 if last else 0)
        if not pps.deblocking_disabled:
            bs_ver, bs_hor = bc._bs_maps_b(info, bw, bh, ref_poc)
            rec_y, rec_u, rec_v = deblock_ops.deblock_420_bs_np(
                rec_y, rec_u, rec_v, qp, bs_ver, bs_hor)
        if sao_on:
            # the reference's apply_ctu loop, with each EO class's map
            # computed once per plane instead of once per CTB
            rec_y, rec_u, rec_v = (
                sao_ops.apply_ctus(p, [p3[c] for p3 in sao_params],
                                   16 if c == 0 else 8, bw)
                for c, p in enumerate((rec_y, rec_u, rec_v)))
        return rec_y, rec_u, rec_v
