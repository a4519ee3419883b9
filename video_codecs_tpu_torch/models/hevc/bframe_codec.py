"""Flat 16x16 hierarchical-B coder: the B block record, the spec merge
and AMVP derivations, the slice header (written and parsed), the host B
coder `HierarchicalBEncoder` and `HierarchicalBDecoder`.

The port's copy of video_codecs_tpu/models/hevc/bframe_codec.py, function
by function (each keeps its name and a comment gives the original's
line): `BBlock`, `mv_scale`, `derive_merge`, `derive_amvp_b`,
`write_b_slice_header`, `parse_b_slice_header`, the hierarchical-B GOP
loop `encode_sequence_rab`, the CTB16 B slice and CU writers,
`_bs_maps_b` and the decoder.  The flat device engines
(models/hevc/inter_dev.py) and the CTB32 quadtree encoder derive from
`HierarchicalBEncoder`.

`HierarchicalBEncoder._encode_b_frame` is the reference's host B coder,
what its encoder CLI runs (through ra_codec.RandomAccessEncoder) for
HM's encoder_randomaccess_main.cfg, split the way the host P coder of
models/hevc/inter_codec.py is:

  pass 1 on the encoder's device: `me.motion_search` against each
    reference list (the SAD kernel on the card) and `decide_modes`' intra
    sweep, one copy back each (`_p_pass1`);
  the raster on the host (`_b_raster`), the reference's loop in numpy:
    the merge candidate (`derive_merge`), each list's AMVP
    (`derive_amvp_b`), the numpy MC twins (bi too), the intra candidate,
    then the 8x8 SATD of every candidate of a block in one call of
    `_satd8` (the reference makes one device call per candidate), the
    choice with the reference's Python-float costs, `code_tb_np` and the
    reconstruction;
  the picture deblock with the B BS maps on the encoder's device
    (`_p_deblock`), with `cfg.sao` the SAO decision from the device
    statistics (`_sao_decide_apply`), CABAC and the hash SEI on the host.

`HierarchicalBDecoder` runs on the host with the numpy twins and
`deblock_420_bs_np`, as the reference's does.  The constructors refuse
the configurations the flat B syntax writes wrongly or the port does
not carry (`check_flat_b`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from video_codecs_tpu_torch.entropy import bitstream as bs
from video_codecs_tpu_torch.entropy import cabac, ctx, residual
from video_codecs_tpu_torch.models.hevc import headers
from video_codecs_tpu_torch.models.hevc import inter_codec as pc
from video_codecs_tpu_torch.models.hevc import intra_codec as ic
from video_codecs_tpu_torch.ops import deblock as deblock_ops
from video_codecs_tpu_torch.ops import interp
from video_codecs_tpu_torch.ops import intra as intra_ops
from video_codecs_tpu_torch.ops import sao as sao_ops
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


# video_codecs_tpu/models/hevc/bframe_codec.py:207
def parse_b_slice_header(rbsp: bytes, pps, sps_sao: bool = False):
    r = bs.BitReader(rbsp)
    assert r.flag() == 1
    assert r.ue() == 0
    st = r.ue()
    poc = r.read(8)
    assert r.flag() == 0
    num_neg = r.ue()
    num_pos = r.ue()
    for _ in range(num_neg):
        r.ue(), r.flag()
    for _ in range(num_pos):
        r.ue(), r.flag()
    sao = False
    if sps_sao:
        sao = bool(r.flag())
        assert bool(r.flag()) == sao, "joint luma+chroma SAO expected"
    assert r.flag() == 0
    if st == 0:
        r.flag()           # mvd_l1_zero_flag
    assert r.ue() == 4
    qp = pps.init_qp + r.se()
    if not pps.deblocking_disabled:
        r.flag()
    assert r.flag() == 1
    r.byte_align()
    return st, poc, qp, r.bit_pos(), sao



def check_flat_b(name, cfg):
    """The configurations the flat 16x16 B syntax writes wrongly, or that
    the port does not carry, raise ValueError."""
    if cfg.tile_columns != 1:
        raise ValueError(f"{name}: tiles are not ported")
    for opt in ("wpp", "weighted_pred", "cu_qp_delta"):
        if getattr(cfg, opt):
            raise ValueError(f"{name}: {opt} is not ported")
    for opt in ("timing_sei", "long_term_idr"):
        if getattr(cfg, opt):
            raise ValueError(
                f"{name}: {opt}: the reference's B picture loop writes "
                "neither the buffering-period / picture-timing SEI nor the "
                "long-term entries its SPS then announces (they are "
                "LowDelayEncoder.encode_frames' and write_p_slice_header's)")
    if cfg.temporal_mvp:
        raise ValueError(
            f"{name}: temporal_mvp: the flat B coder ignores the temporal "
            "candidate in its merge and AMVP derivations, so the "
            "reference's stream does not decode")
    if not (cfg.log2_ctb == cfg.log2_min_cb == cfg.log2_max_tb == 4):
        raise ValueError(f"{name}: the flat B coder codes CTB = CU = TU "
                         "16 (log2_ctb = log2_min_cb = log2_max_tb = 4)")


# video_codecs_tpu/models/hevc/bframe_codec.py:236
class HierarchicalBEncoder(pc.LowDelayEncoder):
    """I0 + P anchors (delta 2) + non-reference B pictures between."""

    #: this module's flat 16x16 syntax writes the slices, so
    #: `check_flat_b` applies (the CTB32 quadtree encoder writes its own)
    flat_syntax = True

    def __init__(self, cfg: headers.HevcConfig, search_range: int = 8,
                 me_method: str = "auto", *, device="cuda") -> None:
        if self.flat_syntax:
            check_flat_b(type(self).__name__, cfg)
        super().__init__(cfg, search_range, me_method, device=device)

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
        """Code one anchor P (L0 only) or B picture (L0 and L1): pass 1
        on the encoder's device, the raster on the host, the deblock on
        the device, SAO, CABAC and the hash SEI.  QP and lambda are the
        picture's cfg.qp, read here once, as the reference reads them."""
        cfg = self.cfg
        y, u, v = frame
        bw, bh = cfg.width // 16, cfg.height // 16
        nb = bw * bh
        yv, uv, vv = (np.asarray(p).astype(np.int32) for p in (y, u, v))
        ref_planes = {lx: tuple(p.astype(np.int32) for p in rec)
                      for lx, (rpoc, rec) in refs.items()}
        ref_poc = {lx: rpoc for lx, (rpoc, rec) in refs.items()}

        cur = np.stack([yv[b // bw * 16:b // bw * 16 + 16,
                           b % bw * 16:b % bw * 16 + 16] for b in range(nb)])
        me_lists, intra_modes = self._p_pass1(y, cur,
                                              list(ref_planes.values()))
        me = dict(zip(ref_planes, me_lists))
        info, (rec_y, rec_u, rec_v) = self._b_raster(
            (yv, uv, vv), cur, ref_planes, ref_poc, poc, is_anchor, me,
            intra_modes)

        neg_delta = poc - ref_poc[L0]
        if not cfg.deblocking_disabled:
            rec_y, rec_u, rec_v = self._p_deblock(
                (rec_y, rec_u, rec_v), info,
                _bs_maps_b(info, bw, bh, ref_poc))
        sao_params = None
        if cfg.sao:
            sao_params, (rec_y, rec_u, rec_v) = self._sao_decide_apply(
                (yv, uv, vv), (rec_y, rec_u, rec_v))
        slice_nal = self._encode_b_slice(info, poc, is_anchor, ref_poc,
                                         neg_delta, sao_params)
        sei_nal = self._hash_sei(rec_y, rec_u, rec_v)
        return [slice_nal, sei_nal], (rec_y, rec_u, rec_v)

    def _b_raster(self, planes, cur, ref_planes, ref_poc, poc, is_anchor,
                  me, intra_modes):
        """The reference's raster loop (bframe_codec.py:308-422) in numpy
        on the host: per block the merge candidate, each list's ME vector
        with its AMVP predictor, the bi combination of the two and the
        intra candidate, their costs (SATD + the Python-float
        round(sqrt(lambda) * bits), ties as the reference breaks them),
        the choice, `code_tb_np` and the reconstruction.  Every
        candidate's prediction is known before any cost is compared, so a
        block's SATDs come from one `_satd8` call.  Returns (BBlock grid,
        recon planes before the loop filters)."""
        cfg = self.cfg
        bw, bh = cfg.width // 16, cfg.height // 16
        qp, qp_c = cfg.qp, ic.chroma_qp(cfg.qp)
        yv, uv, vv = planes
        sl = math.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0))
        bi_ok = not is_anchor and len(ref_planes) == 2

        rec_y = np.zeros_like(yv)
        rec_u = np.zeros_like(uv)
        rec_v = np.zeros_like(vv)
        info = [[None] * bw for _ in range(bh)]

        for by in range(bh):
            for bx in range(bw):
                i = by * bw + bx
                xx, yy = bx * 16, by * 16
                oy = cur[i]
                mdir, mmv = derive_merge(info, bx, by, bw, bh,
                                         is_b_slice=not is_anchor)
                if mdir == 3:
                    pred_merge = interp.mc_luma_bi_np(
                        ref_planes[L0][0], ref_planes[L1][0], xx, yy,
                        mmv[L0], mmv[L1], 16)
                else:
                    mlx = L0 if (mdir & 1) else L1
                    pred_merge = interp.mc_luma_np(
                        ref_planes[mlx][0], xx, yy, *mmv[mlx], 16)

                uni = {}
                preds = [pred_merge]
                for lx in ref_planes:
                    mv = (int(me[lx][0][i]), int(me[lx][1][i]))
                    preds.append(interp.mc_luma_np(ref_planes[lx][0], xx,
                                                   yy, *mv, 16))
                    amvp = derive_amvp_b(info, bx, by, bw, bh, lx,
                                         poc, ref_poc)
                    mvds = [(mv[0] - p[0], mv[1] - p[1]) for p in amvp]
                    bits = [pc.mvd_bits_estimate(d) for d in mvds]
                    mi = 0 if bits[0] <= bits[1] else 1
                    uni[lx] = (mv, mi, mvds[mi], bits[mi])
                if bi_ok:
                    preds.append(interp.mc_luma_bi_np(
                        ref_planes[L0][0], ref_planes[L1][0], xx, yy,
                        uni[L0][0], uni[L1][0], 16))
                imode = int(intra_modes[by, bx])
                ref_arr = ic.build_ref_np(rec_y, xx, yy, 16)
                pred_intra = intra_ops.predict_intra_np(ref_arr, imode, 4)
                satds = pc._satd8(oy, preds + [pred_intra])

                cost_merge = satds[0] + round(sl * 2)
                best_uni = None
                for k, lx in enumerate(ref_planes):
                    mv, mi, mvd, bits = uni[lx]
                    c = satds[1 + k] + round(sl * (7 + bits))
                    if best_uni is None or c < best_uni[0]:
                        best_uni = (c, lx, mv, mi, mvd, preds[1 + k])
                best_bi = None
                if bi_ok:
                    c_bi = satds[-2] + round(
                        sl * (8 + uni[L0][3] + uni[L1][3]))
                    best_bi = (c_bi, preds[-1])
                cost_intra = satds[-1] + round(sl * 9)

                b = BBlock()
                cost_inter = best_uni[0]
                if best_bi is not None:
                    cost_inter = min(cost_inter, best_bi[0])
                if cost_intra <= min(cost_merge, cost_inter):
                    b.pred_mode = MODE_INTRA
                    b.intra_mode = imode
                    pred = pred_intra
                elif cost_merge <= cost_inter:
                    b.pred_mode = MODE_INTER
                    b.merge = True
                    b.inter_dir, b.mv = mdir, dict(mmv)
                    pred = pred_merge
                elif best_bi is not None and best_bi[0] < best_uni[0]:
                    b.pred_mode = MODE_INTER
                    b.inter_dir = 3
                    b.mv = {L0: uni[L0][0], L1: uni[L1][0]}
                    b.mvp_idx = {L0: uni[L0][1], L1: uni[L1][1]}
                    b.mvd = {L0: uni[L0][2], L1: uni[L1][2]}
                    pred = best_bi[1]
                else:
                    _, lx, mv, mi, mvd, pred = best_uni
                    b.pred_mode = MODE_INTER
                    b.inter_dir = 1 if lx == L0 else 2
                    b.mv = {lx: mv}
                    b.mvp_idx = mi
                    b.mvd = mvd

                lv, rec = ic.code_tb_np(oy, pred, qp, 4, dst=False,
                                        sbh=cfg.sign_data_hiding)
                b.cbf_y = bool(lv.any())
                b.levels_y = lv if b.cbf_y else None
                cx, cy = xx // 2, yy // 2
                for comp, (po, pr) in enumerate(((uv, rec_u), (vv, rec_v))):
                    if b.pred_mode == MODE_INTRA:
                        refc = ic.build_ref_np(pr, cx, cy, 8)
                        predc = intra_ops.predict_intra_np(refc, imode, 3,
                                                           is_luma=False)
                    elif b.inter_dir == 3:
                        predc = interp.mc_chroma_bi_np(
                            ref_planes[L0][1 + comp],
                            ref_planes[L1][1 + comp], cx, cy,
                            b.mv[L0], b.mv[L1], 8)
                    else:
                        lx = L0 if 1 & b.inter_dir else L1
                        rp = ref_planes[lx][1 + comp]
                        predc = interp.mc_chroma_np(rp, cx, cy,
                                                    *b.mv[lx], 8)
                    lvc, recc = ic.code_tb_np(po[cy:cy + 8, cx:cx + 8],
                                              predc, qp_c, 3, dst=False,
                                              sbh=cfg.sign_data_hiding)
                    cbf = bool(lvc.any())
                    if comp == 0:
                        b.cbf_cb, b.levels_cb = cbf, (lvc if cbf else None)
                    else:
                        b.cbf_cr, b.levels_cr = cbf, (lvc if cbf else None)
                    pr[cy:cy + 8, cx:cx + 8] = recc
                no_res = not (b.cbf_y or b.cbf_cb or b.cbf_cr)
                if b.pred_mode == MODE_INTER and b.merge and no_res:
                    b.skip = True
                rec_y[yy:yy + 16, xx:xx + 16] = rec if b.cbf_y else pred
                info[by][bx] = b
        return info, (rec_y, rec_u, rec_v)

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


# video_codecs_tpu/models/hevc/bframe_codec.py:561
class HierarchicalBDecoder(ic.IntraDecoder):
    """Decodes the IBPBP streams; returns frames in POC (display) order."""

    # video_codecs_tpu/models/hevc/bframe_codec.py:564
    def __init__(self) -> None:
        super().__init__()
        self._anchors: dict[int, tuple] = {}

    # video_codecs_tpu/models/hevc/bframe_codec.py:568
    def decode(self, stream: bytes):
        from video_codecs_tpu_torch.models.hevc.decoder import \
            _strip_ep_with_pos
        import hashlib
        out: dict[int, tuple] = {}
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
                self._anchors = {0: frame}
                last_poc = 0
            elif nal_type in (NAL_TRAIL_N, NAL_TRAIL_R):
                poc, frame = self._decode_b_slice(rbsp)
                out[poc] = frame
                if nal_type == NAL_TRAIL_R:
                    self._anchors[poc] = frame
                    self._anchors = {k: v for k, v in
                                     sorted(self._anchors.items())[-2:]}
                last_poc = poc
            elif nal_type == bs.NAL_SUFFIX_SEI:
                md5s = self._parse_hash_sei(rbsp)
                if md5s and last_poc is not None:
                    ok = all(hashlib.md5(out[last_poc][i].astype(np.uint8)
                                         .tobytes()).digest() == md5s[i]
                             for i in range(3))
                    self.hash_status.append(ok)
        return [out[k] for k in sorted(out)]

    # video_codecs_tpu/models/hevc/bframe_codec.py:603
    def _decode_b_slice(self, rbsp: bytes):
        cfg, pps = self.cfg, self.pps
        st, poc, qp, off_bits, sao_on = parse_b_slice_header(
            rbsp, pps, sps_sao=cfg.sao)
        is_anchor = st == 1
        anchors = sorted(self._anchors)
        if is_anchor:
            ref_poc = {L0: anchors[-1]}
        else:
            ref_poc = {L0: poc - 1, L1: poc + 1}
        ref_planes = {lx: tuple(p.astype(np.int32)
                                for p in self._anchors[rp])
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
                if b.pred_mode == MODE_INTRA:
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
                    if b.pred_mode == MODE_INTRA:
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
            bs_ver, bs_hor = _bs_maps_b(info, bw, bh, ref_poc)
            rec_y, rec_u, rec_v = deblock_ops.deblock_420_bs_np(
                rec_y, rec_u, rec_v, qp, bs_ver, bs_hor)
        if sao_on:
            # the reference's apply_ctu loop, with each EO class's map
            # computed once per plane instead of once per CTB
            rec_y, rec_u, rec_v = (
                sao_ops.apply_ctus(p, [p3[c] for p3 in sao_params],
                                   16 if c == 0 else 8, bw)
                for c, p in enumerate((rec_y, rec_u, rec_v)))
        return poc, (rec_y, rec_u, rec_v)

    # video_codecs_tpu/models/hevc/bframe_codec.py:695
    def _decode_b_ctu(self, dec, info, bx, by, bw, bh, is_anchor, poc,
                      ref_poc, sbh) -> BBlock:
        b = BBlock()
        left = info[by][bx - 1] if bx else None
        above = info[by - 1][bx] if by else None
        skip_ctx = (1 if (left and left.skip) else 0) + \
                   (1 if (above and above.skip) else 0)
        if dec.decode_bin(ctx.off("skip_flag", skip_ctx)):
            b.skip = True
            b.merge = True
            b.pred_mode = MODE_INTER
            b.inter_dir, b.mv = derive_merge(info, bx, by, bw, bh,
                                             is_b_slice=not is_anchor)
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
        else:
            b.pred_mode = MODE_INTER
            assert dec.decode_bin(ctx.off("part_size")) == 1
            b.merge = bool(dec.decode_bin(ctx.off("merge_flag")))
            if b.merge:
                b.inter_dir, b.mv = derive_merge(info, bx, by, bw, bh,
                                                 is_b_slice=not is_anchor)
            else:
                bi = False
                lx = L0
                if not is_anchor:
                    bi = bool(dec.decode_bin(ctx.off("inter_dir", 0)))
                    if not bi:
                        lx = (L1 if dec.decode_bin(ctx.off("inter_dir", 4))
                              else L0)
                if bi:
                    b.inter_dir = 3
                    b.mv = {}
                    for ll in (L0, L1):
                        mvd = pc.LowDelayDecoder._decode_mvd(dec)
                        mpi = dec.decode_bin(ctx.off("mvp_idx"))
                        amvp = derive_amvp_b(info, bx, by, bw, bh, ll,
                                             poc, ref_poc)
                        p = amvp[mpi]
                        b.mv[ll] = (p[0] + mvd[0], p[1] + mvd[1])
                else:
                    b.inter_dir = 1 if lx == L0 else 2
                    b.mvd = pc.LowDelayDecoder._decode_mvd(dec)
                    b.mvp_idx = dec.decode_bin(ctx.off("mvp_idx"))
                    amvp = derive_amvp_b(info, bx, by, bw, bh, lx, poc,
                                         ref_poc)
                    p = amvp[b.mvp_idx]
                    b.mv = {lx: (p[0] + b.mvd[0], p[1] + b.mvd[1])}
            if not b.merge:
                if not dec.decode_bin(ctx.off("qt_root_cbf")):
                    return b
            b.cbf_cb = bool(dec.decode_bin(ctx.off("cbf_chroma")))
            b.cbf_cr = bool(dec.decode_bin(ctx.off("cbf_chroma")))
            if b.cbf_cb or b.cbf_cr:
                b.cbf_y = bool(dec.decode_bin(ctx.off("cbf_luma", 1)))
            else:
                b.cbf_y = True
        if b.cbf_y:
            b.levels_y = residual.decode_residual(dec, 4, rom.SCAN_DIAG, True,
                                                  sign_hiding=sbh)
        if b.cbf_cb:
            b.levels_cb = residual.decode_residual(dec, 3, rom.SCAN_DIAG,
                                                   False, sign_hiding=sbh)
        if b.cbf_cr:
            b.levels_cr = residual.decode_residual(dec, 3, rom.SCAN_DIAG,
                                                   False, sign_hiding=sbh)
        return b
