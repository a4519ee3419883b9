"""PU-level HEVC motion-candidate derivation (merge / AMVP / TMVP) for
general streams — the full spec 8.5.3.2 machinery with bi-prediction,
arbitrary PU geometry (2Nx2N .. AMP .. NxN) and two reference lists.

Used by the general decoder (models/hevc/decoder.py) to decode
HM-encoder P/B slices.  The simpler 16x16-block twins in motion.py
remain the shared derivation of our own emitted toolset.

Parity references: hm-16.5rc1/source/Lib/TLibCommon/TComDataCU.cpp —
getInterMergeCandidates (:2870, spatial A1/B1/B0/A0/B2 order, partIdx
exclusion rules, TMVP, combined-bi, zero candidates; spec 8.5.3.2.3-4),
fillMvpCand (:3120, two-pass same-ref/scaled AMVP; spec 8.5.3.2.6-8),
xGetColMVP (:3430, collocated list selection + POC scaling; spec
8.5.3.2.9), TComCUMvField::compress (16x16 motion compression = reading
the top-left 4x4 of each 16x16 region, which the ((x>>4)<<4) rounding
here reproduces without a separate compression pass).

The port's whole copy of video_codecs_tpu/models/hevc/motion_hm.py (each
function keeps its name and a comment gives the original's line).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from video_codecs_tpu_torch.models.hevc.motion import scale_mv

L0, L1 = 0, 1


# video_codecs_tpu/models/hevc/motion_hm.py:30
@dataclasses.dataclass
class Motion:
    """Motion of one PU (or one merge candidate): per-list pred flags,
    quarter-pel MVs, reference indices and the POCs they resolve to."""
    pf: list            # [bool, bool]
    mv: list            # [(x, y), (x, y)]
    ref_idx: list       # [int, int]  (-1 when pf is False)
    ref_poc: list       # [int, int]

    # video_codecs_tpu/models/hevc/motion_hm.py:39
    @classmethod
    def none(cls) -> "Motion":
        return cls([False, False], [(0, 0), (0, 0)], [-1, -1], [0, 0])

    # video_codecs_tpu/models/hevc/motion_hm.py:43
    def same_motion(self, o: "Motion") -> bool:
        """Candidate pruning comparison (mv + refIdx per list, spec
        8.5.3.2.3 'have the same motion vectors and the same reference
        indices')."""
        for lx in (L0, L1):
            if self.pf[lx] != o.pf[lx]:
                return False
            if self.pf[lx] and (self.mv[lx] != o.mv[lx] or
                                self.ref_idx[lx] != o.ref_idx[lx]):
                return False
        return True


# video_codecs_tpu/models/hevc/motion_hm.py:56
class PicMotion:
    """Per-picture motion state at 4x4 granularity (HM's TComCUMvField
    laid out as whole-picture SoA arrays)."""

    # video_codecs_tpu/models/hevc/motion_hm.py:60
    def __init__(self, w: int, h: int, poc: int):
        w4, h4 = (w + 3) // 4, (h + 3) // 4
        self.w, self.h, self.poc = w, h, poc
        self.w4, self.h4 = w4, h4
        self.pf = np.zeros((2, h4, w4), bool)
        self.mv = np.zeros((2, h4, w4, 2), np.int32)
        self.ref_idx = np.full((2, h4, w4), -1, np.int8)
        self.ref_poc = np.zeros((2, h4, w4), np.int32)
        self.intra = np.zeros((h4, w4), bool)
        self.skip = np.zeros((h4, w4), bool)
        self.decoded = np.zeros((h4, w4), bool)
        #: multi-slice gating: per-4x4 slice-segment index + the slice
        #: being decoded — spatial neighbors in another slice are
        #: unavailable (spec 6.4.1).  None = single slice / collocated
        #: picture (whole-picture availability).
        self.slice4: np.ndarray | None = None
        self.cur_slice: int | None = None

    # video_codecs_tpu/models/hevc/motion_hm.py:78
    def set_pu(self, x: int, y: int, w: int, h: int, m: Motion) -> None:
        sx, sy = x // 4, y // 4
        ex, ey = (x + w) // 4, (y + h) // 4
        for lx in (L0, L1):
            self.pf[lx, sy:ey, sx:ex] = m.pf[lx]
            self.mv[lx, sy:ey, sx:ex] = m.mv[lx]
            self.ref_idx[lx, sy:ey, sx:ex] = m.ref_idx[lx]
            self.ref_poc[lx, sy:ey, sx:ex] = m.ref_poc[lx]
        self.decoded[sy:ey, sx:ex] = True

    # video_codecs_tpu/models/hevc/motion_hm.py:88
    def set_intra(self, x: int, y: int, size: int) -> None:
        sx, sy = x // 4, y // 4
        n = size // 4
        self.intra[sy:sy + n, sx:sx + n] = True
        self.decoded[sy:sy + n, sx:sx + n] = True

    # video_codecs_tpu/models/hevc/motion_hm.py:94
    def motion_at(self, x: int, y: int) -> Motion | None:
        """Motion of the decoded inter block covering luma (x, y); None
        if outside, not yet decoded, or intra."""
        if x < 0 or y < 0 or x >= self.w or y >= self.h:
            return None
        gx, gy = x // 4, y // 4
        if not self.decoded[gy, gx] or self.intra[gy, gx]:
            return None
        if self.cur_slice is not None and self.slice4 is not None and \
                self.slice4[gy, gx] != self.cur_slice:
            return None
        return Motion(
            [bool(self.pf[0, gy, gx]), bool(self.pf[1, gy, gx])],
            [(int(self.mv[0, gy, gx, 0]), int(self.mv[0, gy, gx, 1])),
             (int(self.mv[1, gy, gx, 0]), int(self.mv[1, gy, gx, 1]))],
            [int(self.ref_idx[0, gy, gx]), int(self.ref_idx[1, gy, gx])],
            [int(self.ref_poc[0, gy, gx]), int(self.ref_poc[1, gy, gx])])

    # video_codecs_tpu/models/hevc/motion_hm.py:112
    def col_motion_at(self, x: int, y: int) -> Motion | None:
        """Collocated lookup with the spec's 16x16 rounding
        ((x>>4)<<4; 8.5.3.2.8) — equals HM's compressed motion field."""
        return self.motion_at((x >> 4) << 4, (y >> 4) << 4)


# video_codecs_tpu/models/hevc/motion_hm.py:118
@dataclasses.dataclass
class SliceMotionCtx:
    """Everything slice-level the candidate derivation needs."""
    cur_poc: int
    ref_pocs: list          # [list0 POCs, list1 POCs] (active refs)
    is_b: bool
    max_merge: int
    tmvp: bool
    col: PicMotion | None   # collocated picture motion (TMVP source)
    collocated_from_l0: bool
    no_backward: bool       # every active ref POC <= cur_poc


# video_codecs_tpu/models/hevc/motion_hm.py:131
def _tmvp_mv(ctx: SliceMotionCtx, col_m: Motion, target_lx: int,
             target_poc: int) -> tuple[int, int] | None:
    """Collocated MV for target list/ref (spec 8.5.3.2.9)."""
    if col_m is None:
        return None
    if not col_m.pf[L0]:
        list_col = L1
    elif not col_m.pf[L1]:
        list_col = L0
    elif ctx.no_backward:
        list_col = target_lx
    else:
        # listCol = collocated_from_l0 ? L1 : L0 is HM's getColFromL0Flag
        # inversion: reading the *other* direction's motion
        list_col = L1 if ctx.collocated_from_l0 else L0
    col_poc = ctx.col.poc
    td = col_poc - col_m.ref_poc[list_col]
    tb = ctx.cur_poc - target_poc
    return scale_mv(col_m.mv[list_col], tb, td)


# video_codecs_tpu/models/hevc/motion_hm.py:152
def _tmvp_lookup(ctx: SliceMotionCtx, x: int, y: int, w: int, h: int,
                 log2_ctb: int, pic_w: int, pic_h: int) -> Motion | None:
    """Collocated block selection: bottom-right then center
    (spec 8.5.3.2.8)."""
    if ctx.col is None:
        return None
    xbr, ybr = x + w, y + h
    col_m = None
    if (ybr >> log2_ctb) == (y >> log2_ctb) and ybr < pic_h and xbr < pic_w:
        col_m = ctx.col.col_motion_at(xbr, ybr)
    if col_m is None:
        col_m = ctx.col.col_motion_at(x + w // 2, y + h // 2)
    return col_m


# video_codecs_tpu/models/hevc/motion_hm.py:167
def _temporal_candidate(ctx: SliceMotionCtx, x, y, w, h, log2_ctb,
                        pic_w, pic_h) -> Motion | None:
    """TMVP merge candidate: refIdx 0 in each used list."""
    col_m = _tmvp_lookup(ctx, x, y, w, h, log2_ctb, pic_w, pic_h)
    if col_m is None:
        return None
    out = Motion.none()
    for lx in (L0, L1) if ctx.is_b else (L0,):
        if not ctx.ref_pocs[lx]:
            continue
        mv = _tmvp_mv(ctx, col_m, lx, ctx.ref_pocs[lx][0])
        if mv is None:
            continue
        out.pf[lx] = True
        out.mv[lx] = mv
        out.ref_idx[lx] = 0
        out.ref_poc[lx] = ctx.ref_pocs[lx][0]
    return out if (out.pf[L0] or out.pf[L1]) else None


# partIdx-1 spatial exclusions (spec 8.5.3.2.3 availability conditions)
_VER_PARTS = ("Nx2N", "nLx2N", "nRx2N")     # A1 excluded for partIdx 1
_HOR_PARTS = ("2NxN", "2NxnU", "2NxnD")     # B1 excluded for partIdx 1


# video_codecs_tpu/models/hevc/motion_hm.py:192
def merge_candidates_pu(pm: PicMotion, ctx: SliceMotionCtx,
                        x: int, y: int, w: int, h: int,
                        part_mode: str, part_idx: int,
                        log2_ctb: int) -> list[Motion]:
    """Full merge candidate list for one PU (spec 8.5.3.2.3-4)."""
    cands: list[Motion] = []

    # spatial A1 / B1 / B0 / A0 (/B2) with partIdx-1 exclusions; pruning
    # pairs exactly per spec: B1 vs A1, B0 vs B1, A0 vs A1, B2 vs A1+B1
    a1 = (None if part_idx == 1 and part_mode in _VER_PARTS
          else pm.motion_at(x - 1, y + h - 1))
    if a1:
        cands.append(a1)
    b1 = (None if part_idx == 1 and part_mode in _HOR_PARTS
          else pm.motion_at(x + w - 1, y - 1))
    if b1 and (a1 is None or not b1.same_motion(a1)):
        cands.append(b1)
    b0 = pm.motion_at(x + w, y - 1)
    if b0 and (b1 is None or not b0.same_motion(b1)):
        cands.append(b0)
    a0 = pm.motion_at(x - 1, y + h)
    if a0 and (a1 is None or not a0.same_motion(a1)):
        cands.append(a0)
    if len(cands) < 4:
        b2 = pm.motion_at(x - 1, y - 1)
        if b2 and (a1 is None or not b2.same_motion(a1)) and \
                (b1 is None or not b2.same_motion(b1)):
            cands.append(b2)

    if ctx.tmvp and len(cands) < ctx.max_merge:
        t = _temporal_candidate(ctx, x, y, w, h, log2_ctb, pm.w, pm.h)
        if t is not None:
            cands.append(t)

    # combined bi-predictive candidates (B slices, spec 8.5.3.2.4)
    if ctx.is_b and len(cands) > 1 and len(cands) < ctx.max_merge:
        l0_idx = (0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3)
        l1_idx = (1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2)
        n_orig = len(cands)
        for k in range(min(n_orig * (n_orig - 1), 12)):
            if len(cands) >= ctx.max_merge:
                break
            c0, c1 = cands[l0_idx[k]], cands[l1_idx[k]]
            if not (c0.pf[L0] and c1.pf[L1]):
                continue
            if (c0.ref_poc[L0] == c1.ref_poc[L1] and
                    c0.mv[L0] == c1.mv[L1]):
                continue
            cands.append(Motion(
                [True, True], [c0.mv[L0], c1.mv[L1]],
                [c0.ref_idx[L0], c1.ref_idx[L1]],
                [c0.ref_poc[L0], c1.ref_poc[L1]]))

    # zero candidates (spec 8.5.3.2.3 step 10)
    if ctx.is_b:
        num_ref = min(len(ctx.ref_pocs[L0]), len(ctx.ref_pocs[L1]))
    else:
        num_ref = len(ctx.ref_pocs[L0])
    zero_idx = 0
    while len(cands) < ctx.max_merge:
        r = min(zero_idx, num_ref - 1)
        m = Motion([True, ctx.is_b], [(0, 0), (0, 0)],
                   [r, r if ctx.is_b else -1],
                   [ctx.ref_pocs[L0][r],
                    ctx.ref_pocs[L1][r] if ctx.is_b else 0])
        cands.append(m)
        zero_idx += 1
    return cands[:ctx.max_merge]


# video_codecs_tpu/models/hevc/motion_hm.py:262
def amvp_candidates_pu(pm: PicMotion, ctx: SliceMotionCtx,
                       x: int, y: int, w: int, h: int,
                       target_lx: int, ref_idx: int,
                       log2_ctb: int) -> list[tuple[int, int]]:
    """Two AMVP predictors for (list, refIdx) (spec 8.5.3.2.6-8)."""
    target_poc = ctx.ref_pocs[target_lx][ref_idx]

    def same_ref(m: Motion):
        """Pass 1: neighbor uses the target reference picture in either
        of its lists (spec checks LX then LY)."""
        for lx in (target_lx, 1 - target_lx):
            if m.pf[lx] and m.ref_poc[lx] == target_poc:
                return m.mv[lx]
        return None

    def scaled(m: Motion):
        """Pass 2: first used list (LX then LY), POC-scaled."""
        for lx in (target_lx, 1 - target_lx):
            if m.pf[lx]:
                return scale_mv(m.mv[lx], ctx.cur_poc - target_poc,
                                ctx.cur_poc - m.ref_poc[lx])
        return None

    a_nbs = [pm.motion_at(x - 1, y + h), pm.motion_at(x - 1, y + h - 1)]
    a_exists = any(m is not None for m in a_nbs)
    mv_a = None
    for m in a_nbs:
        if m is not None:
            mv_a = same_ref(m)
            if mv_a is not None:
                break
    if mv_a is None:
        for m in a_nbs:
            if m is not None:
                mv_a = scaled(m)
                break

    b_nbs = [pm.motion_at(x + w, y - 1), pm.motion_at(x + w - 1, y - 1),
             pm.motion_at(x - 1, y - 1)]
    mv_b = None
    for m in b_nbs:
        if m is not None:
            mv_b = same_ref(m)
            if mv_b is not None:
                break
    if mv_a is None and not a_exists:
        # isScaledFlag == 0: B takes the A slot; re-derive B scaled
        mv_a = mv_b
        mv_b = None
        for m in b_nbs:
            if m is not None:
                mv_b = scaled(m)
                break

    cands: list[tuple[int, int]] = []
    if mv_a is not None:
        cands.append(mv_a)
    if mv_b is not None and mv_b != mv_a:
        cands.append(mv_b)
    if len(cands) < 2 and ctx.tmvp:
        col_m = _tmvp_lookup(ctx, x, y, w, h, log2_ctb, pm.w, pm.h)
        if col_m is not None:
            t = _tmvp_mv(ctx, col_m, target_lx, target_poc)
            if t is not None:
                cands.append(t)
    while len(cands) < 2:
        cands.append((0, 0))
    return cands[:2]
