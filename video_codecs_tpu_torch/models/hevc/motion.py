"""HEVC motion-vector candidate derivation: merge list, AMVP, TMVP.

Shared by the encoder and decoder (identical derivation on both sides is
what keeps streams self-consistent); validated against HM's decoder via
conformance tests.

Parity references: hm-16.5rc1/source/Lib/TLibCommon/TComDataCU.cpp —
getInterMergeCandidates (spatial A1/B1/B0/A0/B2 order + pruning + TMVP +
zero candidates; spec 8.5.3.2.3), fillMvpCand (AMVP two-pass same-ref /
scaled derivation; spec 8.5.3.2.5-8), xGetColMVP + scaling
(spec 8.5.3.2.8 temporal MV derivation, distScaleFactor arithmetic).

Geometry note: the current inter builds use PU == CU == 16x16 blocks, so
neighbor positions map to whole blocks and the TMVP bottom-right
collocated position always falls in the next CTB row (unavailable per the
spec's same-CTB-row constraint) — the center position is used, which at
16x16 granularity is the collocated block itself.

The port's whole copy of video_codecs_tpu/models/hevc/motion.py (each
function keeps its name and a comment gives the original's line), with
one repair: `amvp_candidates` takes the spec's step for a prediction
block without an A neighbor (the reference's derivation gives another
predictor list than any decoder when the B neighbors use different
reference pictures, so its low-delay P streams at several references can
fail their picture hashes).
"""

from __future__ import annotations

import dataclasses

import numpy as np


# video_codecs_tpu/models/hevc/motion.py:27
@dataclasses.dataclass
class MotionField:
    """Per-picture motion storage at 16x16 granularity (HM's compressed
    MV field, TComPic::compressMotion)."""
    inter: np.ndarray          # [bh, bw] bool
    mv: np.ndarray             # [bh, bw, 2] int32 (quarter-pel)
    ref_poc: np.ndarray        # [bh, bw] int32 (POC of the ref used)
    poc: int = 0

    # video_codecs_tpu/models/hevc/motion.py:36
    @classmethod
    def empty(cls, bw: int, bh: int, poc: int) -> "MotionField":
        return cls(np.zeros((bh, bw), bool), np.zeros((bh, bw, 2), np.int32),
                   np.zeros((bh, bw), np.int32), poc)


# video_codecs_tpu/models/hevc/motion.py:42
def _div_trunc(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


# video_codecs_tpu/models/hevc/motion.py:47
def scale_mv(mv: tuple[int, int], tb: int, td: int) -> tuple[int, int]:
    """Spec 8.5.3.2.8 / TComDataCU xGetDistScaleFactor MV scaling."""
    if td == tb or td == 0:
        return mv
    tb = max(-128, min(127, tb))
    td = max(-128, min(127, td))
    tx = _div_trunc(16384 + abs(td) // 2, td)
    dsf = max(-4096, min(4095, (tb * tx + 32) >> 6))

    def one(v):
        s = dsf * v
        val = (abs(s) + 127) >> 8
        return max(-32768, min(32767, val if s >= 0 else -val))

    return (one(mv[0]), one(mv[1]))


# video_codecs_tpu/models/hevc/motion.py:64
class NeighborGrid:
    """Adapter over the per-block decode state: motion of decoded blocks."""

    # video_codecs_tpu/models/hevc/motion.py:67
    def __init__(self, info, bw: int, bh: int):
        self.info, self.bw, self.bh = info, bw, bh

    # video_codecs_tpu/models/hevc/motion.py:70
    def motion(self, nbx: int, nby: int, cur_bx: int, cur_by: int):
        """(mv, ref_idx, ref_poc) of an already-decoded inter neighbor."""
        if nbx < 0 or nby < 0 or nbx >= self.bw or nby >= self.bh:
            return None
        if nby > cur_by or (nby == cur_by and nbx >= cur_bx):
            return None          # not yet decoded (raster order)
        b = self.info[nby][nbx]
        if b is None or b.pred_mode != 0:   # MODE_INTER == 0
            return None
        return (tuple(b.mv), b.ref_idx, b.ref_poc)


# video_codecs_tpu/models/hevc/motion.py:82
def _tmvp(col: MotionField | None, bx: int, by: int, cur_poc: int,
          target_poc: int):
    """Temporal candidate from the collocated picture's center position."""
    if col is None:
        return None
    if not col.inter[by, bx]:
        return None
    col_mv = (int(col.mv[by, bx, 0]), int(col.mv[by, bx, 1]))
    td = col.poc - int(col.ref_poc[by, bx])
    tb = cur_poc - target_poc
    return scale_mv(col_mv, tb, td)


# video_codecs_tpu/models/hevc/motion.py:95
def merge_candidates(grid: NeighborGrid, bx: int, by: int,
                     ref_pocs: list[int], cur_poc: int,
                     col: MotionField | None, max_cands: int,
                     tmvp: bool) -> list[tuple[tuple[int, int], int]]:
    """Merge candidate list [(mv, ref_idx)] (spec 8.5.3.2.3)."""
    poc_to_idx = {p: i for i, p in enumerate(ref_pocs)}

    def spatial(nbx, nby):
        m = grid.motion(nbx, nby, bx, by)
        if m is None:
            return None
        mv, _, ref_poc = m
        idx = poc_to_idx.get(ref_poc)
        if idx is None:
            return None
        return (mv, idx)

    cands: list = []
    a1 = spatial(bx - 1, by)
    if a1:
        cands.append(a1)
    b1 = spatial(bx, by - 1)
    if b1 and b1 != a1:
        cands.append(b1)
    b0 = spatial(bx + 1, by - 1)
    if b0 and b0 != b1:
        cands.append(b0)
    a0 = spatial(bx - 1, by + 1)     # below-left: never decoded in raster
    if a0 and a0 != a1:
        cands.append(a0)
    if len(cands) < 4:
        b2 = spatial(bx - 1, by - 1)
        if b2 and b2 != a1 and b2 != b1:
            cands.append(b2)
    if tmvp and len(cands) < max_cands:
        t = _tmvp(col, bx, by, cur_poc, ref_pocs[0])
        if t is not None:
            cands.append((t, 0))
    zero_idx = 0
    nref = len(ref_pocs)
    while len(cands) < max_cands:
        cands.append(((0, 0), min(zero_idx, nref - 1)))
        zero_idx += 1
    return cands[:max_cands]


# video_codecs_tpu/models/hevc/motion.py:141
def amvp_candidates(grid: NeighborGrid, bx: int, by: int, ref_idx: int,
                    ref_pocs: list[int], cur_poc: int,
                    col: MotionField | None,
                    tmvp: bool) -> list[tuple[int, int]]:
    """Two AMVP predictors for target ref_idx (spec 8.5.3.2.5-8)."""
    target_poc = ref_pocs[ref_idx]

    def neighbor(nbx, nby):
        return grid.motion(nbx, nby, bx, by)

    # A: A0 (below-left, never available in raster order) then A1
    a_nbs = [neighbor(bx - 1, by + 1), neighbor(bx - 1, by)]
    a_exists = any(m is not None for m in a_nbs)
    mv_a = None
    for m in a_nbs:                      # pass 1: same reference picture
        if m is not None and m[2] == target_poc:
            mv_a = m[0]
            break
    if mv_a is None:
        for m in a_nbs:                  # pass 2: scaled
            if m is not None:
                mv_a = scale_mv(m[0], cur_poc - target_poc, cur_poc - m[2])
                break

    # B: B0, B1, B2 with the same reference picture.  When no A neighbor
    # exists (isScaledFlag 0), that candidate becomes A, and B is the
    # first available B neighbor, scaled (spec 8.5.3.2.7, HM
    # TComDataCU::fillMvpCand; the reference keeps the unscaled B and
    # takes a scaled one only when none was found, which a decoder reads
    # differently once the B neighbors use different references)
    b_nbs = [neighbor(bx + 1, by - 1), neighbor(bx, by - 1),
             neighbor(bx - 1, by - 1)]
    mv_b = None
    for m in b_nbs:
        if m is not None and m[2] == target_poc:
            mv_b = m[0]
            break
    if not a_exists:
        if mv_b is not None:
            mv_a = mv_b
        mv_b = None
        for m in b_nbs:
            if m is not None:
                mv_b = scale_mv(m[0], cur_poc - target_poc, cur_poc - m[2])
                break

    cands: list = []
    if mv_a is not None:
        cands.append(mv_a)
    if mv_b is not None and mv_b != mv_a:
        cands.append(mv_b)
    if len(cands) < 2 and tmvp:
        # spec adds the temporal candidate without pruning vs spatial
        t = _tmvp(col, bx, by, cur_poc, target_poc)
        if t is not None:
            cands.append(t)
    while len(cands) < 2:
        cands.append((0, 0))
    return cands[:2]
