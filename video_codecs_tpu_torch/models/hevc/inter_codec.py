"""Host helpers of the HEVC inter encoders: the MVD rate estimate, the
merge-index and MVD binarizations and the decoder's Exp-Golomb read.

The port's copy of the part of video_codecs_tpu/models/hevc/inter_codec.py
that the random-access quadtree encoder (models/hevc/inter_qt.py) reaches
through its `LowDelayEncoder` base; each function keeps its name and a
comment gives the original's line.  Cut (not reached by that chain): the
host low-delay P encoder and its decoder (`encode_frames`,
`encode_p_frame`, the P-slice writer and parser, `LowDelayDecoder`), the
cu_qp_delta syntax, the weighted-prediction estimate and the flat 16x16
MV predictors.
"""

from __future__ import annotations

import math

from video_codecs_tpu_torch.entropy import ctx
from video_codecs_tpu_torch.models.hevc import headers
from video_codecs_tpu_torch.models.hevc import intra_codec as ic

DC = 1
NAL_TRAIL_R = 1

MODE_INTER, MODE_INTRA = 0, 1


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
