"""H.264 soft-decision (trellis-style) quantization.

The port's copy of video_codecs_tpu/ops/h264_rdoq.py, whole and as it is;
each function keeps its name and a comment gives the original's line.

Parity: jm18.5/lencod/src/rdoq.c + quant4x4_trellis.c — JM evaluates,
per transform coefficient, the level candidates {ceil, ceil-1, 0} by
lambda-weighted rate-distortion and additionally prunes trailing
coefficients (the CAVLC/CABAC-context-exact rate models live in
rdoq_cavlc.c/rdoq_cabac.c). Here: the same candidate set with a
closed-form exp-Golomb-shaped rate model, vectorized over all blocks
of the frame at once, plus the trailing-zero pruning pass in zigzag
order. Encoder-only: any level choice yields a conformant stream.
"""

from __future__ import annotations

import numpy as np

from video_codecs_tpu_torch.ops import h264_transform as ht

_ZZ = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15])


# video_codecs_tpu/ops/h264_rdoq.py:22
class AdaptiveRounding:
    """Adaptive rounding (jm18.5 q_around.c / quant4x4_around.c
    semantics, simplified): per-position rounding offsets adapted from
    the observed fractional parts of coefficients that quantize to
    nonzero levels, tracked separately for intra and inter blocks.
    Offsets start at the static 1/3 (intra) / 1/6 (inter) and move by
    EMA toward the content's own distribution, bounded to [1/6, 1/2].
    Encoder-only: any offset yields a conformant stream."""

    # video_codecs_tpu/ops/h264_rdoq.py:31
    def __init__(self, rate: float = 0.1) -> None:
        self.rate = rate
        self.off = {True: np.full((4, 4), 1.0 / 3.0),
                    False: np.full((4, 4), 1.0 / 6.0)}

    # video_codecs_tpu/ops/h264_rdoq.py:36
    def quant_ac(self, w: np.ndarray, qp: int,
                 intra: bool = True) -> np.ndarray:
        qbits = 15 + qp // 6
        m = ht.mf(qp).astype(np.float64)
        a = np.abs(w).astype(np.float64)
        ideal = a * m / (1 << qbits)
        off = self.off[intra]
        lv = np.floor(ideal + off).astype(np.int64)

        frac = ideal - np.floor(ideal)
        mask = (lv > 0).reshape(-1, 4, 4)
        cnt = mask.sum(0)
        upd = cnt > 0
        if upd.any():
            target = np.where(
                upd, (frac.reshape(-1, 4, 4) * mask).sum(0)
                / np.maximum(cnt, 1), off)
            self.off[intra] = np.clip(
                off + self.rate * (target - off), 1.0 / 6.0, 0.5)
        return np.sign(w) * lv


# video_codecs_tpu/ops/h264_rdoq.py:58
def _level_bits(lv: np.ndarray) -> np.ndarray:
    """Approximate CAVLC coefficient cost in bits: ~2*log2(level)+1
    suffix + 1 sign/T1 bit (vlc.c level coding shape)."""
    lv = np.abs(lv)
    bits = 2 * np.floor(np.log2(np.maximum(lv, 1))).astype(np.int64) + 2
    return np.where(lv == 0, 0, bits + 1)


# video_codecs_tpu/ops/h264_rdoq.py:66
def trellis_quant_ac(w: np.ndarray, qp: int, lam: float,
                     intra: bool = True) -> np.ndarray:
    """Soft-decision quantization of transformed blocks [..., 4, 4].

    Stage 1 (rdoq.c level_decision): per coefficient pick
    argmin_{l in {l_hi, l_hi-1, 0}} (ideal - l)^2 * step^2 + lam_td * R(l).
    Stage 2: trailing-zero pruning in zigzag order — drop the last
    nonzero while that improves the lambda cost (last-position part of
    the trellis).
    """
    qbits = 15 + qp // 6
    lam = 0.6 * lam   # rate-model calibration: the closed-form CAVLC
    # estimate overshoots true incremental bits (context coding makes
    # marginal coefficients cheaper); 0.6 minimizes BD-rate on the
    # foreman sweep (-0.7% vs hard quant; >1 flips the gain negative)
    m = ht.mf(qp).astype(np.float64)
    step = (ht.vmat(qp).astype(np.float64) * (1 << (qp // 6)))
    a = np.abs(w).astype(np.float64)
    ideal = a * m / (1 << qbits)            # real-valued level
    l_hi = np.ceil(ideal - 0.0001)          # JM's upper candidate
    cands = np.stack([np.zeros_like(l_hi),
                      np.maximum(l_hi - 1, 0), l_hi])
    # dequant-domain SSD mapped to pixel-domain SSE: the inverse
    # transform rows have norm^2 4 (even) / 2.5 (odd) and a final >>6,
    # so a coefficient error e contributes e^2 * ni^2*nj^2 / 4096
    n2 = np.array([4.0, 2.5, 4.0, 2.5])
    norm_w = (n2[:, None] * n2[None, :]) / 4096.0
    dist = ((ideal - cands) * step) ** 2 * norm_w
    rate = _level_bits(cands.astype(np.int64)).astype(np.float64)
    cost = dist + lam * rate
    best = np.argmin(cost, axis=0)
    lv = np.take_along_axis(cands, best[None], 0)[0].astype(np.int64)

    # stage 2: prune trailing nonzeros per 4x4 block
    shape = lv.shape
    flat = lv.reshape(-1, 16)[:, _ZZ]
    fdist = np.take_along_axis(dist, best[None], 0)[0].reshape(-1, 16)[:, _ZZ]
    zdist = dist[0].reshape(-1, 16)[:, _ZZ]
    frate = _level_bits(flat)
    for b in range(flat.shape[0]):
        nz = np.nonzero(flat[b])[0]
        for k in nz[::-1]:
            # zeroing the current last nonzero also saves ~its position
            # in total_zeros/run coding: credit 1 extra bit
            gain = lam * (frate[b, k] + 1) - (zdist[b, k] - fdist[b, k])
            if gain > 0:
                flat[b, k] = 0
            else:
                break
    out = np.zeros_like(flat)
    out[:, _ZZ] = flat
    return (np.sign(w) * out.reshape(shape)).astype(np.int64)
