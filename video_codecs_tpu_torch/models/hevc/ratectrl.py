"""Picture-level rate control: the R-lambda and URQ quadratic controllers
that drive `LowDelayEncoder.encode_frames` through `pick_qp()` before a
picture and `update(bits, metric)` after it.

The port's copy of video_codecs_tpu/models/hevc/ratectrl.py, in Python
floats as the original computes them; each class and function keeps its
name and a comment gives the original's line.  Parity references (the
original's): hm-16.5rc1 TEncRateCtrl.cpp (R-lambda: lambda = alpha *
bpp^beta, QP = 4.2005 ln(lambda) + 13.7122, the adaptive alpha/beta
update and its bpp-dependent rates, the intra SATD model) and
hm11.0_ratectrl / jm18.5 rc_quadratic.c (URQ: R = X1*MAD/Q +
X2*MAD/Q^2).

Every controller shares the interface:
    qp = rc.pick_qp()            # before encoding a picture
    rc.update(bits, metric)      # after (metric: the picture's MAD)

Two controllers set QPs inside a picture: `UrqBasicUnitControl` (URQ per
basic unit, the hm11.0_ratectrl study: start_frame / unit_qp /
update_unit / end_frame) and `CtuRateControl` (`ctu_qps`: a QP per CTU
from the ME SATD map in float64 numpy, which the host low-delay P coder
models/hevc/inter_codec.LowDelayEncoder signals as cu_qp_delta when its
`ctu_rc` is set).
"""

from __future__ import annotations

import math

# video_codecs_tpu/models/hevc/ratectrl.py:24
class RateLambdaControl:
    """Frame-level R-lambda controller (TEncRateCtrl semantics)."""

    def __init__(self, target_bps: float, fps: float, width: int, height: int,
                 base_qp: int = 32) -> None:
        self.pixels = width * height
        self.target_bits_per_frame = target_bps / fps
        self.alpha = 3.2003
        self.beta = -1.367
        self.base_qp = base_qp
        self.prev_qp = base_qp
        self.buffer_error = 0.0  # bits over/under spent so far

    def pick_qp(self) -> int:
        # spend the per-frame budget, paying back 10% of accumulated error
        target = max(self.target_bits_per_frame - 0.1 * self.buffer_error,
                     0.1 * self.target_bits_per_frame)
        bpp = target / self.pixels
        lam = self.alpha * (bpp ** self.beta)
        qp = int(round(4.2005 * math.log(lam) + 13.7122))
        qp = max(self.prev_qp - 2, min(self.prev_qp + 2, qp))
        qp = max(1, min(51, qp))
        self._last_target_bpp = bpp
        self._last_lambda = lam
        self.prev_qp = qp
        return qp

    def update(self, bits_used: float, metric: float = 0.0) -> None:
        self.buffer_error += bits_used - self.target_bits_per_frame
        actual_bpp = max(bits_used / self.pixels, 1e-7)
        # model update (TEncRateCtrl updateAlphaBetaIntra-style)
        lambda_comp = self.alpha * (actual_bpp ** self.beta)
        delta = math.log(self._last_lambda) - math.log(lambda_comp)
        self.alpha *= math.exp(0.10 * delta)
        self.alpha = min(max(self.alpha, 0.05), 20.0)
        self.beta += 0.05 * delta * math.log(actual_bpp)
        self.beta = min(max(self.beta, -3.0), -0.1)


# video_codecs_tpu/models/hevc/ratectrl.py:63
class UrqQuadraticControl:
    """Legacy URQ quadratic controller (JVT-G012 / hm11.0_ratectrl)."""

    def __init__(self, target_bps: float, fps: float, width: int, height: int,
                 base_qp: int = 32) -> None:
        self.pixels = width * height
        self.target_bits_per_frame = target_bps / fps
        self.x1 = 0.25 * self.target_bits_per_frame  # first-order model term
        self.x2 = 0.0
        self.mad_pred = 8.0
        self.mad_a1, self.mad_a2 = 1.0, 0.0
        self.prev_mad = 8.0
        self.prev_qp = base_qp
        self.buffer_error = 0.0

    @staticmethod
    def _qstep(qp: float) -> float:
        return (2.0 ** ((qp - 4) / 6.0)) * 0.625

    @staticmethod
    def _qp_from_qstep(qs: float) -> int:
        return int(round(4 + 6 * math.log2(max(qs, 1e-6) / 0.625)))

    def pick_qp(self) -> int:
        target = max(self.target_bits_per_frame - 0.1 * self.buffer_error,
                     0.1 * self.target_bits_per_frame)
        mad = self.mad_a1 * self.prev_mad + self.mad_a2
        self.mad_pred = mad
        # solve X1*MAD/Q + X2*MAD/Q^2 = target for Qstep
        a = target
        b = -self.x1 * mad
        c = -self.x2 * mad
        if self.x2 == 0.0 or b * b - 4 * a * c < 0:
            qs = self.x1 * mad / target
        else:
            qs = (-b + math.sqrt(b * b - 4 * a * c)) / (2 * a)
        qp = self._qp_from_qstep(qs)
        qp = max(self.prev_qp - 2, min(self.prev_qp + 2, qp))
        qp = max(1, min(51, qp))
        self._last_qs = self._qstep(qp)
        self.prev_qp = qp
        return qp

    def update(self, bits_used: float, mad: float) -> None:
        self.buffer_error += bits_used - self.target_bits_per_frame
        mad = max(mad, 1e-3)
        # first-order model refresh (windowed regression collapsed to the
        # latest observation with damping, as in rc_quadratic's sliding fit)
        x1_obs = bits_used * self._last_qs / mad
        self.x1 = 0.75 * self.x1 + 0.25 * x1_obs
        self.mad_a1 = 0.75 * self.mad_a1 + 0.25 * (mad / max(self.prev_mad, 1e-3))
        self.mad_a1 = min(max(self.mad_a1, 0.2), 3.0)
        self.prev_mad = mad


# video_codecs_tpu/models/hevc/ratectrl.py:119-121
#: clips of the R-lambda model parameters (TEncRateCtrl.h:70-73)
_ALPHA_MIN, _ALPHA_MAX = 0.05, 500.0
_BETA_MIN, _BETA_MAX = -3.0, -0.1
_BETA1 = 1.2517           # intra cost exponent (RATE_CONTROL_INTRA)


# video_codecs_tpu/models/hevc/ratectrl.py:124
def _clip(v, lo, hi):
    return lo if v < lo else (hi if v > hi else v)


# video_codecs_tpu/models/hevc/ratectrl.py:128
class HmRateControl:
    """Reference-fidelity R-lambda rate control: PER-FRAME-LEVEL
    adaptive alpha/beta with HM's exact update equations and
    bpp-dependent update rates, GOP-level bit allocation, and the
    intra SATD model.

    Parity: hm-16.5rc1 TEncRateCtrl.cpp — update-rate ladder (:96-117),
    TEncRCPic::updateAfterPicture (:1001, the log-lambda gradient step
    with lnbpp clipping and the degenerate-case decay),
    updateAlphaBetaIntra (:1095), calculateLambdaIntra / BETA1 intra
    cost model (:637,1127), getRefineBitsForIntra (:1072; alpha
    0.25/0.30 by bits threshold, beta 0.5582), estimatePicQP ladder
    (QP = 4.2005 ln lambda + 13.7122, +-2/ +-3 clips vs last QP of the
    same level).

    Interface (one picture at a time, in coding order):
        lam, qp = rc.start_picture(level, intra_cost=satd_or_None)
        ... encode with that qp/lambda ...
        rc.update_after_picture(level, bits, qp, lam, is_intra)
    `level` 0 is the intra/anchor level, higher = deeper GOP levels.
    """

    def __init__(self, target_bps: float, fps: float, width: int,
                 height: int, gop_weights: tuple = (1.0,),
                 n_levels: int = 2) -> None:
        self.pixels = width * height
        self.fps = fps
        self.target_bits_per_frame = target_bps / fps
        seq_bpp = target_bps / fps / self.pixels
        # adaptive update rates by sequence bpp (TEncRateCtrl.cpp:96-117)
        if seq_bpp < 0.03:
            self.alpha_update, self.beta_update = 0.01, 0.005
        elif seq_bpp < 0.08:
            self.alpha_update, self.beta_update = 0.05, 0.025
        elif seq_bpp < 0.2:
            self.alpha_update, self.beta_update = 0.1, 0.05
        elif seq_bpp < 0.5:
            self.alpha_update, self.beta_update = 0.2, 0.1
        else:
            self.alpha_update, self.beta_update = 0.4, 0.2
        # per-level model parameters: level 0 carries the intra pair
        # when used for I pictures (alpha 6.7542 / beta 1.7860 —
        # RATE_CONTROL_INTRA class defaults), others the inter pair
        self.alpha = [6.7542] + [3.2003] * (n_levels - 1)
        self.beta = [1.7860] + [-1.367] * (n_levels - 1)
        self.gop_weights = list(gop_weights)
        self.buffer_error = 0.0
        self.last_qp = [0] * n_levels
        self._gop_alloc: list = []
        self._pos = 0

    # ---- allocation ----

    def _picture_target(self, level: int) -> float:
        gs = len(self.gop_weights)
        if self._pos == 0:
            gop_bits = gs * self.target_bits_per_frame \
                - 0.2 * self.buffer_error
            gop_bits = max(gop_bits, 0.1 * gs * self.target_bits_per_frame)
            wsum = sum(self.gop_weights)
            self._gop_alloc = [gop_bits * w / wsum
                               for w in self.gop_weights]
        t = max(self._gop_alloc[self._pos],
                0.05 * self.target_bits_per_frame)
        self._pos = (self._pos + 1) % gs
        return t

    # ---- per-picture estimate ----

    def start_picture(self, level: int, intra_cost: float | None = None):
        """-> (lambda, qp).  intra_cost: the picture's HAD/SATD sum
        (TEncSlice calCostSliceI) for I pictures."""
        target = self._picture_target(level)
        if intra_cost is not None:
            # refine the intra budget by coding complexity
            # (getRefineBitsForIntra)
            a = 0.25 if target * 40 < self.pixels else 0.30
            target = max(a * (intra_cost * 4.0 / target) ** 0.5582
                         * target, 0.05 * self.target_bits_per_frame)
        bpp = target / self.pixels
        if intra_cost is not None:
            cpp = (intra_cost / self.pixels) ** _BETA1
            lam = (self.alpha[level] / 256.0) * \
                ((cpp / bpp) ** self.beta[level])
        else:
            lam = self.alpha[level] * (bpp ** self.beta[level])
        lam = _clip(lam, 0.1, 10000.0)
        qp = int(round(4.2005 * math.log(lam) + 13.7122))
        if self.last_qp[level]:
            qp = _clip(qp, self.last_qp[level] - 3,
                       self.last_qp[level] + 3)
        qp = _clip(qp, 1, 51)
        self._last = (target, bpp, lam)
        self.last_qp[level] = qp
        return lam, qp

    # ---- model update ----

    def update_after_picture(self, level: int, bits: float, qp: int,
                             lam: float, is_intra: bool,
                             intra_cost: float | None = None) -> None:
        self.buffer_error += bits - self.target_bits_per_frame
        alpha, beta = self.alpha[level], self.beta[level]
        target = self._last[0]
        if is_intra:
            # updateAlphaBetaIntra (:1095): gradient on log-bits error
            cpp = ((intra_cost or 1.0) / self.pixels) ** _BETA1
            lnbpp = math.log(cpp)
            diff = _clip(0.25 * beta * (math.log(max(bits, 1.0)) -
                                        math.log(max(target, 1.0))),
                         -0.125, 0.125)
            alpha = alpha * math.exp(diff)
            beta = beta + diff / max(lnbpp, 1e-3)
        else:
            bpp = max(bits / self.pixels, 1e-7)
            cal = alpha * (bpp ** beta)
            if lam < 0.01 or cal < 0.01 or bpp < 0.0001:
                # degenerate: decay toward defaults (:1030-1046)
                alpha *= 1.0 - self.alpha_update / 2.0
                beta *= 1.0 - self.beta_update / 2.0
            else:
                cal = _clip(cal, lam / 10.0, lam * 10.0)
                d = math.log(lam) - math.log(cal)
                alpha += self.alpha_update * d * alpha
                lnbpp = _clip(math.log(bpp), -5.0, -0.1)
                beta += self.beta_update * d * lnbpp
        self.alpha[level] = _clip(alpha, _ALPHA_MIN, _ALPHA_MAX)
        self.beta[level] = _clip(beta, _BETA_MIN, _BETA_MAX) \
            if not is_intra else _clip(beta, -3.0, 10.0)

    # ---- legacy pick_qp/update interface (IPPP: level 1 inter) ----

    def pick_qp(self) -> int:
        self._legacy = self.start_picture(min(1, len(self.alpha) - 1))
        return self._legacy[1]

    def update(self, bits_used: float, metric: float = 0.0) -> None:
        lam, qp = self._legacy
        self.update_after_picture(min(1, len(self.alpha) - 1),
                                  bits_used, qp, lam, is_intra=False)


# video_codecs_tpu/models/hevc/ratectrl.py:270
class UrqBasicUnitControl(UrqQuadraticControl):
    """URQ quadratic control with BASIC UNITS: within a frame, each
    unit (row of CTUs by default) gets its own QP from the remaining
    frame budget and a per-unit MAD prediction.

    Parity: hm11.0_ratectrl TEncRateCtrl.h:695 URQ branch /
    jm18.5 rc_quadratic.c:2754 updateRCModel + basic-unit loop
    (JVT-G012): linear MAD prediction per colocated unit, quadratic
    R(Q) solve on the unit budget, +-2 QP clip inside the frame.
    """

    def __init__(self, target_bps: float, fps: float, width: int,
                 height: int, base_qp: int = 32,
                 units_per_frame: int = 1) -> None:
        super().__init__(target_bps, fps, width, height, base_qp)
        self.n_units = max(1, units_per_frame)
        self.unit_mad = [8.0] * self.n_units
        self._frame_qp = base_qp

    def start_frame(self) -> int:
        self._frame_qp = self.pick_qp()
        self._unit_idx = 0
        self._frame_bits_left = max(
            self.target_bits_per_frame - 0.1 * self.buffer_error,
            0.1 * self.target_bits_per_frame)
        self._unit_bits = []
        return self._frame_qp

    def unit_qp(self) -> int:
        """QP for the next basic unit of the current frame."""
        i = self._unit_idx
        units_left = self.n_units - i
        target = max(self._frame_bits_left / max(units_left, 1), 1.0)
        mad = self.unit_mad[i]
        qs = self.x1 * mad / max(target, 1e-3)
        qp = self._qp_from_qstep(qs)
        qp = _clip(qp, self._frame_qp - 2, self._frame_qp + 2)
        qp = _clip(qp, 1, 51)
        self._unit_qs = self._qstep(qp)
        return qp

    def update_unit(self, bits: float, mad: float) -> None:
        i = self._unit_idx
        self._frame_bits_left -= bits
        mad = max(mad, 1e-3)
        x1_obs = bits * self._unit_qs / mad
        self.x1 = 0.75 * self.x1 + 0.25 * x1_obs
        self.unit_mad[i] = 0.6 * self.unit_mad[i] + 0.4 * mad
        self._unit_bits.append(bits)
        self._unit_idx += 1

    def end_frame(self) -> None:
        self.buffer_error += sum(self._unit_bits) \
            - self.target_bits_per_frame
        self.prev_mad = sum(self.unit_mad) / self.n_units


# video_codecs_tpu/models/hevc/ratectrl.py:327
class GopRateLambdaControl(RateLambdaControl):
    """R-lambda control with GOP-level bit allocation and hierarchical
    per-level weights (TEncRateCtrl.cpp:311-321 xCalEquaCoeff/adaptive
    ratio semantics, collapsed to the lambda-ratio weight table).

    gop_qp_offsets: per-position QP offsets of the GOP structure (e.g.
    GOPEntry qp_offset column); bits are allocated proportionally to
    2^(-offset/3) — the R-lambda equivalent of HM's hierarchical lambda
    ratios — then each picture runs the frame-level model on its share.
    """

    def __init__(self, target_bps: float, fps: float, width: int,
                 height: int, base_qp: int = 32,
                 gop_qp_offsets: tuple = (0,)) -> None:
        super().__init__(target_bps, fps, width, height, base_qp)
        self.weights = [2.0 ** (-o / 3.0) for o in gop_qp_offsets]
        self.gop_size = len(self.weights)
        self._pos = 0

    def pick_qp(self) -> int:
        if self._pos == 0:
            # GOP target: gop_size frame budgets, paying back 20% of the
            # accumulated buffer error over the GOP (fluid buffer)
            gop_bits = self.gop_size * self.target_bits_per_frame \
                - 0.2 * self.buffer_error
            gop_bits = max(gop_bits,
                           0.1 * self.gop_size * self.target_bits_per_frame)
            wsum = sum(self.weights)
            self._alloc = [gop_bits * w / wsum for w in self.weights]
        target = max(self._alloc[self._pos],
                     0.05 * self.target_bits_per_frame)
        self._pos = (self._pos + 1) % self.gop_size
        bpp = target / self.pixels
        lam = self.alpha * (bpp ** self.beta)
        qp = int(round(4.2005 * math.log(lam) + 13.7122))
        qp = max(self.prev_qp - 3, min(self.prev_qp + 3, qp))
        qp = max(1, min(51, qp))
        self._last_target_bpp = bpp
        self._last_lambda = lam
        self.prev_qp = qp
        return qp


# video_codecs_tpu/models/hevc/ratectrl.py:370
class CtuRateControl:
    """CTU-level QP allocation (TEncRateCtrl getLCUTargetBpp +
    getLCUEstLambdaAndQP semantics).

    Per picture: each CTU's bit share is proportional to its complexity
    weight (the ME SATD of the block — HM uses the per-LCU MAD/SATD
    estimate); the per-CTU lambda follows from the frame R-lambda model
    and maps to a QP offset, clipped to frame QP +-2 (HM's LCU QP clip).
    """

    def __init__(self, clip: int = 2) -> None:
        self.clip = clip

    def ctu_qps(self, frame_qp: int, weights):
        import numpy as np

        w = np.asarray(weights, np.float64) + 1.0
        # lambda_i / lambda_frame = (bpp_frame / bpp_i)^|beta| with
        # bpp_i proportional to w_i: cheaper CTUs get larger lambda (higher
        # QP), complex CTUs smaller lambda (HM equation 5.3 shape).
        rel = np.log2(w / np.exp(np.log(w).mean()))
        dqp = -np.round(rel).astype(int)
        qps = np.clip(frame_qp + dqp, frame_qp - self.clip,
                      frame_qp + self.clip)
        return np.clip(qps, 1, 51)
