"""CABAC fractional-bit tables for rate-distortion decisions.

The port's copy of the part of video_codecs_tpu/ops/rdoq.py that the
device RDOQ (ops/rdoq_dev.py) reads: the fractional-bit table of the
64-state CABAC probability model, pLPS(i) = 0.5 * alpha^i with
alpha = (0.01875/0.5)^(1/63) (HM ContextModel::sm_entropyBits), in 2^15
units.  Each function keeps its name and a comment gives the original's
line.  The host RDOQ `rdoq_np` is not ported yet.
"""

from __future__ import annotations

import numpy as np

_SCALE_BITS = 15  # fractional-bit fixed point, 32768 = one bit


# video_codecs_tpu/ops/rdoq.py:44
def _entropy_bits_table() -> np.ndarray:
    """fracBits[packed_state ^ bin] in 2^15 units (see module docstring)."""
    alpha = (0.01875 / 0.5) ** (1.0 / 63.0)
    tab = np.zeros(128, np.int64)
    for s in range(128):
        pstate, mps = s >> 1, s & 1
        p_lps = 0.5 * alpha ** pstate
        # index convention: state ^ bin has LSB 0 when bin == MPS
        tab[s] = round(-np.log2((1.0 - p_lps) if mps == 0 else p_lps)
                       * (1 << _SCALE_BITS))
    return tab


ENTROPY_BITS = _entropy_bits_table()
_BYPASS = 1 << _SCALE_BITS


# video_codecs_tpu/ops/rdoq.py:61
def frac_bits(states: np.ndarray, ctx: int, bin_val: int) -> int:
    """Estimated fractional bits (2^15 scale) to code bin_val in ctx."""
    return int(ENTROPY_BITS[int(states[ctx]) ^ bin_val])
