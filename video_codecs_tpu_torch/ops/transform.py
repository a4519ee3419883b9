"""HEVC core transforms: the numpy twins and the batched device versions.

Counterpart of video_codecs_tpu/ops/transform.py.  `_matrices` and the
numpy twins are the port's copies of the originals (each function keeps
its name and a comment gives the original's line).  The device functions
`forward_transform` / `inverse_transform` keep the reference's two-stage
form with HM's rounding shifts (TComTrQuant.cpp partialButterfly*), but
each stage's product is a float64 matmul: CUDA has no int32 matmul, and
every partial sum here is an integer below 2^53 (at most ~9.4e7), so
float64 gives the reference's int32 results exactly.  float32 would not:
the 32x32 second stage passes 2^24.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from video_codecs_tpu_torch.utils import rom
from video_codecs_tpu_torch.utils.device import const

TRANSFORM_MATRIX_SHIFT = 6


# video_codecs_tpu/ops/transform.py:29
@functools.lru_cache(maxsize=None)
def _matrices(log2_size: int, dst: bool):
    if dst:
        t = rom.DST4
    else:
        t = rom.dct_matrix(1 << log2_size)
    return t.astype(np.int32), np.ascontiguousarray(t.T, dtype=np.int32)


# video_codecs_tpu/ops/transform.py:38
def _stage(t: torch.Tensor, blocks: torch.Tensor, shift: int) -> torch.Tensor:
    """One butterfly stage: out[..., k, j] = (sum_n T[k,n]*blocks[..., j, n] + add) >> shift.

    `t` is the float64 matrix; the product is exact (see module doc)."""
    add = 1 << (shift - 1)
    prod = torch.matmul(blocks.double(), t.T).long()
    out = (prod + add) >> shift
    return out.int().transpose(-1, -2)


# video_codecs_tpu/ops/transform.py:47
def forward_transform(res: torch.Tensor, log2_size: int, bit_depth: int = 8,
                      dst: bool = False) -> torch.Tensor:
    """Forward core transform of residual blocks [..., N, N] int32 -> coeffs.

    Output is indexed [..., vertical_freq, horizontal_freq] like HM's
    row-major coefficient buffer."""
    n = 1 << log2_size
    if res.shape[-1] != n or res.shape[-2] != n:
        raise ValueError(f"expected [..., {n}, {n}] blocks, got {tuple(res.shape)}")
    t = const(_matrices(log2_size, dst)[0], res.device, torch.float64)
    shift_1st = log2_size + bit_depth + TRANSFORM_MATRIX_SHIFT - rom.MAX_TR_DYNAMIC_RANGE
    shift_2nd = log2_size + TRANSFORM_MATRIX_SHIFT
    tmp = _stage(t, res, shift_1st)
    return _stage(t, tmp, shift_2nd)


# video_codecs_tpu/ops/transform.py:65
def inverse_transform(coeff: torch.Tensor, log2_size: int, bit_depth: int = 8,
                      dst: bool = False) -> torch.Tensor:
    """Inverse core transform, bit-exact vs HM partialButterflyInverse*."""
    n = 1 << log2_size
    if coeff.shape[-1] != n or coeff.shape[-2] != n:
        raise ValueError(f"expected [..., {n}, {n}] blocks, got {tuple(coeff.shape)}")
    t_inv = const(_matrices(log2_size, dst)[1], coeff.device, torch.float64)
    shift_1st = TRANSFORM_MATRIX_SHIFT + 1
    shift_2nd = TRANSFORM_MATRIX_SHIFT + rom.MAX_TR_DYNAMIC_RANGE - 1 - bit_depth
    clamp = 1 << rom.MAX_TR_DYNAMIC_RANGE
    tmp = _stage(t_inv, coeff.transpose(-1, -2), shift_1st)
    tmp = tmp.clamp(-clamp, clamp - 1)
    out = _stage(t_inv, tmp, shift_2nd)
    out = out.clamp(-clamp, clamp - 1)
    return out.transpose(-1, -2).contiguous()


# video_codecs_tpu/ops/transform.py:83
def forward_transform_np(res: np.ndarray, log2_size: int, bit_depth: int = 8,
                         dst: bool = False) -> np.ndarray:
    """NumPy twin of forward_transform (host-side golden path)."""
    t = rom.DST4 if dst else rom.dct_matrix(1 << log2_size)
    t = t.astype(np.int64)
    s1 = log2_size + bit_depth + TRANSFORM_MATRIX_SHIFT - rom.MAX_TR_DYNAMIC_RANGE
    s2 = log2_size + TRANSFORM_MATRIX_SHIFT
    tmp = (t @ res.astype(np.int64).T + (1 << (s1 - 1))) >> s1
    out = (t @ tmp.T + (1 << (s2 - 1))) >> s2
    return out.astype(np.int32)


# video_codecs_tpu/ops/transform.py:95
def inverse_transform_np(coeff: np.ndarray, log2_size: int, bit_depth: int = 8,
                         dst: bool = False) -> np.ndarray:
    """NumPy twin of inverse_transform."""
    t = rom.DST4 if dst else rom.dct_matrix(1 << log2_size)
    t = t.astype(np.int64)
    s1 = TRANSFORM_MATRIX_SHIFT + 1
    s2 = TRANSFORM_MATRIX_SHIFT + rom.MAX_TR_DYNAMIC_RANGE - 1 - bit_depth
    clamp = 1 << rom.MAX_TR_DYNAMIC_RANGE
    tmp = (t.T @ coeff.astype(np.int64) + (1 << (s1 - 1))) >> s1
    tmp = np.clip(tmp, -clamp, clamp - 1)
    out = (t.T @ tmp.T + (1 << (s2 - 1))) >> s2
    out = np.clip(out, -clamp, clamp - 1)
    return out.T.astype(np.int32)
