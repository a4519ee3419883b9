"""HEVC sub-pel interpolation and motion compensation (spec 8.5.4.2.2).

Counterpart of video_codecs_tpu/ops/interp.py.  The filter tables and the
numpy twins the general decoder calls (`mc_luma14_rect_np`,
`mc_chroma14_rect_np`) are the port's copies of the originals
(each function keeps its name and a comment gives the original's line);
the batched device functions take int32 tensors on any device.

The reference filters with int32 `einsum`s; CUDA has no int32 matmul, so
each stage here is its 8 (luma) or 4 (chroma) integer multiply-adds over
shifted slices of the window, which give the same integers in any order.
All arithmetic stays int32 (`>>` on int32 is the arithmetic shift, as
in jnp): 14-bit intermediates, shift2 = 6, final (p + 32) >> 6 for
uni-prediction and (p0 + p1 + 64) >> 7 for bi-prediction.
`gather_window` is the integer motion search's edge-clamped window.

The multi-reference entries (`mc_luma14_multi`, `mc_luma_multi`,
`mc_chroma14_multi`, `mc_chroma_multi`) and `bi_average` launch the
hand-written kernels of csrc/inter_pred.cu for CUDA tensors
(`ops/inter_pred.mc_pred`, `inter_pred.bi_average`) and run their plain
versions, the eager bodies `mc_luma14_multi_ref`, `mc_chroma14_multi_ref`
and `bi_average_ref`, for CPU tensors.

The square-block numpy twins of the host low-delay P coder and its
decoder (`mc_luma_np`, `mc_chroma_np`, their 14-bit cores and the
explicit weighted uni-prediction `mc_luma_wp_np` / `mc_chroma_wp_np`)
keep the reference's names, integers and dtypes; where the reference
computes each sample in a Python loop, the 14-bit cores call the
rectangular twins with w = h = n.  The host B coder and its decoder
(models/hevc/bframe_codec.py) add the bi-prediction twins
`mc_luma_bi_np` / `mc_chroma_bi_np`.
"""

from __future__ import annotations

import numpy as np
import torch

from video_codecs_tpu_torch.utils.device import const

# frac -> 8 taps (TComInterpolationFilter.cpp:57)
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1]], np.int32)

# frac (1/8) -> 4 taps (TComInterpolationFilter.cpp:64)
CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2]], np.int32)


def gather_window(ref: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                  w: int, h: int) -> torch.Tensor:
    """[B, h, w] windows of `ref` [H, W] at integer (x0, y0) per block,
    edge-replicated (coordinates clamped into the picture)."""
    hh, ww = ref.shape
    dev = ref.device
    rows = (y0[:, None, None] + torch.arange(h, dtype=torch.int32,
                                             device=dev)[None, :, None]
            ).clamp(0, hh - 1)
    cols = (x0[:, None, None] + torch.arange(w, dtype=torch.int32,
                                             device=dev)[None, None, :]
            ).clamp(0, ww - 1)
    return ref[rows.long(), cols.long()]


# video_codecs_tpu/ops/interp.py:41
def _taps_dev(luma: bool, device) -> torch.Tensor:
    """Filter-tap table on `device` (int32, cached)."""
    return const(LUMA_FILTERS if luma else CHROMA_FILTERS, device)


def _filter2(win: torch.Tensor, fh: torch.Tensor, fv: torch.Tensor,
             n: int) -> torch.Tensor:
    """Separable filtering of [B, n+T-1, n+T-1] int32 windows with
    per-block taps fh, fv [B, T]: horizontal then vertical multiply-adds,
    then >> 6 (the reference's two einsums and its shift2)."""
    taps = fh.shape[1]
    hor = win[:, :, 0:n] * fh[:, 0, None, None]
    for i in range(1, taps):
        hor = hor + win[:, :, i:i + n] * fh[:, i, None, None]
    ver = hor[:, 0:n, :] * fv[:, 0, None, None]
    for i in range(1, taps):
        ver = ver + hor[:, i:i + n, :] * fv[:, i, None, None]
    return ver >> 6


# video_codecs_tpu/ops/interp.py:58
def mc_luma(ref: torch.Tensor, x0, y0, mvx, mvy, n: int) -> torch.Tensor:
    """Spec-exact luma MC [B, n, n]: two 8-tap stages, standard shifts.
    (x0, y0): block positions; (mvx, mvy): quarter-pel MVs, per block."""
    ix = x0 + (mvx >> 2)
    iy = y0 + (mvy >> 2)
    win = gather_window(ref.int(), ix - 3, iy - 3, n + 7, n + 7)
    pred14 = _mc_luma14_core(win, mvx & 3, mvy & 3, n)
    return ((pred14 + 32) >> 6).clamp(0, 255).int()


# video_codecs_tpu/ops/interp.py:83
def mc_chroma(ref: torch.Tensor, x0, y0, mvx, mvy, n: int) -> torch.Tensor:
    """Chroma MC: 1/8-pel MVs (= luma quarter-pel MV used directly in
    chroma sample units), 4-tap filters, taps -1..+2."""
    ix = x0 + (mvx >> 3)
    iy = y0 + (mvy >> 3)
    win = gather_window(ref.int(), ix - 1, iy - 1, n + 3, n + 3)
    pred14 = _mc_chroma14_core(win, mvx & 7, mvy & 7, n)
    return ((pred14 + 32) >> 6).clamp(0, 255).int()


# video_codecs_tpu/ops/interp.py:103
def _gather_window_multi(refs: torch.Tensor, ridx, x0, y0, w: int,
                         h: int) -> torch.Tensor:
    """[B, h, w] windows from stacked planes refs [R, H, W]: block b reads
    plane ridx[b] at integer (x0[b], y0[b]), edge-replicated."""
    hh, ww = refs.shape[-2:]
    dev = refs.device
    rows = (y0[:, None, None] + torch.arange(h, dtype=torch.int32,
                                             device=dev)[None, :, None]
            ).clamp(0, hh - 1)
    cols = (x0[:, None, None] + torch.arange(w, dtype=torch.int32,
                                             device=dev)[None, None, :]
            ).clamp(0, ww - 1)
    return refs[ridx.long()[:, None, None], rows.long(), cols.long()]


# video_codecs_tpu/ops/interp.py:115
def _mc_luma14_core(win: torch.Tensor, fx, fy, n: int) -> torch.Tensor:
    """Two-stage 8-tap filtering of gathered [B, n+7, n+7] windows into the
    14-bit intermediate domain (no final shift)."""
    taps = _taps_dev(True, win.device)
    return _filter2(win, taps[fx.long()], taps[fy.long()], n)


def _inter_pred():
    """ops/inter_pred, imported at the first CUDA call (it imports this
    module)."""
    from video_codecs_tpu_torch.ops import inter_pred
    return inter_pred


def mc_luma14_multi_ref(refs: torch.Tensor, ridx, x0, y0, mvx, mvy,
                        n: int) -> torch.Tensor:
    """The plain version of `mc_luma14_multi`: the reference's gather and
    two-stage filter as eager torch ops."""
    ix = x0 + (mvx >> 2)
    iy = y0 + (mvy >> 2)
    win = _gather_window_multi(refs.int(), ridx, ix - 3, iy - 3, n + 7,
                               n + 7)
    return _mc_luma14_core(win, mvx & 3, mvy & 3, n)


# video_codecs_tpu/ops/interp.py:127
def mc_luma14_multi(refs: torch.Tensor, ridx, x0, y0, mvx, mvy,
                    n: int) -> torch.Tensor:
    """Luma MC to the 14-bit domain from stacked references [R, H, W] with
    a per-block reference index (bi-pred hypothesis / WP input)."""
    if refs.device.type != "cpu":
        return _inter_pred().mc_pred(refs, ridx, x0, y0, mvx, mvy, n,
                                     out14=True)
    return mc_luma14_multi_ref(refs, ridx, x0, y0, mvx, mvy, n)


# video_codecs_tpu/ops/interp.py:138
def mc_luma_multi(refs: torch.Tensor, ridx, x0, y0, mvx, mvy,
                  n: int) -> torch.Tensor:
    """Spec-exact uni-pred luma MC from stacked references [R, H, W]."""
    if refs.device.type != "cpu":
        return _inter_pred().mc_pred(refs, ridx, x0, y0, mvx, mvy, n)
    p14 = mc_luma14_multi_ref(refs, ridx, x0, y0, mvx, mvy, n)
    return ((p14 + 32) >> 6).clamp(0, 255).int()


# video_codecs_tpu/ops/interp.py:145
def _mc_chroma14_core(win: torch.Tensor, fx, fy, n: int) -> torch.Tensor:
    taps = _taps_dev(False, win.device)
    return _filter2(win, taps[fx.long()], taps[fy.long()], n)


def mc_chroma14_multi_ref(refs: torch.Tensor, ridx, x0, y0, mvx, mvy,
                          n: int) -> torch.Tensor:
    """The plain version of `mc_chroma14_multi` (eager torch ops)."""
    ix = x0 + (mvx >> 3)
    iy = y0 + (mvy >> 3)
    win = _gather_window_multi(refs.int(), ridx, ix - 1, iy - 1, n + 3,
                               n + 3)
    return _mc_chroma14_core(win, mvx & 7, mvy & 7, n)


# video_codecs_tpu/ops/interp.py:155
def mc_chroma14_multi(refs: torch.Tensor, ridx, x0, y0, mvx, mvy,
                      n: int) -> torch.Tensor:
    if refs.device.type != "cpu":
        return _inter_pred().mc_pred(refs, ridx, x0, y0, mvx, mvy, n,
                                     luma=False, out14=True)
    return mc_chroma14_multi_ref(refs, ridx, x0, y0, mvx, mvy, n)


# video_codecs_tpu/ops/interp.py:164
def mc_chroma_multi(refs: torch.Tensor, ridx, x0, y0, mvx, mvy,
                    n: int) -> torch.Tensor:
    if refs.device.type != "cpu":
        return _inter_pred().mc_pred(refs, ridx, x0, y0, mvx, mvy, n,
                                     luma=False)
    p14 = mc_chroma14_multi_ref(refs, ridx, x0, y0, mvx, mvy, n)
    return ((p14 + 32) >> 6).clamp(0, 255).int()


def bi_average_ref(p0_14: torch.Tensor, p1_14: torch.Tensor) -> torch.Tensor:
    """The plain version of `bi_average` (eager torch ops)."""
    return ((p0_14 + p1_14 + 64) >> 7).clamp(0, 255).int()


# video_codecs_tpu/ops/interp.py:170
def bi_average(p0_14: torch.Tensor, p1_14: torch.Tensor) -> torch.Tensor:
    """Default bi-pred combine (spec 8.5.4.2.3.2): both hypotheses in the
    14-bit domain, (p0 + p1 + 64) >> 7, clipped to 8-bit."""
    if p0_14.device.type != "cpu":
        return _inter_pred().bi_average(p0_14, p1_14)
    return bi_average_ref(p0_14, p1_14)


# video_codecs_tpu/ops/interp.py:277
def mc_luma14_rect_np(ref: np.ndarray, x0: int, y0: int, mvx: int,
                      mvy: int, w: int, h: int,
                      bit_depth: int = 8) -> np.ndarray:
    """Vectorized rectangular luma MC to the 14-bit domain (general
    decoder path: PU sizes 64x64 .. 8x4).  The horizontal intermediate
    is truncated by shift1 = bit_depth - 8 BEFORE the vertical stage
    (spec 8.5.3.3.3.1) — the two truncations do not commute."""
    ix, iy = x0 + (mvx >> 2), y0 + (mvy >> 2)
    fx, fy = mvx & 3, mvy & 3
    hh, ww = ref.shape
    rows = np.clip(iy - 3 + np.arange(h + 7), 0, hh - 1)
    cols = np.clip(ix - 3 + np.arange(w + 7), 0, ww - 1)
    win = ref[np.ix_(rows, cols)].astype(np.int64)
    fh = LUMA_FILTERS[fx].astype(np.int64)
    fv = LUMA_FILTERS[fy].astype(np.int64)
    hor = sum(win[:, i:i + w] * fh[i] for i in range(8)) >> (bit_depth - 8)
    return sum(hor[i:i + h, :] * fv[i] for i in range(8)) >> 6


# video_codecs_tpu/ops/interp.py:296
def mc_chroma14_rect_np(ref: np.ndarray, x0: int, y0: int, mvx: int,
                        mvy: int, w: int, h: int,
                        bit_depth: int = 8) -> np.ndarray:
    """Vectorized rectangular chroma MC to the 14-bit domain (1/8-pel)."""
    ix, iy = x0 + (mvx >> 3), y0 + (mvy >> 3)
    fx, fy = mvx & 7, mvy & 7
    hh, ww = ref.shape
    rows = np.clip(iy - 1 + np.arange(h + 3), 0, hh - 1)
    cols = np.clip(ix - 1 + np.arange(w + 3), 0, ww - 1)
    win = ref[np.ix_(rows, cols)].astype(np.int64)
    fh = CHROMA_FILTERS[fx].astype(np.int64)
    fv = CHROMA_FILTERS[fy].astype(np.int64)
    hor = sum(win[:, i:i + w] * fh[i] for i in range(4)) >> (bit_depth - 8)
    return sum(hor[i:i + h, :] * fv[i] for i in range(4)) >> 6


# video_codecs_tpu/ops/interp.py:180
def mc_luma_np(ref: np.ndarray, x0: int, y0: int, mvx: int, mvy: int,
               n: int) -> np.ndarray:
    """Uni-pred luma MC of one n x n block, int32: the 14-bit samples,
    (p + 32) >> 6, clipped to 8 bits."""
    p14 = _mc_luma14_np(ref, x0, y0, mvx, mvy, n)
    return np.clip((p14 + 32) >> 6, 0, 255).astype(np.int32)


# video_codecs_tpu/ops/interp.py:204
def mc_chroma_np(ref: np.ndarray, x0: int, y0: int, mvx: int, mvy: int,
                 n: int) -> np.ndarray:
    """Uni-pred chroma MC of one n x n block (1/8-pel), int32."""
    p14 = _mc_chroma14_np(ref, x0, y0, mvx, mvy, n)
    return np.clip((p14 + 32) >> 6, 0, 255).astype(np.int32)


# video_codecs_tpu/ops/interp.py:233
def _mc_luma14_np(ref, x0, y0, mvx, mvy, n):
    """int64 [n, n] luma samples in the 14-bit domain."""
    return mc_luma14_rect_np(ref, x0, y0, mvx, mvy, n, n)


# video_codecs_tpu/ops/interp.py:255
def _mc_chroma14_np(ref, x0, y0, mvx, mvy, n):
    """int64 [n, n] chroma samples in the 14-bit domain (1/8-pel)."""
    return mc_chroma14_rect_np(ref, x0, y0, mvx, mvy, n, n)


# video_codecs_tpu/ops/interp.py:312
def mc_luma_bi_np(ref0, ref1, x0, y0, mv0, mv1, n):
    p0 = _mc_luma14_np(ref0, x0, y0, mv0[0], mv0[1], n)
    p1 = _mc_luma14_np(ref1, x0, y0, mv1[0], mv1[1], n)
    return np.clip((p0 + p1 + 64) >> 7, 0, 255).astype(np.int32)


# video_codecs_tpu/ops/interp.py:318
def mc_chroma_bi_np(ref0, ref1, x0, y0, mv0, mv1, n):
    p0 = _mc_chroma14_np(ref0, x0, y0, mv0[0], mv0[1], n)
    p1 = _mc_chroma14_np(ref1, x0, y0, mv1[0], mv1[1], n)
    return np.clip((p0 + p1 + 64) >> 7, 0, 255).astype(np.int32)


# video_codecs_tpu/ops/interp.py:324
def mc_luma_wp_np(ref, x0, y0, mvx, mvy, n, w, o, denom):
    """Explicit weighted uni-prediction, luma (spec 8.5.3.3.4.3;
    TComWeightPrediction.cpp addWeightUni): the weight applies to the
    14-bit interpolation intermediate, then one combined shift."""
    p14 = _mc_luma14_np(ref, x0, y0, mvx, mvy, n)
    shift = denom + 6            # log2Wd = denom + (14 - bitDepth)
    return np.clip(((p14 * w + (1 << (shift - 1))) >> shift) + o, 0, 255)


# video_codecs_tpu/ops/interp.py:333
def mc_chroma_wp_np(ref, x0, y0, mvx, mvy, n, w, o, denom):
    """Explicit weighted uni-prediction, chroma."""
    p14 = _mc_chroma14_np(ref, x0, y0, mvx, mvy, n)
    shift = denom + 6
    return np.clip(((p14 * w + (1 << (shift - 1))) >> shift) + o, 0, 255)
